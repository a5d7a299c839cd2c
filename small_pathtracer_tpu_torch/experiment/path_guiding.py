"""Voxel path guiding, the port of the JAX package's
``experiment/path_guiding.py``.

A cheap cosine training pass learns, for each voxel of the reference's
10-unit grid (x in [0, 100), y in [-1, 85), z in [-1, 171), 1620 voxels),
the direction that leads to light: every emission pickup deposits its
luminance times the outgoing direction of the last three diffuse vertices
of its path (credit 1, 1/2, 1/4) into their voxels. A guided render then
samples each diffuse bounce from the defensive mixture

    beta * power-cosine(k) around the voxel's lobe + (1 - beta) * cosine

and weights it by pdf_cos / pdf_mix, which keeps the estimator unbiased
for any table (``integrator.wavefront.guided_mixture``).

- ``train_guide`` -> moments (V, 3); ``guide_lobes`` -> (mu (V, 3) unit
  lobes, use (V,) bool), the table the guided kernels take
  (``ops.megakernel.render_megakernel_guided``).
- ``render_guided``: the JAX package's fixed-depth guided estimator,
  ``cosine`` or ``nee`` (textbook NEE), in eager torch: a second reference
  for the guided kernels.
- ``render_guided_online``: online guiding, spans of the guided kernel with
  the table retrained between them.

The training pass sums its deposits exactly (int64 fixed point, the scale
a power of two chosen from the bounce's largest deposit), so the table's
bits do not depend on the order of additions: float atomics would make
them change from run to run on the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import rng, vecmath as vm
from ..geometry.intersect import shade_info, trace
from ..integrator import sampling
from ..integrator.sampling import sample_power_cosine  # noqa: F401
from ..integrator.wavefront import (
    _probe_light, _refr_scatter, _spec_scatter, guided_mixture,
)
from ..scene.types import DIFF, GLOS, REFR, SPEC, Scene, object_arrays

# The reference's grid-scan bounds (smallpt.cpp:386-388), 10-unit voxels.
_LO = np.array([0.0, -1.0, -1.0], np.float32)
_HI = np.array([100.0, 85.0, 171.0], np.float32)
_NVOX = tuple(int(v) for v in np.ceil((_HI - _LO) / 10.0))  # (10, 9, 18)
N_VOXELS = _NVOX[0] * _NVOX[1] * _NVOX[2]
# Credit ring: the last K_CREDIT diffuse vertices of a path, slot kk
# credited 0.5**kk.
K_CREDIT = 3


def voxel_id(x: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (N,) int64 flat voxel ids, clamped into the grid
    (a miss's (0, 0, 0) lands in a corner voxel). Divides by a device
    tensor, as the kernels divide."""
    lo = torch.as_tensor(_LO, device=x.device)
    ten = torch.tensor(10.0, device=x.device)
    hi = torch.as_tensor(np.asarray(_NVOX) - 1, device=x.device)
    ix = torch.clamp(torch.floor((x - lo) / ten).to(torch.int64),
                     min=torch.zeros_like(hi), max=hi)
    return (ix[:, 0] * _NVOX[1] + ix[:, 1]) * _NVOX[2] + ix[:, 2]


def _require_single_light(scene: Scene, what: str) -> None:
    if getattr(scene, "lights", None) is not None:
        raise NotImplementedError(
            f"{what} with estimator='nee' supports single-light scenes "
            "only (the guiding demo has no light-list selection); use the "
            "wavefront/megakernel renderers for multi-emitter scenes"
        )


def _reject_glossy(scene: Scene, what: str) -> None:
    if bool((object_arrays(scene)[2] == GLOS).any()):
        raise NotImplementedError(
            f"{what} does not support GLOS (glossy) primitives: the guided "
            "mixture reweights against the cosine continuation pdf; render "
            "glossy scenes unguided (cosine / nee_textbook / mis)"
        )


def _spawn_all(cam: CameraParams, cfg: RenderConfig, seed, device):
    """Primary rays of every (pixel, sample), path id pix * spp + s."""
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    s = torch.arange(cfg.spp, dtype=torch.int64, device=device)
    path_id = (pix[:, None] * cfg.spp + s[None, :]).reshape(-1)
    px = (pix % cfg.width).repeat_interleave(cfg.spp)
    py = torch.div(pix, cfg.width, rounding_mode="floor").repeat_interleave(
        cfg.spp)
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed)
    return o, d, path_id


def _rr(cfg: RenderConfig, depth, u_rr, albedo, alive):
    """Russian roulette: (alive and survived, the 1/p throughput scale)."""
    p_max = torch.amax(albedo, dim=-1)
    rr_active = (depth > cfg.rr_start_depth) | (p_max <= 0.0)
    survive = torch.where(rr_active, u_rr < p_max, True)
    p_pos = p_max > 0.0
    inv_p = torch.where(
        rr_active & p_pos, 1.0 / torch.where(p_pos, p_max, 1.0), 1.0
    )
    return alive & survive, inv_p


def _material_mix(sh, d_in, u_coin, diff_dir, diff_w):
    """Per-material scatter: ``diff_dir``/``diff_w`` at DIFF vertices, the
    mirror and the dielectric elsewhere."""
    spec_dir, spec_w = _spec_scatter(sh, d_in)
    refr_dir, refr_w = _refr_scatter(sh, d_in, u_coin)
    is_spec = (sh.refl == SPEC)[:, None]
    is_refr = (sh.refl == REFR)[:, None]
    new_d = torch.where(is_spec, spec_dir,
                        torch.where(is_refr, refr_dir, diff_dir))
    w = torch.where(sh.refl == SPEC, spec_w,
                    torch.where(sh.refl == REFR, refr_w, diff_w))
    return new_d, w


def _add_exact(acc: torch.Tensor, vid: torch.Tensor,
               dep: torch.Tensor) -> torch.Tensor:
    """acc (V, 3) float64 plus the rows of dep (M, 3) float32 summed by
    vid (M,), in int64 fixed point: each deposit scaled by a power of two
    (exact) and rounded, the integer sums (exact in any order, so
    ``index_add_``'s atomics on the card change no bit) scaled back. The
    scale keeps M times the largest deposit below 2^62."""
    m = float(dep.abs().max())
    if m == 0.0:
        return acc
    scale = 2.0 ** (62 - math.frexp(m * dep.shape[0])[1])
    q = torch.round(dep.to(torch.float64) * scale).to(torch.int64)
    sums = torch.zeros(acc.shape, dtype=torch.int64, device=acc.device)
    sums.index_add_(0, vid, q)
    return acc + sums.to(torch.float64) / scale


def train_guide(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                n_bounces: int, seed) -> torch.Tensor:
    """Cosine-sampled training pass over cfg's pixels and samples on the
    scene's device. Returns the (V, 3) float32 direction-moment table: the
    sum over emission pickups of (pickup luminance) * 0.5**kk * (the
    direction that left the path's kk-th last diffuse vertex), in that
    vertex's voxel. SPEC/REFR vertices pass credit through unchanged."""
    _reject_glossy(scene, "train_guide")
    device = scene.device
    o, d, path_id = _spawn_all(cam, cfg, int(seed), device)
    n = o.shape[0]
    T = torch.ones((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    moments = torch.zeros((N_VOXELS, 3), dtype=torch.float64, device=device)
    diff_x = [o] * K_CREDIT
    diff_d = [d] * K_CREDIT
    diff_valid = [torch.zeros(n, dtype=torch.bool, device=device)] * K_CREDIT
    for b in range(n_bounces):
        depth = torch.full((n,), b + 1, dtype=torch.int64, device=device)
        hit = trace(scene, o, d)
        sh = shade_info(scene, o, d, hit)
        te = T * sh.emission
        pick = (te[:, 0] + te[:, 1] + te[:, 2]) * alive
        vids, deps = [], []
        for kk in range(K_CREDIT):
            dep = pick * diff_valid[kk] * np.float32(0.5 ** kk)
            vids.append(voxel_id(diff_x[kk]))
            deps.append(diff_d[kk] * dep[:, None])
        moments = _add_exact(moments, torch.cat(vids), torch.cat(deps))

        ctr = depth * rng.DRAWS_PER_BOUNCE
        u_rr, u1, u2, u_refr = (
            rng.uniform_mix(seed, path_id, ctr + p)
            for p in (rng.P_RR, rng.P_SCATTER_U, rng.P_SCATTER_V,
                      rng.P_REFR_COIN))
        alive, inv_p = _rr(cfg, depth, u_rr, sh.albedo, alive)
        cos_dir = sampling.sample_cosine(sh.n, u1, u2)
        new_d, w = _material_mix(sh, d, u_refr, cos_dir,
                                 torch.ones_like(u1))
        T = T * sh.albedo * (inv_p * w)[:, None]
        is_diff = sh.refl == DIFF
        shift1 = alive & is_diff
        shift = shift1[:, None]
        # Ring shift: slot 0 is the most recent diffuse vertex.
        for kk in range(K_CREDIT - 1, 0, -1):
            diff_x[kk] = torch.where(shift, diff_x[kk - 1], diff_x[kk])
            diff_d[kk] = torch.where(shift, diff_d[kk - 1], diff_d[kk])
            diff_valid[kk] = torch.where(shift1, diff_valid[kk - 1],
                                         diff_valid[kk])
        diff_x[0] = torch.where(shift, sh.x, diff_x[0])
        diff_d[0] = torch.where(shift, new_d, diff_d[0])
        diff_valid[0] = alive & (diff_valid[0] | is_diff)
        o = torch.where(alive[:, None], sh.x, o)
        d = torch.where(alive[:, None], new_d, d)
    return moments.to(torch.float32)


def guide_lobes(moments: torch.Tensor, min_weight: float = 1e-3):
    """(V, 3) moments -> (mu (V, 3) unit lobes, use (V,) bool: the moment's
    length exceeds min_weight)."""
    norm = vm.magnitude(moments)
    use = norm > min_weight
    mu = moments / torch.clamp(norm, min=1e-12)[:, None]
    return mu, use


def _guided_diffuse(sh, mu_tab, use_tab, u1, u2, u_coin, beta: float,
                    k: float):
    """The guided mixture at each lane's vertex, its lobe looked up in the
    voxel table at the hit point: (direction, weight, ok), see
    ``guided_mixture``. Only DIFF vertices are guided."""
    vid = voxel_id(sh.x)
    mu = mu_tab.index_select(0, vid)
    use = use_tab.index_select(0, vid) & (sh.refl == DIFF)
    m = guided_mixture(sh.n, mu, use, u1, u2, u_coin, beta, k)
    return m.d, m.w, m.ok


def render_guided(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                  seed, guide, n_bounces: int, beta: float = 0.5,
                  k: float = 8.0, estimator: str = "cosine"):
    """The fixed-depth guided estimator (no regeneration, n_bounces
    bounces a path) with the (mu, use) table ``guide``: "cosine" (guided
    continuation only) or "nee" (a textbook shadow probe at each diffuse
    vertex and the next light pickup suppressed, with the guided
    continuation). SPEC/REFR vertices scatter unguided.

    Returns the unclamped linear (h, w, 3) mean image."""
    if estimator not in ("cosine", "nee"):
        raise ValueError(f"unknown guided estimator {estimator!r}")
    if estimator == "nee":
        _require_single_light(scene, "render_guided")
    _reject_glossy(scene, "render_guided")
    device = scene.device
    mu_tab, use_tab = (t.to(device) for t in guide)
    o, d, path_id = _spawn_all(cam, cfg, int(seed), device)
    n = o.shape[0]
    T = torch.ones((n, 3), dtype=torch.float32, device=device)
    L = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    no_emit = torch.zeros(n, dtype=torch.bool, device=device)
    nee = estimator == "nee"
    light_id = scene.light.light_obj_id
    e_light = object_arrays(scene)[1][light_id]
    for b in range(n_bounces):
        depth = torch.full((n,), b + 1, dtype=torch.int64, device=device)
        hit = trace(scene, o, d)
        sh = shade_info(scene, o, d, hit)
        emit = alive[:, None].to(torch.float32) * T * sh.emission
        if nee:
            is_light_hit = hit.hit & (hit.obj_id == light_id)
            emit = emit * (~(no_emit & is_light_hit))[:, None]
        L = L + emit

        ctr = depth * rng.DRAWS_PER_BOUNCE
        u = {p: rng.uniform_mix(seed, path_id, ctr + p)
             for p in (rng.P_RR, rng.P_SCATTER_U, rng.P_SCATTER_V,
                       rng.P_MIX_COIN, rng.P_REFR_COIN, rng.P_LIGHT_U,
                       rng.P_LIGHT_V)}
        alive_post, inv_p = _rr(cfg, depth, u[rng.P_RR], sh.albedo, alive)
        if nee:
            _, success, w_d = _probe_light(scene, sh.x, sh.n, u)
            diff_live = alive & (sh.refl == DIFF)
            gate = (diff_live & success).to(torch.float32)
            L = L + (gate * w_d)[:, None] * T * sh.albedo * e_light
            no_emit = alive_post & (sh.refl == DIFF)
        g_dir, g_w, g_ok = _guided_diffuse(
            sh, mu_tab, use_tab, u[rng.P_SCATTER_U], u[rng.P_SCATTER_V],
            u[rng.P_MIX_COIN], beta, k)
        new_d, w = _material_mix(sh, d, u[rng.P_REFR_COIN], g_dir, g_w)
        ok = torch.where(sh.refl == DIFF, g_ok, True)
        T = T * sh.albedo * (inv_p * w)[:, None]
        alive = alive_post & ok
        o = torch.where(alive[:, None], sh.x, o)
        d = torch.where(alive[:, None], new_d, d)
        if nee:
            no_emit = no_emit & alive
    return L.reshape(cfg.height * cfg.width, cfg.spp, 3).mean(dim=1).reshape(
        cfg.height, cfg.width, 3)


def render_guided_online(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                         seed, beta: float = 0.6, k: float = 8.0,
                         rounds: int = 4, train_spp: int = 16,
                         train_bounces: int = 8, train_scale: int = 8):
    """Online guiding (the JAX package's ``render_guided_online_pallas``):
    cfg.spp in ``rounds`` sample spans of the guided kernel
    (``render_megakernel_guided``: the kernel on the card, its plain version
    on the CPU). Span 0 renders with an empty table, which is the unguided
    image; between spans a 1/``train_scale``-resolution training pass (seed
    cfg.seed + 101 + r) adds to the moments and the table is rebuilt. Every
    span is unbiased for its table, and span r's table depends only on
    draws independent of span r's samples.

    Returns ((h, w, 3) radiance sum over spp, traces (2,) int64)."""
    from ..ops.megakernel import render_megakernel_guided

    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    spans = [cfg.spp // rounds] * rounds
    spans[-1] += cfg.spp - sum(spans)
    tcfg = dataclasses.replace(
        cfg, width=max(cfg.width // train_scale, 16),
        height=max(cfg.height // train_scale, 16), spp=train_spp)
    moments = torch.zeros((N_VOXELS, 3), dtype=torch.float32,
                          device=scene.device)
    guide = guide_lobes(moments)
    img, traces, s0 = None, None, 0
    for r, n_s in enumerate(spans):
        if n_s == 0:
            continue
        L, tr = render_megakernel_guided(scene, cam, cfg, seed, guide, beta,
                                         k, s0=s0, n_s=n_s)
        img = L if img is None else img + L
        traces = tr if traces is None else traces + tr
        s0 += n_s
        if r < rounds - 1:
            t_seed = cfg.seed + 101 + r
            moments = moments + train_guide(
                scene, cam, dataclasses.replace(tcfg, seed=t_seed),
                train_bounces, t_seed)
            guide = guide_lobes(moments)
    return img, traces
