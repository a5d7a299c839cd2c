"""Regenerating wavefront path integrator, ``nee`` estimator, in eager torch.

The port of the JAX package's ``integrator/wavefront.py`` for this slice,
and the plain version of the CUDA kernel (``ops/megakernel.py``).

- Russian roulette starts after depth ``rr_start_depth`` (or at once when
  the hit's max albedo p is 0); survivors scale throughput by 1/p.
- NEE as continuation: at each diffuse bounce a light sample becomes the
  bounce direction when its nearest hit is the light object, with weight
  |A cos_l| / t^2 * |cos| / pi; otherwise a cosine sample with weight 1.
- SPEC mirrors reflect about the geometric normal with weight 1; REFR glass
  (air 1, glass 1.5) reflects or refracts by a coin with P = .25 + .5 Re
  (Schlick), total internal reflection taking the mirror ray. Neither
  fires an NEE probe.
- Contribution = sum over bounces of throughput * emission.
- Escaped rays shade the stale object 0 at x = (0, 0, 0) and keep going.
- Lane regeneration: lane i is bound to one pixel and walks its samples
  [s_start, s_stop), respawning a primary ray when its path dies.
- Every draw is a pure function of (seed, path_id, depth*8 + purpose), so
  the image does not depend on the lane layout.
- Trace counters [extend, probe] are int64: extend counts one nearest-hit
  query per live lane per bounce, probe one NEE probe per lane that
  survived RR on a diffuse surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import film, rng, vecmath as vm
from ..geometry.intersect import shade_info, trace
from ..scene.types import DIFF, GLOS, REFR, SPEC, Scene, object_arrays
from . import sampling


def _nee_sample(light, probe_o, nl, u):
    """NEE direction toward a uniform point of the light parallelogram, and
    the weight as a function of the traced distance t."""
    lp = sampling.sample_light_point(light, u[rng.P_LIGHT_U], u[rng.P_LIGHT_V])
    d_l = vm.norm(lp - probe_o)

    def w_fn(t_safe):
        return sampling.nee_weight(light, d_l, nl, t_safe)

    return d_l, w_fn


def _diff_scatter(scene: Scene, sh, hit_x, u):
    """Diffuse bounce of the ``nee`` estimator: (direction (N, 3), weight
    (N,), probes (N,) int64)."""
    nl = sh.n
    cos_dir = sampling.sample_cosine(
        nl, u[rng.P_SCATTER_U], u[rng.P_SCATTER_V]
    )
    light = scene.light
    d_l, w_fn = _nee_sample(light, hit_x, nl, u)
    probe = trace(scene, hit_x, d_l)
    success = probe.hit & (probe.obj_id == light.light_obj_id)
    # A miss has t = 1e20, whose square overflows float32.
    t_safe = torch.where(success, probe.t, 1.0)
    new_dir = torch.where(success[:, None], d_l, cos_dir)
    w = torch.where(success, w_fn(t_safe), 1.0)
    return new_dir, w, torch.ones_like(probe.obj_id)


def _spec_scatter(sh, d_in):
    """Ideal mirror: (direction, weight 1)."""
    return vm.reflect(d_in, sh.n_geom), torch.ones_like(d_in[:, 0])


# Dielectric constants of _refr_scatter: air, glass, and Schlick's
# R0 = ((1.5 - 1) / (1.5 + 1))^2.
NC, NT = 1.0, 1.5
R0 = 0.04


def _refr_scatter(sh, d_in, u_coin):
    """Ideal dielectric, Russian roulette between the mirror and the
    refracted ray at every depth: (direction, weight). The expressions and
    their order are the CUDA kernel's: Schlick's c^5 is the product
    c*c*c*c*c, and each weight divides by a tensor, so the two round alike
    on the card."""
    n, nl = sh.n_geom, sh.n
    refl_dir = vm.reflect(d_in, n)
    into = vm.dot(n, nl) > 0.0
    nnt = torch.where(into, NC / NT, NT / NC)
    ddn = vm.dot(d_in, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    pos = cos2t > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, cos2t, 1.0)), 0.0)
    sign = torch.where(into, 1.0, -1.0)
    tdir = vm.norm(d_in * nnt[:, None]
                   - n * (sign * (ddn * nnt + sq))[:, None])
    c = 1.0 - torch.where(into, -ddn, vm.dot(tdir, n))
    re = R0 + (1.0 - R0) * c * c * c * c * c
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    pick_refl = (u_coin < p) | tir
    w = torch.where(tir, 1.0, torch.where(pick_refl, re / p, tr / (1.0 - p)))
    return torch.where(pick_refl[:, None], refl_dir, tdir), w


class BounceOut(NamedTuple):
    emit: torch.Tensor        # (N, 3) throughput * emission, 0 on dead lanes
    x: torch.Tensor           # (N, 3) next origin
    new_dir: torch.Tensor     # (N, 3)
    T: torch.Tensor           # (N, 3) next throughput
    alive: torch.Tensor       # (N,) alive and survived RR
    traces_inc: torch.Tensor  # (2,) int64 [extend, probe]


def _bounce_core(scene: Scene, cfg: RenderConfig, seed, o, d, T, alive,
                 depth, path_id, spec_refr: bool = False) -> BounceOut:
    """One radiance()-body step over the wavefront. ``depth`` is this
    frame's post-increment depth (>= 1). ``spec_refr``: the scene holds
    SPEC or REFR objects (without them the material select is skipped)."""
    hit = trace(scene, o, d)
    sh = shade_info(scene, o, d, hit)
    alive_f = alive.to(T.dtype)[:, None]
    emit = alive_f * T * sh.emission

    ctr = depth.to(torch.int64) * rng.DRAWS_PER_BOUNCE
    u = {
        p: rng.uniform_mix(seed, path_id, ctr + p)
        for p in (rng.P_RR, rng.P_LIGHT_U, rng.P_LIGHT_V,
                  rng.P_SCATTER_U, rng.P_SCATTER_V)
        + ((rng.P_REFR_COIN,) if spec_refr else ())
    }

    # Russian roulette.
    p_max = torch.amax(sh.albedo, dim=-1)
    rr_active = (depth > cfg.rr_start_depth) | (p_max <= 0.0)
    survive = torch.where(rr_active, u[rng.P_RR] < p_max, True)
    p_pos = p_max > 0.0
    inv_p = torch.where(
        rr_active & p_pos, 1.0 / torch.where(p_pos, p_max, 1.0), 1.0
    )
    f = sh.albedo * inv_p[:, None]
    alive_out = alive & survive

    new_dir, w, probes = _diff_scatter(scene, sh, sh.x, u)
    if spec_refr:
        spec_dir, spec_w = _spec_scatter(sh, d)
        refr_dir, refr_w = _refr_scatter(sh, d, u[rng.P_REFR_COIN])
        is_spec, is_refr = sh.refl == SPEC, sh.refl == REFR
        new_dir = torch.where(is_spec[:, None], spec_dir, torch.where(
            is_refr[:, None], refr_dir, new_dir))
        w = torch.where(is_spec, spec_w, torch.where(is_refr, refr_w, w))
    T_out = T * f * w[:, None]
    probe_alive = alive_out & (sh.refl == DIFF)
    traces_inc = torch.stack([
        alive.sum(dtype=torch.int64),
        (probes * probe_alive).sum(dtype=torch.int64),
    ])
    return BounceOut(emit=emit, x=sh.x, new_dir=new_dir, T=T_out,
                     alive=alive_out, traces_inc=traces_inc)


def _spawn(cam: CameraParams, cfg: RenderConfig, seed, px, py, pid_base,
           s_idx):
    """Primary ray and path id for sample ``s_idx`` of the lane's pixel."""
    path_id = (pid_base + s_idx) & rng.MASK32
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed)
    return o, d, path_id


def check_materials(scene: Scene) -> bool:
    """Raises for GLOS objects (not ported yet); returns whether the scene
    holds SPEC or REFR objects."""
    refl = object_arrays(scene)[2]
    if bool((refl == GLOS).any()):
        raise NotImplementedError(
            "GLOS materials are not ported yet (ROADMAP.md queue 1, item 11)"
        )
    return bool(((refl == SPEC) | (refl == REFR)).any())


def path_trace_regen(scene: Scene, cfg: RenderConfig, seed,
                     cam: CameraParams, pix, s_start, s_stop):
    """Regenerating wavefront over lanes: lane i renders pixel ``pix[i]``,
    samples [s_start[i], s_stop[i]). pix, s_start, s_stop: (N,) int64.

    Returns (per-lane radiance sum (N, 3), traces (2,) int64)."""
    spec_refr = check_materials(scene)
    n = pix.shape[0]
    dev = pix.device
    px = pix % cfg.width
    py = torch.div(pix, cfg.width, rounding_mode="floor")
    pid_base = (pix * cfg.spp) & rng.MASK32

    o, d, pid = _spawn(cam, cfg, seed, px, py, pid_base, s_start)
    T = torch.ones((n, 3), dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = s_start < s_stop
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    s = s_start.clone()
    n_traces = torch.zeros(2, dtype=torch.int64, device=dev)

    while bool(alive.any()):
        depth1 = depth + 1
        out = _bounce_core(scene, cfg, seed, o, d, T, alive, depth1, pid,
                           spec_refr)
        # Per-path max_bounces truncation.
        alive_after = out.alive & (depth1 < cfg.max_bounces)
        died = alive & ~alive_after
        s_next = s + died.to(torch.int64)
        respawn = died & (s_next < s_stop)
        o_sp, d_sp, pid_sp = _spawn(cam, cfg, seed, px, py, pid_base, s_next)
        rs = respawn[:, None]
        live = alive_after[:, None]
        o = torch.where(rs, o_sp, torch.where(live, out.x, o))
        d = torch.where(rs, d_sp, torch.where(live, out.new_dir, d))
        T = torch.where(rs, 1.0, torch.where(live, out.T, T))
        L = L + out.emit
        depth = torch.where(respawn, 0, torch.where(alive, depth1, depth))
        s = torch.where(died, s_next, s)
        pid = torch.where(respawn, pid_sp, pid)
        alive = alive_after | respawn
        n_traces = n_traces + out.traces_inc
    return L, n_traces


def lane_groups(n_pix: int, n_s: int, target_lanes: int,
                override: int = 0) -> int:
    """Lanes per pixel: the largest g <= target_lanes / n_pix that divides
    n_s, so every lane gets an equal sample range. ``override`` forces g."""
    g = override or max(1, target_lanes // max(1, n_pix))
    g = min(g, n_s)
    while n_s % g:
        g -= 1
    return g


def regen_groups(cfg: RenderConfig) -> int:
    """Lanes per pixel for the eager regenerating wavefront (target 2^21)."""
    return lane_groups(
        cfg.width * cfg.height, cfg.spp, 1 << 21, cfg.regen_groups
    )


def lane_layout(n_pix: int, g: int, per: int, s0: int, device):
    """(pix, s_start, s_stop) of n_pix * g lanes: lane i renders pixel
    i // g, samples s0 + (i % g) * per + [0, per)."""
    lane = torch.arange(n_pix * g, dtype=torch.int64, device=device)
    pix = torch.div(lane, g, rounding_mode="floor")
    s_start = s0 + (lane % g) * per
    return pix, s_start, s_start + per


def render_regen(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed):
    """Single-pass regenerating render. Returns ((h, w, 3) radiance sum over
    spp, traces (2,) int64 [extend, probe])."""
    n_pix = cfg.width * cfg.height
    g = regen_groups(cfg)
    pix, s_start, s_stop = lane_layout(n_pix, g, cfg.spp // g, 0,
                                       scene.device)
    L, n_traces = path_trace_regen(scene, cfg, seed, cam, pix, s_start,
                                   s_stop)
    img = L.reshape(n_pix, g, 3).sum(dim=1)
    return img.reshape(cfg.height, cfg.width, 3), n_traces


def render_counts(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """Full render on the scene's device: the CUDA kernel on a CUDA device,
    the eager wavefront on the CPU. Returns (linear image (h, w, 3) in
    [0, 1], (extend, probe) trace counts as ints)."""
    if scene.device.type == "cuda":
        from ..ops.megakernel import render_megakernel

        img, n_tr = render_megakernel(scene, cam, cfg, cfg.seed)
    elif scene.device.type == "cpu":
        img, n_tr = render_regen(scene, cam, cfg, cfg.seed)
    else:
        raise ValueError(f"unsupported device {scene.device}")
    extend, probe = n_tr.tolist()
    return film.finalize(img / cfg.spp), (extend, probe)


def render(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """Full render. Returns (linear image (h, w, 3) in [0, 1], total trace
    count: the bench metric's rays)."""
    img, (extend, probe) = render_counts(scene, cam, cfg)
    return img, extend + probe
