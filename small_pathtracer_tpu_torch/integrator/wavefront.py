"""Regenerating wavefront path integrator in eager torch: all seven
estimators, unguided or (``cosine``, ``nee_textbook``, ``mis``) with the
guided mixture of path guiding.

The port of the JAX package's ``integrator/wavefront.py`` for the single
rect light, and the plain version of the CUDA kernels
(``ops/megakernel.py``).

- Russian roulette starts after depth ``rr_start_depth`` (or at once when
  the hit's max albedo p is 0); survivors scale throughput by 1/p.
- ``nee``, NEE as continuation: at each diffuse bounce a light sample
  becomes the bounce direction when its nearest hit is the light object,
  with weight |A cos_l| / t^2 * |cos| / pi; otherwise a cosine sample with
  weight 1. ``mixture`` takes that branch where a coin (P_MIX_COIN) falls
  below ``mixture_q``, the cosine sample with weight 1 elsewhere.
  ``light_sample_mode='glibc_overflow'`` draws both estimators' light
  point from glibc's wrapped offsets (``sampling.
  sample_light_point_glibc``); every other estimator ignores the mode.
- ``cosine``: the cosine sample with weight 1, no probe. ``uniform``: the
  uniform hemisphere sample with weight 1 (the reference's committed,
  biased weights); ``uniform_corrected``: the same sample with weight
  2 max(cos, 0).
- ``nee_textbook``: one shadow probe at each live diffuse vertex (before
  RR) adds T * albedo * e_light * the same weight as a direct term, the
  continuation is the cosine sample, and the next bounce's pickup of the
  light is suppressed (a lane that respawns picks up its primary emission).
- ``mis``: the textbook pair of strategies under Veach's balance
  heuristic: the direct term is weighted by p_light / (p_light + p_bsdf)
  at the light sample (p_light = t^2 / (A max(|cos_l|, 1e-6)), p_bsdf =
  max(cos, 0) / pi), and a BSDF-sampled pickup of the light by
  p_bsdf / (p_bsdf + p_light) with the previous diffuse vertex's p_bsdf
  (``mis_pdf``, carried per lane; 0 after a primary or SPEC/REFR vertex and
  on a respawn, where the pickup is whole).
- Guided (``Guide``, the plain version of rows 4 and 5): ``cosine``,
  ``nee_textbook`` and ``mis`` continue from diffuse vertices through the
  defensive mixture beta * power-cosine(k) around a lobe mu + (1 - beta) *
  cosine, drawn from the cosine sample's uniforms and a coin, weighted by
  pdf_cos / pdf_mix; a lobe sample below the surface ends the path. Under
  ``mis`` both balance weights take the mixture's pdf as p_bsdf.
- SPEC mirrors reflect about the geometric normal with weight 1; REFR glass
  (air 1, glass 1.5) reflects or refracts by a coin with P = .25 + .5 Re
  (Schlick), total internal reflection taking the mirror ray. Neither
  fires an NEE probe or is guided.
- GLOS (the modified-Phong extension, ``cosine``, ``nee_textbook`` and
  ``mis`` only: ``check_glos_estimator``) continues along the Phong lobe
  of exponent n around the mirror of d about the oriented normal, drawn
  from the cosine sample's uniforms, with weight (n+2)/(n+1) max(cos, 0);
  a sample below the surface ends the path. It is a light-sampling vertex
  like a diffuse one: its direct term swaps the diffuse |cos|/pi for the
  lobe's BRDF (n+2)/(2 pi) max(d_l . mirror, 0)^n times max(cos, 0), and
  under ``mis`` both balance weights take the lobe's pdf (n+1)/(2 pi)
  max(d . mirror, 0)^n as p_bsdf. Not guided (``check_guided`` refuses).
- Contribution = sum over bounces of throughput * emission.
- Escaped rays shade the stale object 0 at x = (0, 0, 0) and keep going.
- Lane regeneration: lane i is bound to one pixel and walks its samples
  [s_start, s_stop), respawning a primary ray when its path dies.
- Every draw is a pure function of (seed, path_id, depth*8 + purpose), so
  the image does not depend on the lane layout.
- Trace counters [extend, probe] are int64: extend counts one nearest-hit
  query per live lane per bounce; probe counts one NEE probe per lane that
  survived RR on a diffuse surface (``nee``; ``mixture`` where its coin
  took NEE), per live lane on a diffuse surface (``nee_textbook``,
  ``mis``), none (``cosine``, ``uniform``, ``uniform_corrected``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import film, rng, vecmath as vm
from ..geometry.intersect import shade_info, trace
from ..scene.types import (
    DIFF, GLOS, REFR, SPEC, Scene, has_glos, object_arrays,
)
from . import sampling


def _nee_sample(light, probe_o, nl, u, glibc: bool = False):
    """NEE direction toward a uniform point of the light parallelogram (or
    glibc's wrapped point), and the weight as a function of the traced
    distance t."""
    sample = (sampling.sample_light_point_glibc if glibc
              else sampling.sample_light_point)
    lp = sample(light, u[rng.P_LIGHT_U], u[rng.P_LIGHT_V])
    d_l = vm.norm(lp - probe_o)

    def w_fn(t_safe):
        return sampling.nee_weight(light, d_l, nl, t_safe)

    return d_l, w_fn


def _light_probe(scene: Scene, x, nl, u, glibc: bool = False):
    """The shadow probe of the NEE estimators: (direction to the light
    sample (N, 3), whether its nearest hit is the light (N,), its distance
    there, else 1 (N,), the NEE weight (N,), finite on every lane)."""
    light = scene.light
    d_l, w_fn = _nee_sample(light, x, nl, u, glibc)
    probe = trace(scene, x, d_l)
    success = probe.hit & (probe.obj_id == light.light_obj_id)
    # A miss has t = 1e20, whose square overflows float32.
    t_safe = torch.where(success, probe.t, 1.0)
    return d_l, success, t_safe, w_fn(t_safe)


def _probe_light(scene: Scene, x, nl, u, glibc: bool = False):
    """``_light_probe`` without the distance: the probe of ``nee``,
    ``mixture`` and ``nee_textbook``."""
    d_l, success, _, w = _light_probe(scene, x, nl, u, glibc)
    return d_l, success, w


def _p_light(light, d, t):
    """mis: the light sampler's solid-angle density toward unit d (N, 3) at
    distance t (N,), t^2 / (A max(|d . n_light|, 1e-6)), in the kernels'
    order."""
    area, n_light = sampling.light_area_normal(light)
    cos_l = torch.abs(vm.dot(d, n_light))
    return (t * t) / (area * torch.clamp(cos_l, min=1e-6))


class Guide(NamedTuple):
    """The guided mixture of rows 4 and 5 for the plain version.

    ``lobes(x, depth)`` returns the decoded lobe (N, 3) and its use flag
    (N,) of each lane at its hit points x (N, 3): a voxel-table lookup
    (row 4) or the lane's own lobe at depth 1 (row 5). ``beta`` is the lobe
    probability of a guided diffuse vertex, ``k`` the lobe's power."""

    lobes: Callable[[torch.Tensor, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]
    beta: float
    k: float


class Mixture(NamedTuple):
    """The guided mixture at each lane's vertex (``guided_mixture``)."""

    d: torch.Tensor        # (N, 3) the sampled direction
    w: torch.Tensor        # (N,) pdf_cos / pdf_mix, 0 where not ok
    ok: torch.Tensor       # (N,) the sample carries
    pdf_mix: torch.Tensor  # (N,) the mixture's pdf at d
    beta_eff: torch.Tensor  # (N,) beta where guided, else 0
    norm_k: torch.Tensor   # (k + 1) / (2 pi), float32

    def pdf_at(self, d, mu, k: float, pdf_cos):
        """The mixture's pdf at unit directions d (N, 3) whose cosine pdf is
        pdf_cos (N,): beta_eff * lobe pdf + (1 - beta_eff) * pdf_cos, in
        the kernels' order (mis's balance weight at the light sample)."""
        pdf_lobe = self.norm_k * vm.pow_const(
            torch.clamp(vm.dot(d, mu), min=0.0), k)
        return self.beta_eff * pdf_lobe + (1.0 - self.beta_eff) * pdf_cos


def guided_mixture(nl, mu, use, u1, u2, u_coin, beta: float,
                   k: float) -> Mixture:
    """The defensive mixture at each lane's vertex: its direction (N, 3),
    weight pdf_cos / pdf_mix (N,), ok (N,) (false where the sample is below
    the surface or its pdf is ~0; those lanes get weight 0 and end) and
    pdf_mix (N,), the continuation's pdf that ``mis`` carries.

    The lobe sample uses the cosine sample's uniforms u1, u2; the mixture
    picks it where u_coin < beta_eff (beta where ``use``, else 0, which
    makes the weight exactly 1). The kernels compute the same expressions
    in the same order: 1 / (k + 1), (k + 1) / (2 pi) and beta are float32
    device tensors, and the real power u2^(1/(k+1)) is ``vm.pow_pos``."""
    dev = nl.device
    f32 = torch.float32
    beta_t = torch.tensor(beta, dtype=f32, device=dev)
    inv_k1 = torch.tensor(1.0 / (float(k) + 1.0), dtype=f32, device=dev)
    norm_k = torch.tensor((float(k) + 1.0) / (2.0 * math.pi), dtype=f32,
                          device=dev)
    beta_eff = torch.where(use, beta_t, 0.0)
    cos_dir = sampling.sample_cosine(nl, u1, u2)
    d_lobe = sampling.sample_power_cosine(mu, u1, u2, inv_k1)
    take = u_coin < beta_eff
    new_d = torch.where(take[..., None], d_lobe, cos_dir)
    cos_n = vm.dot(new_d, nl)
    cos_mu = vm.dot(new_d, mu)
    pdf_lobe = norm_k * vm.pow_const(torch.clamp(cos_mu, min=0.0), k)
    pdf_cos = torch.clamp(cos_n, min=0.0) * (1.0 / math.pi)
    pdf_mix = beta_eff * pdf_lobe + (1.0 - beta_eff) * pdf_cos
    ok = (pdf_mix > 1e-9) & (cos_n > 0.0)
    w = torch.where(ok, pdf_cos / torch.where(ok, pdf_mix, 1.0), 0.0)
    return Mixture(new_d, w, ok, pdf_mix, beta_eff, norm_k)


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


class Glossy(NamedTuple):
    """The GLOS lobe at each lane's vertex (``_glos_scatter``)."""

    is_glos: torch.Tensor  # (N,) the hit is GLOS
    mirror: torch.Tensor   # (N, 3) the lobe's axis
    d: torch.Tensor        # (N, 3) the lobe sample
    w: torch.Tensor        # (N,) its path weight, 0 below the surface

    def nee_weight(self, light, sh, d_l, t_safe, w_d):
        """The direct term's weight on GLOS lanes, |A cos_l| / t^2 times
        the lobe's BRDF over albedo times max(d_l . n, 0), w_d elsewhere."""
        w_g = (sampling.light_pdf_inv(light, d_l, t_safe)
               * sampling.phong_brdf_over_albedo(d_l, self.mirror, sh.gloss)
               ) * torch.clamp(vm.dot(d_l, sh.n), min=0.0)
        return torch.where(self.is_glos, w_g, w_d)

    def pdf(self, d, sh, pdf):
        """p_bsdf toward unit d (N, 3): the lobe's pdf on GLOS lanes, pdf
        elsewhere."""
        return torch.where(self.is_glos,
                           sampling.phong_pdf(d, self.mirror, sh.gloss), pdf)


def _glos_scatter(sh, d_in, u1, u2) -> Glossy:
    """The modified-Phong lobe around the mirror of d_in about the oriented
    normal, from the cosine sample's uniforms."""
    mirror = vm.reflect(d_in, sh.n)
    d = sampling.sample_phong(mirror, u1, u2, sh.gloss)
    return Glossy(sh.refl == GLOS, mirror, d,
                  sampling.phong_weight(d, sh.n, sh.gloss))


class BounceOut(NamedTuple):
    emit: torch.Tensor        # (N, 3) pickup (+ direct term), 0 on dead lanes
    x: torch.Tensor           # (N, 3) next origin
    new_dir: torch.Tensor     # (N, 3)
    T: torch.Tensor           # (N, 3) next throughput
    alive: torch.Tensor       # (N,) alive, survived RR (and the mixture)
    traces_inc: torch.Tensor  # (2,) int64 [extend, probe]
    no_emit_next: torch.Tensor  # (N,) nee_textbook: suppress the next pickup
    mis_pdf_next: torch.Tensor  # (N,) mis: the continuation's p_bsdf, else 0


def _bounce_core(scene: Scene, cfg: RenderConfig, seed, o, d, T, alive,
                 depth, path_id, spec_refr: bool = False, no_emit=None,
                 guide: Guide | None = None, mis_pdf=None,
                 glos: bool = False) -> BounceOut:
    """One radiance()-body step over the wavefront. ``depth`` is this
    frame's post-increment depth (>= 1). ``spec_refr``: the scene holds
    SPEC or REFR objects (without them the material select is skipped);
    ``glos``: the scene holds GLOS objects.
    ``no_emit`` (N,) bool: nee_textbook lanes whose previous probe already
    counted the light. ``guide``: continue diffuse vertices through the
    guided mixture (``cosine``, ``nee_textbook`` and ``mis`` only).
    ``mis_pdf`` (N,): mis's p_bsdf of this ray from its previous vertex."""
    est = cfg.estimator
    light = scene.light
    hit = trace(scene, o, d)
    sh = shade_info(scene, o, d, hit)
    alive_f = alive.to(T.dtype)[:, None]
    emit = alive_f * T * sh.emission
    light_id = light.light_obj_id
    if est == "nee_textbook" and no_emit is not None:
        is_light_hit = hit.hit & (hit.obj_id == light_id)
        emit = emit * (~(no_emit & is_light_hit)).to(T.dtype)[:, None]
    if est == "mis" and mis_pdf is not None:
        # The balance weight of a BSDF-sampled pickup of the light.
        is_light_hit = hit.hit & (hit.obj_id == light_id)
        w_bsdf = mis_pdf / (mis_pdf + _p_light(light, d, hit.t))
        emit = emit * torch.where(is_light_hit & (mis_pdf > 0.0), w_bsdf,
                                  1.0)[:, None]

    nee_cont = est in ("nee", "mixture")  # NEE as continuation
    probe_est = nee_cont or est in ("nee_textbook", "mis")
    ctr = depth.to(torch.int64) * rng.DRAWS_PER_BOUNCE
    purposes = [rng.P_RR, rng.P_SCATTER_U, rng.P_SCATTER_V]
    if probe_est:
        purposes += [rng.P_LIGHT_U, rng.P_LIGHT_V]
    if guide is not None or est == "mixture":
        purposes.append(rng.P_MIX_COIN)
    if spec_refr:
        purposes.append(rng.P_REFR_COIN)
    u = {p: rng.uniform_mix(seed, path_id, ctr + p) for p in purposes}

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
    is_diff = sh.refl == DIFF

    u1, u2 = u[rng.P_SCATTER_U], u[rng.P_SCATTER_V]
    # The vertices that sample the light: diffuse, and GLOS ones.
    gl = _glos_scatter(sh, d, u1, u2) if glos else None
    nee_v = (is_diff | gl.is_glos) if glos else is_diff
    mix = None
    if guide is not None:
        mu, use = guide.lobes(sh.x, depth)
        mix = guided_mixture(sh.n, mu, use & is_diff, u1, u2,
                             u[rng.P_MIX_COIN], guide.beta, guide.k)
        new_dir, w = mix.d, mix.w
        alive_out = alive_out & (mix.ok | ~is_diff)
    elif est in ("uniform", "uniform_corrected"):
        new_dir = sampling.sample_uniform(sh.n, u1, u2)
        w = (torch.ones_like(u1) if est == "uniform"
             else 2.0 * torch.clamp(vm.dot(new_dir, sh.n), min=0.0))
    else:
        new_dir = sampling.sample_cosine(sh.n, u1, u2)
        w = torch.ones_like(u1)
    probe_lanes = torch.zeros_like(alive)
    mis_pdf_next = torch.zeros_like(u1)
    if nee_cont:
        if cfg.light_sample_mode == "glibc_overflow":
            d_l, success, w_d = _probe_light(scene, sh.x, sh.n, u, glibc=True)
        else:
            d_l, success, w_d = _probe_light(scene, sh.x, sh.n, u)
        take = (u[rng.P_MIX_COIN] < torch.tensor(cfg.mixture_q,
                                                 dtype=u1.dtype,
                                                 device=u1.device)
                if est == "mixture" else torch.ones_like(alive))
        sel = success & take
        new_dir = torch.where(sel[:, None], d_l, new_dir)
        w = torch.where(sel, w_d, w)
        probe_lanes = alive_out & is_diff & take
    elif est in ("nee_textbook", "mis"):
        d_l, success, t_safe, w_d = _light_probe(scene, sh.x, sh.n, u)
        if glos:
            w_d = gl.nee_weight(light, sh, d_l, t_safe, w_d)
    if est == "mis":
        p_light = _p_light(light, d_l, t_safe)
        p_bsdf = torch.clamp(vm.dot(d_l, sh.n), min=0.0) * (1.0 / math.pi)
        if mix is not None:
            p_bsdf = mix.pdf_at(d_l, mu, guide.k, p_bsdf)
        if glos:
            p_bsdf = gl.pdf(d_l, sh, p_bsdf)
        w_d = w_d * (p_light / (p_light + p_bsdf))
    if est in ("nee_textbook", "mis"):
        e_light = object_arrays(scene)[1][light_id]
        gate = (alive & nee_v & success).to(T.dtype)
        emit = emit + (gate * w_d)[:, None] * T * sh.albedo * e_light
        probe_lanes = alive & nee_v
    if spec_refr:
        spec_dir, spec_w = _spec_scatter(sh, d)
        refr_dir, refr_w = _refr_scatter(sh, d, u[rng.P_REFR_COIN])
        is_spec, is_refr = sh.refl == SPEC, sh.refl == REFR
        new_dir = torch.where(is_spec[:, None], spec_dir, torch.where(
            is_refr[:, None], refr_dir, new_dir))
        w = torch.where(is_spec, spec_w, torch.where(is_refr, refr_w, w))
    if glos:
        new_dir = torch.where(gl.is_glos[:, None], gl.d, new_dir)
        w = torch.where(gl.is_glos, gl.w, w)
        # A lobe sample below the surface is absorbed.
        alive_out = alive_out & ~(gl.is_glos & (gl.w <= 0.0))
    if est == "mis":
        # The continuation's p_bsdf, which the next pickup weighs against.
        pdf_cont = mix.pdf_mix if mix is not None else (
            torch.clamp(vm.dot(new_dir, sh.n), min=0.0) * (1.0 / math.pi))
        if glos:
            pdf_cont = gl.pdf(new_dir, sh, pdf_cont)
        mis_pdf_next = torch.where(alive_out & nee_v, pdf_cont, 0.0)
    T_out = T * f * w[:, None]
    traces_inc = torch.stack([
        alive.sum(dtype=torch.int64),
        probe_lanes.sum(dtype=torch.int64),
    ])
    return BounceOut(emit=emit, x=sh.x, new_dir=new_dir, T=T_out,
                     alive=alive_out, traces_inc=traces_inc,
                     no_emit_next=alive_out & nee_v,
                     mis_pdf_next=mis_pdf_next)


def _spawn(cam: CameraParams, cfg: RenderConfig, seed, px, py, pid_base,
           s_idx):
    """Primary ray and path id for sample ``s_idx`` of the lane's pixel."""
    path_id = (pid_base + s_idx) & rng.MASK32
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed)
    return o, d, path_id


def has_spec_refr(scene: Scene) -> bool:
    """Whether the scene holds SPEC or REFR objects."""
    refl = object_arrays(scene)[2]
    return bool(((refl == SPEC) | (refl == REFR)).any())


# The estimators with glossy semantics (the JAX package's).
GLOS_ESTIMATORS = ("cosine", "nee_textbook", "mis")


def check_glos_estimator(scene: Scene, cfg: RenderConfig) -> None:
    """The JAX package's refusal of a GLOS scene under an estimator
    without glossy semantics (ValueError): the NEE-continuation pair
    (``nee``, ``mixture``) hard-codes the diffuse cos/pi BRDF in its
    weight, and the ``uniform`` pair the reference's weights."""
    if cfg.estimator not in GLOS_ESTIMATORS and has_glos(scene):
        raise ValueError(
            f"estimator {cfg.estimator!r} is a reference-parity estimator "
            f"with no glossy (GLOS) semantics; use one of "
            f"{GLOS_ESTIMATORS} for scenes with glossy primitives"
        )


def path_trace_regen(scene: Scene, cfg: RenderConfig, seed,
                     cam: CameraParams, pix, s_start, s_stop,
                     guide: Guide | None = None):
    """Regenerating wavefront over lanes: lane i renders pixel ``pix[i]``,
    samples [s_start[i], s_stop[i]). pix, s_start, s_stop: (N,) int64.
    ``guide``: the guided mixture at diffuse vertices (rows 4 and 5).

    Returns (per-lane radiance sum (N, 3), traces (2,) int64)."""
    check_glos_estimator(scene, cfg)
    spec_refr = has_spec_refr(scene)
    glos = has_glos(scene)
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
    no_emit = torch.zeros(n, dtype=torch.bool, device=dev)
    mis_pdf = torch.zeros(n, dtype=torch.float32, device=dev)

    while bool(alive.any()):
        depth1 = depth + 1
        out = _bounce_core(scene, cfg, seed, o, d, T, alive, depth1, pid,
                           spec_refr, no_emit, guide, mis_pdf, glos)
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
        # A respawned lane picks up its primary hit's emission whole.
        no_emit = out.no_emit_next & ~respawn
        mis_pdf = torch.where(respawn, 0.0, out.mis_pdf_next)
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


def lane_layout(n_pix: int, g: int, per: int, s0: int, device,
                pix0: int = 0):
    """(pix, s_start, s_stop) of n_pix * g lanes: lane i renders pixel
    pix0 + i // g, samples s0 + (i % g) * per + [0, per)."""
    lane = torch.arange(n_pix * g, dtype=torch.int64, device=device)
    pix = pix0 + torch.div(lane, g, rounding_mode="floor")
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
