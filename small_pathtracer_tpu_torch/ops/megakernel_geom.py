"""Sphere-geometry training on the card: the port's counterpart of the JAX
package's ``ops/megakernel_geom.py`` for every estimator (``nee``,
``cosine``, ``nee_textbook``, ``uniform``, ``uniform_corrected``,
``mixture``, ``mis``, and ``light_sample_mode='glibc_overflow'`` for
``nee`` and ``mixture``), sphere-table scenes (rects unrolled, spheres in
the runtime table), DIFF/SPEC/REFR and one rect light.

- ``geom_run`` / ``geom_vjp``: one launch of the estimator's instance of
  ``megakernel_geom`` (``csrc/megakernel_geom.cuh``; ``geom_kernel_name``
  names it). The image-only launch (``g_img=None``) runs the TPU kernel's
  pass A alone, which is row 2's loop body: the image, counts and time of
  ``megakernel_<est>_tab``. The adjoint launch
  traces the same paths with the same bounce code, tapes each bounce's
  state in the lane's local memory and sweeps the bounces back once each,
  adding the pathwise interior cotangents of every sphere's (center,
  radius) and every object's (albedo, emission) under the per-pixel
  cotangent ``g_img`` of the radiance sum.
- ``RenderSpheres``: the two launches as one ``torch.autograd.Function``;
  ``loss_and_geom_grads`` and ``fit_geom``: the JAX package's
  ``loss_and_geom_grads`` and ``fit_pallas_geom`` on one card, the
  trust-region steps on the common-random-number loss.
- ``geom_train_step_sharded`` (row 12): one training evaluation over an
  (sp, dp) mesh, each rank running both launches on its shard's lanes
  (``geom_run_shard``); ``fit_geom(mesh=)`` routes every step through it.
- ``diff_step`` and ``bounce_vjp``: one bounce's continuous map (o, d,
  center, radius, mis's pdf carry) -> (x, d', w, the direct term's
  weight, the pickup's weight, the continuation's pdf) with every discrete
  choice fixed, and its pullback derived by hand in the formulas and
  order of the kernel's ``bounce_vjp``. The TPU kernel gets the pullback
  from ``jax.vjp`` inside the kernel; the card has no such thing, so this
  is the written derivation, held against ``torch.autograd`` by the
  tests.

Gradient layout (the port's tables, not the JAX 16-slot ``gtab``): sphere
rows (S, 4) ``[cx, cy, cz, r]`` as ``ops/megakernel.sphere_tables`` packs
them, and albedo and emission (K, 3) in global object order (rects, then
spheres). ``grads_to_scene`` turns them into a scene-shaped tuple.

On a CUDA device each wrapper launches the kernel or raises; on the CPU it
runs the plain version, ``geom_run_plain``: the eager regenerating forward
on the kernel's lane layout, and torch.autograd through it with the sphere
rows and material tables as leaves (the forward fixes every discrete
choice, so this is the same pathwise interior gradient). Silhouette
(boundary) terms are not computed, as in the JAX kernel.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import vecmath as vm
from ..integrator.sampling import light_area_normal
from ..integrator.wavefront import path_trace_regen
from ..parallel.mesh import Mesh
from ..parallel.sharded import ShardLayout, reduce_lanes, shard_lanes
from ..scene.types import DIFF, SPEC, Scene, has_glos, num_quads, num_spheres
from . import _build
from .megakernel import (
    EST_CODE, KernelGeometry, _image, _resolve, count, est_code,
    full_layout, launch_args, pack_geometry, shard_of, sphere_args,
    sphere_tables,
)
from .megakernel_grad import (
    _est_name, material_grads_to_scene, plain_chunk, unpack_materials,
)

# Threads a block (kBlock in csrc/megakernel_common.cuh): sizes the
# per-block partial sums. The kernel keeps one row of gradient slots a warp
# in shared memory beside the sphere rows, which caps the sphere count.
KERNEL_BLOCK = 128
MAX_GEOM_SPHERES = 1024  # kMaxGeomSpheres in csrc/megakernel_geom.cu
# The adjoint launch's counters: [extend, probe] of pass A, replayed
# bounces, VJP bounces, paths longer than the tape.
N_COUNTS = 5
FIELDS = ("center", "radius", "albedo", "emission")

_ITEM = "is not ported yet (ROADMAP.md queue 1, item {})"


# ---------------------------------------------------------------------------
# Scope and layout.

def check_ported(scene: Scene) -> None:
    """The geometry adjoint's refusal of quads and GLOS objects
    (NotImplementedError: item 11's geometry half), which ``cli fit
    --train center,...`` also makes before it counts the spheres."""
    for what, found in (("quads", num_quads(scene) > 0),
                        ("GLOS materials", has_glos(scene))):
        if found:
            raise NotImplementedError(
                f"the geometry adjoint does not take {what} yet (ROADMAP.md "
                "queue 1, item 11, its geometry half: rows 11 and 12)")


def check_geom(scene: Scene, cfg: RenderConfig) -> None:
    """The refusals of the geometry adjoint, on every device: quads and GLOS
    (``check_ported``: item 11's geometry half), and the JAX kernel's
    own ValueErrors (no spheres, no unrolled object, a light that is not
    an unrolled rect). Every estimator and
    light_sample_mode passes (``mis`` and ``nee_textbook`` ignore
    'glibc_overflow', as the JAX package's config.py says). Light lists
    and sphere lights never reach here: the port's Scene holds neither
    (``convert.scene_from_jax`` refuses them, item 12)."""
    check_ported(scene)
    if num_spheres(scene) == 0:
        raise ValueError("no spheres to differentiate; use the material "
                         "adjoint kernel (ops/megakernel_grad.py)")
    R = scene.rects.k.shape[0]
    if R == 0:
        raise ValueError("sphere-table mode needs at least one unrolled "
                         "rect/quad (C15 miss default)")
    if int(scene.light.light_obj_id) >= R:
        raise ValueError("the light must be an unrolled rect/quad")


def pack_tables(scene: Scene):
    """(sph (S, 4) [cx, cy, cz, r], albedo (K, 3), emission (K, 3)) float32
    copies of the scene's trainable leaves on its device."""
    sph, alb, emi, _ = sphere_tables(scene, scene.device)
    return sph.clone(), alb.clone(), emi.clone()


def scene_with_tables(scene: Scene, sph, alb, emi) -> Scene:
    """Inverse of pack_tables: the tables put back into the scene (the
    tensors themselves, so gradients flow to them; the materials through
    ``unpack_materials``)."""
    S = num_spheres(scene)
    if tuple(sph.shape) != (S, 4):
        raise ValueError(f"expected a {(S, 4)} table, got {tuple(sph.shape)}")
    sc = unpack_materials(scene, alb, emi)
    return sc._replace(spheres=sc.spheres._replace(center=sph[:, :3],
                                                   radius=sph[:, 3]))


def grads_to_scene(scene: Scene, g_sph, g_alb, g_emi) -> Scene:
    """The kernel's gradient tables as a scene-shaped tuple of gradients
    (zeros for every other leaf), the counterpart of the JAX package's
    ``grads_to_scene``."""
    zero = material_grads_to_scene(scene, g_alb, g_emi)
    return zero._replace(spheres=zero.spheres._replace(center=g_sph[:, :3],
                                                       radius=g_sph[:, 3]))


# ---------------------------------------------------------------------------
# One bounce as a continuous map, and its pullback.

RECT, SPHERE, MISS = 0, 1, 2
INV_PI = 1.0 / math.pi
NNT_INTO, NNT_OUT, R0 = 1.0 / 1.5, 1.5, 0.04
# The estimators whose NEE probe, where it reaches the light, is the
# continuation, and those that add a direct term at each diffuse vertex.
NEE_CONT = ("nee", "mixture")
DIRECT = ("nee_textbook", "mis")
COS_MIN = 1e-6  # mis: the floor of the light density's |cos| (_p_light)


class Bounce(NamedTuple):
    """The discrete choices and draws of one bounce, per lane (N,): what
    the forward fixed. ``n = sign * ng``; the hemisphere sample (cosine, or
    the uniform estimators' uniform one) is ``norm(fu * alpha + fv * beta
    + n * wz)`` in the frame of n; ``lp`` the light sample (glibc's patch
    point under glibc_overflow); ``coin`` the REFR coin. The frame's axis
    pick, REFR's ``into``, ``tir`` and reflect/refract pick follow from the
    primal. ``take``: mixture's coin took NEE (None: every lane). ``pick``:
    mis, the hit is the light's and the carry is above 0 (the pickup is
    balance-weighted)."""

    kind: torch.Tensor     # RECT, SPHERE or MISS
    axis: torch.Tensor     # the rect winner's axis (rect 0's on a miss)
    k: torch.Tensor        # the rect winner's plane offset
    near: torch.Tensor     # sphere winner: the near root
    refl: torch.Tensor     # DIFF, SPEC or REFR
    sign: torch.Tensor     # +-1.0
    alpha: torch.Tensor
    beta: torch.Tensor
    wz: torch.Tensor
    lp: torch.Tensor       # (N, 3)
    success: torch.Tensor  # the NEE probe reached the light
    coin: torch.Tensor
    take: torch.Tensor | None = None
    pick: torch.Tensor | None = None


class LightConsts(NamedTuple):
    """The NEE weight's light: the sampler's unit normal (3,) and area,
    and the light rect's axis and plane offset (the probe's distance)."""

    ln: torch.Tensor
    area: torch.Tensor
    axis: int
    k: torch.Tensor


def light_consts(scene: Scene) -> LightConsts:
    """The LightConsts of the scene's light sampler and light rect."""
    area, ln = light_area_normal(scene.light)
    i = int(scene.light.light_obj_id)
    return LightConsts(ln, area, int(scene.rects.axis[i]), scene.rects.k[i])


def _onehot(axis, like):
    return (axis[:, None] == torch.arange(3, device=like.device)).to(like.dtype)


def _col(v, axis):
    return torch.gather(v, 1, axis[:, None])[:, 0]


def _safe_norm(v):
    l2 = vm.dot(v, v)
    return v * vm.rsqrt(torch.where(l2 > 0.0, l2, 1.0))[:, None]


def _p_light(light: LightConsts, d, t):
    """mis: the light sampler's density toward unit d at distance t."""
    cm = torch.clamp(torch.abs(vm.dot(d, light.ln)), min=COS_MIN)
    return (t * t) / (light.area * cm)


def diff_step(o, d, c, r, mp, b: Bounce, light: LightConsts,
              est: str = "nee"):
    """One bounce's continuous map for the estimator ``est``: (o, d, winner
    sphere center c (N, 3) and radius r (N,), mis's carry mp (N,), the
    previous diffuse vertex's p_bsdf of d) -> (x (N, 3), d' (N, 3), w (N,)
    the continuation's weight, w_tb (N,) the direct term's weight, w_pick
    (N,) the pickup's weight, pdf_cont (N,) the p_bsdf of d' that the next
    bounce's pickup weighs against), the outputs of the JAX kernel's
    diff_step. Every discrete choice is fixed by ``b``; torch.autograd
    differentiates it. The expressions are the eager forward's
    (integrator/wavefront.py, geometry/intersect.py)."""
    is_sph, is_rect = b.kind == SPHERE, b.kind == RECT
    da = _col(d, b.axis)
    t_rect = (b.k - _col(o, b.axis)) * (1.0 / torch.where(da != 0.0, da, 1.0))
    op = c - o
    bq = vm.dot(op, d)
    m = bq[:, None] * d - op
    m2 = vm.dot(m, m)
    mlen = torch.where(m2 > 0.0, torch.sqrt(torch.where(m2 > 0.0, m2, 1.0)),
                       0.0)
    det = (r - mlen) * (r + mlen)
    sdet = torch.sqrt(torch.where(det > 0.0, det, 1.0))
    t_sph = torch.where(b.near, bq - sdet, bq + sdet)
    t = torch.where(is_sph, t_sph, torch.where(is_rect, t_rect, 0.0))
    x = torch.where((b.kind != MISS)[:, None], o + t[:, None] * d, 0.0)
    ng = torch.where(is_sph[:, None], _safe_norm(x - c), _onehot(b.axis, x))
    n = ng * b.sign[:, None]
    # DIFF: the hemisphere sample in the frame of n (axis pick detached).
    pick = (torch.abs(n.detach()[:, 0]) > 0.1)[:, None]
    e_y = torch.tensor([0.0, 1.0, 0.0], device=x.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], device=x.device)
    fu = _safe_norm(vm.cross(torch.where(pick, e_y, e_x), n))
    fv = vm.cross(n, fu)
    cos_dir = _safe_norm(fu * b.alpha[:, None] + fv * b.beta[:, None]
                         + n * b.wz[:, None])
    # DIFF: NEE toward the light sample, the probe's distance to the light
    # rect's plane.
    dl = _safe_norm(b.lp - x)
    dla = dl[:, light.axis]
    tl = (light.k - x[:, light.axis]) * (
        1.0 / torch.where(dla != 0.0, dla, 1.0))
    tl = torch.where(b.success, tl, 1.0)
    w_nee = (torch.abs(light.area * vm.dot(dl, light.ln)) / (tl * tl)) * (
        torch.abs(vm.dot(dl, n)) * INV_PI)
    is_diff1 = b.refl == DIFF
    w_tb = torch.zeros_like(r)
    if est in NEE_CONT:
        sel = b.success if b.take is None else b.success & b.take
        dir_diff = torch.where(sel[:, None], dl, cos_dir)
        w_diff = torch.where(sel, w_nee, 1.0)
    else:
        dir_diff = cos_dir
        w_diff = (2.0 * torch.clamp(vm.dot(cos_dir, n), min=0.0)
                  if est == "uniform_corrected" else torch.ones_like(r))
    if est in DIRECT:
        if est == "mis":
            p_l = _p_light(light, dl, tl)
            p_b = torch.clamp(vm.dot(dl, n), min=0.0) * INV_PI
            w_nee = w_nee * (p_l / (p_l + p_b))
        w_tb = torch.where(b.success & is_diff1, w_nee, 0.0)
    # SPEC: the mirror about the geometric normal.
    refl_dir = vm.reflect(d, ng)
    # REFR: Schlick's dielectric, decisions detached.
    into = b.sign > 0.0
    nnt = torch.where(into, NNT_INTO, NNT_OUT)
    ddn = vm.dot(d, n)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = (cos2t < 0.0).detach()
    pos = cos2t > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, cos2t, 1.0)), 0.0)
    sgn = torch.where(into, 1.0, -1.0)
    td = _safe_norm(d * nnt[:, None] - ng * (sgn * (ddn * nnt + sq))[:, None])
    cc = 1.0 - torch.where(into, -ddn, vm.dot(td, ng))
    re = R0 + (1.0 - R0) * cc * cc * cc * cc * cc
    pr = 0.25 + 0.5 * re
    pick_refl = ((b.coin < pr) | tir).detach()
    w_refr = torch.where(tir, 1.0, torch.where(pick_refl, re / pr,
                                               (1.0 - re) / (1.0 - pr)))
    dir_refr = torch.where(pick_refl[:, None], refl_dir, td)
    is_diff, is_spec = is_diff1[:, None], (b.refl == SPEC)[:, None]
    d_new = torch.where(is_diff, dir_diff,
                        torch.where(is_spec, refl_dir, dir_refr))
    w = torch.where(b.refl == DIFF, w_diff,
                    torch.where(b.refl == SPEC, 1.0, w_refr))
    w_pick, pdf_cont = torch.ones_like(r), torch.zeros_like(r)
    if est == "mis":
        # The pickup's balance weight at this hit, and the continuation's
        # p_bsdf (the cosine sample's).
        den = torch.where(b.pick, mp + _p_light(light, d, t), 1.0)
        w_pick = torch.where(b.pick, mp / den, 1.0)
        pdf_cont = torch.where(is_diff1, torch.clamp(
            vm.dot(d_new, n), min=0.0) * INV_PI, 0.0)
    return x, d_new, w, w_tb, w_pick, pdf_cont


def _reflect_vjp(d, ng, lam):
    """r = d - ng * (2 (ng . d)): (g_d, g_ng) under the cotangent lam."""
    k2 = 2.0 * vm.dot(ng, d)
    gk = -vm.dot(ng, lam)
    g_d = lam + ng * (2.0 * gk)[:, None]
    g_ng = -lam * k2[:, None] + d * (2.0 * gk)[:, None]
    return g_d, g_ng


def _norm_vjp(u, rs, g_u):
    """u = v * rs, rs = 1 / |v|: the cotangent of v."""
    return (g_u - u * vm.dot(u, g_u)[:, None]) * rs[:, None]


def _nee_vjp(x, n, b: Bounce, light: LightConsts, sig, lam_dl, balance):
    """The NEE weight |A (dl . ln)| / tl^2 * |dl . n| / pi of a probe that
    reached the light (``balance``: times mis's p_l / (p_l + p_b)) and its
    direction dl = norm(lp - x), pulled back under the cotangents (sig,
    lam_dl): (g_x, g_n); csrc/megakernel_geom.cuh ``nee_vjp``."""
    vl = b.lp - x
    vl2 = vm.dot(vl, vl)
    rs_l = vm.rsqrt(torch.where(vl2 > 0.0, vl2, 1.0))
    dl = vl * rs_l[:, None]
    dla = dl[:, light.axis]
    inv_l = 1.0 / torch.where(dla != 0.0, dla, 1.0)
    tl = (light.k - x[:, light.axis]) * inv_l
    cl = vm.dot(dl, light.ln)
    a1 = light.area * cl
    q = torch.abs(a1) / (tl * tl)
    cs = vm.dot(dl, n)
    bb = torch.abs(cs) * INV_PI
    gcs_b = gtl_b = gcl_b = 0.0
    if balance:
        cm = torch.clamp(torch.abs(cl), min=COS_MIN)
        p_l = (tl * tl) / (light.area * cm)
        p_b = torch.clamp(cs, min=0.0) * INV_PI
        den = p_l + p_b
        g_bal = sig * (q * bb)
        sig = sig * (p_l / den)
        g_pl = g_bal * p_b / (den * den)
        g_pb = -g_bal * p_l / (den * den)
        gtl_b = g_pl * 2.0 * tl / (light.area * cm)
        gcl_b = torch.where(torch.abs(cl) >= COS_MIN,
                            -g_pl * p_l / cm * torch.sign(cl), 0.0)
        gcs_b = torch.where(cs >= 0.0, g_pb * INV_PI, 0.0)
    gq = sig * bb
    gb = sig * q
    gcs = gb * INV_PI * torch.sign(cs) + gcs_b
    ga1 = gq / (tl * tl) * torch.sign(a1)
    gtl = -2.0 * gq * q / tl + gtl_b
    gdl = lam_dl + light.ln * (ga1 * light.area + gcl_b)[:, None] + n * gcs[
        :, None]
    g_n = dl * gcs[:, None]
    e_l = torch.zeros_like(x)
    e_l[:, light.axis] = 1.0
    g_x = -e_l * (gtl * inv_l)[:, None]
    gdl = gdl - e_l * (gtl * tl * inv_l)[:, None]
    g_x = g_x - _norm_vjp(dl, rs_l, gdl)
    return g_x, g_n


def bounce_vjp(o, d, c, r, mp, b: Bounce, light: LightConsts, lam_x, lam_d,
               sig_w, sig_tb, sig_pk, lam_mp, est: str = "nee"):
    """The pullback of ``diff_step`` at (o, d, c, r, mp) under the
    cotangents (lam_x, lam_d, sig_w, sig_tb, sig_pk, lam_mp) of its six
    outputs: returns (g_o, g_d, g_c, g_r, g_mp), derived by hand, in the
    formulas and order of ``bounce_vjp`` in csrc/megakernel_geom.cuh (there
    per lane with branches; here every branch on every lane, then
    selected). g_mp is mis's: the cotangent of the previous diffuse
    vertex's pdf_cont."""
    z3 = torch.zeros_like(o)
    is_sph, is_rect, hit = b.kind == SPHERE, b.kind == RECT, b.kind != MISS
    # Forward quantities.
    da = _col(d, b.axis)
    inv = 1.0 / torch.where(da != 0.0, da, 1.0)
    t_rect = (b.k - _col(o, b.axis)) * inv
    op = c - o
    bq = vm.dot(op, d)
    m = bq[:, None] * d - op
    m2 = vm.dot(m, m)
    mlen = torch.where(m2 > 0.0, torch.sqrt(torch.where(m2 > 0.0, m2, 1.0)),
                       0.0)
    det = (r - mlen) * (r + mlen)
    sdet = torch.sqrt(torch.where(det > 0.0, det, 1.0))
    t = torch.where(is_sph, torch.where(b.near, bq - sdet, bq + sdet),
                    torch.where(is_rect, t_rect, 0.0))
    x = torch.where(hit[:, None], o + d * t[:, None], 0.0)
    v = x - c
    v2 = vm.dot(v, v)
    rs_n = vm.rsqrt(torch.where(v2 > 0.0, v2, 1.0))
    ng = torch.where(is_sph[:, None], v * rs_n[:, None], _onehot(b.axis, x))
    n = ng * b.sign[:, None]

    # Scatter: the cotangents of x, n, ng and d from (lam_d, sig_w).
    # DIFF, NEE as the continuation: d' = dl = norm(lp - x), w = w_nee.
    gx_nee, gn_nee = _nee_vjp(x, n, b, light, sig_w, lam_d, False)

    # DIFF, the hemisphere sample: d' = its direction, w = 1
    # (uniform_corrected: 2 max(d' . n, 0); mis: pdf_cont = max(d' . n, 0)
    # / pi).
    pick = (torch.abs(n[:, 0]) > 0.1)[:, None]
    e_y = torch.tensor([0.0, 1.0, 0.0], device=x.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], device=x.device)
    ax = torch.where(pick, e_y, e_x).expand_as(n)
    cr = vm.cross(ax, n)
    cr2 = vm.dot(cr, cr)
    rs_u = vm.rsqrt(torch.where(cr2 > 0.0, cr2, 1.0))
    fu = cr * rs_u[:, None]
    fv = vm.cross(n, fu)
    sv = (fu * b.alpha[:, None] + fv * b.beta[:, None] + n * b.wz[:, None])
    sv2 = vm.dot(sv, sv)
    rs_s = vm.rsqrt(torch.where(sv2 > 0.0, sv2, 1.0))
    dn = sv * rs_s[:, None]
    lam_s, gn_cd = lam_d, z3
    if est in ("uniform_corrected", "mis"):
        g_cd = torch.where(vm.dot(dn, n) >= 0.0, 2.0 * sig_w
                           if est == "uniform_corrected" else lam_mp * INV_PI,
                           0.0)
        lam_s = lam_d + n * g_cd[:, None]
        gn_cd = dn * g_cd[:, None]
    gsv = _norm_vjp(dn, rs_s, lam_s)
    gfu = gsv * b.alpha[:, None]
    gfv = gsv * b.beta[:, None]
    gn_cos = gsv * b.wz[:, None] + vm.cross(fu, gfv)
    gfu = gfu + vm.cross(gfv, n)
    gcr = _norm_vjp(fu, rs_u, gfu)
    gn_cos = gn_cos + vm.cross(gcr, ax) + gn_cd

    # SPEC: d' = reflect(d, ng), w = 1.
    gd_spec, gng_spec = _reflect_vjp(d, ng, lam_d)

    # REFR.
    into = b.sign > 0.0
    nnt = torch.where(into, NNT_INTO, NNT_OUT)
    ddn = vm.dot(d, n)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    pos = cos2t > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, cos2t, 1.0)), 0.0)
    sgn = torch.where(into, 1.0, -1.0)
    h = sgn * (ddn * nnt + sq)
    tv = d * nnt[:, None] - ng * h[:, None]
    tv2 = vm.dot(tv, tv)
    rs_t = vm.rsqrt(torch.where(tv2 > 0.0, tv2, 1.0))
    td = tv * rs_t[:, None]
    cc = 1.0 - torch.where(into, -ddn, vm.dot(td, ng))
    c4 = cc * cc * cc * cc
    re = R0 + (1.0 - R0) * c4 * cc
    tr = 1.0 - re
    pr = 0.25 + 0.5 * re
    pick_refl = (b.coin < pr) | tir
    gre = torch.where(pick_refl, sig_w / pr, -(sig_w / (1.0 - pr)))
    gpr = torch.where(pick_refl, -sig_w * re / (pr * pr),
                      sig_w * tr / ((1.0 - pr) * (1.0 - pr)))
    gre = gre + 0.5 * gpr
    gcc = torch.where(tir, 0.0, gre * (1.0 - R0) * 5.0 * c4)
    gddn = torch.where(into, gcc, 0.0)
    gtd = -ng * torch.where(into, 0.0, gcc)[:, None]
    gng_refr = -td * torch.where(into, 0.0, gcc)[:, None]
    gd_r, gng_r = _reflect_vjp(d, ng, lam_d)
    refl_m = pick_refl[:, None]
    gd_refr = torch.where(refl_m, gd_r, z3)
    gng_refr = gng_refr + torch.where(refl_m, gng_r, z3)
    gtd = gtd + torch.where(refl_m, z3, lam_d)
    gtv = _norm_vjp(td, rs_t, gtd)
    gd_refr = gd_refr + gtv * nnt[:, None]
    gng_refr = gng_refr - gtv * h[:, None]
    gh = -vm.dot(ng, gtv)
    gddn = gddn + sgn * nnt * gh
    gsq = sgn * gh
    gcos2t = torch.where(pos, gsq * 0.5 / sq, 0.0)
    gddn = gddn + gcos2t * nnt * nnt * 2.0 * ddn
    gd_refr = gd_refr + n * gddn[:, None]
    gn_refr = d * gddn[:, None]

    # Select the scatter's cotangents by material; the direct term's weight
    # (nee_textbook, mis) under sig_tb where the probe reached the light.
    is_diff = (b.refl == DIFF)[:, None]
    is_spec = (b.refl == SPEC)[:, None]
    succ = b.success[:, None]
    if est in NEE_CONT:
        nee_m = succ if b.take is None else succ & b.take[:, None]
    else:
        nee_m = torch.zeros_like(succ)
    gx_diff = torch.where(nee_m, gx_nee, z3)
    gn_diff = torch.where(nee_m, gn_nee, gn_cos)
    if est in DIRECT:
        gx_tb, gn_tb = _nee_vjp(x, n, b, light, sig_tb, z3, est == "mis")
        gx_diff = gx_diff + torch.where(succ, gx_tb, z3)
        gn_diff = gn_diff + torch.where(succ, gn_tb, z3)
    g_x = torch.where(is_diff, gx_diff, z3)
    g_n = torch.where(is_diff, gn_diff,
                      torch.where(is_spec, z3, gn_refr))
    g_ng = torch.where(is_diff, z3, torch.where(is_spec, gng_spec, gng_refr))
    g_d = torch.where(is_diff, z3, torch.where(is_spec, gd_spec, gd_refr))

    # n = sign * ng; ng = norm(x - c) on a sphere winner.
    g_ng = g_ng + g_n * b.sign[:, None]
    gv = _norm_vjp(ng, rs_n, g_ng)
    sph_m = is_sph[:, None]
    g_x = g_x + torch.where(sph_m, gv, z3)
    g_c = -torch.where(sph_m, gv, z3)
    # x = o + d t on a hit.
    g_x = torch.where(hit[:, None], g_x + lam_x, z3)
    g_o = g_x
    g_d = g_d + g_x * t[:, None]
    g_t = vm.dot(g_x, d)
    g_mp = torch.zeros_like(r)
    if est == "mis":
        # The pickup's weight mp / (mp + p_h), p_h = t^2 / (A max(|d . ln|,
        # 1e-6)), on a BSDF-sampled hit of the light (a rect).
        cos_h = vm.dot(d, light.ln)
        cm = torch.clamp(torch.abs(cos_h), min=COS_MIN)
        p_h = (t * t) / (light.area * cm)
        den = torch.where(b.pick, mp + p_h, 1.0)
        g_mp = torch.where(b.pick, sig_pk * p_h / (den * den), 0.0)
        g_ph = torch.where(b.pick, -sig_pk * mp / (den * den), 0.0)
        g_t = g_t + g_ph * 2.0 * t / (light.area * cm)
        g_cm = torch.where(torch.abs(cos_h) >= COS_MIN,
                           -g_ph * p_h / cm * torch.sign(cos_h), 0.0)
        g_d = g_d + light.ln * g_cm[:, None]
    # Rect winner: t = (k - o[a]) / d[a].
    e_a = _onehot(b.axis, o)
    rect_m = is_rect[:, None]
    g_o = g_o - torch.where(rect_m, e_a * (g_t * inv)[:, None], z3)
    g_d = g_d - torch.where(rect_m, e_a * (g_t * t * inv)[:, None], z3)
    # Sphere winner: t = b -+ sqrt((r - |m|)(r + |m|)), m = b d - op.
    g_sd = torch.where(b.near, -g_t, g_t)
    g_det = g_sd * 0.5 / sdet
    g_r = torch.where(is_sph, g_det * 2.0 * r, 0.0)
    g_m2 = torch.where(m2 > 0.0, -g_det, 0.0)
    g_m = m * (2.0 * g_m2)[:, None]
    g_b = g_t + vm.dot(g_m, d)
    g_dd = g_m * bq[:, None] + op * g_b[:, None]
    g_op = -g_m + d * g_b[:, None]
    g_o = g_o - torch.where(sph_m, g_op, z3)
    g_d = g_d + torch.where(sph_m, g_dd, z3)
    g_c = g_c + torch.where(sph_m, g_op, z3)
    return g_o, g_d, g_c, g_r, g_mp


# ---------------------------------------------------------------------------
# The plain version.

def geom_run_plain(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                   g_img=None, device=None):
    """The kernel's plain version: the eager regenerating forward on the
    kernel's lane layout and, with ``g_img``, torch.autograd of
    sum(g_img * img_sum) through it, the sphere rows and material tables as
    leaves. With ``g_img`` the lanes run in chunks (``plain_chunk``: one
    on the CPU, a bounded number on the card), their gradients summed:
    exact up to summation order. Returns (img_sum (h, w, 3), g_sph (S, 4), g_alb
    (K, 3), g_emi (K, 3), traces (2,) int64 [extend, probe]); the
    gradients are zero without ``g_img``."""
    check_geom(scene, cfg)
    device = _resolve(scene, device)
    img, *grads, traces = _plain(scene, cam, cfg, seed,
                                 _rows(g_img, cfg, device), full_layout(cfg),
                                 device)
    return (_image(img, cfg), *grads, traces)


def _rows(g_img, cfg: RenderConfig, device):
    """The (h, w, 3) cotangent as (n_pix, 3) float32 rows, or None."""
    if g_img is None:
        return None
    g = g_img.detach().to(device=device, dtype=torch.float32)
    if tuple(g.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"g_img must be ({cfg.height}, {cfg.width}, 3)"
                         f", got {tuple(g.shape)}")
    return g.reshape(-1, 3)


def _plain(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed, g_rows,
           lay: ShardLayout, device):
    """geom_run_plain on the lanes ``lay``, the cotangent rows g_rows
    (n_pix_loc, 3) or None: ((n_pix_loc, 3) radiance sums, g_sph, g_alb,
    g_emi, traces)."""
    sc, cm = scene.to(device), cam.to(device)
    leaves = pack_tables(sc)
    pix, s_start, s_stop = shard_lanes(lay, device)
    n = pix.shape[0]
    grads = [torch.zeros_like(t) for t in leaves]
    want = g_rows is not None
    if want:
        g_lane = g_rows.detach().to(device=device, dtype=torch.float32
                                    ).index_select(0, pix - lay.pix0)
        chunk = plain_chunk(num_spheres(sc), device)
    else:
        chunk = n
    Ls, traces = [], torch.zeros(2, dtype=torch.int64, device=device)
    for a in range(0, n, chunk):
        z = slice(a, min(n, a + chunk))
        with torch.set_grad_enabled(want):
            lv = [t.detach().requires_grad_(want) for t in leaves]
            L, tr = path_trace_regen(scene_with_tables(sc, *lv), cfg,
                                     int(seed), cm, pix[z], s_start[z],
                                     s_stop[z])
            if want:
                parts = torch.autograd.grad(L, lv, grad_outputs=g_lane[z],
                                            allow_unused=True)
                for acc, p in zip(grads, parts):
                    if p is not None:
                        acc += p
        Ls.append(L.detach())
        traces += tr
    return (reduce_lanes(torch.cat(Ls), lay), *grads, traces)


# ---------------------------------------------------------------------------
# The kernel.

# The estimator codes (ops/megakernel.est_code) whose instances
# csrc/megakernel_geom_direct.cu holds (the direct-term estimators); nee's
# is csrc/megakernel_geom.cu's, the others csrc/megakernel_geom_est.cu's.
_DIRECT_CODES = (EST_CODE["nee_textbook"], EST_CODE["mis"])


def geom_kernel_name(cfg: RenderConfig) -> str:
    """The name under which both launches of cfg's estimator count in
    LAUNCHES: megakernel_geom (``nee``) or megakernel_geom_<est>
    (``_est_name``: cosine, textbook, uniform, uniform_corrected, mixture,
    mis, nee_glibc, mixture_glibc; ``mis`` with glibc_overflow is
    ``mis``); its linear and tree instances count together."""
    name = _est_name(cfg)
    return "megakernel_geom" + ("" if name == "nee" else "_" + name)


def _check_spheres(scene: Scene) -> int:
    S = num_spheres(scene)
    if S > MAX_GEOM_SPHERES:
        raise NotImplementedError(
            f"the geometry-adjoint kernel takes at most {MAX_GEOM_SPHERES} "
            f"spheres (its per-warp gradient rows fill a block's shared "
            f"memory), got {S}"
        )
    return S


def _launch(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
            g_rows, lay: ShardLayout, device,
            geometry: KernelGeometry | None):
    """One launch of cfg's instance of megakernel_geom
    (``geom_kernel_name``) on the lanes ``lay``, the adjoint under the
    (n_pix_loc, 3) cotangent rows g_rows, image-only for None: ((n_pix_loc,
    3) radiance sums, g_sph, g_alb, g_emi, counts (5,))."""
    S = _check_spheres(scene)
    geom = pack_geometry(scene, cam) if geometry is None else geometry
    R = len(geom.rect_axis)
    lib = _build.build_kernels().lib
    K = R + S
    n_slots = 6 * K + 4 * S
    out_l = torch.empty((lay.n_pix_loc * lay.g, 3), dtype=torch.float32,
                        device=device)
    counts = torch.zeros(N_COUNTS, dtype=torch.int64, device=device)
    out = torch.zeros(n_slots, dtype=torch.float32, device=device)
    if g_rows is None:
        bk, g_ptr, partials = 0, None, out[:0]
    else:
        bk = 1
        g_rows = g_rows.detach().to(device=device,
                                    dtype=torch.float32).contiguous()
        if tuple(g_rows.shape) != (lay.n_pix_loc, 3):
            raise ValueError(f"expected ({lay.n_pix_loc}, 3) cotangent "
                             f"rows, got {tuple(g_rows.shape)}")
        g_ptr = g_rows.data_ptr()
        n_blocks = -(-lay.n_pix_loc * lay.g // KERNEL_BLOCK)
        partials = torch.empty(n_blocks * n_slots, dtype=torch.float32,
                               device=device)
    code = est_code(cfg)
    if code == EST_CODE["nee"]:
        entry, est = lib.spt_megakernel_geom, ()
    else:
        entry = (lib.spt_megakernel_geom_direct if code in _DIRECT_CODES
                 else lib.spt_megakernel_geom_est)
        est = (code, cfg.mixture_q)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        sa = sphere_args(lib, scene, device)
        err = entry(
            *est, geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data, R,
            *launch_args(geom, cfg, seed, lay), *sa.args(), bk, g_ptr,
            partials.data_ptr(), partials.numel(), out.data_ptr(),
            out_l.data_ptr(), counts.data_ptr(), stream,
        )
    count(geom_kernel_name(cfg), err)
    g_alb = out[:3 * K].reshape(K, 3)
    g_emi = out[3 * K:6 * K].reshape(K, 3)
    g_sph = out[6 * K:].reshape(S, 4)
    return reduce_lanes(out_l, lay), g_sph, g_alb, g_emi, counts


def geom_run(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
             g_img=None, device=None, geometry: KernelGeometry | None = None,
             with_counts: bool = False):
    """One launch of the geometry-adjoint kernel (the JAX ``geom_run``).

    With ``g_img=None`` the image-only launch: pass A alone (row 2's loop
    body, the NEE fold on for nee and mixture), the image of
    megakernel_<est>_tab bit for bit, zero gradients. With ``g_img`` (h, w, 3)
    the adjoint launch: the same image, and the pathwise interior
    cotangents of sum(g_img * img_sum). The two launches trace the same
    paths (common random numbers), so a fit step's loss and gradient see
    one path set. ``geometry`` (``pack_geometry(scene, cam)``) saves the
    host packing of the rects a call.

    Returns (img_sum (h, w, 3) radiance sum over spp, g_sph (S, 4)
    [cx, cy, cz, r], g_alb (K, 3), g_emi (K, 3)), and with ``with_counts``
    the counters: on the card (5,) int64 [extend, probe, replayed bounces,
    VJP bounces, paths longer than the tape] (the first two pass A's, which
    are megakernel_<est>_tab's; the image-only launch counts the first two
    only); on the CPU (2,) [extend, probe]."""
    check_geom(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        img, gs, ga, ge, counts = geom_run_plain(scene, cam, cfg, seed, g_img,
                                                 device)
    else:
        img, gs, ga, ge, counts = _launch(
            scene, cam, cfg, seed, _rows(g_img, cfg, device),
            full_layout(cfg), device, geometry)
        img = _image(img, cfg)
    return (img, gs, ga, ge, counts) if with_counts else (img, gs, ga, ge)


def geom_vjp(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
             g_img, device=None, geometry: KernelGeometry | None = None):
    """The adjoint launch's gradients alone: (g_sph, g_alb, g_emi)."""
    return geom_run(scene, cam, cfg, seed, g_img, device, geometry)[1:]


class RenderSpheres(torch.autograd.Function):
    """img_sum (h, w, 3) as a function of the sphere rows and material
    tables. Forward: the image-only launch; backward: the adjoint launch
    under grad_output with the same seed, so the same paths.

    apply(sph, alb, emi, scene, cam, cfg, seed, geometry=None)"""

    @staticmethod
    def forward(ctx, sph, alb, emi, scene, cam, cfg, seed, geometry=None):
        sc = scene_with_tables(scene, sph.detach(), alb.detach(),
                               emi.detach())
        ctx.render_args = (sc, cam, cfg, seed, geometry)
        return geom_run(sc, cam, cfg, seed, geometry=geometry)[0]

    @staticmethod
    def backward(ctx, g_img):
        sc, cam, cfg, seed, geometry = ctx.render_args
        g_sph, g_alb, g_emi = geom_vjp(sc, cam, cfg, seed, g_img,
                                       geometry=geometry)
        return g_sph, g_alb, g_emi, None, None, None, None, None


def _no_edge_terms(edge_sphere) -> None:
    if edge_sphere is not None:
        raise NotImplementedError(
            "the edge-sampled boundary terms (edge_sphere, fit --fd-sphere "
            "with a geometry field) need grad/edge.py, which "
            + _ITEM.format(16))


def loss_and_geom_grads(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                        seed, target, edge_sphere: int | None = None,
                        geometry: KernelGeometry | None = None):
    """One geometry-training evaluation: the MSE of the linear mean image
    against ``target`` (h, w, 3), with the pathwise interior gradients of
    every sphere's (center, radius) and every object's (albedo, emission).
    Two launches of one kernel, image then adjoint, so the loss and the
    gradient see one path set. Returns (loss (), g_sph (S, 4), g_alb
    (K, 3), g_emi (K, 3))."""
    _no_edge_terms(edge_sphere)
    check_geom(scene, cfg)
    sph, alb, emi = (t.requires_grad_() for t in pack_tables(scene))
    img_sum = RenderSpheres.apply(sph, alb, emi, scene, cam, cfg, seed,
                                  geometry)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=img_sum.device)
    diff = img_sum / cfg.spp - target
    loss = torch.mean(diff * diff)
    g_sph, g_alb, g_emi = torch.autograd.grad(loss, (sph, alb, emi))
    return loss.detach(), g_sph, g_alb, g_emi


def geom_run_shard_plain(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                         mesh: Mesh, seed, g_rows=None, device=None):
    """The shard launch's plain version (see geom_run_shard); its counts
    are (2,) [extend, probe]."""
    check_geom(scene, cfg)
    device = _resolve(scene, device)
    return _plain(scene, cam, cfg, seed, g_rows,
                  shard_of(cfg, mesh, what="spp"), device)


def geom_run_shard(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                   mesh: Mesh, seed, g_rows=None, device=None,
                   geometry: KernelGeometry | None = None):
    """One launch of cfg's megakernel_geom instance on this rank's shard
    lanes, before any collective: image-only with ``g_rows=None``, else
    the adjoint under the cotangent rows g_rows (n_pix_loc, 3) of its pixel
    block. Both launches
    of a step take the same lanes and seed, so they trace the same paths.
    Returns ((n_pix_loc, 3) partial radiance sums over the shard's
    samples, g_sph (S, 4), g_alb (K, 3), g_emi (K, 3) partials, counts:
    (5,) on the card, (2,) on the CPU)."""
    check_geom(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return geom_run_shard_plain(scene, cam, cfg, mesh, seed, g_rows,
                                    device)
    return _launch(scene, cam, cfg, seed, g_rows,
                   shard_of(cfg, mesh, what="spp"), device, geometry)


def geom_train_step_sharded(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, mesh: Mesh, target,
                            device=None):
    """The JAX package's ``geom_train_step_sharded``: a geometry-training
    evaluation over the mesh in which every rank (a) runs the image-only
    launch on its shard's lanes, (b) sums the partial image over dp, (c)
    takes its loss and cotangent from its own pixel rows of ``target``
    (h, w, 3), and (d) replays the same lanes with the adjoint. The loss
    sums over sp only (it is replicated along dp), the gradients over the
    whole mesh.

    Returns step(sph, alb, emi, seed) -> (loss (), img_loc (n_pix_loc, 3)
    this rank's pixel rows of the radiance sum over spp, g_sph (S, 4),
    g_alb (K, 3), g_emi (K, 3)) in the port's table layout
    (``grads_to_scene``); loss and gradients are the same on every rank.
    The JAX step's image output is the sp-sharded array whose local block
    is img_loc."""
    check_geom(scene, cfg)
    device = _resolve(scene, device)
    lay = shard_of(cfg, mesh, what="spp")
    n_pix = cfg.width * cfg.height
    tgt = torch.as_tensor(target, dtype=torch.float32, device=device)
    tgt = tgt.reshape(n_pix, 3)[lay.pix0:lay.pix0 + lay.n_pix_loc]
    geometry = pack_geometry(scene, cam) if device.type == "cuda" else None
    spp_t = torch.tensor(float(cfg.spp), device=device)
    n_t = torch.tensor(float(n_pix * 3), device=device)
    inv_n = torch.tensor(2.0 / (n_pix * 3 * cfg.spp), device=device)

    def step(sph, alb, emi, seed):
        sc = scene_with_tables(scene, sph, alb, emi)
        part = geom_run_shard(sc, cam, cfg, mesh, seed, None, device,
                              geometry)[0]
        img_loc = mesh.sum_dp(part)
        diff = img_loc / spp_t - tgt
        loss = mesh.sum_sp(torch.sum(diff * diff) / n_t)
        _, g_sph, g_alb, g_emi, _ = geom_run_shard(
            sc, cam, cfg, mesh, seed, diff * inv_n, device, geometry)
        return (loss, img_loc, mesh.sum_world(g_sph), mesh.sum_world(g_alb),
                mesh.sum_world(g_emi))

    return step


def check_fit(fields, sphere_idx: int | None = None) -> None:
    """fit_geom's refusals: a field outside FIELDS (ValueError) and a
    geometry field of one sphere (its boundary terms, item 16), with a
    mesh or without."""
    bad = [f for f in fields if f not in FIELDS]
    if bad:
        raise ValueError(f"fields must be in {FIELDS}, got {bad}")
    if {"center", "radius"} & set(fields):
        _no_edge_terms(sphere_idx)


def fit_geom(scene: Scene, cam: CameraParams, cfg: RenderConfig, target,
             sphere_idx: int | None = None,
             fields: tuple[str, ...] = ("center", "radius"), steps: int = 10,
             lr: float = 1.0, seed: int = 0, log=None, mesh=None):
    """Sphere inverse rendering through the geometry adjoint, the JAX
    package's ``fit_pallas_geom`` on one card: normalized-step descent (the
    direction from the gradient, the step length capped and backtracked on
    the common-random-number loss; ``lr`` is the initial geometry step in
    scene units, materials take min(lr, 0.1)), one image and one adjoint
    launch a step. ``fields``: of center, radius, albedo, emission (the
    spheres'); ``sphere_idx`` masks the update to one sphere, which with a
    geometry field would add the edge-sampled boundary terms (item 16).
    ``mesh`` (``parallel/mesh.py``) routes every step through
    ``geom_train_step_sharded``: each rank renders its shard, the loss and
    gradients are the whole image's on every rank, so every rank takes the
    same steps.

    Returns (best scene, [losses]); losses[-1] describes the returned
    scene."""
    check_fit(fields, sphere_idx)
    check_geom(scene, cfg)
    geometry = (pack_geometry(scene, cam) if scene.device.type == "cuda"
                else None)
    if mesh is not None:
        sharded = geom_train_step_sharded(scene, cam, cfg, mesh, target)
    cap0_geo, cap0_mat = float(lr), min(float(lr), 0.1)
    cap_geo, cap_mat = cap0_geo, cap0_mat
    losses: list[float] = []
    s, best_loss, best_s = scene, float("inf"), scene
    R = scene.rects.k.shape[0]

    def msel(arr):
        if sphere_idx is None:
            return arr
        m = torch.zeros(arr.shape[0], dtype=torch.bool, device=arr.device)
        m[sphere_idx] = True
        return torch.where(m.reshape((-1,) + (1,) * (arr.ndim - 1)), arr,
                           0.0)

    def step(grad, cap):
        nrm = float(torch.linalg.vector_norm(grad))
        if nrm < 1e-30:
            return torch.zeros_like(grad)
        return -cap * grad / nrm

    for i in range(steps):
        t0 = time.perf_counter()
        if mesh is None:
            loss, g_sph, g_alb, g_emi = loss_and_geom_grads(
                s, cam, cfg, seed, target, geometry=geometry)
        else:
            loss, _, g_sph, g_alb, g_emi = sharded(*pack_tables(s), seed)
        loss = float(loss)  # waits for the step's kernels
        if loss > best_loss:
            s = best_s
            cap_geo *= 0.5
            cap_mat *= 0.5
            losses.append(best_loss)
            if log is not None:
                print(f"step {i}: loss {loss:.6f} rejected (cap -> "
                      f"{cap_geo:.3f})  seconds "
                      f"{time.perf_counter() - t0:.6f}", file=log, flush=True)
            continue
        best_loss, best_s = loss, s
        cap_geo = min(1.2 * cap_geo, cap0_geo)
        cap_mat = min(1.2 * cap_mat, cap0_mat)
        losses.append(loss)
        sp = s.spheres
        if "center" in fields:
            sp = sp._replace(center=sp.center + step(msel(g_sph[:, :3]),
                                                     cap_geo))
        if "radius" in fields:
            sp = sp._replace(radius=torch.clamp(
                sp.radius + step(msel(g_sph[:, 3]), cap_geo), min=1e-3))
        if "albedo" in fields:
            sp = sp._replace(albedo=torch.clamp(
                sp.albedo + step(msel(g_alb[R:]), cap_mat), 0.0, 1.0))
        if "emission" in fields:
            sp = sp._replace(emission=torch.clamp(
                sp.emission + step(msel(g_emi[R:]), cap_mat), min=0.0))
        s = s._replace(spheres=sp)
        if log is not None:
            idx = sphere_idx if sphere_idx is not None else 0
            cc = [round(v, 3) for v in s.spheres.center[idx].tolist()]
            print(f"step {i}: loss {loss:.6f} center {cc} radius "
                  f"{float(s.spheres.radius[idx]):.3f}  seconds "
                  f"{time.perf_counter() - t0:.6f}", file=log, flush=True)
    return best_s, losses
