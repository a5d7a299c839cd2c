"""Nearest-hit queries over the scene's rects, quads and spheres.

Semantics of the JAX package's ``geometry/intersect.py``:

- rect hit: t = (k - o[axis]) * (1 / d[axis]), one reciprocal per ray axis
  shared by every rect; the hit point must lie inside the in-plane bounds
  (inclusive) and t > SELF_HIT_EPS; a ray parallel to the plane misses;
- quad hit (a parallelogram): the plane through the quad's (unnormalized)
  normal n = edge_u x edge_v, t = ((corner - o) . n) / (d . n), then the
  barycentric (a, b) from the 2x2 Gram solve, inclusive bounds [0, 1] and
  t > SELF_HIT_EPS; a ray parallel to the plane misses. The quad's
  constants (n, the Gram entries, 1 / det, the unit normal) are computed
  in float64 and rounded to float32 (``quad_consts``), as the JAX
  megakernel bakes them on the host (its ``_iter_hits``), so the
  expression tree is the TPU kernel's, which the CUDA kernels follow too;
- sphere hit: the recentered (rejection-form) quadratic, robust at giant
  radii, with eps = max(SPHERE_EPS, SPHERE_EPS_REL * radius); the near root
  when it clears eps, else the far one;
- the nearest hit is a strict ``<`` scan in object order (rects, quads,
  then spheres), so the first object wins a tie; a miss has t = MISS_T and
  object id 0;
- shading on a miss uses the stale id 0 (a rect) at x = (0, 0, 0).

Every sum is written out in x, y, z order, as the CUDA kernels write it.
Per-rect axes and per-ray materials are picked with ``torch.where`` instead
of advanced indexing: selection is exact, and a garbled index cannot turn
into an out-of-bounds read on the device. Spheres are tested in chunks of
SPHERE_CHUNK, so the (N, S) temporaries stay bounded at any sphere count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..scene.types import (
    Quads, Scene, Spheres, gloss_arrays, num_quads, num_spheres,
    object_arrays,
)

MISS_T = 1e20
SPHERE_EPS = 1e-4
SELF_HIT_EPS = 1e-3
SPHERE_EPS_REL = 4e-6
SPHERE_CHUNK = 64


class Hit(NamedTuple):
    t: torch.Tensor       # (N,) distance, MISS_T on a miss
    obj_id: torch.Tensor  # (N,) int64 global object id, 0 on a miss
    hit: torch.Tensor     # (N,) bool


def _pick(v: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """v[:, axis] for v (N, 3) and axis (R,) in {0, 1, 2}: (N, R)."""
    return torch.where(axis == 0, v[:, 0:1],
                       torch.where(axis == 1, v[:, 1:2], v[:, 2:3]))


def intersect_rects(rects, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-rect hit distances. o, d: (N, 3). Returns (N, R), MISS_T on miss."""
    ax = rects.axis
    # OTHER_AXES[ax]: the first and second bounded in-plane axes.
    ax0 = torch.where(ax == 0, 1, 0)
    ax1 = torch.where(ax == 2, 1, 2)
    d_ok = d != 0.0
    inv_d = 1.0 / torch.where(d_ok, d, 1.0)
    t = (rects.k[None, :] - _pick(o, ax)) * _pick(inv_d, ax)
    p0 = _pick(o, ax0) + t * _pick(d, ax0)
    p1 = _pick(o, ax1) + t * _pick(d, ax1)
    valid = (
        (p0 >= rects.lo[None, :, 0])
        & (p0 <= rects.hi[None, :, 0])
        & (p1 >= rects.lo[None, :, 1])
        & (p1 <= rects.hi[None, :, 1])
        & (t > SELF_HIT_EPS)
        & _pick(d_ok, ax)
    )
    return torch.where(valid, t, MISS_T)


# The columns of a quad_consts row (csrc/megakernel_common.cuh's Quad).
QUAD_COLS = 19


def quad_consts(quads: Quads) -> torch.Tensor:
    """(Q, QUAD_COLS) float32 on the quads' device, one row a quad: corner
    3, edge_u 3, edge_v 3, the unnormalized normal n = edge_u x edge_v 3,
    the Gram entries uu, vv, uv, 1 / (uu vv - uv^2), and the unit normal 3.
    Each is computed in float64 from the float32 leaves in the JAX
    megakernel's order and rounded once (its ``_iter_hits``: Python floats,
    then np.float32; every operation is IEEE's, so any device gives the
    same bits). A degenerate quad (det 0) gets n = 0, so it never hits."""
    if quads.corner.shape[0] == 0:
        return torch.zeros((0, QUAD_COLS), device=quads.corner.device)
    f64 = torch.float64
    c, eu, ev = (t.detach().to(f64)
                 for t in (quads.corner, quads.edge_u, quads.edge_v))
    n = torch.stack([eu[:, 1] * ev[:, 2] - eu[:, 2] * ev[:, 1],
                     eu[:, 2] * ev[:, 0] - eu[:, 0] * ev[:, 2],
                     eu[:, 0] * ev[:, 1] - eu[:, 1] * ev[:, 0]], dim=1)

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    uu, vv, uv = dot(eu, eu), dot(ev, ev), dot(eu, ev)
    gdet = uu * vv - uv * uv
    ok = gdet != 0.0
    inv_gdet = torch.where(ok, 1.0 / torch.where(ok, gdet, 1.0), 0.0)
    nl = torch.sqrt(dot(n, n))
    inv_nl = 1.0 / torch.where(ok, nl, 1.0)
    n = torch.where(ok[:, None], n, 0.0)
    cols = [c, eu, ev, n, uu[:, None], vv[:, None], uv[:, None],
            inv_gdet[:, None], n * inv_nl[:, None]]
    return torch.cat(cols, dim=1).to(torch.float32)


def intersect_quads(quads: Quads, o: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Per-quad hit distances. o, d: (N, 3). Returns (N, Q), MISS_T on
    miss."""
    q = quad_consts(quads).to(o.device)
    c, eu, ev, n = q[:, 0:3], q[:, 3:6], q[:, 6:9], q[:, 9:12]
    uu, vv, uv, inv_gdet = q[:, 12], q[:, 13], q[:, 14], q[:, 15]
    oc = [o[:, i:i + 1] for i in range(3)]
    dc = [d[:, i:i + 1] for i in range(3)]
    denom = dc[0] * n[:, 0] + dc[1] * n[:, 1] + dc[2] * n[:, 2]
    ok = denom != 0.0
    num = ((c[:, 0] - oc[0]) * n[:, 0] + (c[:, 1] - oc[1]) * n[:, 1]
           + (c[:, 2] - oc[2]) * n[:, 2])
    t = num / torch.where(ok, denom, 1.0)
    p = [(oc[i] + t * dc[i]) - c[:, i] for i in range(3)]
    pu = p[0] * eu[:, 0] + p[1] * eu[:, 1] + p[2] * eu[:, 2]
    pv = p[0] * ev[:, 0] + p[1] * ev[:, 1] + p[2] * ev[:, 2]
    a = (pu * vv - pv * uv) * inv_gdet
    b = (pv * uu - pu * uv) * inv_gdet
    valid = (ok & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
             & (t > SELF_HIT_EPS))
    return torch.where(valid, t, MISS_T)


def intersect_spheres(spheres: Spheres, o: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """Per-sphere hit distances. o, d: (N, 3). Returns (N, S), MISS_T on
    miss."""
    op = [spheres.center[None, :, i] - o[:, i:i + 1] for i in range(3)]
    dc = [d[:, i:i + 1] for i in range(3)]
    b = op[0] * dc[0] + op[1] * dc[1] + op[2] * dc[2]
    m = [b * dc[i] - op[i] for i in range(3)]  # center-to-line rejection
    m2 = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    m2_pos = m2 > 0.0
    mlen = torch.where(m2_pos, torch.sqrt(torch.where(m2_pos, m2, 1.0)), 0.0)
    rad = spheres.radius[None, :]
    det = (rad - mlen) * (rad + mlen)
    det_pos = det > 0.0
    sdet = torch.sqrt(torch.where(det_pos, det, 1.0))
    t_near = b - sdet
    t_far = b + sdet
    eps = torch.clamp(SPHERE_EPS_REL * rad, min=SPHERE_EPS)
    t = torch.where(t_near > eps, t_near, t_far)
    return torch.where(det_pos & (t > eps), t, MISS_T)


def trace(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> Hit:
    """Nearest hit over all objects."""
    ts = intersect_rects(scene.rects, o, d)
    t_best = torch.full_like(ts[:, 0], MISS_T)
    obj_id = torch.zeros(ts.shape[0], dtype=torch.int64, device=ts.device)
    for i in range(ts.shape[1]):
        win = ts[:, i] < t_best
        t_best = torch.where(win, ts[:, i], t_best)
        obj_id = torch.where(win, i, obj_id)
    base = ts.shape[1]
    if num_quads(scene):
        tq = intersect_quads(scene.quads, o, d)
        for i in range(tq.shape[1]):
            win = tq[:, i] < t_best
            t_best = torch.where(win, tq[:, i], t_best)
            obj_id = torch.where(win, base + i, obj_id)
        base += tq.shape[1]
    for c0 in range(0, num_spheres(scene), SPHERE_CHUNK):
        chunk = Spheres(*(f[c0:c0 + SPHERE_CHUNK] for f in scene.spheres))
        # min over a row returns the first minimal index: the strict scan.
        t_c, i_c = intersect_spheres(chunk, o, d).min(dim=1)
        win = t_c < t_best
        t_best = torch.where(win, t_c, t_best)
        obj_id = torch.where(win, base + c0 + i_c, obj_id)
    return Hit(t=t_best, obj_id=obj_id, hit=t_best < MISS_T)


class Shade(NamedTuple):
    x: torch.Tensor         # (N, 3) hit point, (0, 0, 0) on a miss
    n: torch.Tensor         # (N, 3) normal oriented against the ray
    n_geom: torch.Tensor    # (N, 3) unoriented geometric normal
    albedo: torch.Tensor    # (N, 3)
    emission: torch.Tensor  # (N, 3)
    refl: torch.Tensor      # (N,) int64
    gloss: torch.Tensor     # (N,) Phong exponent (GLOS; 0 elsewhere)


def shade_info(scene: Scene, o: torch.Tensor, d: torch.Tensor,
               hit: Hit) -> Shade:
    """Hit point, oriented normal and material of each ray's nearest hit.
    A rect's normal is its axis, a quad's its unit normal (``quad_consts``)
    and a sphere's norm(x - center)."""
    x = torch.where(hit.hit[:, None], o + hit.t[:, None] * d, 0.0)
    albedo_all, emission_all, refl_all = object_arrays(scene)
    R, Q = scene.rects.k.shape[0], num_quads(scene)
    # One row an object: [albedo 3, emission 3, center 3, refl, axis,
    # quad normal 3, gloss] (center 0 but for spheres, axis -1 but for
    # rects, quad normal 0 but for quads); small integers are exact in
    # float32.
    f32 = x.dtype
    dev = x.device
    center = torch.cat([torch.zeros((R + Q, 3), dtype=f32, device=dev),
                        scene.spheres.center])
    axis = torch.cat([scene.rects.axis,
                      torch.full_like(scene.quads.refl, -1),
                      torch.full_like(scene.spheres.refl, -1)])
    n_quad = torch.zeros((R + Q + num_spheres(scene), 3), dtype=f32,
                         device=dev)
    if Q:
        n_quad[R:R + Q] = quad_consts(scene.quads)[:, 16:19].to(dev)
    table = torch.cat([albedo_all, emission_all, center,
                       refl_all[:, None].to(f32), axis[:, None].to(f32),
                       n_quad, gloss_arrays(scene)[:, None]], dim=1)
    row = torch.zeros((x.shape[0], table.shape[1]), dtype=f32,
                      device=x.device)
    # obj_id is in [0, K): exactly one object matches each ray.
    for i in range(table.shape[0]):
        row = torch.where((hit.obj_id == i)[:, None], table[i], row)
    n_geom = (row[:, 10:11] == torch.arange(3, device=x.device)).to(f32)
    if Q:
        is_quad = ((hit.obj_id >= R) & (hit.obj_id < R + Q))[:, None]
        n_geom = torch.where(is_quad, row[:, 11:14], n_geom)
    if num_spheres(scene):
        is_sphere = (hit.obj_id >= R + Q)[:, None]
        n_geom = torch.where(is_sphere, vm.norm(x - row[:, 6:9]), n_geom)
    return Shade(
        x=x,
        n=vm.orient_normal(n_geom, d),
        n_geom=n_geom,
        albedo=row[:, 0:3],
        emission=row[:, 3:6],
        refl=row[:, 9].to(torch.int64),
        gloss=row[:, 14],
    )
