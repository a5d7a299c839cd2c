"""Nearest-hit queries over the scene's rects and spheres.

Semantics of the JAX package's ``geometry/intersect.py``:

- rect hit: t = (k - o[axis]) * (1 / d[axis]), one reciprocal per ray axis
  shared by every rect; the hit point must lie inside the in-plane bounds
  (inclusive) and t > SELF_HIT_EPS; a ray parallel to the plane misses;
- sphere hit: the recentered (rejection-form) quadratic, robust at giant
  radii, with eps = max(SPHERE_EPS, SPHERE_EPS_REL * radius); the near root
  when it clears eps, else the far one;
- the nearest hit is a strict ``<`` scan in object order (rects, then
  spheres), so the first object wins a tie; a miss has t = MISS_T and
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
from ..scene.types import Scene, Spheres, num_spheres, object_arrays

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


def shade_info(scene: Scene, o: torch.Tensor, d: torch.Tensor,
               hit: Hit) -> Shade:
    """Hit point, oriented normal and material of each ray's nearest hit.
    A rect's normal is its axis; a sphere's is norm(x - center)."""
    x = torch.where(hit.hit[:, None], o + hit.t[:, None] * d, 0.0)
    albedo_all, emission_all, refl_all = object_arrays(scene)
    R = scene.rects.k.shape[0]
    # One row an object: [albedo 3, emission 3, center 3, refl, axis]
    # (center 0 for rects, axis -1 for spheres); small integers are exact
    # in float32.
    f32 = x.dtype
    center = torch.cat([torch.zeros_like(scene.rects.lo[:, :1]).expand(R, 3),
                        scene.spheres.center])
    axis = torch.cat([scene.rects.axis,
                      torch.full_like(scene.spheres.refl, -1)])
    table = torch.cat([albedo_all, emission_all, center,
                       refl_all[:, None].to(f32), axis[:, None].to(f32)],
                      dim=1)
    row = torch.zeros((x.shape[0], table.shape[1]), dtype=f32,
                      device=x.device)
    # obj_id is in [0, K): exactly one object matches each ray.
    for i in range(table.shape[0]):
        row = torch.where((hit.obj_id == i)[:, None], table[i], row)
    n_geom = (row[:, 10:11] == torch.arange(3, device=x.device)).to(f32)
    if num_spheres(scene):
        is_sphere = (hit.obj_id >= R)[:, None]
        n_geom = torch.where(is_sphere, vm.norm(x - row[:, 6:9]), n_geom)
    return Shade(
        x=x,
        n=vm.orient_normal(n_geom, d),
        n_geom=n_geom,
        albedo=row[:, 0:3],
        emission=row[:, 3:6],
        refl=row[:, 9].to(torch.int64),
    )
