"""Nearest-hit queries over the scene's rects.

Semantics of the JAX package's ``geometry/intersect.py``:

- rect hit: t = (k - o[axis]) * (1 / d[axis]), one reciprocal per ray axis
  shared by every rect; the hit point must lie inside the in-plane bounds
  (inclusive) and t > SELF_HIT_EPS; a ray parallel to the plane misses;
- the nearest hit is a strict ``<`` scan in object order, so the first
  object wins a tie; a miss has t = MISS_T and object id 0;
- shading on a miss uses the stale id 0 at x = (0, 0, 0).

Per-rect axes and per-ray materials are picked with ``torch.where`` instead
of advanced indexing: selection is exact, and a garbled index cannot turn
into an out-of-bounds read on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..scene.types import Scene, object_arrays

MISS_T = 1e20
SPHERE_EPS = 1e-4
SELF_HIT_EPS = 1e-3
SPHERE_EPS_REL = 4e-6


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


def trace(scene: Scene, o: torch.Tensor, d: torch.Tensor) -> Hit:
    """Nearest hit over all objects."""
    ts = intersect_rects(scene.rects, o, d)
    t_best = torch.full_like(ts[:, 0], MISS_T)
    obj_id = torch.zeros(ts.shape[0], dtype=torch.int64, device=ts.device)
    for i in range(ts.shape[1]):
        win = ts[:, i] < t_best
        t_best = torch.where(win, ts[:, i], t_best)
        obj_id = torch.where(win, i, obj_id)
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
    """Hit point, oriented normal and material of each ray's nearest hit."""
    x = torch.where(hit.hit[:, None], o + hit.t[:, None] * d, 0.0)
    albedo_all, emission_all, refl_all = object_arrays(scene)
    albedo = torch.zeros_like(x)
    emission = torch.zeros_like(x)
    refl = torch.zeros_like(hit.obj_id)
    axis = torch.zeros_like(hit.obj_id)
    # obj_id is in [0, R): exactly one object matches each ray.
    for i in range(albedo_all.shape[0]):
        m = hit.obj_id == i
        albedo = torch.where(m[:, None], albedo_all[i], albedo)
        emission = torch.where(m[:, None], emission_all[i], emission)
        refl = torch.where(m, refl_all[i], refl)
        axis = torch.where(m, scene.rects.axis[i], axis)
    n_geom = (axis[:, None] == torch.arange(3, device=x.device)).to(x.dtype)
    return Shade(
        x=x,
        n=vm.orient_normal(n_geom, d),
        n_geom=n_geom,
        albedo=albedo,
        emission=emission,
        refl=refl,
    )
