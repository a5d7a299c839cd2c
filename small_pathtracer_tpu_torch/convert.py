"""Convert the JAX package's scene, camera and material tables into the
port's.

Reads the leaves by duck typing (``np.asarray(getattr(...))``) and imports
no JAX, so the tests can feed both packages one scene.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import CameraParams
from .device import resolve
from .scene.types import (
    LightSampler, Quads, Rects, Scene, Spheres, num_quads, num_spheres,
)


def _leaf(obj, name, dtype, device):
    return torch.as_tensor(np.array(getattr(obj, name)), dtype=dtype,
                           device=device)


def _count(block, name) -> int:
    return int(np.asarray(getattr(block, name)).shape[0])


def scene_from_jax(scene, device="cuda") -> Scene:
    """The port's Scene from a JAX ``Scene``; raises for anything outside
    this slice (a sphere light, a light list)."""
    device = resolve(device)
    if getattr(scene, "lights", None) is not None:
        raise NotImplementedError(
            "light lists are not ported yet (ROADMAP.md queue 1, item 12)"
        )
    light = scene.light
    if not hasattr(light, "corner"):
        raise NotImplementedError(
            "sphere lights are not ported yet (ROADMAP.md queue 1, item 12)"
        )
    f32, i64 = torch.float32, torch.int64
    r, q, s = scene.rects, scene.quads, scene.spheres
    rects = Rects(
        axis=_leaf(r, "axis", i64, device),
        k=_leaf(r, "k", f32, device),
        lo=_leaf(r, "lo", f32, device),
        hi=_leaf(r, "hi", f32, device),
        albedo=_leaf(r, "albedo", f32, device),
        emission=_leaf(r, "emission", f32, device),
        refl=_leaf(r, "refl", i64, device),
        gloss=_leaf(r, "gloss", f32, device),
    )
    quads = Quads(
        *(_leaf(q, f, f32, device).reshape(-1, 3)
          for f in ("corner", "edge_u", "edge_v", "albedo", "emission")),
        refl=_leaf(q, "refl", i64, device),
        gloss=_leaf(q, "gloss", f32, device),
    )
    spheres = Spheres(
        center=_leaf(s, "center", f32, device).reshape(-1, 3),
        radius=_leaf(s, "radius", f32, device),
        albedo=_leaf(s, "albedo", f32, device).reshape(-1, 3),
        emission=_leaf(s, "emission", f32, device).reshape(-1, 3),
        refl=_leaf(s, "refl", i64, device),
        gloss=_leaf(s, "gloss", f32, device),
    )
    ls = LightSampler(
        corner=_leaf(light, "corner", f32, device),
        edge_u=_leaf(light, "edge_u", f32, device),
        edge_v=_leaf(light, "edge_v", f32, device),
        light_obj_id=int(np.asarray(light.light_obj_id)),
    )
    return Scene(rects=rects, quads=quads, spheres=spheres, light=ls)


def camera_from_jax(cam, device="cuda") -> CameraParams:
    """The port's CameraParams from a JAX ``CameraParams``."""
    device = resolve(device)
    return CameraParams(*(
        _leaf(cam, name, torch.float32, device)
        for name in CameraParams._fields
    ))


def materials_from_jax(albedo, emission, device="cuda"):
    """The port's (K, 3) float32 albedo and emission tables from the JAX
    package's ``pack_materials`` arrays (the same global object order)."""
    device = resolve(device)
    tables = tuple(
        torch.as_tensor(np.array(t, dtype=np.float32), device=device)
        for t in (albedo, emission)
    )
    for t in tables:
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"expected a (K, 3) table, got {tuple(t.shape)}")
    return tables


def guide_from_jax(mu, use, device="cuda"):
    """The port's guide (mu (V, 3) float32, use (V,) bool) from a JAX
    ``guide_lobes`` table given as arrays, for the guided renders of
    ``ops.megakernel``."""
    device = resolve(device)
    mu_t = torch.as_tensor(np.array(mu, dtype=np.float32), device=device)
    use_t = torch.as_tensor(np.array(use, dtype=bool), device=device)
    if mu_t.ndim != 2 or mu_t.shape[1] != 3 or tuple(use_t.shape) != (
            mu_t.shape[0],):
        raise ValueError(f"expected mu (V, 3) and use (V,), got "
                         f"{tuple(mu_t.shape)} and {tuple(use_t.shape)}")
    return mu_t, use_t


def geom_grads_from_jax(scene: Scene, gtab, galb, gemi, device=None):
    """The port's geometry-adjoint tables from the JAX package's
    ``geom_vjp`` outputs: gtab (S * TAB_STRIDE,) holds per sphere row the
    slots [cx, cy, cz, r, albedo rgb, emission rgb], galb and gemi
    ((R + Q) * 3,) the rects' and the quads'. Returns (g_sph (S, 4), g_alb
    (K, 3), g_emi (K, 3)) in global object order (rects, quads, then
    spheres) on ``device`` (the port ``scene``'s by default), as
    ``ops.megakernel_geom.geom_run`` returns them."""
    device = resolve(scene.device if device is None else device)
    U, S = _count(scene.rects, "k") + num_quads(scene), num_spheres(scene)
    gt = np.asarray(gtab, np.float32).reshape(S, -1)
    ga = np.asarray(galb, np.float32).reshape(U, 3)
    ge = np.asarray(gemi, np.float32).reshape(U, 3)
    return tuple(torch.as_tensor(np.ascontiguousarray(t), device=device)
                 for t in (gt[:, 0:4], np.concatenate([ga, gt[:, 4:7]]),
                           np.concatenate([ge, gt[:, 7:10]])))
