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
from .scene.types import GLOS, LightSampler, Rects, Scene, Spheres


def _leaf(obj, name, dtype, device):
    return torch.as_tensor(np.array(getattr(obj, name)), dtype=dtype,
                           device=device)


def _count(block, name) -> int:
    return int(np.asarray(getattr(block, name)).shape[0])


def scene_from_jax(scene, device="cuda") -> Scene:
    """The port's Scene from a JAX ``Scene``; raises for anything outside
    this slice (quads, a sphere light, a light list, GLOS materials)."""
    device = resolve(device)
    if _count(scene.quads, "corner"):
        raise NotImplementedError(
            "quads are not ported yet (ROADMAP.md queue 1, item 11)"
        )
    if getattr(scene, "lights", None) is not None:
        raise NotImplementedError(
            "light lists are not ported yet (ROADMAP.md queue 1, item 12)"
        )
    light = scene.light
    if not hasattr(light, "corner"):
        raise NotImplementedError(
            "sphere lights are not ported yet (ROADMAP.md queue 1, item 12)"
        )
    if any(np.any(np.asarray(b.refl) == GLOS)
           for b in (scene.rects, scene.spheres)):
        raise NotImplementedError(
            "GLOS materials are not ported yet (ROADMAP.md queue 1, item 11)"
        )
    f32, i64 = torch.float32, torch.int64
    r, s = scene.rects, scene.spheres
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
    return Scene(rects=rects, spheres=spheres, light=ls)


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
