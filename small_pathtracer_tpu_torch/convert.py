"""Convert the JAX package's scene and camera containers into the port's.

Reads the leaves by duck typing (``np.asarray(getattr(...))``) and imports
no JAX, so the tests can feed both packages one scene.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import CameraParams
from .scene.types import LightSampler, Rects, Scene


def _leaf(obj, name, dtype, device):
    return torch.as_tensor(np.array(getattr(obj, name)), dtype=dtype,
                           device=device)


def _count(block, name) -> int:
    return int(np.asarray(getattr(block, name)).shape[0])


def scene_from_jax(scene, device="cpu") -> Scene:
    """The port's Scene from a JAX ``Scene``; raises for anything outside
    this slice (quads, spheres, a sphere light, a light list)."""
    if _count(scene.quads, "corner") or _count(scene.spheres, "radius"):
        raise NotImplementedError(
            "quads and spheres are not ported yet (ROADMAP.md queue 1, "
            "item 11)"
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
    f32, i64 = torch.float32, torch.int64
    r = scene.rects
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
    ls = LightSampler(
        corner=_leaf(light, "corner", f32, device),
        edge_u=_leaf(light, "edge_u", f32, device),
        edge_v=_leaf(light, "edge_v", f32, device),
        light_obj_id=int(np.asarray(light.light_obj_id)),
    )
    return Scene(rects=rects, light=ls)


def camera_from_jax(cam, device="cpu") -> CameraParams:
    """The port's CameraParams from a JAX ``CameraParams``."""
    return CameraParams(*(
        _leaf(cam, name, torch.float32, device)
        for name in CameraParams._fields
    ))
