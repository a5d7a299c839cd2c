"""Shirley-style pinhole camera with the box pixel filter.

basis: w = normalize(lookat - lookfrom), u = normalize(w x vup), v = u x w;
lower_left = origin - u*half_width - v*half_height + w. A primary ray for
pixel (px, py) with jitter (ju, jv) in [0, 1) aims at
``lower_left + s*horizontal + t*vertical`` with s = (px - 0.5 + ju)/width
and t = ((height - py - 1) - 0.5 + jv)/height (row 0 is the top), and is
normalized.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import rng, vecmath as vm
from ..device import resolve


class CameraParams(NamedTuple):
    origin: torch.Tensor      # (3,)
    lower_left: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor    # (3,)

    def to(self, device) -> "CameraParams":
        return CameraParams(*(t.to(device) for t in self))


LOOKFROM = (50.0, 40.0, 168.0)
LOOKAT = (50.0, 40.0, 5.0)
VUP = (0.0, 1.0, 0.0)
VFOV_DEG = 65.0


def make_camera(lookfrom=LOOKFROM, lookat=LOOKAT, vup=VUP,
                vfov_deg=VFOV_DEG, aspect: float = 1.0,
                device="cuda") -> CameraParams:
    """Camera constructor math in float32. It runs on the CPU whatever the
    target device, so every device renders from the same camera floats.
    The camera lands on ``device``, the card by default."""
    device = resolve(device)
    f32 = torch.float32
    lookfrom = torch.tensor(lookfrom, dtype=f32)
    lookat = torch.tensor(lookat, dtype=f32)
    vup = torch.tensor(vup, dtype=f32)
    theta = torch.tensor(vfov_deg, dtype=f32) * (math.pi / 180.0)
    half_height = torch.tan(theta / 2.0)
    half_width = aspect * half_height
    w = vm.norm(lookat - lookfrom)
    u = vm.norm(vm.cross(w, vup))
    v = vm.cross(u, w)
    lower_left = lookfrom - u * half_width - v * half_height + w
    return CameraParams(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=u * (2.0 * half_width),
        vertical=v * (2.0 * half_height),
    ).to(device)


def primary_rays(cam: CameraParams, width: int, height: int,
                 px: torch.Tensor, py: torch.Tensor,
                 jit_u: torch.Tensor, jit_v: torch.Tensor):
    """Normalized primary rays for pixel coordinates (px, py) with jitter in
    [0, 1). Returns (origins (N, 3), directions (N, 3))."""
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    # Divide by device tensors, not Python numbers: on CUDA, torch turns a
    # division by a CPU scalar into a multiply by its reciprocal, which
    # rounds differently from the kernel's (and the CPU's) true division.
    width_t = torch.tensor(float(width), device=px.device)
    height_t = torch.tensor(float(height), device=px.device)
    s = (px - 0.5 + jit_u) / width_t
    t = ((height_t - py - 1.0) - 0.5 + jit_v) / height_t
    d = (
        cam.lower_left
        + s[:, None] * cam.horizontal
        + t[:, None] * cam.vertical
        - cam.origin
    )
    d = vm.norm(d)
    return cam.origin.expand(d.shape), d


def primary_rays_cfg(cam: CameraParams, cfg, px, py, path_id, seed):
    """primary_rays with the camera jitter drawn at counters 0 and 1 (below
    rng.DRAWS_PER_BOUNCE, so they never collide with bounce draws)."""
    ju = rng.uniform_mix(seed, path_id, 0)
    jv = rng.uniform_mix(seed, path_id, 1)
    return primary_rays(cam, cfg.width, cfg.height, px, py, ju, jv)
