"""Scene presets, copies of the JAX package's:

- ``cornell_box``: the reference's 17-rect scene (6 walls, the light as
  object 6, and two 5-face boxes);
- ``cornell_spheres``: the same walls and light with two DIFF spheres;
- ``smallpt_original``: rect walls in smallpt's colours, the Cornell rect
  light, a SPEC mirror and a REFR glass sphere;
- ``sphere_grid(n, seed)``: the Cornell walls and light with an n-sphere
  grid of random albedos, about 15% of them SPEC mirrors (64 by default;
  ``sphere_grid_256`` and ``sphere_grid_1024`` are the larger rungs);
- ``cornell_alcove`` and ``cornell_alcove_baffled``: the hard-transport
  scenes path guiding exists for, a room lit only through a slot in its
  ceiling from a light in an alcove above it (24 and 25 rects);
- ``cornell_tilted_light``: the Cornell box with its light replaced by a
  quad pitched 15 degrees about x (16 rects, the light quad id 16);
- ``cornell_glossy``: the Cornell walls and light with a GLOS
  (modified-Phong, exponent 60) sphere beside a diffuse one."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve
from .types import DIFF, GLOS, REFR, SPEC, LightSampler, Scene, make_scene

AX_X, AX_Y, AX_Z = 0, 1, 2

_WHITE75 = (0.75, 0.75, 0.75)
_ZERO = (0.0, 0.0, 0.0)
_ONE = (1.0, 1.0, 1.0)


def _cornell_walls() -> list[tuple]:
    return [
        # (axis, k, (lo0, lo1), (hi0, hi1), albedo, emission, refl)
        (AX_Z, 0.0, (1.0, 0.0), (99.0, 81.6), _WHITE75, _ZERO, DIFF),    # front
        (AX_Z, 170.0, (1.0, 0.0), (99.0, 81.6), _WHITE75, _ZERO, DIFF),  # back
        (AX_X, 1.0, (0.0, 0.0), (81.6, 170.0), (0.25, 0.75, 0.25), _ZERO, DIFF),  # left
        (AX_X, 99.0, (0.0, 0.0), (81.6, 170.0), (0.75, 0.25, 0.25), _ZERO, DIFF),  # right
        (AX_Y, 0.0, (1.0, 0.0), (99.0, 170.0), _WHITE75, _ZERO, DIFF),   # bottom
        (AX_Y, 81.6, (1.0, 0.0), (99.0, 170.0), _WHITE75, _ZERO, DIFF),  # top
        (AX_Y, 81.5, (32.0, 63.0), (68.0, 96.0), _ZERO, (12.0, 12.0, 12.0), DIFF),  # light, id 6
    ]


def _cornell_light_sampler() -> LightSampler:
    """x in [32, 68], z in [63, 99] on the y = 81.6 plane (the reference's
    constants: the sampled square overshoots the light rect, and its plane
    is the ceiling's, 0.1 above the light); area 36*36 = 1296."""
    f32 = torch.float32
    return LightSampler(
        corner=torch.tensor([32.0, 81.6, 63.0], dtype=f32),
        edge_u=torch.tensor([36.0, 0.0, 0.0], dtype=f32),
        edge_v=torch.tensor([0.0, 0.0, 36.0], dtype=f32),
        light_obj_id=6,
    )


def cornell_box(device="cuda") -> Scene:
    device = resolve(device)
    # Tall box x in [12, 42], y in [0, 50], z in [32, 62]; short box x in
    # [63, 88], y in [0, 25], z in [63, 88].
    rects = _cornell_walls() + _cornell_boxes(_ONE)
    return make_scene(rects, _cornell_light_sampler(), device=device)


def cornell_spheres(device="cuda") -> Scene:
    device = resolve(device)
    spheres = [
        ((27.0, 16.5, 47.0), 16.5, (0.999, 0.999, 0.999), _ZERO, DIFF),
        ((73.0, 16.5, 78.0), 16.5, _WHITE75, _ZERO, DIFF),
    ]
    return make_scene(_cornell_walls(), _cornell_light_sampler(), spheres,
                      device)


def smallpt_original(device="cuda") -> Scene:
    device = resolve(device)
    rects = [
        (AX_Z, 0.0, (1.0, 0.0), (99.0, 81.6), _WHITE75, _ZERO, DIFF),  # back (grey)
        (AX_Z, 170.0, (1.0, 0.0), (99.0, 81.6), _ZERO, _ZERO, DIFF),  # front (black)
        (AX_X, 1.0, (0.0, 0.0), (81.6, 170.0), (0.75, 0.25, 0.25), _ZERO, DIFF),  # left red
        (AX_X, 99.0, (0.0, 0.0), (81.6, 170.0), (0.25, 0.25, 0.75), _ZERO, DIFF),  # right blue
        (AX_Y, 0.0, (1.0, 0.0), (99.0, 170.0), _WHITE75, _ZERO, DIFF),  # floor
        (AX_Y, 81.6, (1.0, 0.0), (99.0, 170.0), _WHITE75, _ZERO, DIFF),  # ceiling
        (AX_Y, 81.5, (32.0, 63.0), (68.0, 96.0), _ZERO, (12.0, 12.0, 12.0), DIFF),  # light
    ]
    spheres = [
        ((27.0, 16.5, 47.0), 16.5, (0.999, 0.999, 0.999), _ZERO, SPEC),  # mirror
        ((73.0, 16.5, 78.0), 16.5, (0.999, 0.999, 0.999), _ZERO, REFR),  # glass
    ]
    return make_scene(rects, _cornell_light_sampler(), spheres, device)


def _cornell_boxes(albedo) -> list[tuple]:
    """The tall and the short box of cornell_box, all ten faces in
    ``albedo``."""
    return [
        (AX_Z, 32.0, (12.0, 0.0), (42.0, 50.0), albedo, _ZERO, DIFF),
        (AX_Z, 62.0, (12.0, 0.0), (42.0, 50.0), albedo, _ZERO, DIFF),
        (AX_X, 12.0, (0.0, 32.0), (50.0, 62.0), albedo, _ZERO, DIFF),
        (AX_X, 42.0, (0.0, 32.0), (50.0, 62.0), albedo, _ZERO, DIFF),
        (AX_Y, 50.0, (12.0, 32.0), (42.0, 62.0), albedo, _ZERO, DIFF),
        (AX_Z, 63.0, (63.0, 0.0), (88.0, 25.0), albedo, _ZERO, DIFF),
        (AX_Z, 88.0, (63.0, 0.0), (88.0, 25.0), albedo, _ZERO, DIFF),
        (AX_X, 63.0, (0.0, 63.0), (25.0, 88.0), albedo, _ZERO, DIFF),
        (AX_X, 88.0, (0.0, 63.0), (25.0, 88.0), albedo, _ZERO, DIFF),
        (AX_Y, 25.0, (63.0, 63.0), (88.0, 88.0), albedo, _ZERO, DIFF),
    ]


def _light(corner, edge_u, edge_v, obj_id: int) -> LightSampler:
    f32 = torch.float32
    return LightSampler(corner=torch.tensor(corner, dtype=f32),
                        edge_u=torch.tensor(edge_u, dtype=f32),
                        edge_v=torch.tensor(edge_v, dtype=f32),
                        light_obj_id=obj_id)


def cornell_alcove(device="cuda") -> Scene:
    """The only light sits at the top of an alcove above the ceiling, seen
    from the room only through a 10 x 33 slot (x in [45, 55], z in
    [63, 96]). Ids: 0-4 front, back, left, right walls and floor, 5-8 the
    ceiling around the slot, 9-12 the alcove's walls, 13 the light
    (y = 94), 14-23 the two boxes."""
    device = resolve(device)
    ceiling = [
        (AX_Y, 81.6, (1.0, 0.0), (45.0, 170.0), _WHITE75, _ZERO, DIFF),
        (AX_Y, 81.6, (55.0, 0.0), (99.0, 170.0), _WHITE75, _ZERO, DIFF),
        (AX_Y, 81.6, (45.0, 0.0), (55.0, 63.0), _WHITE75, _ZERO, DIFF),
        (AX_Y, 81.6, (45.0, 96.0), (55.0, 170.0), _WHITE75, _ZERO, DIFF),
    ]
    cavity = [
        (AX_X, 45.0, (81.6, 63.0), (94.0, 96.0), _WHITE75, _ZERO, DIFF),
        (AX_X, 55.0, (81.6, 63.0), (94.0, 96.0), _WHITE75, _ZERO, DIFF),
        (AX_Z, 63.0, (45.0, 81.6), (55.0, 94.0), _WHITE75, _ZERO, DIFF),
        (AX_Z, 96.0, (45.0, 81.6), (55.0, 94.0), _WHITE75, _ZERO, DIFF),
    ]
    light_rect = [(AX_Y, 94.0, (45.0, 63.0), (55.0, 96.0), _ZERO,
                   (40.0, 40.0, 40.0), DIFF)]
    rects = (_cornell_walls()[:5] + ceiling + cavity + light_rect
             + _cornell_boxes(_ONE))
    return make_scene(rects, _light((45.0, 94.0, 63.0), (10.0, 0.0, 0.0),
                                    (0.0, 0.0, 33.0), 13), device=device)


def cornell_alcove_baffled(device="cuda") -> Scene:
    """cornell_alcove with the light on the alcove's side wall (x = 45.5,
    facing +x) and a dark room (albedo 0.35, boxes 0.45): no point of the
    floor sees the light through the slot, and the image is mostly
    two-bounce light (room, slot, the lit x = 55 alcove wall, light). Ids:
    0-4 walls and floor, 5-8 the ceiling around the slot, 9-13 the alcove's
    walls and top, 14 the light, 15-24 the boxes."""
    device = resolve(device)
    dark, boxes = (0.35, 0.35, 0.35), (0.45, 0.45, 0.45)
    walls = [
        (AX_Z, 0.0, (1.0, 0.0), (99.0, 81.6), dark, _ZERO, DIFF),
        (AX_Z, 170.0, (1.0, 0.0), (99.0, 81.6), dark, _ZERO, DIFF),
        (AX_X, 1.0, (0.0, 0.0), (81.6, 170.0), (0.15, 0.45, 0.15), _ZERO, DIFF),
        (AX_X, 99.0, (0.0, 0.0), (81.6, 170.0), (0.45, 0.15, 0.15), _ZERO, DIFF),
        (AX_Y, 0.0, (1.0, 0.0), (99.0, 170.0), dark, _ZERO, DIFF),
    ]
    ceiling = [
        (AX_Y, 81.6, (1.0, 0.0), (45.0, 170.0), dark, _ZERO, DIFF),
        (AX_Y, 81.6, (55.0, 0.0), (99.0, 170.0), dark, _ZERO, DIFF),
        (AX_Y, 81.6, (45.0, 0.0), (55.0, 63.0), dark, _ZERO, DIFF),
        (AX_Y, 81.6, (45.0, 96.0), (55.0, 170.0), dark, _ZERO, DIFF),
    ]
    cavity = [
        (AX_X, 45.0, (81.6, 63.0), (94.0, 96.0), _WHITE75, _ZERO, DIFF),
        (AX_X, 55.0, (81.6, 63.0), (94.0, 96.0), _WHITE75, _ZERO, DIFF),
        (AX_Z, 63.0, (45.0, 81.6), (55.0, 94.0), _WHITE75, _ZERO, DIFF),
        (AX_Z, 96.0, (45.0, 81.6), (55.0, 94.0), _WHITE75, _ZERO, DIFF),
        (AX_Y, 94.0, (45.0, 63.0), (55.0, 96.0), _WHITE75, _ZERO, DIFF),
    ]
    # 0.5 inside the x = 45 wall, so that wall is behind the two-sided
    # light and no probe from the room's ceiling reaches it.
    light_rect = [(AX_X, 45.5, (81.6, 63.0), (94.0, 96.0), _ZERO,
                   (40.0, 40.0, 40.0), DIFF)]
    rects = walls + ceiling + cavity + light_rect + _cornell_boxes(boxes)
    return make_scene(rects, _light((45.5, 81.6, 63.0), (0.0, 12.4, 0.0),
                                    (0.0, 0.0, 33.0), 14), device=device)


def cornell_tilted_light(device="cuda") -> Scene:
    """The Cornell box with its light (rect 6) replaced by a quad hung
    below the ceiling, pitched 15 degrees about x: corner (32, 78, 63),
    edge_u (36, 0, 0), edge_v (0, 36 sin 15, 36 cos 15). The NEE sampler
    is the quad itself. Ids: 16 rects (0-15), the light quad 16."""
    device = resolve(device)
    walls = [r for i, r in enumerate(_cornell_walls()) if i != 6]
    corner = (32.0, 78.0, 63.0)
    edge_u = (36.0, 0.0, 0.0)
    tilt = math.radians(15.0)
    edge_v = (0.0, 36.0 * math.sin(tilt), 36.0 * math.cos(tilt))
    quads = [(corner, edge_u, edge_v, _ZERO, (12.0, 12.0, 12.0), DIFF)]
    return make_scene(walls + _cornell_boxes(_ONE),
                      _light(corner, edge_u, edge_v, 16), device=device,
                      quads=quads)


def cornell_glossy(device="cuda") -> Scene:
    """The Cornell walls and light with a GLOS sphere (exponent 60) beside
    a diffuse one; it renders under cosine, nee_textbook and mis."""
    device = resolve(device)
    spheres = [
        ((27.0, 16.5, 47.0), 16.5, (0.999, 0.999, 0.999), _ZERO, GLOS, 60.0),
        ((73.0, 16.5, 78.0), 16.5, _WHITE75, _ZERO, DIFF),
    ]
    return make_scene(_cornell_walls(), _cornell_light_sampler(), spheres,
                      device)


def sphere_grid(n: int = 64, seed: int = 0, device="cuda") -> Scene:
    """The Cornell walls and light with n radius-4 spheres on a grid. The
    albedos and the 15% SPEC choice are drawn from
    ``np.random.default_rng(seed)`` in the JAX preset's order, so the
    leaves equal its bit for bit."""
    device = resolve(device)
    rng_ = np.random.default_rng(seed)
    side = max(1, math.ceil(n ** (1 / 3)))
    spheres = []
    i = 0
    for gx in range(side):
        for gy in range(side):
            for gz in range(side):
                if i >= n:
                    break
                c = (
                    20.0 + 60.0 * gx / max(1, side - 1),
                    8.0 + 50.0 * gy / max(1, side - 1),
                    30.0 + 100.0 * gz / max(1, side - 1),
                )
                alb = tuple(float(a) for a in rng_.uniform(0.3, 0.95, 3))
                refl = SPEC if rng_.uniform() < 0.15 else DIFF
                spheres.append((c, 4.0, alb, _ZERO, refl))
                i += 1
    return make_scene(_cornell_walls(), _cornell_light_sampler(), spheres,
                      device)


PRESETS = {
    "cornell_box": cornell_box,
    "cornell_spheres": cornell_spheres,
    "smallpt_original": smallpt_original,
    "sphere_grid": sphere_grid,
    "sphere_grid_256": functools.partial(sphere_grid, 256),
    "sphere_grid_1024": functools.partial(sphere_grid, 1024),
    "cornell_alcove": cornell_alcove,
    "cornell_alcove_baffled": cornell_alcove_baffled,
    "cornell_tilted_light": cornell_tilted_light,
    "cornell_glossy": cornell_glossy,
}

# Presets of the JAX package that later slices port (ROADMAP.md queue 1,
# item 12: light lists and sphere lights).
NOT_PORTED = (
    "cornell_spheres_roundlight", "smallpt_original_true",
    "cornell_twolights", "veach_mis",
)


def get_scene(name: str, device="cuda") -> Scene:
    """The preset ``name`` on ``device`` (the card by default; raises
    RuntimeError when CUDA is absent and no other device is asked for)."""
    if name in PRESETS:
        return PRESETS[name](device=device)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scene preset {name!r} is not ported yet "
            "(ROADMAP.md queue 1, item 12)"
        )
    raise ValueError(
        f"unknown scene preset {name!r}; available: {sorted(PRESETS)}"
    )
