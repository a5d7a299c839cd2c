"""Scene presets. This slice ports ``cornell_box``: the reference's 17-rect
scene (6 walls, the light as object 6, and two 5-face boxes)."""

from __future__ import annotations

import torch

from ..device import resolve
from .types import DIFF, LightSampler, Scene, make_scene

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
    rects = _cornell_walls() + [
        # Tall box, x in [12, 42], y in [0, 50], z in [32, 62]
        (AX_Z, 32.0, (12.0, 0.0), (42.0, 50.0), _ONE, _ZERO, DIFF),
        (AX_Z, 62.0, (12.0, 0.0), (42.0, 50.0), _ONE, _ZERO, DIFF),
        (AX_X, 12.0, (0.0, 32.0), (50.0, 62.0), _ONE, _ZERO, DIFF),
        (AX_X, 42.0, (0.0, 32.0), (50.0, 62.0), _ONE, _ZERO, DIFF),
        (AX_Y, 50.0, (12.0, 32.0), (42.0, 62.0), _ONE, _ZERO, DIFF),
        # Short box, x in [63, 88], y in [0, 25], z in [63, 88]
        (AX_Z, 63.0, (63.0, 0.0), (88.0, 25.0), _ONE, _ZERO, DIFF),
        (AX_Z, 88.0, (63.0, 0.0), (88.0, 25.0), _ONE, _ZERO, DIFF),
        (AX_X, 63.0, (0.0, 63.0), (25.0, 88.0), _ONE, _ZERO, DIFF),
        (AX_X, 88.0, (0.0, 63.0), (25.0, 88.0), _ONE, _ZERO, DIFF),
        (AX_Y, 25.0, (63.0, 63.0), (88.0, 88.0), _ONE, _ZERO, DIFF),
    ]
    return make_scene(rects, _cornell_light_sampler(), device)


PRESETS = {"cornell_box": cornell_box}

# Presets of the JAX package that later slices port (ROADMAP.md queue 1,
# items 11 and 12).
NOT_PORTED = (
    "cornell_spheres", "cornell_spheres_roundlight", "smallpt_original",
    "smallpt_original_true", "cornell_tilted_light", "cornell_alcove",
    "cornell_alcove_baffled", "cornell_twolights", "cornell_glossy",
    "veach_mis", "sphere_grid", "sphere_grid_256", "sphere_grid_1024",
)


def get_scene(name: str, device="cuda") -> Scene:
    """The preset ``name`` on ``device`` (the card by default; raises
    RuntimeError when CUDA is absent and no other device is asked for)."""
    if name in PRESETS:
        return PRESETS[name](device)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scene preset {name!r} is not ported yet "
            "(ROADMAP.md queue 1, items 11-12)"
        )
    raise ValueError(
        f"unknown scene preset {name!r}; available: {sorted(PRESETS)}"
    )
