"""Scene representation: struct-of-arrays NamedTuples of tensors.

Global object ids run over the rects in order (the Cornell light is rect 6).
This slice of the port holds axis-aligned rects and one parallelogram light;
quads, spheres, sphere lights and light lists come with ROADMAP.md queue 1,
items 11 and 12.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Material codes (the reference's Refl_t, plus the GLOS extension).
DIFF = 0
SPEC = 1
REFR = 2
GLOS = 3

# For normal axis a, OTHER_AXES[a] are the two bounded in-plane axes.
OTHER_AXES = ((1, 2), (0, 2), (0, 1))


class Rects(NamedTuple):
    """Axis-aligned rectangles.

    axis: (R,) int64 normal axis (0 = x, 1 = y, 2 = z); k: (R,) plane
    offset; lo, hi: (R, 2) bounds on OTHER_AXES[axis]; albedo, emission:
    (R, 3); refl: (R,) int64 material code; gloss: (R,) Phong exponent."""

    axis: torch.Tensor
    k: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    refl: torch.Tensor
    gloss: torch.Tensor

    def to(self, device) -> "Rects":
        return Rects(*(t.to(device) for t in self))


class LightSampler(NamedTuple):
    """The NEE parallelogram: point = corner + u*edge_u + v*edge_v.

    light_obj_id is the global object id whose nearest hit counts as
    reaching the light."""

    corner: torch.Tensor  # (3,)
    edge_u: torch.Tensor  # (3,)
    edge_v: torch.Tensor  # (3,)
    light_obj_id: int

    def to(self, device) -> "LightSampler":
        return LightSampler(self.corner.to(device), self.edge_u.to(device),
                            self.edge_v.to(device), self.light_obj_id)


class Scene(NamedTuple):
    rects: Rects
    light: LightSampler

    @property
    def device(self) -> torch.device:
        return self.rects.k.device

    def to(self, device) -> "Scene":
        return Scene(self.rects.to(device), self.light.to(device))


def make_scene(rects: list[tuple], light: LightSampler,
               device="cpu") -> Scene:
    """Build a Scene from a list of
    (axis, k, (lo0, lo1), (hi0, hi1), albedo3, emission3, refl[, gloss])."""
    if not rects:
        raise ValueError("a scene needs at least one rect")
    f32, i64 = torch.float32, torch.int64
    r = Rects(
        axis=torch.tensor([x[0] for x in rects], dtype=i64),
        k=torch.tensor([x[1] for x in rects], dtype=f32),
        lo=torch.tensor([x[2] for x in rects], dtype=f32),
        hi=torch.tensor([x[3] for x in rects], dtype=f32),
        albedo=torch.tensor([x[4] for x in rects], dtype=f32),
        emission=torch.tensor([x[5] for x in rects], dtype=f32),
        refl=torch.tensor([x[6] for x in rects], dtype=i64),
        gloss=torch.tensor(
            [float(x[7]) if len(x) > 7 else 0.0 for x in rects], dtype=f32
        ),
    )
    return Scene(rects=r, light=light).to(device)


def object_arrays(scene: Scene):
    """Per-object (albedo, emission, refl) in global-id order."""
    r = scene.rects
    return r.albedo, r.emission, r.refl
