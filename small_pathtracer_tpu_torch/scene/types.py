"""Scene representation: struct-of-arrays NamedTuples of tensors.

Global object ids run over the rects first, then the spheres (the JAX
package's order, with its quads in between: this port has none yet), so the
Cornell light stays rect 6. This slice of the port holds axis-aligned rects,
spheres and one parallelogram light; quads, sphere lights and light lists
come with ROADMAP.md queue 1, items 11 and 12.
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


class Spheres(NamedTuple):
    """Spheres. center: (S, 3); radius: (S,); albedo, emission: (S, 3);
    refl: (S,) int64 material code; gloss: (S,) Phong exponent."""

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    refl: torch.Tensor
    gloss: torch.Tensor

    def to(self, device) -> "Spheres":
        return Spheres(*(t.to(device) for t in self))


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
    spheres: Spheres
    light: LightSampler

    @property
    def device(self) -> torch.device:
        return self.rects.k.device

    def to(self, device) -> "Scene":
        return Scene(self.rects.to(device), self.spheres.to(device),
                     self.light.to(device))


def make_scene(rects: list[tuple], light: LightSampler,
               spheres: list[tuple] = (), device="cpu") -> Scene:
    """Build a Scene from lists of rects
    (axis, k, (lo0, lo1), (hi0, hi1), albedo3, emission3, refl[, gloss])
    and spheres (center3, radius, albedo3, emission3, refl[, gloss])."""
    if not rects:
        raise ValueError("a scene needs at least one rect")
    f32, i64 = torch.float32, torch.int64

    def gloss(items, n_base):
        return torch.tensor(
            [float(x[n_base]) if len(x) > n_base else 0.0 for x in items],
            dtype=f32,
        )

    r = Rects(
        axis=torch.tensor([x[0] for x in rects], dtype=i64),
        k=torch.tensor([x[1] for x in rects], dtype=f32),
        lo=torch.tensor([x[2] for x in rects], dtype=f32),
        hi=torch.tensor([x[3] for x in rects], dtype=f32),
        albedo=torch.tensor([x[4] for x in rects], dtype=f32),
        emission=torch.tensor([x[5] for x in rects], dtype=f32),
        refl=torch.tensor([x[6] for x in rects], dtype=i64),
        gloss=gloss(rects, 7),
    )
    s = Spheres(
        center=torch.tensor([x[0] for x in spheres],
                            dtype=f32).reshape(-1, 3),
        radius=torch.tensor([x[1] for x in spheres], dtype=f32),
        albedo=torch.tensor([x[2] for x in spheres],
                            dtype=f32).reshape(-1, 3),
        emission=torch.tensor([x[3] for x in spheres],
                              dtype=f32).reshape(-1, 3),
        refl=torch.tensor([x[4] for x in spheres], dtype=i64),
        gloss=gloss(spheres, 5),
    )
    return Scene(rects=r, spheres=s, light=light).to(device)


def num_spheres(scene: Scene) -> int:
    return scene.spheres.radius.shape[0]


def object_arrays(scene: Scene):
    """Per-object (albedo, emission, refl) in global-id order: (K, 3),
    (K, 3), (K,) with K = R + S."""
    r, s = scene.rects, scene.spheres
    return (torch.cat([r.albedo, s.albedo]),
            torch.cat([r.emission, s.emission]),
            torch.cat([r.refl, s.refl]))
