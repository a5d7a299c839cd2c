"""Scene representation: struct-of-arrays NamedTuples of tensors.

Global object ids run over the rects first, then the quads, then the
spheres (the JAX package's order), so the Cornell light stays rect 6. This
slice of the port holds axis-aligned rects, general parallelograms (quads),
spheres and one parallelogram light, which may be a rect or a quad; sphere
lights and light lists come with ROADMAP.md queue 1, item 12.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve

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


class Quads(NamedTuple):
    """General (possibly tilted) parallelograms, two-sided: point = corner
    + a*edge_u + b*edge_v, a, b in [0, 1]. corner, edge_u, edge_v, albedo,
    emission: (Q, 3); refl: (Q,) int64 material code; gloss: (Q,) Phong
    exponent."""

    corner: torch.Tensor
    edge_u: torch.Tensor
    edge_v: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    refl: torch.Tensor
    gloss: torch.Tensor

    def to(self, device) -> "Quads":
        return Quads(*(t.to(device) for t in self))


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
    """Global object ids: rects (0..R-1), quads (R..R+Q-1), spheres
    (R+Q..R+Q+S-1)."""

    rects: Rects
    quads: Quads
    spheres: Spheres
    light: LightSampler

    @property
    def device(self) -> torch.device:
        return self.rects.k.device

    def to(self, device) -> "Scene":
        return Scene(self.rects.to(device), self.quads.to(device),
                     self.spheres.to(device), self.light.to(device))


def make_scene(rects: list[tuple], light: LightSampler,
               spheres: list[tuple] = (), device="cuda",
               quads: list[tuple] = ()) -> Scene:
    """Build a Scene from lists of rects
    (axis, k, (lo0, lo1), (hi0, hi1), albedo3, emission3, refl[, gloss]),
    spheres (center3, radius, albedo3, emission3, refl[, gloss]) and quads
    (corner3, edge_u3, edge_v3, albedo3, emission3, refl[, gloss]) on
    ``device``, the card by default (RuntimeError without CUDA)."""
    device = resolve(device)
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
    q = Quads(
        *(torch.tensor([x[i] for x in quads], dtype=f32).reshape(-1, 3)
          for i in range(5)),
        refl=torch.tensor([x[5] for x in quads], dtype=i64),
        gloss=gloss(quads, 6),
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
    return Scene(rects=r, quads=q, spheres=s, light=light).to(device)


def num_spheres(scene: Scene) -> int:
    return scene.spheres.radius.shape[0]


def num_quads(scene: Scene) -> int:
    return scene.quads.corner.shape[0]


def object_arrays(scene: Scene):
    """Per-object (albedo, emission, refl) in global-id order: (K, 3),
    (K, 3), (K,) with K = R + Q + S."""
    r, q, s = scene.rects, scene.quads, scene.spheres
    return (torch.cat([r.albedo, q.albedo, s.albedo]),
            torch.cat([r.emission, q.emission, s.emission]),
            torch.cat([r.refl, q.refl, s.refl]))


def gloss_arrays(scene: Scene) -> torch.Tensor:
    """Per-object Phong exponent (K,) in global-id order (0 where the
    object is not GLOS)."""
    return torch.cat([scene.rects.gloss, scene.quads.gloss,
                      scene.spheres.gloss])


def object_refl(scene: Scene) -> torch.Tensor:
    """Per-object material codes (K,) in global-id order."""
    return torch.cat([scene.rects.refl, scene.quads.refl, scene.spheres.refl])


def has_glos(scene: Scene) -> bool:
    return bool((object_refl(scene) == GLOS).any())


def insert_rect(scene: Scene, pos: int, src: int, albedo=None,
                emission=None) -> Scene:
    """The scene with a copy of rect ``src`` inserted at id ``pos``, its
    albedo or emission replaced where given; the light's id follows. The
    copy ties with ``src`` on every ray, which the rect scans break by the
    smaller id."""
    return _insert_copy(scene, "rects", 0, pos, src, albedo, emission)


def insert_quad(scene: Scene, pos: int, src: int, albedo=None,
                emission=None) -> Scene:
    """insert_rect for quads: a copy of quad ``src`` at quad index ``pos``
    (object id R + pos)."""
    return _insert_copy(scene, "quads", scene.rects.k.shape[0], pos, src,
                        albedo, emission)


def _insert_copy(scene: Scene, block: str, base: int, pos: int, src: int,
                 albedo, emission) -> Scene:
    """A copy of row ``src`` of ``block`` (whose first object id is
    ``base``) inserted at row ``pos``, albedo or emission replaced where
    given; the light's id follows."""
    new = {"albedo": albedo, "emission": emission}
    rows = getattr(scene, block)

    def field(name, t):
        row = t[src:src + 1].clone()
        if new.get(name) is not None:
            row[0] = torch.tensor(new[name], dtype=row.dtype)
        return torch.cat([t[:pos], row, t[pos:]])

    rows = type(rows)(*(field(n, t) for n, t in zip(rows._fields, rows)))
    lid = scene.light.light_obj_id
    return scene._replace(**{block: rows}, light=scene.light._replace(
        light_obj_id=lid + (base + pos <= lid)))
