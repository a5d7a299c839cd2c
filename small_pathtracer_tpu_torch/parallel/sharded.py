"""Sharded rendering over an (sp, dp) mesh (the port of the JAX package's
``parallel/sharded.py``).

Each rank renders its own (pixel block x sample range) share of the image
and nothing else: it derives the block from its mesh coordinate, the
bounce loop needs no communication (paths never migrate), and the per-pixel
radiance sums reduce over the sample axis with one all-reduce a span.
Every draw is a pure function of (seed, path id, counter) and a path id
uses the global pixel and the global spp, so each sample's radiance is the
unsharded sample's bit for bit; only the order of the sums differs.

``shard_layout`` is the lane layout of every sharded launch
(``ops/megakernel.py``, ``ops/megakernel_grad.py``,
``ops/megakernel_geom.py``). ``render_sharded`` is the whole render over the
mesh through row 7 (``render_megakernel_sharded``): the kernel on a CUDA
device, its plain version on the CPU. The JAX package's scan schedule
branch waits for ROADMAP.md item 14 (``RenderConfig`` refuses
``wavefront='scan'``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import film
from ..integrator.wavefront import lane_groups, lane_layout
from ..scene.types import Scene
from .mesh import Mesh

class ShardLayout(NamedTuple):
    """One rank's lanes: pixels [pix0, pix0 + n_pix_loc), samples [samp0,
    samp0 + g * per) of each, g lanes a pixel walking ``per`` samples each
    (lane i: pixel pix0 + i // g, samples samp0 + (i % g) * per + [0, per))."""

    pix0: int
    n_pix_loc: int
    samp0: int
    g: int
    per: int


def shard_layout(cfg: RenderConfig, n_s: int, mesh: Mesh, target_lanes: int,
                 s0: int = 0, what: str = "n_s") -> ShardLayout:
    """The lanes of ``mesh``'s coordinate for the span [s0, s0 + n_s): the
    pixels split over sp, the span over dp, g = lane_groups(n_pix_loc,
    n_s_loc, target_lanes, cfg.regen_groups) from the local counts (the JAX
    package's ``_build_render_sharded``). Raises the JAX ValueError when the
    pixels do not split over sp or the span over dp (``what`` names the span
    in the message: n_s, or spp for the train steps)."""
    n_sp, n_dp = mesh.n_sp, mesh.n_dp
    n_pix = cfg.width * cfg.height
    if n_pix % n_sp or n_s % n_dp:
        raise ValueError(f"n_pix={n_pix} % n_sp={n_sp} or {what}={n_s} % "
                         f"n_dp={n_dp} != 0")
    n_pix_loc, n_s_loc = n_pix // n_sp, n_s // n_dp
    g = lane_groups(n_pix_loc, n_s_loc, target_lanes, cfg.regen_groups)
    return ShardLayout(mesh.sp_idx * n_pix_loc, n_pix_loc,
                       int(s0) + mesh.dp_idx * n_s_loc, g, n_s_loc // g)


def shard_lanes(lay: ShardLayout, device):
    """(pix, s_start, s_stop) int64 tensors of the layout's lanes."""
    return lane_layout(lay.n_pix_loc, lay.g, lay.per, lay.samp0, device,
                       lay.pix0)


def reduce_lanes(L: torch.Tensor, lay: ShardLayout) -> torch.Tensor:
    """Per-lane radiance (n_pix_loc * g, 3) -> per-pixel sums (n_pix_loc,
    3), the lane groups of a pixel summed in order."""
    return L.reshape(lay.n_pix_loc, lay.g, 3).sum(dim=1)


def render_sharded(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                   mesh: Mesh):
    """The whole render over the mesh (spp divisible by dp, ValueError
    otherwise): each rank renders its share of all of spp in one
    ``render_megakernel_sharded`` call (row 7's kernel on a CUDA device,
    its plain version on the CPU), and every rank returns the whole image
    (gathered over sp). Returns (clamped linear (h, w, 3) image, total
    traces (extend + probe) of the mesh as an int)."""
    # ops.megakernel imports this module's layout.
    from ..ops.megakernel import render_megakernel_sharded

    if cfg.spp % mesh.n_dp:
        raise ValueError(f"spp ({cfg.spp}) not divisible by dp={mesh.n_dp}")
    L, traces = render_megakernel_sharded(scene, cam, cfg, mesh, cfg.seed)
    img = mesh.gather_sp(L).reshape(cfg.height, cfg.width, 3)
    return film.finalize(img / cfg.spp), int(traces.sum())
