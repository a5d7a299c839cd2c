"""Host wrapper of the CUDA megakernel (``csrc/megakernel.cu``): the port's
counterpart of the JAX package's ``render_pallas`` / ``render_pallas_span``.

Lane layout of ``_build_render``: ``g = lane_groups(n_pix, n_s, 2^18,
cfg.regen_groups)`` lanes per pixel, each walking ``n_s // g`` samples of the
span [s0, s0 + n_s). Lane i renders pixel i // g; the per-lane radiance sums
are reduced over g by the wrapper, so the kernel and its plain version share
that reduction.

On a CUDA device the wrapper builds (once) and launches the kernel, or
raises. On the CPU it runs the plain version: the eager
``integrator.wavefront.path_trace_regen`` on the same lane layout.
``pack_geometry`` and ``launch_args`` also serve the runtime-material
kernels of ``ops/megakernel_grad.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..device import resolve
from ..integrator import sampling
from ..integrator.wavefront import (
    check_materials, lane_groups, lane_layout, path_trace_regen,
)
from ..scene.types import Scene
from . import _build

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch, and nowhere else).
LAUNCHES = 0

TARGET_LANES = 1 << 18
MAX_RECTS = 32


def _layout(cfg: RenderConfig, n_s: int):
    n_pix = cfg.width * cfg.height
    g = lane_groups(n_pix, n_s, TARGET_LANES, cfg.regen_groups)
    return n_pix, g, n_s // g


def _resolve(scene: Scene, device) -> torch.device:
    return resolve(scene.device if device is None else device)


def _reduce(L: torch.Tensor, cfg: RenderConfig, n_pix: int, g: int):
    return L.reshape(n_pix, g, 3).sum(dim=1).reshape(cfg.height, cfg.width, 3)


def render_megakernel_plain(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, seed, s0: int = 0,
                            n_s: int | None = None, device=None):
    """The kernel's plain version: the eager regenerating wavefront on the
    kernel's lane layout. Returns ((h, w, 3) radiance sum over the span,
    traces (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    pix, s_start, s_stop = lane_layout(n_pix, g, per, int(s0), device)
    L, traces = path_trace_regen(scene.to(device), cfg, int(seed),
                                 cam.to(device), pix, s_start, s_stop)
    return _reduce(L, cfg, n_pix, g), traces


class KernelGeometry(NamedTuple):
    """What the kernels take from the scene and camera besides materials,
    packed once on the host (float32 / int32 numpy arrays)."""

    rect_geom: np.ndarray  # (R, 5) [k, lo0, lo1, hi0, hi1]
    rect_axis: np.ndarray  # (R,) int32
    light_f: np.ndarray    # (13,) [corner, edge_u, edge_v, unit normal, area]
    light_id: int
    cam_f: np.ndarray      # (12,) [origin, lower_left, horizontal, vertical]


def _host_f32(tensors) -> np.ndarray:
    """(R, c0 + c1 + ...) float32 host array from (R, ci) tensors."""
    return np.ascontiguousarray(torch.cat(
        [t.detach().cpu() for t in tensors], dim=1).numpy(), dtype=np.float32)


def pack_geometry(scene: Scene, cam: CameraParams) -> KernelGeometry:
    """Pack the scene's rects, light and the camera for the kernels (one
    host copy; a training loop packs once and reuses the result). Raises
    for a scene the kernels do not take."""
    check_materials(scene)
    rects = scene.rects
    R = rects.k.shape[0]
    if R > MAX_RECTS:
        raise NotImplementedError(
            f"the kernel takes at most {MAX_RECTS} rects, got {R}"
        )
    light = scene.light.to("cpu")
    area, n_light = sampling.light_area_normal(light)
    light_f = np.ascontiguousarray(torch.cat(
        [light.corner, light.edge_u, light.edge_v, n_light, area[None]]
    ).numpy(), dtype=np.float32)
    cam_f = np.ascontiguousarray(torch.cat(
        [t.detach().cpu() for t in (cam.origin, cam.lower_left,
                                    cam.horizontal, cam.vertical)]
    ).numpy(), dtype=np.float32)
    return KernelGeometry(
        rect_geom=_host_f32([rects.k[:, None], rects.lo, rects.hi]),
        rect_axis=np.ascontiguousarray(rects.axis.cpu().numpy(),
                                       dtype=np.int32),
        light_f=light_f,
        light_id=int(light.light_obj_id),
        cam_f=cam_f,
    )


def launch_args(geom: KernelGeometry, cfg: RenderConfig, seed, g: int,
                per: int, s0: int) -> tuple:
    """The arguments every kernel entry point takes after ``n_rects``: light,
    camera and the launch settings."""
    return (
        geom.light_f.ctypes.data, geom.light_id,
        geom.cam_f.ctypes.data, int(seed) & 0xFFFFFFFF, cfg.width,
        cfg.height, cfg.spp, g, per, int(s0) & 0xFFFFFFFF,
        cfg.rr_start_depth, cfg.max_bounces,
    )


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def render_megakernel(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      seed, s0: int = 0, n_s: int | None = None,
                      device=None):
    """Render sample indices [s0, s0 + n_s) of every pixel (all of spp by
    default) on ``device`` (the scene's by default): the CUDA kernel on a
    CUDA device, the plain version on the CPU. Returns ((h, w, 3) radiance
    sum over the span, traces (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_plain(scene, cam, cfg, seed, s0, n_s,
                                       device)
    global LAUNCHES
    geom = pack_geometry(scene, cam)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    rects = scene.rects
    alb = _host_f32([rects.albedo])
    emi = _host_f32([rects.emission])
    # The NEE fold needs the light to be absorbing (zero albedo).
    fold = int(float(alb[geom.light_id].max()) == 0.0)

    lib = _build.build_kernels().lib
    out_l = torch.empty((n_pix * g, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_nee(
            geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
            alb.ctypes.data, emi.ctypes.data, len(geom.rect_axis),
            *launch_args(geom, cfg, seed, g, per, s0), fold,
            out_l.data_ptr(), traces.data_ptr(), stream,
        )
    check_launch(err, "megakernel_nee")
    LAUNCHES += 1
    return _reduce(out_l, cfg, n_pix, g), traces
