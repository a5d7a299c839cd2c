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
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
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
    device = scene.device if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


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
    check_materials(scene)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    R = scene.rects.k.shape[0]
    if R > MAX_RECTS:
        raise NotImplementedError(
            f"the kernel takes at most {MAX_RECTS} rects, got {R}"
        )
    rects = scene.rects
    rect_f = np.ascontiguousarray(torch.cat(
        [rects.k[:, None], rects.lo, rects.hi, rects.albedo, rects.emission],
        dim=1,
    ).detach().cpu().numpy(), dtype=np.float32)
    rect_axis = np.ascontiguousarray(rects.axis.cpu().numpy(), dtype=np.int32)
    light = scene.light.to("cpu")
    area, n_light = sampling.light_area_normal(light)
    light_f = np.ascontiguousarray(torch.cat(
        [light.corner, light.edge_u, light.edge_v, n_light, area[None]]
    ).numpy(), dtype=np.float32)
    cam_f = np.ascontiguousarray(torch.cat(
        [t.detach().cpu() for t in (cam.origin, cam.lower_left,
                                    cam.horizontal, cam.vertical)]
    ).numpy(), dtype=np.float32)
    # The NEE fold needs the light to be absorbing (zero albedo).
    fold = int(float(rects.albedo[light.light_obj_id].max()) == 0.0)

    lib = _build.build_kernels().lib
    out_l = torch.empty((n_pix * g, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_nee(
            rect_f.ctypes.data, rect_axis.ctypes.data, R,
            light_f.ctypes.data, light.light_obj_id, cam_f.ctypes.data,
            int(seed) & 0xFFFFFFFF, cfg.width, cfg.height, cfg.spp,
            g, per, int(s0) & 0xFFFFFFFF,
            cfg.rr_start_depth, cfg.max_bounces, fold,
            out_l.data_ptr(), traces.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return _reduce(out_l, cfg, n_pix, g), traces
