"""Host wrappers of the CUDA render megakernels (``csrc/megakernel.cu``): the
port's counterpart of the JAX package's ``render_pallas`` /
``render_pallas_span``.

- ``megakernel_nee`` (row 1 of the kernel table in ROADMAP.md) renders
  rect-only DIFF scenes, with the materials baked into its parameters.
- ``megakernel_nee_tab`` (row 2, the JAX sphere-table kernel) renders every
  scene with spheres or SPEC/REFR objects: the sphere rows and the
  material tables are device tensors.
- ``megakernel_nee_budgets`` and ``megakernel_nee_tab_budgets`` (row 3, the
  JAX ``render_pallas_budgets``) are rows 1 and 2 with per-pixel sample
  budgets: ``render_megakernel_budgets``, the unit of an adaptive wave
  (``utils/adaptive.py``).

Lane layout of ``_build_render``: ``g = lane_groups(n_pix, n_s, 2^18,
cfg.regen_groups)`` lanes per pixel, each walking ``n_s // g`` samples of the
span [s0, s0 + n_s). Lane i renders pixel i // g; the per-lane radiance sums
are reduced over g by the wrapper, so the kernel and its plain version share
that reduction.

On a CUDA device a wrapper builds (once) and launches a kernel, or raises.
On the CPU it runs the plain version, for every kernel: the eager
``integrator.wavefront.path_trace_regen`` on the same lanes.
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
from ..scene.types import Scene, num_spheres, object_arrays
from . import _build

# Launches of each CUDA kernel in this process (the wrapper adds one per
# launch of its kernel, and nowhere else): megakernel_nee,
# megakernel_nee_tab, megakernel_nee_budgets, megakernel_nee_tab_budgets.
LAUNCHES = 0
LAUNCHES_TAB = 0
LAUNCHES_BUDGETS = 0
LAUNCHES_TAB_BUDGETS = 0

TARGET_LANES = 1 << 18
MAX_RECTS = 32
MAX_SPHERES = 4096  # kMaxSpheres in csrc/megakernel_common.cuh


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


def _head_args(geom: KernelGeometry, cfg: RenderConfig, seed) -> tuple:
    return (
        geom.light_f.ctypes.data, geom.light_id,
        geom.cam_f.ctypes.data, int(seed) & 0xFFFFFFFF, cfg.width,
        cfg.height, cfg.spp,
    )


def launch_args(geom: KernelGeometry, cfg: RenderConfig, seed, g: int,
                per: int, s0: int) -> tuple:
    """The arguments every kernel entry point takes after ``n_rects``: light,
    camera and the launch settings."""
    return (*_head_args(geom, cfg, seed), g, per, int(s0) & 0xFFFFFFFF,
            cfg.rr_start_depth, cfg.max_bounces)


def _budget_args(geom: KernelGeometry, cfg: RenderConfig, seed) -> tuple:
    """launch_args of the budget kernels: one lane a pixel, so no g, per or
    s0."""
    return (*_head_args(geom, cfg, seed), cfg.rr_start_depth,
            cfg.max_bounces)


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def uses_sphere_table(scene: Scene) -> bool:
    """Whether the card renders ``scene`` with megakernel_nee_tab: it holds
    spheres or SPEC/REFR objects (raises for GLOS objects)."""
    spec_refr = check_materials(scene)
    return num_spheres(scene) > 0 or spec_refr


def render_megakernel(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      seed, s0: int = 0, n_s: int | None = None,
                      device=None):
    """Render sample indices [s0, s0 + n_s) of every pixel (all of spp by
    default) on ``device`` (the scene's by default): a CUDA kernel on a
    CUDA device (megakernel_nee_tab for a scene with spheres or SPEC/REFR
    objects, megakernel_nee otherwise), the plain version on the CPU.
    Returns ((h, w, 3) radiance sum over the span, traces (2,) int64
    [extend, probe])."""
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_plain(scene, cam, cfg, seed, s0, n_s,
                                       device)
    if uses_sphere_table(scene):
        return _render_tab(scene, cam, cfg, seed, s0, n_s, device)
    global LAUNCHES
    geom = pack_geometry(scene, cam)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    alb, emi, fold = _baked_materials(scene, geom)

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


def _baked_materials(scene: Scene, geom: KernelGeometry):
    """Host (R, 3) albedo and emission for the baked kernels, and whether
    the NEE fold is on: it needs an absorbing light (zero albedo)."""
    alb = _host_f32([scene.rects.albedo])
    emi = _host_f32([scene.rects.emission])
    return alb, emi, int(float(alb[geom.light_id].max()) == 0.0)


def sphere_tables(scene: Scene, device):
    """The sphere-table kernel's device inputs: sphere rows (S, 4) float32
    [cx, cy, cz, r], and albedo (K, 3), emission (K, 3) float32 and refl
    (K,) int32 in global object order (rects, then spheres)."""
    sp = scene.spheres
    sph = torch.cat([sp.center, sp.radius[:, None]], dim=1)
    alb, emi, refl = object_arrays(scene)
    f32 = torch.float32
    return tuple(t.to(device=device, dtype=dt).contiguous() for t, dt in (
        (sph, f32), (alb, f32), (emi, f32), (refl, torch.int32)))


def _check_spheres(scene: Scene) -> int:
    S = num_spheres(scene)
    if S > MAX_SPHERES:
        raise NotImplementedError(
            f"the sphere-table kernel takes at most {MAX_SPHERES} spheres "
            f"(64 KB of shared memory a block), got {S}"
        )
    return S


def _render_tab(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                s0: int, n_s: int | None, device):
    global LAUNCHES_TAB
    S = _check_spheres(scene)
    geom = pack_geometry(scene, cam)
    sph, alb, emi, refl = sphere_tables(scene, device)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    lib = _build.build_kernels().lib
    out_l = torch.empty((n_pix * g, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_nee_tab(
            geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
            len(geom.rect_axis), *launch_args(geom, cfg, seed, g, per, s0),
            sph.data_ptr(), S, alb.data_ptr(), emi.data_ptr(),
            refl.data_ptr(), out_l.data_ptr(), traces.data_ptr(), stream,
        )
    check_launch(err, "megakernel_nee_tab")
    LAUNCHES_TAB += 1
    return _reduce(out_l, cfg, n_pix, g), traces


def _spans(x, n_pix: int, device, dtype) -> torch.Tensor:
    """A (n_pix,) span bound as a contiguous ``dtype`` tensor on ``device``
    (from a tensor or a numpy array)."""
    t = torch.as_tensor(x, device=device).to(dtype).contiguous()
    if tuple(t.shape) != (n_pix,):
        raise ValueError(f"expected ({n_pix},) span bounds, got "
                         f"{tuple(t.shape)}")
    return t


def render_megakernel_budgets_plain(scene: Scene, cam: CameraParams,
                                    cfg: RenderConfig, seed, s_start, s_stop,
                                    device=None):
    """The budget kernels' plain version: the eager regenerating wavefront
    with one lane a pixel, lane i rendering samples [s_start[i],
    s_stop[i]). Returns ((n_pix, 3) radiance sum over each span, traces
    (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    return path_trace_regen(
        scene.to(device), cfg, int(seed), cam.to(device), pix,
        _spans(s_start, n_pix, device, torch.int64),
        _spans(s_stop, n_pix, device, torch.int64))


def render_megakernel_budgets(scene: Scene, cam: CameraParams,
                              cfg: RenderConfig, seed, s_start, s_stop,
                              device=None):
    """Render samples [s_start[i], s_stop[i]) of every pixel i on
    ``device`` (the scene's by default): the unit of an adaptive wave, the
    JAX package's ``render_pallas_budgets``. s_start, s_stop: (n_pix,)
    integer tensors or arrays with 0 <= s_start <= s_stop < 2^31; an empty
    span renders nothing. cfg.spp stays the path-id stride, so a sample's
    radiance is the same as in every other schedule.

    On a CUDA device this launches megakernel_nee_tab_budgets for a scene
    with spheres or SPEC/REFR objects, megakernel_nee_budgets otherwise; on
    the CPU it runs the plain version. Returns ((n_pix, 3) float32 radiance
    sum over each span, traces (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_budgets_plain(scene, cam, cfg, seed,
                                               s_start, s_stop, device)
    global LAUNCHES_BUDGETS, LAUNCHES_TAB_BUDGETS
    n_pix = cfg.width * cfg.height
    s_start = _spans(s_start, n_pix, device, torch.int32)
    s_stop = _spans(s_stop, n_pix, device, torch.int32)
    tab = uses_sphere_table(scene)
    S = _check_spheres(scene) if tab else 0
    geom = pack_geometry(scene, cam)
    head = _budget_args(geom, cfg, seed)
    lib = _build.build_kernels().lib
    out_l = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if tab:
            sph, alb, emi, refl = sphere_tables(scene, device)
            err = lib.spt_megakernel_nee_tab_budgets(
                geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
                len(geom.rect_axis), *head, sph.data_ptr(), S,
                alb.data_ptr(), emi.data_ptr(), refl.data_ptr(),
                s_start.data_ptr(), s_stop.data_ptr(), out_l.data_ptr(),
                traces.data_ptr(), stream,
            )
        else:
            alb, emi, fold = _baked_materials(scene, geom)
            err = lib.spt_megakernel_nee_budgets(
                geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
                alb.ctypes.data, emi.ctypes.data, len(geom.rect_axis),
                *head, fold, s_start.data_ptr(), s_stop.data_ptr(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
    if tab:
        check_launch(err, "megakernel_nee_tab_budgets")
        LAUNCHES_TAB_BUDGETS += 1
    else:
        check_launch(err, "megakernel_nee_budgets")
        LAUNCHES_BUDGETS += 1
    return out_l, traces
