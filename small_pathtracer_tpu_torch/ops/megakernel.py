"""Host wrappers of the CUDA render megakernels (``csrc/megakernel.cu``): the
port's counterpart of the JAX package's ``render_pallas`` /
``render_pallas_span``.

- ``megakernel_nee`` (row 1 of the kernel table in ROADMAP.md) renders
  rect-only DIFF scenes, with the materials baked into its parameters.
- ``megakernel_nee_tab`` (row 2, the JAX sphere-table kernel) renders every
  scene with spheres or SPEC/REFR objects: the sphere rows and the
  material tables are device tensors, and the spheres are scanned through
  a tree that ``sphere_bvh`` builds on the host at each launch
  (``csrc/megakernel_bvh.cuh``).
- ``megakernel_cosine`` / ``megakernel_textbook`` and their ``_tab``
  twins are rows 1 and 2 with the ``cosine`` and ``nee_textbook``
  estimators (``render_megakernel`` picks the kernel from cfg.estimator);
  ``megakernel_uniform``, ``_uniform_corrected``, ``_mixture``, ``_mis``,
  ``_nee_glibc`` and ``_mixture_glibc`` (and ``_tab``) with the others and
  with ``light_sample_mode='glibc_overflow'`` (``csrc/megakernel_est.cu``;
  ``kernel_name`` gives each launch's name).
- ``megakernel_<est>_budgets`` and ``megakernel_<est>_tab_budgets`` (row 3,
  the JAX ``render_pallas_budgets``; ``csrc/megakernel_budgets.cu``) are
  rows 1 and 2 with per-pixel sample budgets: ``render_megakernel_budgets``,
  the unit of an adaptive wave (``utils/adaptive.py``, through
  ``budget_waves``). They launch one lane for each pixel with a non-empty
  span.
- ``megakernel_guided`` and ``megakernel_guided_tab`` (row 4, the JAX
  ``render_pallas_guided``) guide every diffuse vertex from a voxel table of
  packed lobes: ``render_megakernel_guided``. ``megakernel_guided_primary``
  and ``megakernel_guided_primary_tab`` (row 5,
  ``render_pallas_guided_primary``) guide the first diffuse vertex from one
  lobe a pixel: ``render_megakernel_guided_primary``. Both take the
  ``cosine``, ``nee_textbook`` and ``mis`` estimators (``mis`` counted as
  ``megakernel_guided_mis``, ``megakernel_guided_primary_mis`` and their
  ``_tab`` twins).
- Scenes with quads or GLOS objects go to ``megakernel_<est>_ext``
  (``csrc/megakernel_ext.cu``): row 2's table kernel with the quads
  scanned after the rects and the GLOS lobe (``cosine``, ``nee_textbook``
  and ``mis`` only), and its budget (row 3, ``_ext_budgets``) and guided
  (rows 4 and 5, quads only: the guide refuses GLOS; ``megakernel_guided
  [_primary][_mis]_ext``) twins. The existing instances compile as before.
- ``render_megakernel_sharded`` (row 7, the JAX ``render_pallas_sharded``)
  and ``render_megakernel_guided_sharded`` (row 6,
  ``render_pallas_guided_sharded``) launch the same kernels on one rank's
  shard of an (sp, dp) mesh (``parallel/mesh.py``): its pixel block and its
  sample range. The image sums over dp and the traces over the mesh are
  ``torch.distributed`` all-reduces around the launch.

Lane layout of ``_build_render``: ``g = lane_groups(n_pix, n_s, 2^18,
cfg.regen_groups)`` lanes per pixel, each walking ``n_s // g`` samples of the
span [s0, s0 + n_s). Lane i renders pixel i // g; the per-lane radiance sums
are reduced over g by the wrapper, so the kernel and its plain version share
that reduction. A shard's layout (``parallel/sharded.shard_layout``) is the
same on its own pixels [pix0, pix0 + n_pix_loc) and samples, with g from the
local counts; the unsharded layout is the shard (0, n_pix) of a 1x1 mesh.

On a CUDA device a wrapper builds (once) and launches a kernel, or raises.
On the CPU it runs the plain version, for every kernel: the eager
``integrator.wavefront.path_trace_regen`` on the same lanes.
``pack_geometry`` and ``launch_args`` also serve the runtime-material
kernels of ``ops/megakernel_grad.py``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..camera.pinhole import CameraParams, primary_rays
from ..config import SPHERE_TABLE_AUTO_MIN, RenderConfig
from ..core import vecmath as vm
from ..device import resolve
from ..experiment.path_guiding import voxel_id
from ..geometry.intersect import (
    QUAD_COLS, intersect_rects, quad_consts, shade_info, trace,
)
from ..integrator import sampling
from ..integrator.wavefront import (
    Guide, check_glos_estimator, lane_groups, path_trace_regen,
)
from ..parallel.mesh import Mesh
from ..parallel.sharded import (
    ShardLayout, reduce_lanes, shard_layout, shard_lanes,
)
from ..scene.types import (
    GLOS, REFR, SPEC, Scene, gloss_arrays, num_quads, num_spheres,
    object_arrays, object_refl,
)
from . import _build

# Launches of each CUDA kernel in this process, by kernel name: the wrapper
# adds one where it launches its kernel (``count``), and nowhere else. A
# launch on a shard's lanes counts under its kernel's name as well.
LAUNCHES: Counter = Counter()

# The estimator codes of csrc/megakernel_lane.cuh (kNee ... kMis), the
# flag kGlibc adds to kNee and kMixture under light_sample_mode=
# 'glibc_overflow', and each code's row 1 kernel. Rows 1 and 2 launch codes
# 0-2 through csrc/megakernel.cu's entry points, the others through
# csrc/megakernel_est.cu's; row 3 every code through
# csrc/megakernel_budgets.cu's.
EST_CODE = {"nee": 0, "cosine": 1, "nee_textbook": 2, "uniform": 3,
            "uniform_corrected": 4, "mixture": 5, "mis": 6}
GLIBC = 8
_OWN_CODES = (0, 1, 2)
_EST_KERNEL = {0: "megakernel_nee", 1: "megakernel_cosine",
               2: "megakernel_textbook", 3: "megakernel_uniform",
               4: "megakernel_uniform_corrected", 5: "megakernel_mixture",
               6: "megakernel_mis", GLIBC: "megakernel_nee_glibc",
               5 + GLIBC: "megakernel_mixture_glibc"}


def est_code(cfg: RenderConfig) -> int:
    """The kernels' estimator code of cfg: EST_CODE, plus GLIBC for nee
    and mixture under light_sample_mode='glibc_overflow' (the other
    estimators ignore the mode, as in the JAX package)."""
    code = EST_CODE[cfg.estimator]
    if (cfg.light_sample_mode == "glibc_overflow"
            and cfg.estimator in ("nee", "mixture")):
        code += GLIBC
    return code


def kernel_name(scene: Scene, cfg: RenderConfig, suffix: str = "") -> str:
    """The name under which a row 1 or 2 launch (``suffix`` "_budgets": row
    3) of cfg's estimator on ``scene`` counts in LAUNCHES: e.g.
    megakernel_mis, megakernel_mis_tab, megakernel_mixture_glibc_budgets,
    megakernel_cosine_ext (a scene with quads or GLOS objects)."""
    return _EST_KERNEL[est_code(cfg)] + kernel_family(scene) + suffix


def kernel_family(scene: Scene) -> str:
    """The kernels that render ``scene`` on the card, as their names'
    suffix: "_ext" for a scene with quads or GLOS objects, "_tab" (the
    sphere table) for one with spheres or SPEC/REFR objects, "" (row 1's
    baked kernels) else. One host copy of the material codes."""
    if num_quads(scene):
        return "_ext"
    codes = set(object_refl(scene).tolist())
    if GLOS in codes:
        return "_ext"
    return "_tab" if num_spheres(scene) or codes & {SPEC, REFR} else ""


TARGET_LANES = 1 << 18
MAX_RECTS = 32
MAX_QUADS = 8  # kMaxQuads in csrc/megakernel_common.cuh
MAX_SPHERES = 4096  # kMaxSpheres in csrc/megakernel_common.cuh
BVH_ERROR = -(2 ** 31)  # kBvhError in csrc/megakernel_bvh.cuh


def full_layout(cfg: RenderConfig, n_s: int | None = None,
                s0: int = 0) -> ShardLayout:
    """The unsharded kernels' lanes for the span [s0, s0 + n_s) (all of spp
    by default): every pixel, g = lane_groups(n_pix, n_s, 2^18)."""
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix = cfg.width * cfg.height
    g = lane_groups(n_pix, n_s, TARGET_LANES, cfg.regen_groups)
    return ShardLayout(0, n_pix, int(s0), g, n_s // g)


def shard_of(cfg: RenderConfig, mesh: Mesh, s0: int = 0,
             n_s: int | None = None, what: str = "n_s") -> ShardLayout:
    """The kernels' lanes of ``mesh``'s coordinate for the span [s0, s0 +
    n_s) (all of spp by default)."""
    return shard_layout(cfg, cfg.spp if n_s is None else int(n_s), mesh,
                        TARGET_LANES, s0, what)


def _resolve(scene: Scene, device) -> torch.device:
    return resolve(scene.device if device is None else device)


def _image(L: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(n_pix, 3) per-pixel sums as the (h, w, 3) image."""
    return L.reshape(cfg.height, cfg.width, 3)


def plain_lanes(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                lay: ShardLayout, device, guide: Guide | None = None):
    """The plain version of every render kernel on the lanes ``lay``: the
    eager regenerating wavefront. Returns ((n_pix_loc, 3) radiance sums of
    the lanes' pixels, traces (2,) int64 [extend, probe])."""
    pix, s_start, s_stop = shard_lanes(lay, device)
    L, traces = path_trace_regen(scene.to(device), cfg, int(seed),
                                 cam.to(device), pix, s_start, s_stop, guide)
    return reduce_lanes(L, lay), traces


def render_megakernel_plain(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, seed, s0: int = 0,
                            n_s: int | None = None, device=None):
    """The kernel's plain version: the eager regenerating wavefront on the
    kernel's lane layout. Returns ((h, w, 3) radiance sum over the span,
    traces (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    L, traces = plain_lanes(scene, cam, cfg, seed, full_layout(cfg, n_s, s0),
                            device)
    return _image(L, cfg), traces


class KernelGeometry(NamedTuple):
    """What the kernels take from the scene and camera besides materials,
    packed once on the host (float32 / int32 numpy arrays)."""

    rect_geom: np.ndarray  # (R, 5) [k, lo0, lo1, hi0, hi1]
    rect_axis: np.ndarray  # (R,) int32
    quad_f: np.ndarray     # (Q, QUAD_COLS) geometry.intersect.quad_consts
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
    rects = scene.rects
    R, Q = rects.k.shape[0], num_quads(scene)
    if R > MAX_RECTS:
        raise NotImplementedError(
            f"the kernel takes at most {MAX_RECTS} rects, got {R}"
        )
    if Q > MAX_QUADS:
        raise NotImplementedError(
            f"the kernel takes at most {MAX_QUADS} quads, got {Q}"
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
        quad_f=np.ascontiguousarray(quad_consts(scene.quads).cpu().numpy(),
                                    dtype=np.float32).reshape(Q, QUAD_COLS),
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


def launch_args(geom: KernelGeometry, cfg: RenderConfig, seed,
                lay: ShardLayout) -> tuple:
    """The arguments every kernel entry point takes after ``n_rects``: light,
    camera and the launch settings of the lanes ``lay``."""
    return (*_head_args(geom, cfg, seed), lay.g, lay.per,
            lay.samp0 & 0xFFFFFFFF, lay.pix0, lay.n_pix_loc,
            cfg.rr_start_depth, cfg.max_bounces)


def _budget_args(geom: KernelGeometry, cfg: RenderConfig, seed) -> tuple:
    """launch_args of the budget kernels: one lane a pixel, so no g, per or
    s0."""
    return (*_head_args(geom, cfg, seed), cfg.rr_start_depth,
            cfg.max_bounces)


def uses_sphere_table(scene: Scene) -> bool:
    """Whether the card renders ``scene`` with a table kernel
    (megakernel_<est>_tab or, with quads or GLOS objects, _ext): it holds
    spheres, SPEC/REFR objects, quads or GLOS objects."""
    return kernel_family(scene) != ""



def render_megakernel(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      seed, s0: int = 0, n_s: int | None = None,
                      device=None):
    """Render sample indices [s0, s0 + n_s) of every pixel (all of spp by
    default) on ``device`` (the scene's by default): a CUDA kernel on a
    CUDA device (row 2, megakernel_<est>_tab, for a scene with spheres or
    SPEC/REFR objects, row 1 megakernel_<est> otherwise, by cfg.estimator
    and light_sample_mode: ``kernel_name``), the plain version on the CPU.
    Returns ((h, w, 3) radiance sum over the span, traces (2,) int64
    [extend, probe])."""
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_plain(scene, cam, cfg, seed, s0, n_s,
                                       device)
    L, traces = _launch_render(scene, cam, cfg, seed,
                              full_layout(cfg, n_s, s0), device)
    return _image(L, cfg), traces


def _launch_render(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                  lay: ShardLayout, device):
    """Launches row 2 of cfg.estimator (a scene with spheres or SPEC/REFR
    objects; its _ext instance with quads or GLOS objects) or row 1 on the
    lanes ``lay``. Returns ((n_pix_loc, 3) radiance sums, traces (2,)
    int64 [extend, probe])."""
    family = kernel_family(scene)
    if family == "_ext":
        check_glos_estimator(scene, cfg)
    geom = pack_geometry(scene, cam)
    lib = _build.build_kernels().lib
    code = est_code(cfg)
    own = code in _OWN_CODES
    out_l = torch.empty((lay.n_pix_loc * lay.g, 3), dtype=torch.float32,
                        device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family == "_ext":
            sa = sphere_args(lib, scene, device)
            err = lib.spt_megakernel_ext(
                code, cfg.mixture_q, *ext_scene_args(geom),
                *launch_args(geom, cfg, seed, lay), *sa.ext_args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        elif family:
            sa = sphere_args(lib, scene, device)
            est = (code, 0) if own else (code, cfg.mixture_q)
            err = (lib.spt_megakernel_tab if own
                   else lib.spt_megakernel_est_tab)(
                *est, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, len(geom.rect_axis),
                *launch_args(geom, cfg, seed, lay), *sa.args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        else:
            alb, emi, fold = _baked_materials(scene, geom)
            est = (code,) if own else (code, cfg.mixture_q)
            err = (lib.spt_megakernel if own else lib.spt_megakernel_est)(
                *est, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, alb.ctypes.data, emi.ctypes.data,
                len(geom.rect_axis), *launch_args(geom, cfg, seed, lay),
                fold, out_l.data_ptr(), traces.data_ptr(), stream,
            )
    count(_EST_KERNEL[code] + family, err)
    return reduce_lanes(out_l, lay), traces


def count(name: str, err: int) -> None:
    """Raises if the launch of kernel ``name`` failed, else counts it in
    LAUNCHES."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _baked_materials(scene: Scene, geom: KernelGeometry):
    """Host (R, 3) albedo and emission for the baked kernels, and whether
    the NEE fold is on: it needs an absorbing light (zero albedo); the
    entry points apply it to nee and mixture only."""
    alb = _host_f32([scene.rects.albedo])
    emi = _host_f32([scene.rects.emission])
    return alb, emi, int(float(alb[geom.light_id].max()) == 0.0)


def ext_scene_args(geom: KernelGeometry) -> tuple:
    """The scene arguments of the _ext entry points: the rects, their
    count, the quads' constants and their count."""
    return (geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
            len(geom.rect_axis), geom.quad_f.ctypes.data, len(geom.quad_f))


def sphere_tables(scene: Scene, device):
    """The sphere-table kernel's device inputs: sphere rows (S, 4) float32
    [cx, cy, cz, r], and albedo (K, 3), emission (K, 3) float32 and refl
    (K,) int32 in global object order (rects, quads, then spheres)."""
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
            f"the sphere-table kernels take at most {MAX_SPHERES} spheres, "
            f"got {S}"
        )
    return S


def bvh_floats(n: int) -> int:
    """Floats of the tree of n sphere rows (bvh_floats in
    csrc/megakernel_bvh.cuh): the rows, then at most n - 1 nodes."""
    return 8 * n + 16 * max(n - 1, 0)


def sphere_bvh(lib, sph: torch.Tensor, device):
    """The tree over the (S, 4) sphere rows ``sph``, built on the host by
    the kernel library's ``spt_sphere_bvh`` (csrc/megakernel_bvh.cuh):
    (its buffer, a float32 tensor on ``device``, and its root link). It is
    built anew at each launch: a fit moves the spheres every step."""
    rows = np.ascontiguousarray(sph.detach().cpu().numpy(), dtype=np.float32)
    n = rows.shape[0]
    out = np.zeros(bvh_floats(n), np.float32)
    root = lib.spt_sphere_bvh(rows.ctypes.data, n, out.ctypes.data, out.size)
    if root == BVH_ERROR:
        raise NotImplementedError(f"no sphere tree for {n} rows (at most "
                                  f"{MAX_SPHERES})")
    return torch.from_numpy(out).to(device), int(root)


class SphereArgs(NamedTuple):
    """A sphere table as the table kernels take it, on the device: the
    rows, the tree (``sphere_bvh``) and the material tables."""

    sph: torch.Tensor
    bvh: torch.Tensor
    root: int
    alb: torch.Tensor
    emi: torch.Tensor
    refl: torch.Tensor
    gloss: torch.Tensor  # (K,) float32, the Phong exponents

    def args(self) -> tuple:
        """The entry points' sphere arguments: sph, n_spheres, bvh, root,
        albedo, emission, refl."""
        return (self.sph.data_ptr(), self.sph.shape[0], self.bvh.data_ptr(),
                self.root, self.alb.data_ptr(), self.emi.data_ptr(),
                self.refl.data_ptr())

    def ext_args(self) -> tuple:
        """The _ext entry points' sphere arguments: ``args`` and gloss."""
        return (*self.args(), self.gloss.data_ptr())


def sphere_args(lib, scene: Scene, device) -> SphereArgs:
    """``scene``'s sphere table and its tree for the table kernels."""
    _check_spheres(scene)
    sph, alb, emi, refl = sphere_tables(scene, device)
    bvh, root = sphere_bvh(lib, sph, device)
    gloss = gloss_arrays(scene).to(device=device,
                                   dtype=torch.float32).contiguous()
    return SphereArgs(sph, bvh, root, alb, emi, refl, gloss)


def render_megakernel_counted(scene: Scene, cam: CameraParams,
                              cfg: RenderConfig, seed, device=None):
    """Row 2's counting instance (``megakernel_nee_tab<kScanCount>``,
    counted as megakernel_nee_tab_count) on every pixel and all of spp,
    for the bound of the tree's algorithm: the image
    and traces of megakernel_nee_tab, and the scans' work. Returns ((h, w,
    3) radiance sum, counts (5,) int64 [extend, probe, node tests, sphere
    rows tested, rows that reached the square root]). The counts are the
    card's algorithm's: there is no plain version, and the CPU raises."""
    device = _resolve(scene, device)
    if device.type == "cpu" or cfg.estimator != "nee":
        raise NotImplementedError("the counting instance runs on a CUDA "
                                  "device, estimator nee")
    lay = full_layout(cfg)
    geom = pack_geometry(scene, cam)
    lib = _build.build_kernels().lib
    out_l = torch.empty((lay.n_pix_loc * lay.g, 3), dtype=torch.float32,
                        device=device)
    counts = torch.zeros(5, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_tab(
            EST_CODE["nee"], 1, geom.rect_geom.ctypes.data,
            geom.rect_axis.ctypes.data, len(geom.rect_axis),
            *launch_args(geom, cfg, seed, lay),
            *sphere_args(lib, scene, device).args(), out_l.data_ptr(),
            counts.data_ptr(), stream,
        )
    count("megakernel_nee_tab_count", err)
    return _image(reduce_lanes(out_l, lay), cfg), counts


def sphere_queries_plain(scene: Scene, o: torch.Tensor, d: torch.Tensor):
    """The plain version of the sphere table's two scans on rays (o, d)
    (N, 3): the in-order strict-< scan's nearest hit (t, id), and the
    probe toward the light: success iff that winner is the light, and the
    light's t (MISS_T where the ray misses it)."""
    h = trace(scene, o, d)
    L = int(scene.light.light_obj_id)
    t_l = intersect_rects(scene.rects, o, d)[:, L]
    return h.t, h.obj_id.to(torch.int32), (h.hit & (h.obj_id == L)), t_l


def sphere_queries(scene: Scene, cam: CameraParams, o: torch.Tensor,
                   d: torch.Tensor):
    """The sphere table's nearest-hit scan and light probe (nearest_tab,
    probe_light_tab, through the tree) on rays (o, d) (N, 3) float32 on the
    scene's device (the camera is packed, not read): the query kernel
    ``sphere_queries`` on a CUDA device, ``sphere_queries_plain`` on the
    CPU. Returns (t (N,), id (N,) int32, success (N,) bool, t_light
    (N,)). Scenes with quads are refused (ValueError)."""
    if num_quads(scene):
        raise ValueError("sphere_queries scans rects and spheres only")
    device = scene.device
    if device.type == "cpu":
        return sphere_queries_plain(scene, o, d)
    geom = pack_geometry(scene, cam)
    lib = _build.build_kernels().lib
    o = o.to(device=device, dtype=torch.float32).contiguous()
    d = d.to(device=device, dtype=torch.float32).contiguous()
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=device)
    t_l = torch.empty_like(t)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    ok = torch.empty_like(ids)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        sa = sphere_args(lib, scene, device)
        err = lib.spt_sphere_queries(
            geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
            len(geom.rect_axis), geom.light_f.ctypes.data, geom.light_id,
            *sa.args()[:4], o.data_ptr(), d.data_ptr(), n, t.data_ptr(),
            ids.data_ptr(), ok.data_ptr(), t_l.data_ptr(), stream)
    count("sphere_queries", err)
    return t, ids, ok.bool(), t_l


def _spans(x, n_pix: int, device, dtype) -> torch.Tensor:
    """A (n_pix,) span bound as a contiguous ``dtype`` tensor on ``device``
    (from a tensor or a numpy array)."""
    t = torch.as_tensor(x, device=device).to(dtype).contiguous()
    if tuple(t.shape) != (n_pix,):
        raise ValueError(f"expected ({n_pix},) span bounds, got "
                         f"{tuple(t.shape)}")
    return t


def live_pixels(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The indices of the True entries of the (n_pix,) bool ``mask``, in
    order, as an (n,) int32 tensor on its device, where n is the number of
    True entries (which the caller knows): a scatter of each pixel to its
    place, with no host read."""
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    live = torch.empty(n + 1, dtype=torch.int32, device=mask.device)
    live.scatter_(0, torch.where(mask, pos, n),
                  torch.arange(mask.shape[0], dtype=torch.int32,
                               device=mask.device))
    return live[:n]


def render_megakernel_budgets_plain(scene: Scene, cam: CameraParams,
                                    cfg: RenderConfig, seed, s_start, s_stop,
                                    device=None, live=None):
    """The budget kernels' plain version: the eager regenerating wavefront
    with one lane a live pixel, lane i rendering samples [s_start[j],
    s_stop[j]) of pixel j = live[i]; ``live`` (the pixels with a non-empty
    span, in order) is computed from the spans when not given. Returns
    ((n_pix, 3) radiance sum over each span, 0 outside ``live``, traces
    (2,) int64 [extend, probe])."""
    device = _resolve(scene, device)
    n_pix = cfg.width * cfg.height
    s_start = _spans(s_start, n_pix, device, torch.int64)
    s_stop = _spans(s_stop, n_pix, device, torch.int64)
    if live is None:
        live = torch.nonzero(s_stop > s_start).flatten()
    pix = live.to(device=device, dtype=torch.int64)
    L = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    if pix.numel() == 0:
        return L, torch.zeros(2, dtype=torch.int64, device=device)
    L_live, traces = path_trace_regen(
        scene.to(device), cfg, int(seed), cam.to(device), pix, s_start[pix],
        s_stop[pix])
    return L.index_copy_(0, pix, L_live), traces


class _BudgetScene(NamedTuple):
    """What the budget kernels take from a scene and camera, packed once
    for every wave of an adaptive render: the library, the geometry, and
    the sphere table (with its tree) or the baked materials."""

    lib: object
    geom: KernelGeometry
    spheres: SphereArgs | None
    baked: tuple | None  # (albedo, emission, fold)
    suffix: str  # kernel_family


def _pack_budgets(scene: Scene, cam: CameraParams, device) -> _BudgetScene:
    lib = _build.build_kernels().lib
    geom = pack_geometry(scene, cam)
    suffix = kernel_family(scene)
    if suffix:
        return _BudgetScene(lib, geom, sphere_args(lib, scene, device), None,
                            suffix)
    return _BudgetScene(lib, geom, None, _baked_materials(scene, geom),
                        suffix)


def _launch_budgets(pk: _BudgetScene, cfg: RenderConfig, seed,
                    s_start: torch.Tensor, s_stop: torch.Tensor,
                    live: torch.Tensor, device):
    """One launch of a budget kernel over the pixels ``live`` ((n_live,)
    int32, n_live >= 1) on ``device``. Returns ((n_pix, 3) radiance sums,
    0 outside ``live``, traces (2,) int64)."""
    n_pix = cfg.width * cfg.height
    s_start = _spans(s_start, n_pix, device, torch.int32)
    s_stop = _spans(s_stop, n_pix, device, torch.int32)
    live = live.to(device=device, dtype=torch.int32).contiguous()
    geom = pk.geom
    head = _budget_args(geom, cfg, seed)
    lanes = (live.data_ptr(), live.numel(), s_start.data_ptr(),
             s_stop.data_ptr())
    code = est_code(cfg)
    out_l = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if pk.suffix == "_ext":
            err = pk.lib.spt_megakernel_ext_budgets(
                code, cfg.mixture_q, *ext_scene_args(geom), *head,
                *pk.spheres.ext_args(), *lanes, out_l.data_ptr(),
                traces.data_ptr(), stream,
            )
        elif pk.spheres is not None:
            err = pk.lib.spt_megakernel_tab_budgets(
                code, cfg.mixture_q, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, len(geom.rect_axis), *head,
                *pk.spheres.args(), *lanes, out_l.data_ptr(),
                traces.data_ptr(), stream,
            )
        else:
            alb, emi, fold = pk.baked
            err = pk.lib.spt_megakernel_budgets(
                code, cfg.mixture_q, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, alb.ctypes.data,
                emi.ctypes.data, len(geom.rect_axis), *head, fold, *lanes,
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
    count(_EST_KERNEL[code] + pk.suffix + "_budgets", err)
    return out_l, traces


def render_megakernel_budgets(scene: Scene, cam: CameraParams,
                              cfg: RenderConfig, seed, s_start, s_stop,
                              device=None):
    """Render samples [s_start[i], s_stop[i]) of every pixel i on
    ``device`` (the scene's by default): the unit of an adaptive wave, the
    JAX package's ``render_pallas_budgets``. s_start, s_stop: (n_pix,)
    integer tensors or arrays with 0 <= s_start <= s_stop < 2^31; an empty
    span renders nothing. cfg.spp stays the path-id stride, so a sample's
    radiance is the same as in every other schedule.

    On a CUDA device this launches the budget kernel of cfg's estimator
    (``kernel_name(scene, cfg, "_budgets")``: megakernel_<est>_tab_budgets
    for a scene with spheres or SPEC/REFR objects, megakernel_<est>_budgets
    otherwise), one lane for each pixel with a non-empty span (none when
    every span is empty); on the CPU it runs the plain version. Returns
    ((n_pix, 3) float32 radiance sum over each span, traces (2,) int64
    [extend, probe])."""
    device = _resolve(scene, device)
    check_glos_estimator(scene, cfg)
    if device.type == "cpu":
        return render_megakernel_budgets_plain(scene, cam, cfg, seed,
                                               s_start, s_stop, device)
    n_pix = cfg.width * cfg.height
    a = _spans(s_start, n_pix, device, torch.int32)
    b = _spans(s_stop, n_pix, device, torch.int32)
    live = torch.nonzero(b > a).flatten()
    if live.numel() == 0:
        return (torch.zeros((n_pix, 3), dtype=torch.float32, device=device),
                torch.zeros(2, dtype=torch.int64, device=device))
    return _launch_budgets(_pack_budgets(scene, cam, device), cfg, seed, a,
                           b, live, device)


def budget_waves(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """The waves of one adaptive render on the scene's device: packs the
    scene for the budget kernels once (geometry, sphere table and its tree,
    the library) and returns wave(seed, s_start, s_stop, live) ->
    ((n_pix, 3) radiance sums, traces (2,) int64), which renders the spans
    of the pixels ``live`` ((n_live,) int32, n_live >= 1: the pixels with a
    non-empty span, in order; ``live_pixels``). The scene must not change
    between waves. On the CPU a wave is the plain version."""
    device = scene.device
    check_glos_estimator(scene, cfg)
    if device.type == "cpu":
        return lambda seed, s_start, s_stop, live: (
            render_megakernel_budgets_plain(scene, cam, cfg, seed, s_start,
                                            s_stop, device, live))
    pk = _pack_budgets(scene, cam, device)
    return lambda seed, s_start, s_stop, live: _launch_budgets(
        pk, cfg, seed, s_start, s_stop, live, device)


# ---------------------------------------------------------------------------
# Path guiding (rows 4 and 5). The guide is (mu (V, 3), use (V,)) from
# experiment/path_guiding.guide_lobes. The kernels take each voxel's lobe
# as one int32: its octahedral chart point quantized to two int16 in
# [-32767, 32767] (low 16 bits u, high 16 bits v); GUIDE_SENTINEL marks an
# unguided voxel (no real entry has that pattern). The mixture pdf uses the
# decoded lobe, so the quantization (~2e-5 rad of aim) adds no bias. The
# port's table is a flat (V,) int32 device tensor: the kernel copies it
# into shared memory and reads one entry a diffuse hit (the TPU's (rows,
# 128) plane served Mosaic's lane-axis gather only).

GUIDE_SENTINEL = np.int32(-(2 ** 31))
_OCT_Q = 1.0 / 32767.0


def oct_decode(packed: torch.Tensor):
    """Packed lobes (N,) int32 -> (mu (N, 3) unit float32, use (N,) bool),
    in the order the kernels' ``oct_decode`` computes them. The sentinel
    decodes to a finite unit vector too, with use False."""
    p = packed.to(torch.int64)
    iu = ((p & 0xFFFF) ^ 0x8000) - 0x8000  # the low half, sign-extended
    iv = p >> 16
    u = iu.to(torch.float32) * _OCT_Q
    v = iv.to(torch.float32) * _OCT_Q
    az = 1.0 - torch.abs(u) - torch.abs(v)
    fold = az < 0.0
    su = torch.where(u >= 0.0, 1.0, -1.0)
    sv = torch.where(v >= 0.0, 1.0, -1.0)
    uf = torch.where(fold, (1.0 - torch.abs(v)) * su, u)
    vf = torch.where(fold, (1.0 - torch.abs(u)) * sv, v)
    inv = vm.rsqrt(uf * uf + vf * vf + az * az)
    mu = torch.stack([uf * inv, vf * inv, az * inv], dim=-1)
    return mu, packed != int(GUIDE_SENTINEL)


def pack_guide_entries(guide) -> np.ndarray:
    """(mu (V, 3), use (V,)) tensors or arrays -> (V,) int32 packed lobes,
    GUIDE_SENTINEL where use is False (the JAX package's
    ``pack_guide_entries``, in float64 numpy)."""
    mu = np.asarray(torch.as_tensor(guide[0]).detach().cpu(), np.float64)
    use = np.asarray(torch.as_tensor(guide[1]).cpu()).astype(bool)
    n = np.linalg.norm(mu, axis=1)
    n = np.where(n > 0, n, 1.0)
    m = mu / n[:, None]
    denom = np.abs(m).sum(axis=1)
    denom = np.where(denom > 0, denom, 1.0)
    u = m[:, 0] / denom
    w = m[:, 1] / denom
    lower = m[:, 2] < 0

    def sgn(x):
        return np.where(x >= 0, 1.0, -1.0)

    uf = np.where(lower, (1.0 - np.abs(w)) * sgn(u), u)
    wf = np.where(lower, (1.0 - np.abs(u)) * sgn(w), w)
    iu = np.clip(np.rint(uf * 32767.0), -32767, 32767).astype(np.int64)
    iv = np.clip(np.rint(wf * 32767.0), -32767, 32767).astype(np.int64)
    packed = (iu & 0xFFFF) | ((iv & 0xFFFF) << 16)  # uint32 bit pattern
    packed = np.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return np.where(use, packed, int(GUIDE_SENTINEL)).astype(np.int32)


def guide_table(guide, device) -> torch.Tensor:
    """The kernels' voxel table: pack_guide_entries as a (V,) int32
    tensor on ``device``."""
    return torch.from_numpy(pack_guide_entries(guide)).to(device)


def dequantize_guide(guide, device=None):
    """The (mu (V, 3), use (V,)) table the guided kernels see after the
    quantization: the fixed-depth ``render_guided`` on it is comparable
    with the kernels to float order."""
    dev = torch.as_tensor(guide[0]).device if device is None else device
    return oct_decode(guide_table(guide, dev))


# The estimators the guided kernels take (the JAX package's).
GUIDED_ESTIMATORS = ("cosine", "nee_textbook", "mis")


def check_guided(scene: Scene, cfg: RenderConfig,
                 family: str | None = None) -> None:
    """The JAX guided entries' refusals, on every device: an estimator
    other than cosine, nee_textbook or mis (ValueError), GLOS objects
    (ValueError: the mixture reweights against the cosine pdf), and a scene
    the JAX package would render through its sphere table (ValueError):
    spheres with sphere_table on, cluster or cluster_scratch, or auto with
    SPHERE_TABLE_AUTO_MIN spheres or more. ``family``: the scene's
    ``kernel_family`` where the caller has it."""
    if cfg.estimator not in GUIDED_ESTIMATORS:
        raise ValueError(
            "the guided megakernel composes with the cosine-continuation "
            "estimators ('cosine', 'nee_textbook', 'mis') only; got "
            f"estimator={cfg.estimator!r}")
    if family is None:
        family = kernel_family(scene)
    if family == "_ext" and bool((object_refl(scene) == GLOS).any()):
        raise ValueError(
            "guided rendering does not compose with GLOS primitives "
            "(the guide mixture reweights against the cosine pdf)")
    S = num_spheres(scene)
    mode = cfg.sphere_table
    if S and (mode in ("on", "cluster", "cluster_scratch")
              or (mode == "auto" and S >= SPHERE_TABLE_AUTO_MIN)):
        raise ValueError(
            "the guided megakernel does not support sphere_table mode yet; "
            "pass sphere_table='off' or drop --guided")


def pixel_primary_lobes(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                        guide, device=None) -> torch.Tensor:
    """(n_pix,) int32 packed lobe of each pixel on ``device``: the voxel
    table's entry at the hit of the pixel's centre ray. Any lobe a pixel
    keeps the estimator unbiased; the centre ray only aims it."""
    device = _resolve(scene, device)
    sc, cm = scene.to(device), cam.to(device)
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h, dtype=torch.int64, device=device)
    half = torch.full((w * h,), 0.5, dtype=torch.float32, device=device)
    o, d = primary_rays(cm, w, h, pix % w,
                        torch.div(pix, w, rounding_mode="floor"), half, half)
    sh = shade_info(sc, o, d, trace(sc, o, d))
    return guide_table(guide, device).index_select(0, voxel_id(sh.x))


def _guide_consts(beta: float, k: float) -> tuple:
    """(beta, k, (k + 1) / (2 pi), 1 / (k + 1), k as an int in [1, 64] or
    0): the guide arguments of the kernel entry points."""
    kf = float(k)
    k_int = int(kf) if kf.is_integer() and 1 <= kf <= 64 else 0
    return (float(beta), kf, (kf + 1.0) / (2.0 * math.pi), 1.0 / (kf + 1.0),
            k_int)


def render_megakernel_guided_plain(scene: Scene, cam: CameraParams,
                                   cfg: RenderConfig, seed, guide,
                                   beta: float = 0.5, k: float = 8.0,
                                   s0: int = 0, n_s: int | None = None,
                                   device=None):
    """Row 4's plain version: the eager regenerating wavefront on the
    kernel's lane layout, each diffuse vertex guided from the packed voxel
    table. Returns ((h, w, 3) radiance sum over the span, traces (2,))."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    L, traces = plain_lanes(scene, cam, cfg, seed, full_layout(cfg, n_s, s0),
                            device, _voxel_guide(guide, beta, k, device))
    return _image(L, cfg), traces


def _voxel_guide(guide, beta: float, k: float, device) -> Guide:
    """Row 4's guide for the plain version: each diffuse vertex's lobe from
    the packed voxel table, decoded as the kernel decodes it."""
    mu_tab, use_tab = oct_decode(guide_table(guide, device))

    def lobes(x, depth):
        vid = voxel_id(x)
        return mu_tab.index_select(0, vid), use_tab.index_select(0, vid)

    return Guide(lobes, beta, k)


def render_megakernel_guided_primary_plain(scene: Scene, cam: CameraParams,
                                           cfg: RenderConfig, seed, guide,
                                           beta: float = 0.5, k: float = 8.0,
                                           s0: int = 0,
                                           n_s: int | None = None,
                                           device=None):
    """Row 5's plain version: as row 4's, the lane's pixel lobe
    (``pixel_primary_lobes``) guiding depth 1 only."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    lay = full_layout(cfg, n_s, s0)
    pix_lobes = pixel_primary_lobes(scene, cam, cfg, guide, device)
    pix, _, _ = shard_lanes(lay, device)
    mu_l, use_l = oct_decode(pix_lobes.index_select(0, pix))

    def lobes(x, depth):
        return mu_l, use_l & (depth == 1)

    L, traces = plain_lanes(scene, cam, cfg, seed, lay, device,
                            Guide(lobes, beta, k))
    return _image(L, cfg), traces


def render_megakernel_guided(scene: Scene, cam: CameraParams,
                             cfg: RenderConfig, seed, guide,
                             beta: float = 0.5, k: float = 8.0, s0: int = 0,
                             n_s: int | None = None, device=None):
    """Guided render of sample indices [s0, s0 + n_s) (all of spp by
    default), the JAX package's ``render_pallas_guided``: every diffuse
    vertex samples the defensive mixture of a power-cosine(k) lobe from
    the voxel table ``guide`` (probability beta) and the cosine lobe. On a
    CUDA device megakernel_guided (megakernel_guided_tab for a scene with
    spheres or SPEC/REFR objects; ``guided_kernel_name``), on the CPU the
    plain version. cfg.estimator is cosine, nee_textbook or mis. Returns
    ((h, w, 3) radiance sum over the span, traces (2,) int64 [extend,
    probe])."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_guided_plain(scene, cam, cfg, seed, guide,
                                              beta, k, s0, n_s, device)
    L, traces = _launch_guided(scene, cam, cfg, seed,
                              guide_table(guide, device), 0, beta, k,
                              full_layout(cfg, n_s, s0), device)
    return _image(L, cfg), traces


def render_megakernel_guided_primary(scene: Scene, cam: CameraParams,
                                     cfg: RenderConfig, seed, guide,
                                     beta: float = 0.5, k: float = 8.0,
                                     s0: int = 0, n_s: int | None = None,
                                     device=None):
    """Primary-vertex guided render, the JAX package's
    ``render_pallas_guided_primary``: each lane guides its first diffuse
    vertex from its pixel's lobe (``pixel_primary_lobes``); deeper bounces
    are unguided. megakernel_guided_primary (``_tab``) on a CUDA device,
    the plain version on the CPU. Returns as render_megakernel_guided."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_guided_primary_plain(
            scene, cam, cfg, seed, guide, beta, k, s0, n_s, device)
    lobes = pixel_primary_lobes(scene, cam, cfg, guide, device)
    L, traces = _launch_guided(scene, cam, cfg, seed, lobes, 1, beta, k,
                              full_layout(cfg, n_s, s0), device)
    return _image(L, cfg), traces


def _launch_guided(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                  table: torch.Tensor, primary: int, beta: float, k: float,
                  lay: ShardLayout, device):
    """Launches row 4 (primary 0: ``table`` is the (V,) voxel table) or row
    5 (primary 1: ``table`` is the (n_pix,) pixel lobes) on the lanes
    ``lay``. Returns ((n_pix_loc, 3) radiance sums, traces (2,) int64)."""
    family = kernel_family(scene)
    check_guided(scene, cfg, family)
    geom = pack_geometry(scene, cam)
    table = table.to(device=device, dtype=torch.int32).contiguous()
    head = (EST_CODE[cfg.estimator], primary, table.data_ptr(),
            table.numel(), *_guide_consts(beta, k))
    lib = _build.build_kernels().lib
    out_l = torch.empty((lay.n_pix_loc * lay.g, 3), dtype=torch.float32,
                        device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family == "_ext":
            sa = sphere_args(lib, scene, device)
            err = lib.spt_megakernel_ext_guided(
                *head, *ext_scene_args(geom),
                *launch_args(geom, cfg, seed, lay), *sa.args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        elif family:
            sa = sphere_args(lib, scene, device)
            err = lib.spt_megakernel_guided_tab(
                *head, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, len(geom.rect_axis),
                *launch_args(geom, cfg, seed, lay), *sa.args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        else:
            alb, emi, _ = _baked_materials(scene, geom)
            err = lib.spt_megakernel_guided(
                *head, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, alb.ctypes.data, emi.ctypes.data,
                len(geom.rect_axis), *launch_args(geom, cfg, seed, lay),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
    count(_guided_name(cfg, primary, family), err)
    return reduce_lanes(out_l, lay), traces


def guided_kernel_name(scene: Scene, cfg: RenderConfig,
                       primary: int = 0) -> str:
    """The name under which a launch of row 4 (row 5 with ``primary``)
    counts in LAUNCHES: megakernel_guided[_primary][_mis][_tab|_ext],
    ``_mis`` for the mis instances (cosine and nee_textbook count
    together), ``_ext`` on scenes with quads."""
    return _guided_name(cfg, primary, kernel_family(scene))


def _guided_name(cfg: RenderConfig, primary: int, family: str) -> str:
    return ("megakernel_guided" + ("_primary" if primary else "")
            + ("_mis" if cfg.estimator == "mis" else "") + family)


# ---------------------------------------------------------------------------
# Rows 7 and 6: the render kernels on one rank's shard of an (sp, dp) mesh.

def render_megakernel_sharded_plain(scene: Scene, cam: CameraParams,
                                    cfg: RenderConfig, mesh: Mesh, seed,
                                    s0: int = 0, n_s: int | None = None,
                                    device=None):
    """Row 7's plain version: the eager regenerating wavefront on the
    shard's lanes, then the sums of ``render_megakernel_sharded``."""
    device = _resolve(scene, device)
    L, traces = plain_lanes(scene, cam, cfg, seed,
                            shard_of(cfg, mesh, s0, n_s), device)
    return mesh.sum_dp(L), mesh.sum_world(traces)


def render_megakernel_sharded(scene: Scene, cam: CameraParams,
                              cfg: RenderConfig, mesh: Mesh, seed,
                              s0: int = 0, n_s: int | None = None,
                              device=None):
    """This rank's share of the render of sample indices [s0, s0 + n_s)
    (all of spp by default), the JAX package's ``render_pallas_sharded``:
    the pixels of its sp block, the samples of its dp range, through the
    kernel ``render_megakernel`` picks (rows 1 and 2) on a CUDA device and
    the plain version on the CPU. n_pix must split over sp and n_s over dp
    (ValueError). Returns ((n_pix_loc, 3) radiance sums of the block,
    summed over dp; traces (2,) int64 [extend, probe] summed over the
    mesh)."""
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_sharded_plain(scene, cam, cfg, mesh, seed,
                                               s0, n_s, device)
    L, traces = _launch_render(scene, cam, cfg, seed,
                              shard_of(cfg, mesh, s0, n_s), device)
    return mesh.sum_dp(L), mesh.sum_world(traces)


def render_megakernel_guided_sharded_plain(scene: Scene, cam: CameraParams,
                                           cfg: RenderConfig, mesh: Mesh,
                                           seed, guide, beta: float = 0.5,
                                           k: float = 8.0, s0: int = 0,
                                           n_s: int | None = None,
                                           device=None):
    """Row 6's plain version: row 4's on the shard's lanes, then the sums
    of ``render_megakernel_guided_sharded``."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    L, traces = plain_lanes(scene, cam, cfg, seed,
                            shard_of(cfg, mesh, s0, n_s), device,
                            _voxel_guide(guide, beta, k, device))
    return mesh.sum_dp(L), mesh.sum_world(traces)


def render_megakernel_guided_sharded(scene: Scene, cam: CameraParams,
                                     cfg: RenderConfig, mesh: Mesh, seed,
                                     guide, beta: float = 0.5, k: float = 8.0,
                                     s0: int = 0, n_s: int | None = None,
                                     device=None):
    """The guided render on this rank's shard, the JAX package's
    ``render_pallas_guided_sharded``: row 4's kernel (megakernel_guided,
    ``_tab``) on the shard's lanes with the voxel table copied to every
    rank, its plain version on the CPU. Refuses what row 4 refuses
    (``check_guided``). Returns as ``render_megakernel_sharded``."""
    check_guided(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_guided_sharded_plain(
            scene, cam, cfg, mesh, seed, guide, beta, k, s0, n_s, device)
    L, traces = _launch_guided(scene, cam, cfg, seed,
                              guide_table(guide, device), 0, beta, k,
                              shard_of(cfg, mesh, s0, n_s), device)
    return mesh.sum_dp(L), mesh.sum_world(traces)
