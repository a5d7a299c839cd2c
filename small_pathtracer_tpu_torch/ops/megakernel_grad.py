"""Material training on the kernels: the port's counterpart of the JAX
package's ``ops/megakernel_grad.py`` for all seven estimators and both
light-sample modes, rects, general quads and spheres with DIFF, SPEC, REFR
and GLOS materials, and one parallelogram light (a rect or a quad).

- ``render_megakernel_mat``: the forward with runtime (K, 3) albedo and
  emission tables, the counterpart of ``render_pallas_mat``: on rect-only
  DIFF scenes ``megakernel_<est>_mat`` (``csrc/megakernel.cu`` for nee,
  cosine and nee_textbook, ``csrc/megakernel_est.cu`` for the others), on
  scenes with spheres or SPEC/REFR objects row 2's table kernel of the
  estimator with the runtime tables (``megakernel_<est>_mat_tab``), on
  scenes with quads or GLOS objects its _ext kernel
  (``csrc/megakernel_ext.cu``, ``megakernel_<est>_mat_ext``), each counted
  under ``mat_kernel_name``. Equal tables give the image and trace counts
  of ``ops.megakernel.render_megakernel`` bit for bit.
- ``render_megakernel_vjp``: the material adjoint, one trace a sample and
  a sweep of its bounces back from a per-lane tape
  (``csrc/megakernel_vjp.cuh``: ``megakernel_vjp``, its estimator and scan
  instances in ``csrc/megakernel_grad.cu`` and ``megakernel_grad_est.cu``,
  and ``megakernel_vjp_ext`` in ``csrc/megakernel_grad_ext.cu`` for quads
  and GLOS objects, named by ``vjp_kernel_name``), the counterpart of
  ``render_pallas_vjp``.
- ``RenderMaterials``: the two as one ``torch.autograd.Function``.
- ``loss_and_material_grads`` and ``fit_megakernel``: SGD on the tables, the
  counterparts of ``loss_and_material_grads`` and ``fit_pallas``.
- ``material_train_step_sharded`` (row 10): one training evaluation over
  an (sp, dp) mesh, each rank running both kernels on its shard's lanes
  (``render_megakernel_mat_shard``, ``render_megakernel_vjp_shard``).

The tables are in global object order (``pack_materials``): the rects, the
quads, then the spheres, so K = R + Q + S (17 for ``cornell_box``, 7 + 2
for ``smallpt_original``, 16 + 1 for ``cornell_tilted_light``, whose light
is object 16, its quad). The kernels are named by the estimator code
(``ops.megakernel.est_code``): light_sample_mode 'glibc_overflow' changes
``nee`` and ``mixture`` only (``nee_glibc``, ``mixture_glibc``); the other
estimators ignore it, as ``config.py`` and the jnp wavefront do, so ``mis``
with it trains as ``mis``. GLOS objects train under ``cosine``,
``nee_textbook`` and ``mis`` only (the JAX kernel's ValueError), and more
than ``MAX_GRAD_OBJECTS`` objects are refused, on every device
(``check_trainable``). On a CUDA device
each wrapper launches its kernel or raises. On the CPU it runs the plain
version: the eager forward (``render_megakernel_plain``) with the tables
put into the scene and, for the adjoint, ``torch.autograd`` through it.
"""

from __future__ import annotations

import time

import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..integrator.wavefront import GLOS_ESTIMATORS, path_trace_regen
from ..parallel.mesh import Mesh
from ..parallel.sharded import ShardLayout, reduce_lanes, shard_lanes
from ..scene.types import (
    LightSampler, Quads, Rects, Scene, Spheres, has_glos, num_quads,
    num_spheres,
)
from . import _build
from .megakernel import (
    _EST_KERNEL, _OWN_CODES, KernelGeometry, SphereArgs, _image, _resolve,
    count, est_code, ext_scene_args, full_layout, kernel_family, launch_args,
    pack_geometry, plain_lanes, shard_of, sphere_args, sphere_tables,
)

# Threads a block of the adjoint kernel (kBlock in csrc/megakernel_common.cuh):
# it sizes the per-block partial sums.
KERNEL_BLOCK = 128
# The adjoint keeps a row of 6·K gradient slots a warp in shared memory,
# which caps the object count K = R + Q + S (kMaxGradObjects in
# csrc/megakernel_vjp.cuh: 32 rects and 1024 spheres).
MAX_GRAD_OBJECTS = 1056
FIELDS = ("albedo", "emission")


def _est_name(cfg: RenderConfig) -> str:
    """The estimator code's part of the kernels' names: nee, cosine,
    textbook, uniform, uniform_corrected, mixture, mis, nee_glibc,
    mixture_glibc."""
    return _EST_KERNEL[est_code(cfg)].removeprefix("megakernel_")


def check_trainable(scene: Scene, cfg: RenderConfig) -> None:
    """Raises for a scene outside rows 8 and 9, on every device and before
    any launch, so the CPU never trains what the card refuses: more objects
    than the adjoint's shared-memory rows hold (NotImplementedError,
    ROADMAP.md queue 2, row 9) and GLOS objects under an estimator without
    glossy semantics (the JAX kernel's ValueError). Light lists and sphere
    lights never reach here: the port's Scene holds neither
    (``convert.scene_from_jax`` refuses them, item 12)."""
    K = _n_objects(scene)
    if K > MAX_GRAD_OBJECTS:
        raise NotImplementedError(
            f"material training takes at most {MAX_GRAD_OBJECTS} objects "
            "(the adjoint kernel's per-warp gradient rows fill a block's "
            f"shared memory; ROADMAP.md queue 2, row 9), got {K}")
    if cfg.estimator not in GLOS_ESTIMATORS and has_glos(scene):
        raise ValueError(
            f"estimator {cfg.estimator!r} has no glossy (GLOS) semantics; "
            "use cosine / nee_textbook / mis (same rule as the forward "
            "kernel, ops/megakernel.build_kernel)")


def mat_kernel_name(scene: Scene, cfg: RenderConfig) -> str:
    """The name under which row 8 counts its launches on ``scene``: the
    rect kernel megakernel_<est>_mat (``_est_name``: e.g. nee, textbook,
    mis, nee_glibc), or the table kernel of the estimator launched with the
    runtime tables, row 2's (``_tab``) or, with quads or GLOS objects, its
    _ext instance (``_ext``): ``megakernel.kernel_family``."""
    return f"megakernel_{_est_name(cfg)}_mat{kernel_family(scene)}"


def vjp_kernel_name(scene: Scene, cfg: RenderConfig) -> str:
    """The name under which row 9 counts its launches on ``scene``:
    megakernel_vjp (``nee``) or megakernel_vjp_<est> (``_est_name``: e.g.
    cosine, textbook, mis, nee_glibc), with ``_tab`` for the sphere-table
    instances and ``_ext`` for those with quads and GLOS
    (``megakernel.kernel_family``; linear and tree counted together)."""
    name = _est_name(cfg)
    est = "" if name == "nee" else "_" + name
    return f"megakernel_vjp{est}{kernel_family(scene)}"


def pack_materials(scene: Scene):
    """The scene's materials as (K, 3) float32 tables in global object order
    (rects, quads, then spheres: ``sphere_tables``), copies on its
    device."""
    _, alb, emi, _ = sphere_tables(scene, scene.device)
    return alb.clone(), emi.clone()


def unpack_materials(scene: Scene, alb, emi) -> Scene:
    """Inverse of pack_materials: the tables put back into the scene (the
    tensors themselves, so gradients flow to them)."""
    R, Q = scene.rects.k.shape[0], num_quads(scene)
    K = _n_objects(scene)
    for t in (alb, emi):
        if tuple(t.shape) != (K, 3):
            raise ValueError(f"expected a ({K}, 3) table, got "
                             f"{tuple(t.shape)}")
    return scene._replace(
        rects=scene.rects._replace(albedo=alb[:R], emission=emi[:R]),
        quads=scene.quads._replace(albedo=alb[R:R + Q],
                                   emission=emi[R:R + Q]),
        spheres=scene.spheres._replace(albedo=alb[R + Q:],
                                       emission=emi[R + Q:]),
    )


def material_grads_to_scene(scene: Scene, galb, gemi) -> Scene:
    """(K, 3) material cotangents as a scene-shaped tuple of gradients
    (zeros for every non-material leaf)."""
    light = scene.light
    zero = Scene(
        rects=Rects(*(torch.zeros_like(t) for t in scene.rects)),
        quads=Quads(*(torch.zeros_like(t) for t in scene.quads)),
        spheres=Spheres(*(torch.zeros_like(t) for t in scene.spheres)),
        light=LightSampler(torch.zeros_like(light.corner),
                           torch.zeros_like(light.edge_u),
                           torch.zeros_like(light.edge_v),
                           light.light_obj_id),
    )
    return unpack_materials(zero, galb, gemi)


def _tables(albedo, emission, k: int, device):
    out = []
    for t in (albedo, emission):
        t = t.detach().to(device=device, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (k, 3):
            raise ValueError(f"expected a ({k}, 3) table, got "
                             f"{tuple(t.shape)}")
        out.append(t)
    return out


def _n_objects(scene: Scene) -> int:
    """K = R + Q + S."""
    return scene.rects.k.shape[0] + num_quads(scene) + num_spheres(scene)


def _table_args(lib, scene: Scene, alb, emi, device) -> SphereArgs:
    """The scene's sphere table and its tree for the table kernels, with
    the runtime material tables in place of the scene's."""
    return sphere_args(lib, scene, device)._replace(alb=alb, emi=emi)


def render_megakernel_mat_plain(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, albedo, emission, seed,
                                s0: int = 0, n_s: int | None = None,
                                device=None):
    """The runtime-material kernel's plain version: the eager forward with
    the tables put into the scene."""
    device = _resolve(scene, device)
    L, traces = _mat_plain(scene, cam, cfg, albedo, emission, seed,
                           full_layout(cfg, n_s, s0), device)
    return _image(L, cfg), traces


def _mat_plain(scene, cam, cfg, albedo, emission, seed, lay, device):
    return plain_lanes(unpack_materials(scene, albedo, emission), cam, cfg,
                       seed, lay, device)


def render_megakernel_mat(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, albedo, emission, seed,
                          s0: int = 0, n_s: int | None = None, device=None,
                          geometry: KernelGeometry | None = None):
    """Render the scene's geometry with the (K, 3) ``albedo`` and
    ``emission`` tables over sample indices [s0, s0 + n_s). ``geometry``
    (``pack_geometry(scene, cam)``) saves the host copy of the rects per
    call; the tables never leave the device. Returns ((h, w, 3) radiance sum
    over the span, traces (2,) int64 [extend, probe])."""
    check_trainable(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_mat_plain(scene, cam, cfg, albedo, emission,
                                           seed, s0, n_s, device)
    L, traces = _launch_mat(scene, cam, cfg, albedo, emission, seed,
                            full_layout(cfg, n_s, s0), device, geometry)
    return _image(L, cfg), traces


def _launch_mat(scene, cam, cfg, albedo, emission, seed, lay: ShardLayout,
                device, geometry):
    """Row 8 on the lanes ``lay`` (``mat_kernel_name``): ((n_pix_loc, 3)
    radiance sums, traces (2,) int64)."""
    geom = pack_geometry(scene, cam) if geometry is None else geometry
    alb, emi = _tables(albedo, emission, _n_objects(scene), device)
    lib = _build.build_kernels().lib
    out_l = torch.empty((lay.n_pix_loc * lay.g, 3), dtype=torch.float32,
                        device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    code = est_code(cfg)
    own = code in _OWN_CODES
    family = kernel_family(scene)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family:
            sa = _table_args(lib, scene, alb, emi, device)
        if family == "_ext":
            err = lib.spt_megakernel_ext(
                code, cfg.mixture_q, *ext_scene_args(geom),
                *launch_args(geom, cfg, seed, lay), *sa.ext_args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        elif family:
            est = (code, 0) if own else (code, cfg.mixture_q)
            err = (lib.spt_megakernel_tab if own
                   else lib.spt_megakernel_est_tab)(
                *est, geom.rect_geom.ctypes.data,
                geom.rect_axis.ctypes.data, len(geom.rect_axis),
                *launch_args(geom, cfg, seed, lay), *sa.args(),
                out_l.data_ptr(), traces.data_ptr(), stream,
            )
        else:
            est = (code,) if own else (code, cfg.mixture_q)
            err = (lib.spt_megakernel_mat if own
                   else lib.spt_megakernel_est_mat)(
                *est, geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
                len(geom.rect_axis), *launch_args(geom, cfg, seed, lay),
                alb.data_ptr(), emi.data_ptr(), out_l.data_ptr(),
                traces.data_ptr(), stream,
            )
    count(mat_kernel_name(scene, cfg), err)
    return reduce_lanes(out_l, lay), traces


def render_megakernel_vjp_plain(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, albedo, emission, seed,
                                g_img, device=None):
    """The adjoint's plain version: torch.autograd of sum(g_img · I_sum)
    through the plain forward, the tables as leaves. Returns (d/d albedo,
    d/d emission), each (K, 3)."""
    device = _resolve(scene, device)
    g = g_img.detach().to(device=device, dtype=torch.float32)
    return _vjp_plain(scene, cam, cfg, albedo, emission, seed,
                      g.reshape(-1, 3), full_layout(cfg), device)


def plain_chunk(n_objects: int, device) -> int:
    """Lanes of one autograd chunk of the adjoints' plain versions: the
    eager loop keeps every bounce's (N, S) and (N, Q) intersection
    temporaries for the backward, so bound the lanes by the count of
    spheres and quads on the card; the CPU runs one chunk."""
    if device.type == "cpu":
        return 1 << 62
    return max(4096, (1 << 21) // (16 + n_objects))


def _vjp_plain(scene, cam, cfg, albedo, emission, seed, g_rows,
               lay: ShardLayout, device):
    """torch.autograd of sum(g_rows · I) through the plain forward on the
    lanes ``lay``, the tables as leaves; g_rows is (n_pix_loc, 3). The
    lanes run in chunks (``plain_chunk``: one on the CPU), their gradients
    summed: exact up to summation order."""
    sc, cm = scene.to(device), cam.to(device)
    leaves = _tables(albedo, emission, _n_objects(sc), device)
    pix, s_start, s_stop = shard_lanes(lay, device)
    g_lane = g_rows.detach().to(device=device, dtype=torch.float32
                                ).index_select(0, pix - lay.pix0)
    grads = [torch.zeros_like(t) for t in leaves]
    chunk = plain_chunk(num_spheres(sc) + num_quads(sc), device)
    for a in range(0, pix.shape[0], chunk):
        z = slice(a, a + chunk)
        with torch.enable_grad():
            lv = [t.detach().requires_grad_() for t in leaves]
            L, _ = path_trace_regen(unpack_materials(sc, *lv), cfg, int(seed),
                                    cm, pix[z], s_start[z], s_stop[z])
            parts = torch.autograd.grad(L, lv, grad_outputs=g_lane[z])
        for acc, p in zip(grads, parts):
            acc += p
    return tuple(grads)


def render_megakernel_vjp(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, albedo, emission, seed, g_img,
                          device=None,
                          geometry: KernelGeometry | None = None):
    """Cotangents of sum over pixels of g_img · I_sum, where I_sum (h, w, 3)
    is render_megakernel_mat's radiance sum over spp: (d/d albedo,
    d/d emission), each (K, 3), pathwise. The CUDA kernel on a CUDA device,
    the plain version on the CPU."""
    check_trainable(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_vjp_plain(scene, cam, cfg, albedo, emission,
                                           seed, g_img, device)
    g = g_img.detach().to(device=device, dtype=torch.float32)
    if tuple(g.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(
            f"g_img must be ({cfg.height}, {cfg.width}, 3), got "
            f"{tuple(g.shape)}"
        )
    return _launch_vjp(scene, cam, cfg, albedo, emission, seed,
                       g.reshape(-1, 3), full_layout(cfg), device, geometry)


def _launch_vjp(scene, cam, cfg, albedo, emission, seed, g_rows,
                lay: ShardLayout, device, geometry):
    """Row 9 (``vjp_kernel_name``) and its fixed-order reduction on the
    lanes ``lay`` under the (n_pix_loc, 3) cotangent rows g_rows: (galb,
    gemi)."""
    geom = pack_geometry(scene, cam) if geometry is None else geometry
    K = _n_objects(scene)
    alb, emi = _tables(albedo, emission, K, device)
    g = g_rows.detach().to(device=device, dtype=torch.float32).contiguous()
    n_blocks = -(-lay.n_pix_loc * lay.g // KERNEL_BLOCK)
    partials = torch.empty(n_blocks * 6 * K, dtype=torch.float32,
                           device=device)
    out = torch.empty((2, K, 3), dtype=torch.float32, device=device)
    lib = _build.build_kernels().lib
    family = kernel_family(scene)
    code = est_code(cfg)
    grads = (alb.data_ptr(), emi.data_ptr(), g.data_ptr(),
             partials.data_ptr(), partials.numel(), out.data_ptr(), code,
             cfg.mixture_q)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if family:
            sa = _table_args(lib, scene, alb, emi, device)
            spheres = (*sa.args()[:4], sa.refl.data_ptr())
        else:
            spheres = (None, 0, None, 0, None)
        if family == "_ext":
            err = lib.spt_megakernel_vjp_ext(
                *ext_scene_args(geom), *launch_args(geom, cfg, seed, lay),
                *grads, *spheres, sa.gloss.data_ptr(), stream,
            )
        else:
            err = (lib.spt_megakernel_vjp if code in _OWN_CODES
                   else lib.spt_megakernel_vjp_est)(
                geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
                len(geom.rect_axis), *launch_args(geom, cfg, seed, lay),
                *grads, int(family != ""), *spheres, stream,
            )
    count(vjp_kernel_name(scene, cfg), err)
    return out[0], out[1]


class RenderMaterials(torch.autograd.Function):
    """I_sum (h, w, 3) = render_megakernel_mat(...) as a function of the
    albedo and emission tables. Backward: the adjoint kernel on a CUDA
    device, the plain VJP on the CPU.

    apply(albedo, emission, scene, cam, cfg, seed, geometry=None)"""

    @staticmethod
    def forward(ctx, albedo, emission, scene, cam, cfg, seed, geometry=None):
        img, _ = render_megakernel_mat(scene, cam, cfg, albedo, emission,
                                       seed, geometry=geometry)
        ctx.save_for_backward(albedo, emission)
        ctx.render_args = (scene, cam, cfg, seed, geometry)
        return img

    @staticmethod
    def backward(ctx, g_img):
        albedo, emission = ctx.saved_tensors
        scene, cam, cfg, seed, geometry = ctx.render_args
        galb, gemi = render_megakernel_vjp(scene, cam, cfg, albedo, emission,
                                           seed, g_img, geometry=geometry)
        return galb, gemi, None, None, None, None, None


def loss_and_material_grads(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, seed, target,
                            geometry: KernelGeometry | None = None):
    """One training evaluation: MSE of the linear mean image against
    ``target`` (h, w, 3), with the albedo and emission gradients from the
    adjoint. Returns (loss (), galb (K, 3), gemi (K, 3))."""
    alb, emi = (t.requires_grad_() for t in pack_materials(scene))
    img_sum = RenderMaterials.apply(alb, emi, scene, cam, cfg, seed,
                                    geometry)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=img_sum.device)
    diff = img_sum / cfg.spp - target
    loss = torch.mean(diff * diff)
    galb, gemi = torch.autograd.grad(loss, (alb, emi))
    return loss.detach(), galb, gemi


def fit_megakernel(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                   target, steps: int = 20, lr: float = 1.0,
                   train_fields: tuple[str, ...] = ("emission", "albedo"),
                   seed: int = 0, log=None, checkpoint: str | None = None,
                   checkpoint_every: int = 0):
    """Inverse rendering on the kernels: SGD on the material tables through
    the runtime-material forward and the adjoint. Every step uses the same
    ``seed``. The geometry is packed once; the tables stay on the device.

    Returns (optimized scene, list of per-step losses)."""
    check_trainable(scene, cfg)
    if checkpoint or checkpoint_every:
        raise NotImplementedError(
            "fit checkpoints are not ported yet (ROADMAP.md queue 1, item "
            "16: utils/train_checkpoint.py -> torch.save)"
        )
    bad = [f for f in train_fields if f not in FIELDS]
    if bad:
        raise ValueError(f"train_fields must be in {FIELDS}, got {bad}")
    geometry = (pack_geometry(scene, cam) if scene.device.type == "cuda"
                else None)
    alb, emi = pack_materials(scene)
    losses = []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, galb, gemi = loss_and_material_grads(
            unpack_materials(scene, alb, emi), cam, cfg, seed, target,
            geometry,
        )
        if "albedo" in train_fields:
            alb = alb - lr * galb
        if "emission" in train_fields:
            emi = emi - lr * gemi
        losses.append(float(loss))  # waits for the step's kernels
        if log is not None:
            print(f"step {i}: loss {losses[-1]:.6f}  seconds "
                  f"{time.perf_counter() - t0:.6f}", file=log, flush=True)
    return unpack_materials(scene, alb, emi), losses


# ---------------------------------------------------------------------------
# Row 10: the material train step over an (sp, dp) mesh.

def render_megakernel_mat_shard_plain(scene: Scene, cam: CameraParams,
                                      cfg: RenderConfig, mesh: Mesh, albedo,
                                      emission, seed, device=None):
    """The shard forward's plain version (see render_megakernel_mat_shard)."""
    device = _resolve(scene, device)
    return _mat_plain(scene, cam, cfg, albedo, emission, seed,
                      shard_of(cfg, mesh, what="spp"), device)


def render_megakernel_mat_shard(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, mesh: Mesh, albedo,
                                emission, seed, device=None,
                                geometry: KernelGeometry | None = None):
    """This rank's own partial of the runtime-material forward over all of
    spp: its pixel block's radiance sums over its dp sample range, before
    any collective (row 8 on the shard's lanes on a CUDA device). Returns
    ((n_pix_loc, 3) partial sums, traces (2,) int64 of the shard)."""
    check_trainable(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_mat_shard_plain(scene, cam, cfg, mesh,
                                                 albedo, emission, seed,
                                                 device)
    return _launch_mat(scene, cam, cfg, albedo, emission, seed,
                       shard_of(cfg, mesh, what="spp"), device, geometry)


def render_megakernel_vjp_shard_plain(scene: Scene, cam: CameraParams,
                                      cfg: RenderConfig, mesh: Mesh, albedo,
                                      emission, seed, g_rows, device=None):
    """The shard adjoint's plain version: torch.autograd through the shard
    forward's plain version."""
    device = _resolve(scene, device)
    g = g_rows.detach().to(device=device, dtype=torch.float32)
    return _vjp_plain(scene, cam, cfg, albedo, emission, seed, g,
                      shard_of(cfg, mesh, what="spp"), device)


def render_megakernel_vjp_shard(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, mesh: Mesh, albedo,
                                emission, seed, g_rows, device=None,
                                geometry: KernelGeometry | None = None):
    """This rank's own partial of the material adjoint: the cotangents of
    sum(g_rows · I_loc) over its shard's lanes, where g_rows (n_pix_loc, 3)
    holds the cotangents of its pixel block only (row 9 on a CUDA
    device). Returns (galb, gemi) partials, each (K, 3)."""
    check_trainable(scene, cfg)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_vjp_shard_plain(scene, cam, cfg, mesh,
                                                 albedo, emission, seed,
                                                 g_rows, device)
    lay = shard_of(cfg, mesh, what="spp")
    if tuple(g_rows.shape) != (lay.n_pix_loc, 3):
        raise ValueError(f"g_rows must be ({lay.n_pix_loc}, 3), got "
                         f"{tuple(g_rows.shape)}")
    return _launch_vjp(scene, cam, cfg, albedo, emission, seed, g_rows, lay,
                       device, geometry)


def material_train_step_sharded(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, mesh: Mesh, target,
                                device=None):
    """The JAX package's ``material_train_step_sharded``: a training
    evaluation over the mesh in which every rank (a) renders its shard
    through the runtime-material forward, (b) sums the partial image over
    dp, (c) takes its loss and cotangent from its own pixel rows of
    ``target`` (h, w, 3), and (d) runs the adjoint on the same lanes. The
    local loss is already replicated along dp, so it sums over sp only;
    the gradients sum over the whole mesh.

    Returns step(albedo, emission, seed) -> (loss (), galb (K, 3),
    gemi (K, 3)), the same on every rank."""
    check_trainable(scene, cfg)
    device = _resolve(scene, device)
    lay = shard_of(cfg, mesh, what="spp")
    n_pix, spp = cfg.width * cfg.height, cfg.spp
    tgt = torch.as_tensor(target, dtype=torch.float32, device=device)
    tgt = tgt.reshape(n_pix, 3)[lay.pix0:lay.pix0 + lay.n_pix_loc]
    geometry = pack_geometry(scene, cam) if device.type == "cuda" else None
    spp_t = torch.tensor(float(spp), device=device)
    n_t = torch.tensor(float(n_pix * 3), device=device)
    inv_n = torch.tensor(2.0 / (n_pix * 3 * spp), device=device)

    def step(albedo, emission, seed):
        part, _ = render_megakernel_mat_shard(scene, cam, cfg, mesh, albedo,
                                              emission, seed, device,
                                              geometry)
        diff = mesh.sum_dp(part) / spp_t - tgt
        loss = mesh.sum_sp(torch.sum(diff * diff) / n_t)
        galb, gemi = render_megakernel_vjp_shard(
            scene, cam, cfg, mesh, albedo, emission, seed, diff * inv_n,
            device, geometry)
        return loss, mesh.sum_world(galb), mesh.sum_world(gemi)

    return step
