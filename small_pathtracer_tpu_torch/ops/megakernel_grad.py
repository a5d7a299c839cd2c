"""Material training on the kernels: the port's counterpart of the JAX
package's ``ops/megakernel_grad.py`` for ``nee``, rects and one rect light.

- ``render_megakernel_mat``: the forward with runtime (K, 3) albedo and
  emission tables (``csrc/megakernel.cu``, ``megakernel_nee_mat``), the
  counterpart of ``render_pallas_mat``. Equal tables give the image and
  trace counts of ``ops.megakernel.render_megakernel`` bit for bit.
- ``render_megakernel_vjp``: the material adjoint by two-pass replay
  (``csrc/megakernel_grad.cu``), the counterpart of ``render_pallas_vjp``.
- ``RenderMaterials``: the two as one ``torch.autograd.Function``.
- ``loss_and_material_grads`` and ``fit_megakernel``: SGD on the tables, the
  counterparts of ``loss_and_material_grads`` and ``fit_pallas``.

The tables are in global object order (``pack_materials``): the rects, so
K = 17 for ``cornell_box``. Scenes with spheres or SPEC/REFR objects are
refused on every device (``check_trainable``): the kernels of rows 8 and 9
know rects and DIFF only. On a CUDA device each wrapper launches its
kernel or raises. On the CPU it runs the plain version: the eager forward
(``render_megakernel_plain``) with the tables put into the scene and, for
the adjoint, ``torch.autograd`` through it.
"""

from __future__ import annotations

import time

import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..scene.types import (
    DIFF, LightSampler, Rects, Scene, Spheres, num_spheres,
)
from . import _build
from .megakernel import (
    KernelGeometry, _layout, _reduce, _resolve, check_launch, launch_args,
    pack_geometry, render_megakernel_plain,
)

# Launches of each CUDA kernel in this process (each wrapper adds one per
# launch of its kernel, and nowhere else).
LAUNCHES_MAT = 0
LAUNCHES_VJP = 0

# Threads a block of the adjoint kernel (kBlock in csrc/megakernel_common.cuh):
# it sizes the per-block partial sums.
KERNEL_BLOCK = 128
FIELDS = ("albedo", "emission")


def check_trainable(scene: Scene) -> None:
    """Raises NotImplementedError for a scene outside rows 8 and 9 (spheres
    or SPEC/REFR objects), on every device, so the CPU never trains a scene
    that the card refuses."""
    if num_spheres(scene) or bool((scene.rects.refl != DIFF).any()):
        raise NotImplementedError(
            "material training on scenes with spheres or SPEC/REFR objects "
            "is not ported yet (ROADMAP.md queue 1, item 23)"
        )


def pack_materials(scene: Scene):
    """The scene's materials as (K, 3) float32 tables in global object order
    (this slice's scenes hold rects only)."""
    r = scene.rects
    return (r.albedo.to(torch.float32).reshape(-1, 3).clone(),
            r.emission.to(torch.float32).reshape(-1, 3).clone())


def unpack_materials(scene: Scene, alb, emi) -> Scene:
    """Inverse of pack_materials: the tables put back into the scene."""
    R = scene.rects.k.shape[0]
    for t in (alb, emi):
        if tuple(t.shape) != (R, 3):
            raise ValueError(f"expected a ({R}, 3) table, got {tuple(t.shape)}")
    return scene._replace(rects=scene.rects._replace(albedo=alb,
                                                     emission=emi))


def material_grads_to_scene(scene: Scene, galb, gemi) -> Scene:
    """(K, 3) material cotangents as a scene-shaped tuple of gradients
    (zeros for every non-material leaf)."""
    light = scene.light
    zero = Scene(
        rects=Rects(*(torch.zeros_like(t) for t in scene.rects)),
        spheres=Spheres(*(torch.zeros_like(t) for t in scene.spheres)),
        light=LightSampler(torch.zeros_like(light.corner),
                           torch.zeros_like(light.edge_u),
                           torch.zeros_like(light.edge_v),
                           light.light_obj_id),
    )
    return unpack_materials(zero, galb, gemi)


def _tables(albedo, emission, n_rects: int, device):
    out = []
    for t in (albedo, emission):
        t = t.detach().to(device=device, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (n_rects, 3):
            raise ValueError(
                f"expected a ({n_rects}, 3) table, got {tuple(t.shape)}"
            )
        out.append(t)
    return out


def render_megakernel_mat_plain(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, albedo, emission, seed,
                                s0: int = 0, n_s: int | None = None,
                                device=None):
    """The runtime-material kernel's plain version: the eager forward with
    the tables put into the scene."""
    return render_megakernel_plain(
        unpack_materials(scene, albedo, emission), cam, cfg, seed, s0, n_s,
        device,
    )


def render_megakernel_mat(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, albedo, emission, seed,
                          s0: int = 0, n_s: int | None = None, device=None,
                          geometry: KernelGeometry | None = None):
    """Render the scene's geometry with the (K, 3) ``albedo`` and
    ``emission`` tables over sample indices [s0, s0 + n_s). ``geometry``
    (``pack_geometry(scene, cam)``) saves the host copy of the geometry per
    call; the tables never leave the device. Returns ((h, w, 3) radiance sum
    over the span, traces (2,) int64 [extend, probe])."""
    check_trainable(scene)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_mat_plain(scene, cam, cfg, albedo, emission,
                                           seed, s0, n_s, device)
    global LAUNCHES_MAT
    geom = pack_geometry(scene, cam) if geometry is None else geometry
    alb, emi = _tables(albedo, emission, len(geom.rect_axis), device)
    n_s = cfg.spp if n_s is None else int(n_s)
    n_pix, g, per = _layout(cfg, n_s)
    lib = _build.build_kernels().lib
    out_l = torch.empty((n_pix * g, 3), dtype=torch.float32, device=device)
    traces = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_nee_mat(
            geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data,
            len(geom.rect_axis), *launch_args(geom, cfg, seed, g, per, s0),
            alb.data_ptr(), emi.data_ptr(), out_l.data_ptr(),
            traces.data_ptr(), stream,
        )
    check_launch(err, "megakernel_nee_mat")
    LAUNCHES_MAT += 1
    return _reduce(out_l, cfg, n_pix, g), traces


def render_megakernel_vjp_plain(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, albedo, emission, seed,
                                g_img, device=None):
    """The adjoint's plain version: torch.autograd of sum(g_img · I_sum)
    through the plain forward, the tables as leaves. Returns (d/d albedo,
    d/d emission), each (K, 3)."""
    device = _resolve(scene, device)
    alb, emi = (t.requires_grad_() for t in _tables(
        albedo, emission, scene.rects.k.shape[0], device))
    g = g_img.detach().to(device=device, dtype=torch.float32)
    with torch.enable_grad():
        img, _ = render_megakernel_mat_plain(scene.to(device), cam, cfg, alb,
                                             emi, seed, device=device)
        return torch.autograd.grad(img, (alb, emi), grad_outputs=g)


def render_megakernel_vjp(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, albedo, emission, seed, g_img,
                          device=None,
                          geometry: KernelGeometry | None = None):
    """Cotangents of sum over pixels of g_img · I_sum, where I_sum (h, w, 3)
    is render_megakernel_mat's radiance sum over spp: (d/d albedo,
    d/d emission), each (K, 3), pathwise. The CUDA kernel on a CUDA device,
    the plain version on the CPU."""
    check_trainable(scene)
    device = _resolve(scene, device)
    if device.type == "cpu":
        return render_megakernel_vjp_plain(scene, cam, cfg, albedo, emission,
                                           seed, g_img, device)
    global LAUNCHES_VJP
    geom = pack_geometry(scene, cam) if geometry is None else geometry
    R = len(geom.rect_axis)
    alb, emi = _tables(albedo, emission, R, device)
    g = g_img.detach().to(device=device, dtype=torch.float32).contiguous()
    if tuple(g.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(
            f"g_img must be ({cfg.height}, {cfg.width}, 3), got "
            f"{tuple(g.shape)}"
        )
    n_pix, groups, per = _layout(cfg, cfg.spp)
    n_blocks = -(-n_pix * groups // KERNEL_BLOCK)
    partials = torch.empty(n_blocks * 6 * R, dtype=torch.float32,
                           device=device)
    out = torch.empty((2, R, 3), dtype=torch.float32, device=device)
    lib = _build.build_kernels().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_megakernel_vjp(
            geom.rect_geom.ctypes.data, geom.rect_axis.ctypes.data, R,
            *launch_args(geom, cfg, seed, groups, per, 0),
            alb.data_ptr(), emi.data_ptr(), g.data_ptr(),
            partials.data_ptr(), partials.numel(), out.data_ptr(), stream,
        )
    check_launch(err, "megakernel_vjp")
    LAUNCHES_VJP += 1
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
    check_trainable(scene)
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
