"""CLI: ``python -m small_pathtracer_tpu_torch.cli render|bench|fit``.

``--device`` defaults to ``cuda``, where the render runs through the CUDA
kernels, and raises when CUDA is absent. ``--device cpu`` runs the eager
wavefront and, for ``fit``, torch.autograd through it.

``render`` takes the JAX CLI's single-card flags, with its messages and
composition rules: adaptive sampling (``--adaptive-tol``, through the
budget kernels), checkpointed and progressive renders (``--checkpoint``,
``--preview``, through span renders), voxel path guiding (``--guided``, a
training pre-pass and the guided kernel; ``--guide-online R`` retrains
between R spans), first-hit AOVs (``--aov``), the a-trous denoiser
(``--denoise``), and PPM or PNG output by extension. The JAX CLI's
``--guided`` without ``--pallas`` runs its fixed-depth jnp estimator; here
the device decides, as everywhere: the guided kernel on the card, its plain
version on the CPU.
One difference: ``--adaptive-tol 0`` runs the adaptive waves (the
uniform image, wave by wave), where the JAX CLI takes 0 for a uniform
render; leave the flag out for that.

``--mesh SPxDP`` (``render``, and ``fit --train center,radius``) splits the
pixels over SP ranks and the samples over DP ranks (``parallel/``): each
rank launches the kernels on its shard and the sums cross ranks through
``torch.distributed``. Launch SP * DP ranks with ``python -m
torch.distributed.run --nproc-per-node N -m small_pathtracer_tpu_torch.cli
...``, or run one process with ``--mesh 1x1``. ``--dist-backend`` is nccl
on the card and gloo on the CPU by default; several ranks on one card need
gloo (NCCL refuses two ranks on one device). Only rank 0 writes files and
the summary lines.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import ESTIMATORS, RenderConfig
from ..camera.pinhole import make_camera
from ..core import film, imageio
from ..device import resolve
from ..integrator.wavefront import render
from ..experiment.path_guiding import (
    guide_lobes, render_guided_online, train_guide,
)
from ..ops.megakernel import (
    GUIDED_ESTIMATORS, render_megakernel, render_megakernel_guided,
)
from ..ops import megakernel_geom
from ..parallel.launcher import init_distributed
from ..parallel.mesh import make_mesh
from ..parallel.sharded import render_sharded
from ..ops.megakernel_grad import (
    FIELDS, check_trainable, fit_megakernel, pack_materials,
)
from ..scene.presets import PRESETS, get_scene
from ..utils.adaptive import adaptive_render
from ..utils.aov import render_aovs
from ..utils.checkpoint import render_with_checkpoints
from ..utils.denoise import denoise


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box",
                   help="preset: " + ", ".join(PRESETS))
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--estimator", default="nee", choices=ESTIMATORS,
                   help="uniform | uniform_corrected | cosine | nee | "
                        "mixture | nee_textbook (unbiased shadow-ray NEE) "
                        "| mis (balance-heuristic MIS over light + BSDF "
                        "sampling)")
    p.add_argument("--mixture-q", type=float, default=0.5,
                   help="NEE probability of --estimator mixture")
    p.add_argument("--light-sample-mode", default="intended",
                   choices=["intended", "glibc_overflow"],
                   help="glibc_overflow: the reference's Linux light "
                        "sampler (nee and mixture only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernel) or cpu (eager)")
    p.add_argument("--sphere-table", default="auto",
                   choices=["auto", "on", "off", "cluster",
                            "cluster_scratch"],
                   help="the JAX package's sphere-table modes; here every "
                        "value takes the same kernel and gives the same "
                        "image (config.py)")


def _add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default="",
                   help="distributed mesh shape 'SPxDP' (e.g. 2x2) over the "
                        "ranks of the process group; empty = one process")
    p.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                   help="torch.distributed backend for --mesh (default: "
                        "nccl on cuda, gloo on cpu)")


@contextlib.contextmanager
def _distributed(args):
    """(mesh, device) for --mesh SPxDP, joining the process group first
    (and leaving it at the end when this call joined it); (None, device)
    without --mesh."""
    if not args.mesh:
        yield None, resolve(args.device)
        return
    try:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise SystemExit(f"--mesh takes SPxDP (e.g. 2x2), got {args.mesh!r}")
    backend = args.dist_backend or (
        "nccl" if resolve(args.device).type == "cuda" else "gloo")
    joined = not dist.is_initialized()
    device = init_distributed(backend, args.device)
    try:
        yield make_mesh(shape), device
    finally:
        if joined:
            dist.destroy_process_group()


def _build(args, device=None):
    device = resolve(args.device) if device is None else device
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       estimator=args.estimator, mixture_q=args.mixture_q,
                       light_sample_mode=args.light_sample_mode,
                       seed=args.seed, sphere_table=args.sphere_table)
    scene = get_scene(args.scene, device=device)
    cam = make_camera(aspect=args.width / args.height, device=device)
    return scene, cam, cfg


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    torch device name when nvidia-smi is absent."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)
    if res.returncode != 0 or not res.stdout.strip():
        return torch.cuda.get_device_name(device)
    return res.stdout.strip()


def _u8(x) -> np.ndarray:
    """[0, 1] floats to uint8, linearly (no gamma)."""
    x = np.asarray(x, np.float32)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _write_aovs(prefix: str, aovs) -> None:
    """The feature buffers as PPMs to look at (albedo tone-mapped like a
    render, normal mapped from [-1, 1] to [0, 1], depth over its max,
    coverage as grey) and PREFIX.npz with the float32 arrays."""
    host = {k: v.cpu().numpy().astype(np.float32) for k, v in aovs.items()}

    def gray3(x):
        return np.repeat(np.asarray(x)[..., None], 3, axis=-1)

    film.write_ppm(prefix + ".albedo.ppm",
                   film.tonemap_u8(aovs["albedo"]).cpu().numpy())
    film.write_ppm(prefix + ".normal.ppm", _u8((host["normal"] + 1.0) * 0.5))
    dep = host["depth"]
    dmax = float(dep.max())
    film.write_ppm(prefix + ".depth.ppm",
                   gray3(_u8(dep / (dmax if dmax > 0 else 1.0))))
    film.write_ppm(prefix + ".coverage.ppm", gray3(_u8(host["coverage"])))
    np.savez(prefix + ".npz", **host)


def _render_guided_cli(args, scene, cam, cfg, mesh=None):
    """render --guided: a cosine training pre-pass at 1/8 of the resolution
    (at least 16x16, seed + 1; the 10-unit voxel grid needs coverage, not
    pixels), its lobe table, then the guided render (online, in
    checkpointed or sharded spans, or one launch). Every rank of a mesh
    trains the same table. Returns (clamped linear image, traces)."""
    if cfg.estimator not in GUIDED_ESTIMATORS:
        raise SystemExit(
            "--guided requires --estimator cosine, nee_textbook, or mis "
            "(C13-continuation estimators replace the bounce with the "
            "light sample, leaving nothing to guide)"
        )
    if args.guide_online > 0 and (args.checkpoint or args.preview or mesh):
        raise SystemExit(
            "--guide-online does not compose with "
            "--checkpoint/--mesh/--preview yet (the span schedule is "
            "owned by the online loop); drop one of the flags"
        )
    tcfg = RenderConfig(width=max(args.width // 8, 16),
                        height=max(args.height // 8, 16),
                        spp=args.guide_train_spp, seed=args.seed + 1)
    t0 = time.perf_counter()
    guide = guide_lobes(train_guide(scene, cam, tcfg, args.guide_bounces,
                                    tcfg.seed))
    n_guided = int(guide[1].sum())
    if mesh is None or mesh.rank == 0:
        print(f"guide table trained: {n_guided} guided voxels (pre-pass "
              f"{time.perf_counter() - t0:.6f} s)", file=sys.stderr)
    if args.guide_online > 0:
        img, tr = render_guided_online(
            scene, cam, cfg, cfg.seed, args.guide_beta, args.guide_k,
            rounds=args.guide_online, train_spp=args.guide_train_spp,
            train_bounces=args.guide_bounces)
    elif args.checkpoint or args.preview or mesh is not None:
        every = args.checkpoint_every
        if args.preview:
            every = (args.preview_every or args.checkpoint_every
                     or max(1, cfg.spp // 8))
        return render_with_checkpoints(
            scene, cam, cfg, args.checkpoint, every, mesh=mesh,
            preview_path=args.preview, guide=guide,
            guide_beta=args.guide_beta, guide_k=args.guide_k)
    else:
        img, tr = render_megakernel_guided(scene, cam, cfg, cfg.seed, guide,
                                           args.guide_beta, args.guide_k)
    spp_t = torch.tensor(float(cfg.spp), device=img.device)
    return film.finalize(img / spp_t), int(tr.sum())


def cmd_render(args) -> int:
    with _distributed(args) as (mesh, device):
        return _render(args, mesh, device)


def _render(args, mesh, device) -> int:
    scene, cam, cfg = _build(args, device)
    lead = mesh is None or mesh.rank == 0
    t0 = time.perf_counter()
    if args.adaptive_tol is not None:
        if args.checkpoint or args.preview or args.guided or mesh:
            raise SystemExit(
                "--adaptive-tol composes with --pallas only (not --mesh/"
                "--checkpoint/--preview/--guided)"
            )
        res = adaptive_render(scene, cam, cfg, tol=args.adaptive_tol,
                              wave=args.adaptive_wave, log=sys.stderr)
        img, traces = res.image, sum(res.traces)
        spp_map = res.spp_map.cpu().numpy()
        print(
            f"[adaptive] {res.waves} waves, {res.total_samples} samples "
            f"({100.0 * res.total_samples / res.uniform_samples:.0f}% of "
            f"uniform {cfg.spp} spp), spp range "
            f"{int(spp_map.min())}-{int(spp_map.max())}",
            file=sys.stderr,
        )
        if args.adaptive_map:
            m = spp_map.astype(np.float32) / float(spp_map.max())
            film.write_ppm(args.adaptive_map, film.tonemap_u8(
                torch.from_numpy(np.repeat(m[..., None], 3, axis=-1))
            ).numpy())
    elif args.guided:
        img, traces = _render_guided_cli(args, scene, cam, cfg, mesh)
    elif args.checkpoint or args.preview:
        every = args.checkpoint_every
        if args.preview:
            every = (args.preview_every or args.checkpoint_every
                     or max(1, cfg.spp // 8))
        img, traces = render_with_checkpoints(
            scene, cam, cfg, args.checkpoint, every, mesh=mesh,
            preview_path=args.preview,
        )
    elif mesh is not None:
        img, traces = render_sharded(scene, cam, cfg, mesh)
    else:
        img, traces = render(scene, cam, cfg)
    if lead and (args.aov or args.denoise):
        aovs = render_aovs(scene, cam, cfg,
                           spp=args.aov_spp if args.aov_spp > 0 else None)
        if args.denoise:
            img = film.finalize(denoise(img, aovs, iterations=args.denoise,
                                        sigma_l=args.denoise_sigma_l))
        if args.aov:
            _write_aovs(args.aov, aovs)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the render produced non-finite pixels")
    u8 = film.tonemap_u8(img).cpu().numpy()
    dt = time.perf_counter() - t0
    if not lead:
        return 0
    imageio.write_image(args.output, u8)
    where = str(scene.device) + (
        "" if mesh is None else f" mesh {mesh.n_sp}x{mesh.n_dp} "
        f"({mesh.backend})")
    print(
        f"wrote {args.output}  {cfg.width}x{cfg.height}x{cfg.spp}spp "
        f"on {where}  traces={traces}  seconds={dt:.6f}  "
        f"{traces / dt / 1e6:.1f} Mrays/s",
        file=sys.stderr,
    )
    return 0


def cmd_bench(args) -> int:
    scene, cam, cfg = _build(args)
    if scene.device.type != "cuda":
        raise RuntimeError("bench measures the card: run it with a CUDA device")

    def once(seed):
        run_cfg = dataclasses.replace(cfg, seed=seed)
        img, traces = render(scene, cam, run_cfg)
        float(img.mean())  # value fetch: the render has finished
        return traces

    once(7)  # warmup and kernel build
    best_dt, traces = None, 0
    for seed in (1, 2):
        t0 = time.perf_counter()
        traces = once(seed)
        dt = time.perf_counter() - t0
        best_dt = dt if best_dt is None else min(best_dt, dt)
    mrays = traces / best_dt / 1e6
    print(json.dumps({
        "metric": (f"Mrays/s ({args.scene} {cfg.width}x{cfg.height}x"
                   f"{cfg.spp}spp {cfg.estimator}, cuda megakernel)"),
        "value": mrays,
        "unit": "Mrays/s",
        "device": card_name(scene.device),
    }))
    return 0


def _fit_result(loss: float, steps: int) -> dict:
    """Strict-JSON fit summary (the JAX CLI's, which also reports a resumed
    checkpoint as ``already_complete``): ``final_loss`` is None, with
    ``diverged`` set, when the last step's loss is NaN or infinite (the
    JAX CLI prints an infinite loss as JSON's non-standard Infinity)."""
    if not math.isfinite(loss):
        return {"steps": steps, "final_loss": None, "diverged": True}
    return {"steps": steps, "final_loss": loss}


def _read_target(path: str, cfg: RenderConfig, device) -> torch.Tensor:
    target = torch.as_tensor(film.srgb_from_u8(film.read_ppm(path)),
                             dtype=torch.float32, device=device)
    if tuple(target.shape) != (cfg.height, cfg.width, 3):
        raise SystemExit(
            f"--target is {tuple(target.shape[:2])} pixels, the render "
            f"{(cfg.height, cfg.width)}"
        )
    return target


def _cmd_fit_geom(args, fields: tuple[str, ...], mesh=None,
                  device=None) -> int:
    """Sphere fitting through the geometry adjoint (the JAX CLI's ``fit
    --pallas --train center,...``): normalized-step descent on the spheres'
    fields, one image and one adjoint launch of the estimator's
    megakernel_geom instance a step (``--estimator``,
    ``--light-sample-mode``). Without ``--target`` the self-test: the
    target is the scene at seed + 1, then sphere ``--fd-sphere`` (or 0) is
    moved by (4, 0, -3) and its radius scaled by 1.1. With ``--mesh``
    every step is sharded (``fit_geom(mesh=)``); each rank renders the
    whole target."""
    bad = [f for f in fields if f not in megakernel_geom.FIELDS]
    if bad or args.optimizer != "sgd":
        raise SystemExit(
            "fit --train center,... supports --optimizer sgd on "
            "center/radius/albedo/emission "
            f"(got optimizer={args.optimizer}, fields={fields})"
        )
    scene, cam, cfg = _build(args, device)
    lead = mesh is None or mesh.rank == 0
    si = args.fd_sphere if args.fd_sphere >= 0 else None
    n_sph = scene.spheres.radius.shape[0]
    if n_sph == 0:
        raise SystemExit("scene has no spheres to fit")
    megakernel_geom.check_geom(scene, cfg)
    if si is not None and si >= n_sph:
        raise SystemExit(f"--fd-sphere {si} out of range ({n_sph})")
    megakernel_geom.check_fit(fields, si)
    if args.target:
        target = _read_target(args.target, cfg, scene.device)
    else:
        img_sum = megakernel_geom.geom_run(scene, cam, cfg, cfg.seed + 1)[0]
        target = img_sum / cfg.spp
        s0 = si if si is not None else 0
        sp = scene.spheres
        center, radius = sp.center.clone(), sp.radius.clone()
        center[s0] += torch.tensor([4.0, 0.0, -3.0], device=center.device)
        radius[s0] *= 1.1
        scene = scene._replace(spheres=sp._replace(center=center,
                                                   radius=radius))
    fitted, losses = megakernel_geom.fit_geom(
        scene, cam, cfg, target, sphere_idx=si, fields=fields,
        steps=args.steps, lr=args.lr, seed=cfg.seed,
        log=sys.stderr if lead else None, mesh=mesh,
    )
    out = _fit_result(losses[-1], args.steps)
    ri = si if si is not None else 0
    out["center"] = fitted.spheres.center[ri].tolist()
    out["radius"] = float(fitted.spheres.radius[ri])
    if lead:
        print(json.dumps(out, allow_nan=False))
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering on the kernels: SGD on the albedo and emission
    tables (the JAX CLI's ``fit --pallas``), or, when ``--train`` names
    center or radius, sphere fitting through the geometry adjoint
    (``_cmd_fit_geom``). Without ``--target`` the material fit's target is
    the scene rendered with its rects' emission x1.5 at seed + 1, as the
    JAX CLI builds it (a quad light, as ``cornell_tilted_light``'s, keeps
    its emission there: drive that fit with ``--target``); the printed
    ``light_emission`` is the light's row of the fitted emission table, a
    rect's or a quad's."""
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    fields = tuple(args.train.split(","))
    if {"center", "radius"} & set(fields):
        with _distributed(args) as (mesh, device):
            return _cmd_fit_geom(args, fields, mesh, device)
    if args.mesh:
        raise SystemExit(
            "--mesh shards the sphere fit (--train center,radius,...) "
            "only: the kernels' material fit takes no mesh (the JAX CLI's "
            "fit --pallas ignores it), and the sharded autodiff fit is not "
            "ported yet (ROADMAP.md queue 1, item 16)")
    bad = [f for f in fields if f not in FIELDS]
    if bad or args.optimizer != "sgd":
        raise SystemExit(
            "fit supports --optimizer sgd on albedo/emission only (got "
            f"optimizer={args.optimizer}, fields={fields})"
        )
    scene, cam, cfg = _build(args)
    check_trainable(scene, cfg)
    if args.target:
        target = _read_target(args.target, cfg, scene.device)
    else:
        bright = scene._replace(rects=scene.rects._replace(
            emission=scene.rects.emission * 1.5))
        img_sum, _ = render_megakernel(bright, cam, cfg, cfg.seed + 1)
        target = img_sum / cfg.spp
    fitted, losses = fit_megakernel(
        scene, cam, cfg, target, steps=args.steps, lr=args.lr,
        train_fields=fields, seed=cfg.seed, log=sys.stderr,
    )
    out = _fit_result(losses[-1], args.steps)
    light = scene.light.light_obj_id
    out["light_emission"] = [
        v if math.isfinite(v) else None
        for v in pack_materials(fitted)[1][light].tolist()
    ]
    print(json.dumps(out, allow_nan=False))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="small_pathtracer_tpu_torch",
        description="path tracer, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_render = sub.add_parser("render", help="render an image")
    _add_render_args(p_render)
    _add_mesh_args(p_render)
    p_render.add_argument("-o", "--output", default="image.ppm",
                          help="output image: ASCII PPM for .ppm, else PNG")
    p_render.add_argument(
        "--adaptive-tol", type=float, default=None,
        help="adaptive sampling: stop a pixel when the standard error of "
             "its mean falls below TOL * (luma + 0.02); --spp becomes the "
             "per-pixel cap (utils/adaptive.py). 0 = every pixel to spp, "
             "in waves; without the flag, uniform sampling")
    p_render.add_argument(
        "--adaptive-wave", type=int, default=0,
        help="samples per adaptive wave (0 = auto: spp/8, at least 8)")
    p_render.add_argument(
        "--adaptive-map", default="",
        help="also write the per-pixel spp heatmap to this PPM path")
    p_render.add_argument(
        "--checkpoint", default="",
        help="render-state checkpoint path (resume if it exists)")
    p_render.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save render state every N spp (0 = only at end)")
    p_render.add_argument(
        "--preview", default="",
        help="progressive preview: write the tone-mapped running mean here "
             "(atomically, PPM/PNG by extension) after every "
             "--preview-every spp chunk")
    p_render.add_argument(
        "--preview-every", type=int, default=0,
        help="preview/chunk interval in spp (default: --checkpoint-every, "
             "else spp/8)")
    p_render.add_argument(
        "--guided", action="store_true",
        help="voxel path guiding (experiment/path_guiding.py): train a lobe "
             "table with a short pre-pass, then importance-sample the guided "
             "mixture through the guided kernel; estimator must be cosine, "
             "nee_textbook or mis")
    p_render.add_argument(
        "--guide-beta", type=float, default=0.6,
        help="guided-mixture lobe probability in guided voxels")
    p_render.add_argument("--guide-k", type=float, default=8.0,
                          help="power-cosine lobe sharpness")
    p_render.add_argument(
        "--guide-train-spp", type=int, default=16,
        help="spp of the guide-training pre-pass (at 1/8 res)")
    p_render.add_argument(
        "--guide-bounces", type=int, default=8,
        help="bounce depth of the guide-training passes")
    p_render.add_argument(
        "--guide-online", type=int, default=0, metavar="R",
        help="online guiding: render in R sample spans, refining the lobe "
             "table between spans from low-res training passes; 0 = one "
             "pre-trained table for the whole render")
    p_render.add_argument(
        "--aov", default="",
        help="also render first-hit feature buffers (utils/aov.py) and "
             "write PREFIX.{albedo,normal,depth,coverage}.ppm plus "
             "PREFIX.npz with the raw float32 arrays")
    p_render.add_argument(
        "--aov-spp", type=int, default=0,
        help="primary samples for the AOV pass (0 = auto: min(spp, 64))")
    p_render.add_argument(
        "--denoise", type=int, nargs="?", const=5, default=0, metavar="N",
        help="edge-aware a-trous denoise (utils/denoise.py) with N passes "
             "(bare flag = 5) guided by an AOV pass; filters the linear "
             "image before the tone map")
    p_render.add_argument(
        "--denoise-sigma-l", type=float, default=0.5,
        help="denoiser luminance edge stop (bigger = smoother)")
    p_render.set_defaults(fn=cmd_render)
    p_bench = sub.add_parser("bench", help="measure Mrays/s on the card")
    _add_render_args(p_bench)
    p_bench.set_defaults(fn=cmd_bench)
    p_fit = sub.add_parser(
        "fit", help="inverse rendering: SGD on albedo/emission, or sphere "
                    "fitting with --train center,radius")
    _add_render_args(p_fit)
    _add_mesh_args(p_fit)
    p_fit.add_argument("--target", default="", help="target PPM image")
    p_fit.add_argument("--steps", type=int, default=20)
    p_fit.add_argument("--lr", type=float, default=1.0)
    p_fit.add_argument("--train", default="emission,albedo",
                       help="comma-separated fields to train: albedo, "
                            "emission; naming center or radius fits the "
                            "spheres' center, radius, albedo, emission "
                            "through the geometry adjoint")
    p_fit.add_argument("--fd-sphere", type=int, default=-1,
                       help="with --train center/radius: fit sphere IDX "
                            "only (needs the edge-sampled boundary terms, "
                            "not ported yet: item 16)")
    p_fit.add_argument("--optimizer", default="sgd",
                       help="sgd (the only one the kernel path takes)")
    p_fit.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    return args.fn(args)
