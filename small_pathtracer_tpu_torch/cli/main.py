"""CLI: ``python -m small_pathtracer_tpu_torch.cli render|bench|fit``.

``--device`` defaults to ``cuda``, where the render runs through the CUDA
kernels, and raises when CUDA is absent. ``--device cpu`` runs the eager
wavefront and, for ``fit``, torch.autograd through it.

``render`` takes the JAX CLI's single-card flags, with its messages and
composition rules: adaptive sampling (``--adaptive-tol``, through the
budget kernels), checkpointed and progressive renders (``--checkpoint``,
``--preview``, through span renders), first-hit AOVs (``--aov``), the
a-trous denoiser (``--denoise``), and PPM or PNG output by extension.
One difference: ``--adaptive-tol 0`` runs the adaptive waves (the
uniform image, wave by wave), where the JAX CLI takes 0 for a uniform
render; leave the flag out for that.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import ESTIMATORS, RenderConfig
from ..camera.pinhole import make_camera
from ..core import film, imageio
from ..device import resolve
from ..integrator.wavefront import render
from ..ops.megakernel import render_megakernel
from ..ops.megakernel_grad import FIELDS, check_trainable, fit_megakernel
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
    p.add_argument("--estimator", default="nee", choices=ESTIMATORS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernel) or cpu (eager)")
    p.add_argument("--sphere-table", default="auto",
                   choices=["auto", "on", "off", "cluster",
                            "cluster_scratch"],
                   help="the JAX package's sphere-table modes; here every "
                        "value takes the same kernel and gives the same "
                        "image (config.py)")


def _build(args):
    device = resolve(args.device)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       estimator=args.estimator, seed=args.seed,
                       sphere_table=args.sphere_table)
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


def cmd_render(args) -> int:
    scene, cam, cfg = _build(args)
    t0 = time.perf_counter()
    if args.adaptive_tol is not None:
        if args.checkpoint or args.preview:
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
    elif args.checkpoint or args.preview:
        every = args.checkpoint_every
        if args.preview:
            every = (args.preview_every or args.checkpoint_every
                     or max(1, cfg.spp // 8))
        img, traces = render_with_checkpoints(
            scene, cam, cfg, args.checkpoint, every,
            preview_path=args.preview,
        )
    else:
        img, traces = render(scene, cam, cfg)
    if args.aov or args.denoise:
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
    imageio.write_image(args.output, u8)
    print(
        f"wrote {args.output}  {cfg.width}x{cfg.height}x{cfg.spp}spp "
        f"on {scene.device}  traces={traces}  seconds={dt:.6f}  "
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
    ``diverged`` set, when the last step's loss is NaN."""
    if loss != loss:
        return {"steps": steps, "final_loss": None, "diverged": True}
    return {"steps": steps, "final_loss": loss}


def cmd_fit(args) -> int:
    """Inverse rendering on the kernels: SGD on the albedo and emission
    tables (the JAX CLI's ``fit --pallas``). Without ``--target`` the target
    is the scene rendered with emission x1.5 at seed + 1."""
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    fields = tuple(args.train.split(","))
    bad = [f for f in fields if f not in FIELDS]
    if bad or args.optimizer != "sgd":
        raise SystemExit(
            "fit supports --optimizer sgd on albedo/emission only (got "
            f"optimizer={args.optimizer}, fields={fields})"
        )
    scene, cam, cfg = _build(args)
    check_trainable(scene)
    if args.target:
        target = torch.as_tensor(
            film.srgb_from_u8(film.read_ppm(args.target)),
            dtype=torch.float32, device=scene.device,
        )
        if tuple(target.shape) != (cfg.height, cfg.width, 3):
            raise SystemExit(
                f"--target is {tuple(target.shape[:2])} pixels, the render "
                f"{(cfg.height, cfg.width)}"
            )
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
        for v in fitted.rects.emission[light].tolist()
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
        "fit", help="inverse rendering: SGD on albedo/emission")
    _add_render_args(p_fit)
    p_fit.add_argument("--target", default="", help="target PPM image")
    p_fit.add_argument("--steps", type=int, default=20)
    p_fit.add_argument("--lr", type=float, default=1.0)
    p_fit.add_argument("--train", default="emission,albedo",
                       help="comma-separated fields to train: "
                            "albedo, emission")
    p_fit.add_argument("--optimizer", default="sgd",
                       help="sgd (the only one the kernel path takes)")
    p_fit.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    return args.fn(args)
