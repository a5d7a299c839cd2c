"""CLI: ``python -m small_pathtracer_tpu_torch.cli render|bench|fit``.

``--device`` defaults to ``cuda``, where the render runs through the CUDA
kernels, and raises when CUDA is absent. ``--device cpu`` runs the eager
wavefront and, for ``fit``, torch.autograd through it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from ..config import ESTIMATORS, RenderConfig
from ..camera.pinhole import make_camera
from ..core import film
from ..device import resolve
from ..integrator.wavefront import render
from ..ops.megakernel import render_megakernel
from ..ops.megakernel_grad import FIELDS, check_trainable, fit_megakernel
from ..scene.presets import PRESETS, get_scene


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


def cmd_render(args) -> int:
    scene, cam, cfg = _build(args)
    t0 = time.perf_counter()
    img, traces = render(scene, cam, cfg)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the render produced non-finite pixels")
    u8 = film.tonemap_u8(img).cpu().numpy()
    dt = time.perf_counter() - t0
    film.write_ppm(args.output, u8)
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
    p_render.add_argument("-o", "--output", default="image.ppm")
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
