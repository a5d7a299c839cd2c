"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version and against the committed golden image,
then drives the main path (``cli render`` of the Cornell box, ``nee``,
1024x768x512) and checks that the path went through the kernel. Every phase
raises on failure. The second-to-last line of the output is one JSON object
describing each kernel, the line before it the card's name and power limit,
and the last line ``{"ok": true, "device": {...}}``. Without CUDA, or outside
the repository, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "goldens" / "cornell_box_64x48x16_nee_seed42.ppm"
KERNEL_SOURCE = "small_pathtracer_tpu_torch/csrc/megakernel.cu"
REPLACES = "small_pathtracer_tpu/ops/megakernel.py:1203"


def log(msg: str) -> None:
    """Progress to stdout, and a copy of each [smoke] line to stderr, so the
    end of stderr alone says which phase a failure stopped in."""
    print(msg, flush=True)
    if msg.startswith("[smoke]"):
        print(msg, file=sys.stderr, flush=True)


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


def golden_bound(got: np.ndarray, golden: np.ndarray) -> tuple[float, float]:
    """The JAX-free golden contract: >= 99% of bytes equal and each channel
    mean within 0.5 levels. Returns (equal fraction, worst mean gap)."""
    if got.shape != golden.shape:
        raise AssertionError(f"shape {got.shape} != golden {golden.shape}")
    eq = float(np.mean(got == golden))
    gap = float(np.max(np.abs(
        got.reshape(-1, 3).astype(np.float64).mean(0)
        - golden.reshape(-1, 3).astype(np.float64).mean(0)
    )))
    if eq < 0.99 or gap > 0.5:
        raise AssertionError(
            f"golden mismatch: {eq:.4%} bytes equal (need 99%), "
            f"channel mean gap {gap:.3f} levels (limit 0.5)"
        )
    return eq, gap


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.cli import main as cli_main
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.ops import _build, megakernel

    device = torch.device("cuda:0")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "--id=0"])
    log(f"[smoke] card: {card}")
    log(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("[smoke] nvcc: " + run([_build.find_nvcc(), "--version"])
        .splitlines()[-1])

    # Phase 2: build the kernel from this checkout's sources.
    built, build_s = timed(_build.build_kernels)
    log(f"[smoke] kernel build {built.build_seconds:.2f}s "
        f"(load included {build_s:.2f}s) from {KERNEL_SOURCE}")
    for line in built.build_output.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[smoke] ptxas: {line.strip()}")

    # Phase 3: the kernel against the committed golden (rendered by the JAX
    # package on the CPU).
    log("[smoke] phase: golden 64x48x16, kernel and plain version")
    golden = film.read_ppm(str(GOLDEN))
    cfg_g = RenderConfig(width=64, height=48, spp=16, seed=42)
    scene = get_scene("cornell_box", device=device)
    cam_g = make_camera(aspect=64 / 48, device=device)
    img, tr = megakernel.render_megakernel(scene, cam_g, cfg_g, 42)
    got = film.tonemap_u8(film.finalize(img / cfg_g.spp)).cpu().numpy()
    eq, gap = golden_bound(got, golden)
    # This shape has 16 lanes a pixel: the plain version must agree exactly.
    p_img, p_tr = megakernel.render_megakernel_plain(scene, cam_g, cfg_g, 42)
    if not (torch.equal(img, p_img) and torch.equal(tr, p_tr)):
        raise AssertionError("kernel and plain version differ at 64x48x16")
    log(f"[smoke] golden 64x48x16: {eq:.4%} bytes equal, channel mean gap "
        f"{gap:.3f} levels; kernel == plain, traces {tr.tolist()}: ok")

    # Phase 4: kernel against its plain version on the card, full width.
    # Times are medians of three wrapper calls (host clock, synchronized),
    # taken in turns: plain, kernel, kernel, plain, plain, kernel.
    log("[smoke] phase: parity 1024x768x4, kernel against plain version")
    cfg_p = RenderConfig(width=1024, height=768, spp=4, seed=3)
    cam_p = make_camera(aspect=1024 / 768, device=device)
    runs = {"kernel": [], "plain": []}
    fns = {"kernel": megakernel.render_megakernel,
           "plain": megakernel.render_megakernel_plain}
    for which in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        out, sec = timed(lambda: fns[which](scene, cam_p, cfg_p, 3))
        runs[which].append((sec, out))
    (k_img, k_tr), (p_img, p_tr) = runs["kernel"][0][1], runs["plain"][0][1]
    k_s = float(np.median([sec for sec, _ in runs["kernel"]]))
    p_s = float(np.median([sec for sec, _ in runs["plain"]]))
    for which, (img0, tr0) in (("kernel", (k_img, k_tr)),
                               ("plain", (p_img, p_tr))):
        for _, (img_i, tr_i) in runs[which][1:]:
            if not (torch.equal(img_i, img0) and torch.equal(tr_i, tr0)):
                raise AssertionError(f"{which} runs differ from each other")
    k_tr, p_tr = k_tr.tolist(), p_tr.tolist()
    max_err = float((k_img - p_img).abs().max())
    log(f"[smoke] parity 1024x768x4: kernel {k_s * 1e3:.3f} ms traces "
        f"{k_tr}; plain {p_s * 1e3:.3f} ms traces {p_tr}; "
        f"max |img diff| {max_err:.3e}")
    if k_tr != p_tr:
        raise AssertionError(f"trace counts differ: kernel {k_tr} plain {p_tr}")
    tol = 1e-5 * cfg_p.spp
    if not torch.allclose(k_img, p_img, rtol=0.0, atol=tol):
        raise AssertionError(f"image differs by {max_err} > atol {tol}")

    # Phase 5: the main path, as a user calls it.
    log("[smoke] phase: main path, cli render 1024x768x512")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell_1024x768x512.ppm")
        err = io.StringIO()
        megakernel.LAUNCHES = 0
        with contextlib.redirect_stderr(err):
            rc = cli_main(["render", "--width", "1024", "--height", "768",
                           "--spp", "512", "--estimator", "nee", "-o", out])
        launches = megakernel.LAUNCHES
        log("[smoke] cli: " + err.getvalue().strip())
        if rc != 0:
            raise AssertionError(f"cli render returned {rc}")
        if launches < 1:
            raise AssertionError("cli render did not launch the kernel")
        final = film.read_ppm(out)
    m = re.search(r"traces=(\d+)\s+seconds=([0-9.]+)", err.getvalue())
    if m is None:
        raise AssertionError("cli render printed no trace count")
    traces, seconds = int(m.group(1)), float(m.group(2))
    if final.shape != (768, 1024, 3):
        raise AssertionError(f"image shape {final.shape}")
    means = final.reshape(-1, 3).astype(np.float64).mean(0)
    g_means = golden.reshape(-1, 3).astype(np.float64).mean(0)
    rel = np.abs(means - g_means) / g_means
    log(f"[smoke] main path 1024x768x512: {launches} kernel launch(es), "
        f"{traces} rays in {seconds:.3f}s = {traces / seconds / 1e6:.1f} "
        f"Mrays/s on {card}; channel means {means.round(2).tolist()} vs "
        f"golden {g_means.round(2).tolist()}")
    if np.any(rel > 0.10):
        raise AssertionError(f"channel means off the golden's by {rel}")

    log(json.dumps({"kernels": [{
        "name": "megakernel_nee",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_s * 1e3,
        "plain_ms": p_s * 1e3,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
