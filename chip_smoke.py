"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version (and
the baked forward against the committed golden image), then drives the two
paths a user calls: ``cli render`` of the Cornell box (``nee``,
1024x768x512) and ``cli fit`` (SGD on albedo and emission, 1024x768x512, 5
steps). Each path runs with the kernels' launch counts set to 0 just before
it and read just after, and fails unless its kernels launched. Every phase
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
CSRC = "small_pathtracer_tpu_torch/csrc/"
FIT_LR = "8"  # chosen on the CPU at 32x24x16: the loss falls for 5 steps
VJP_TOL = 1e-4  # of the largest entry of each table (reason: PERF.md)

# Peak rates of one H100 SXM at 700 W: fp32 outside the tensor cores and
# HBM from NVIDIA's data sheet; int32 from 64 INT32 lanes an SM x 132 SMs x
# 1.98 GHz.
FP32_PER_S = 67e12
INT32_PER_S = 16.7e12
BYTES_PER_S = 3.35e12
# Operations counted from the .cu sources (PERF.md): fp32 (FMA as 2,
# a divide or sqrt as 1) per nearest-hit query over the 17 rects, per
# bounce of shading, per probe (its least: ray prep and the light's test),
# per spawn and per pass-B gradient update; int32 per bounce (five murmur3
# draws, 16 operations each, sharing the 6 of the path-id word) and per
# spawn (two draws).
FP_QUERY, FP_SHADE, FP_PROBE, FP_SPAWN, FP_GRAD = 210, 162, 18, 35, 52
INT_BOUNCE, INT_SPAWN = 5 * 16 + 6, 2 * 16 + 6


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


def in_turns(fns: dict, order: tuple) -> tuple[dict, dict]:
    """Calls fns[name]() in the given order; returns ({name: outputs},
    {name: median seconds})."""
    outs = {k: [] for k in fns}
    secs = {k: [] for k in fns}
    for name in order:
        out, sec = timed(fns[name])
        outs[name].append(out)
        secs[name].append(sec)
    return outs, {k: float(np.median(v)) for k, v in secs.items()}


def event_ms(fn, n: int) -> float:
    """Milliseconds a call, by CUDA events around n calls in a row."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def bound(fp_ops: float, int_ops: float, n_bytes: float):
    """(least ms, what bounds it): the larger of the operations over the
    peak rate of their type and the bytes over the memory rate."""
    t_ops = max(fp_ops / FP32_PER_S, int_ops / INT32_PER_S)
    t_bytes = n_bytes / BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def forward_bound(traces, n_samples: int, n_lanes: int, k: int):
    """Forward kernels: every counted probe follows one traced, unfolded
    bounce (query, shading, probe, five draws); the extends beyond it (RR
    deaths, folded bounces) are left out, so this is a lower bound. Bytes:
    the per-lane radiance and the counters out, the tables in."""
    _, probe = traces
    fp = probe * (FP_QUERY + FP_SHADE + FP_PROBE) + n_samples * FP_SPAWN
    it = probe * INT_BOUNCE + n_samples * INT_SPAWN
    return bound(fp, it, n_lanes * 12 + 16 + 2 * k * 3 * 4)


def vjp_bound(traces, n_samples: int, n_pix: int, k: int):
    """The adjoint traces every bounce of every sample twice, unfolded (the
    forward's extend count), and updates the gradients once a bounce.
    Bytes: the cotangent image and the tables in, the gradients out."""
    extend, _ = traces
    per_pass = extend * (FP_QUERY + FP_SHADE + FP_PROBE) + n_samples * FP_SPAWN
    fp = 2 * per_pass + extend * FP_GRAD
    it = 2 * (extend * INT_BOUNCE + n_samples * INT_SPAWN)
    return bound(fp, it, n_pix * 12 + 4 * k * 3 * 4)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.cli import main as cli_main
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.ops import _build, megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg

    device = torch.device("cuda:0")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "--id=0"])
    log(f"[smoke] card: {card}")
    log(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("[smoke] nvcc: " + run([_build.find_nvcc(), "--version"])
        .splitlines()[-1])

    # Phase 2: build the kernels from this checkout's sources.
    built, build_s = timed(_build.build_kernels)
    log(f"[smoke] kernel build {built.build_seconds:.2f}s "
        f"(load included {build_s:.2f}s) from {CSRC}*.cu")
    for line in built.build_output.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[smoke] ptxas: {line.strip()}")

    # Phase 3: the baked kernel against the committed golden (rendered by
    # the JAX package on the CPU).
    log("[smoke] phase: golden 64x48x16, kernel and plain version")
    golden = film.read_ppm(str(GOLDEN))
    cfg_g = RenderConfig(width=64, height=48, spp=16, seed=42)
    scene = get_scene("cornell_box")
    cam_g = make_camera(aspect=64 / 48)
    img, tr = megakernel.render_megakernel(scene, cam_g, cfg_g, 42)
    got = film.tonemap_u8(film.finalize(img / cfg_g.spp)).cpu().numpy()
    eq, gap = golden_bound(got, golden)
    # This shape has 16 lanes a pixel: the plain version must agree exactly.
    p_img, p_tr = megakernel.render_megakernel_plain(scene, cam_g, cfg_g, 42)
    if not (torch.equal(img, p_img) and torch.equal(tr, p_tr)):
        raise AssertionError("kernel and plain version differ at 64x48x16")
    log(f"[smoke] golden 64x48x16: {eq:.4%} bytes equal, channel mean gap "
        f"{gap:.3f} levels; kernel == plain, traces {tr.tolist()}: ok")

    # Phase 4: the baked kernel against its plain version, full width.
    # Times are medians of three wrapper calls (host clock, synchronized),
    # taken in turns.
    log("[smoke] phase: parity 1024x768x4, kernel against plain version")
    cfg_p = RenderConfig(width=1024, height=768, spp=4, seed=3)
    cam_p = make_camera(aspect=1024 / 768)
    n_pix_p = cfg_p.width * cfg_p.height
    n_samp_p = n_pix_p * cfg_p.spp
    outs, med = in_turns(
        {"kernel": lambda: megakernel.render_megakernel(scene, cam_p, cfg_p, 3),
         "plain": lambda: megakernel.render_megakernel_plain(
             scene, cam_p, cfg_p, 3)},
        ("plain", "kernel", "kernel", "plain", "plain", "kernel"))
    for which, runs in outs.items():
        for img_i, tr_i in runs[1:]:
            if not (torch.equal(img_i, runs[0][0])
                    and torch.equal(tr_i, runs[0][1])):
                raise AssertionError(f"{which} runs differ from each other")
    (k_img, k_tr), (p_img, p_tr) = outs["kernel"][0], outs["plain"][0]
    k_s, p_s = med["kernel"], med["plain"]
    traces_p = k_tr.tolist()
    max_err = float((k_img - p_img).abs().max())
    log(f"[smoke] parity 1024x768x4: kernel {k_s * 1e3:.3f} ms traces "
        f"{traces_p}; plain {p_s * 1e3:.3f} ms traces {p_tr.tolist()}; "
        f"max |img diff| {max_err:.3e}")
    if traces_p != p_tr.tolist():
        raise AssertionError(f"trace counts differ: kernel {traces_p} plain "
                             f"{p_tr.tolist()}")
    tol = 1e-5 * cfg_p.spp
    if not torch.allclose(k_img, p_img, rtol=0.0, atol=tol):
        raise AssertionError(f"image differs by {max_err} > atol {tol}")
    k_rects = scene.rects.k.shape[0]
    nee_bound = forward_bound(traces_p, n_samp_p, n_pix_p, k_rects)

    # Phase (a): the runtime-material forward with the scene's own tables
    # must equal the baked kernel and the plain version bit for bit.
    log("[smoke] phase: runtime-material forward 1024x768x4 against the "
        "baked kernel and the plain version")
    alb, emi = mg.pack_materials(scene)
    outs, med = in_turns(
        {"kernel": lambda: mg.render_megakernel_mat(scene, cam_p, cfg_p, alb,
                                                    emi, 3),
         "plain": lambda: mg.render_megakernel_mat_plain(
             scene, cam_p, cfg_p, alb, emi, 3)},
        ("kernel", "plain", "plain", "kernel", "kernel", "plain"))
    for which, runs in outs.items():
        for img_i, tr_i in runs:
            if not (torch.equal(img_i, k_img) and torch.equal(tr_i, k_tr)):
                raise AssertionError(
                    f"runtime-material {which} differs from the baked kernel")
    mat_err = float((outs["kernel"][0][0] - outs["plain"][0][0]).abs().max())
    mat_s, mat_plain_s = med["kernel"], med["plain"]
    mat_bound = forward_bound(traces_p, n_samp_p, n_pix_p, k_rects)
    log(f"[smoke] runtime-material forward 1024x768x4: kernel "
        f"{mat_s * 1e3:.3f} ms, plain {mat_plain_s * 1e3:.3f} ms; image and "
        f"traces {traces_p} equal the baked kernel's bit for bit")

    # Phase (b): the adjoint against autograd through the plain forward, at
    # the parity shape, under a seeded cotangent.
    log("[smoke] phase: material adjoint 1024x768x4 against its plain "
        "version")
    g_img = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cfg_p.height, cfg_p.width, 3)).astype(np.float32)).to(device)
    torch.cuda.reset_peak_memory_stats()
    outs, med = in_turns(
        {"kernel": lambda: mg.render_megakernel_vjp(scene, cam_p, cfg_p, alb,
                                                    emi, 3, g_img),
         "plain": lambda: mg.render_megakernel_vjp_plain(
             scene, cam_p, cfg_p, alb, emi, 3, g_img)},
        ("kernel", "plain", "plain", "kernel", "kernel", "plain"))
    peak = torch.cuda.max_memory_allocated()
    ka, ke = outs["kernel"][0]
    for ka_i, ke_i in outs["kernel"][1:]:
        if not (torch.equal(ka_i, ka) and torch.equal(ke_i, ke)):
            raise AssertionError("adjoint kernel runs differ from each other")
    pa, pe = outs["plain"][0]
    vjp_err = 0.0
    for name, kt, pt in (("albedo", ka, pa), ("emission", ke, pe)):
        err = float((kt - pt).abs().max())
        scale = float(pt.abs().max())
        vjp_err = max(vjp_err, err)
        log(f"[smoke] adjoint d/d {name}: max |kernel - plain| {err:.3e}, "
            f"largest entry {scale:.3e}, ratio {err / scale:.3e} "
            f"(limit {VJP_TOL:g})")
        if not err <= VJP_TOL * scale:
            raise AssertionError(f"adjoint d/d {name} off by {err} > "
                                 f"{VJP_TOL} x {scale}")
    vjp_s, vjp_plain_s = med["kernel"], med["plain"]
    vjp_b = vjp_bound(traces_p, n_samp_p, n_pix_p, k_rects)
    log(f"[smoke] adjoint 1024x768x4: kernel {vjp_s * 1e3:.3f} ms, plain "
        f"{vjp_plain_s * 1e3:.3f} ms, peak memory {peak / 2**30:.2f} GiB; "
        f"three kernel runs bit-identical")

    # Phase 5: the render path, as a user calls it.
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

    # Phase (c): the training path, as a user calls it.
    log(f"[smoke] phase: training path, cli fit 1024x768x512, 5 steps, "
        f"lr {FIT_LR}")
    fit_argv = ["fit", "--width", "1024", "--height", "768", "--spp", "512",
                "--steps", "5", "--train", "emission,albedo", "--lr", FIT_LR]
    out, err = io.StringIO(), io.StringIO()
    megakernel.LAUNCHES = mg.LAUNCHES_MAT = mg.LAUNCHES_VJP = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(fit_argv)
    fit_launches = {"megakernel_nee": megakernel.LAUNCHES,
                    "megakernel_nee_mat": mg.LAUNCHES_MAT,
                    "megakernel_vjp": mg.LAUNCHES_VJP}
    for line in err.getvalue().strip().splitlines():
        log("[smoke] cli fit: " + line)
    if rc != 0:
        raise AssertionError(f"cli fit returned {rc}")
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    log("[smoke] cli fit: " + json.dumps(res))
    steps = [(float(a), float(b)) for a, b in re.findall(
        r"loss (\S+)\s+seconds (\S+)", err.getvalue())]
    losses = [a for a, _ in steps]
    if len(losses) != 5 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"fit losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the fit loss did not fall: {losses}")
    e_light = np.asarray(res["light_emission"], dtype=np.float64)
    # The light's emission starts at 12; the target's is 18.
    if not np.all((e_light > 12.5) & (e_light < 24.0)):
        raise AssertionError(f"the light's emission {e_light} did not move "
                             "toward 18 (12 x 1.5)")
    for name in ("megakernel_nee_mat", "megakernel_vjp"):
        if fit_launches[name] < 1:
            raise AssertionError(f"cli fit did not launch {name}")
    # Device time of each kernel at the fit's shape: CUDA events around
    # three launches in a row (each launch's host work overlaps the one
    # before it), with the geometry packed once as the trainer packs it.
    step_s = float(np.median([b for _, b in steps[1:]]))
    cfg_f = RenderConfig(width=1024, height=768, spp=512, seed=0)
    cam_f = make_camera(aspect=1024 / 768)
    geom_f = megakernel.pack_geometry(scene, cam_f)
    g_f = torch.full((768, 1024, 3), 1e-7, device=device)
    _, tr_f = mg.render_megakernel_mat(scene, cam_f, cfg_f, alb, emi, 0,
                                       geometry=geom_f)
    tr_f = tr_f.tolist()
    f_ms = {
        "megakernel_nee": event_ms(lambda: megakernel.render_megakernel(
            scene, cam_f, cfg_f, 0), 3),
        "megakernel_nee_mat": event_ms(lambda: mg.render_megakernel_mat(
            scene, cam_f, cfg_f, alb, emi, 0, geometry=geom_f), 3),
        "megakernel_vjp": event_ms(lambda: mg.render_megakernel_vjp(
            scene, cam_f, cfg_f, alb, emi, 0, g_f, geometry=geom_f), 3),
    }
    n_pix_f = 1024 * 768
    f_bound = forward_bound(tr_f, n_pix_f * 512, n_pix_f, k_rects)
    f_bounds = {"megakernel_nee": f_bound, "megakernel_nee_mat": f_bound,
                "megakernel_vjp": vjp_bound(tr_f, n_pix_f * 512, n_pix_f,
                                            k_rects)}
    log(f"[smoke] training path: launches {fit_launches}; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; light emission "
        f"{e_light.round(3).tolist()}; {step_s:.4f} s a step (median of "
        f"steps 1-4)")
    for name, ms in f_ms.items():
        share = (f", {ms / 1e3 / step_s:.1%} of a step"
                 if name != "megakernel_nee" else "")
        log(f"[smoke] 1024x768x512 seed 0, traces {tr_f}: {name} {ms:.3f} ms"
            f" a launch{share}; bound {f_bounds[name][0]:.3f} ms "
            f"({f_bounds[name][1]})")

    # No single PyTorch call computes any of these functions: library_ms is
    # null for each.
    def entry(name, source, replaces, launch, err_, ms, plain_ms, b):
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": "small_pathtracer_tpu/ops/" + replaces,
                "launches": launch, "max_abs_err": err_, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": None}

    log(json.dumps({"kernels": [
        entry("megakernel_nee", "megakernel.cu", "megakernel.py:1203",
              launches, max_err, k_s * 1e3, p_s * 1e3, nee_bound),
        entry("megakernel_nee_mat", "megakernel.cu", "megakernel_grad.py:980",
              fit_launches["megakernel_nee_mat"], mat_err, mat_s * 1e3,
              mat_plain_s * 1e3, mat_bound),
        entry("megakernel_vjp", "megakernel_grad.cu",
              "megakernel_grad.py:1049", fit_launches["megakernel_vjp"],
              vjp_err, vjp_s * 1e3, vjp_plain_s * 1e3, vjp_b),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
