"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version (and
the forwards against the committed golden images), then drives the paths a
user calls: ``cli render`` of the Cornell box (``nee``, 1024x768x512),
``cli fit`` (SGD on albedo and emission, 1024x768x512, 5 steps) and ``cli
render`` of the sphere scenes ``sphere_grid`` (1024x768x512) and
``sphere_grid_1024`` (1024x768, fewer samples). Then the per-pixel budget
kernels (``megakernel_nee_budgets``, ``megakernel_nee_tab_budgets``) bit for
bit against their plain version on ragged spans (``cornell_box``,
``sphere_grid``, ``smallpt_original``), and the rest of ``cli render`` at
1024x768x512: ``--adaptive-tol 0`` (it must count the uniform render's
traces, one launch a wave), ``--adaptive-tol 0.01`` on ``cornell_box`` and
``sphere_grid`` (waves, samples, card time a wave), ``--checkpoint`` with
``--preview`` (the uniform render's traces and image) and ``--aov
--denoise``. Each path runs with its kernels' launch counts set to 0 just
before it and read just after, and fails unless its kernels launched. Every phase raises on failure, and the
seconds each phase took are logged at the end. The second-to-last line of
the output is one JSON object describing each kernel, the line before it
the card's name and power limit, and the last line ``{"ok": true,
"device": {...}}``. Without CUDA, or outside the repository, it exits
non-zero before printing a result.
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
GOLDEN_SPH = ROOT / "goldens" / "cornell_spheres_64x48x16_nee_seed42.ppm"
# The sphere golden's byte-equality floor (tests/test_torch_spheres.py
# measured 97.89% on the CPU, 97.93% with a correctly rounded sqrt as on the
# card): grazing sphere hits flip between jax.lax.rsqrt and 1/sqrt, so it is
# looser than the box's 99%.
SPH_GOLDEN_EQ = 0.96
# sphere_grid_1024's main-path samples a pixel: a render of a few seconds
# (on an H100 80GB HBM3 at 700 W, 32 samples took 0.50 s).
SPP_1024 = "128"
# Tone-mapped channel means of a main-path render against its parity render
# (x4, the same scene): within this share. The x4 render's means are biased
# low by the concave tone map and the clamp (measured on the CPU: x4 under
# x64 by 6% on sphere_grid, x4 under x32 by 12-17% on sphere_grid_1024).
MEAN_TOL = 0.25
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
# a divide or sqrt as 1) per nearest-hit query (6 for the ray's
# reciprocals, 12 a rect, 26 a sphere at least: the test's early exit when
# the ray misses), per bounce of shading, per probe (its least: ray prep and
# the light's test), per spawn and per pass-B gradient update; int32 per
# bounce (five murmur3 draws, 16 operations each, sharing the 6 of the
# path-id word) and per spawn (two draws).
FP_RAY, FP_RECT, FP_SPHERE = 6, 12, 26
FP_SHADE, FP_PROBE, FP_SPAWN, FP_GRAD = 162, 18, 35, 52
INT_BOUNCE, INT_SPAWN = 5 * 16 + 6, 2 * 16 + 6


def log(msg: str) -> None:
    """Progress to stdout, and a copy of each [smoke] line to stderr, so the
    end of stderr alone says which phase a failure stopped in."""
    print(msg, flush=True)
    if msg.startswith("[smoke]"):
        print(msg, file=sys.stderr, flush=True)


PHASES: list[tuple[str, float]] = []


def phase(name: str) -> None:
    """Marks the start of a phase (the seconds of each are logged at the
    end)."""
    PHASES.append((name, time.perf_counter()))
    log(f"[smoke] phase: {name}")


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


def golden_bound(got: np.ndarray, golden: np.ndarray,
                 min_eq: float = 0.99) -> tuple[float, float]:
    """The JAX-free golden contract: >= min_eq of bytes equal and each
    channel mean within 0.5 levels. Returns (equal fraction, worst mean
    gap)."""
    if got.shape != golden.shape:
        raise AssertionError(f"shape {got.shape} != golden {golden.shape}")
    eq = float(np.mean(got == golden))
    gap = float(np.max(np.abs(
        got.reshape(-1, 3).astype(np.float64).mean(0)
        - golden.reshape(-1, 3).astype(np.float64).mean(0)
    )))
    if eq < min_eq or gap > 0.5:
        raise AssertionError(
            f"golden mismatch: {eq:.4%} bytes equal (need {min_eq:.0%}), "
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


def query_ops(n_rects: int, n_spheres: int = 0) -> int:
    """fp32 operations of one nearest-hit query: 210 on the Cornell box."""
    return FP_RAY + FP_RECT * n_rects + FP_SPHERE * n_spheres


def forward_bound(traces, n_samples: int, n_lanes: int, n_rects: int,
                  n_spheres: int = 0, span_bytes: int = 0):
    """Forward kernels: every counted probe follows one traced, unfolded
    bounce (query, shading, probe, five draws); the extends beyond it (RR
    deaths, folded bounces, SPEC/REFR bounces) are left out, so this is a
    lower bound. Bytes: the per-lane radiance and the counters out, the
    material tables (and, with spheres, the codes and sphere rows) in, and
    the budget kernels' span bounds (span_bytes) in."""
    _, probe = traces
    fp = (probe * (query_ops(n_rects, n_spheres) + FP_SHADE + FP_PROBE)
          + n_samples * FP_SPAWN)
    it = probe * INT_BOUNCE + n_samples * INT_SPAWN
    k = n_rects + n_spheres
    tables = 2 * k * 3 * 4 + (k * 4 + n_spheres * 16 if n_spheres else 0)
    return bound(fp, it, n_lanes * 12 + 16 + tables + span_bytes)


def ragged_spans(n_pix: int, start_hi: int, len_hi: int, seed: int):
    """Seeded per-pixel spans: s_start in [0, start_hi), lengths in
    [0, len_hi], about 10% of them empty. Returns int32 (s_start, s_stop)."""
    r = np.random.default_rng(seed)
    s_start = r.integers(0, start_hi, n_pix)
    length = r.integers(0, len_hi + 1, n_pix)
    length[r.random(n_pix) < 0.1] = 0
    return s_start.astype(np.int32), (s_start + length).astype(np.int32)


def cli_stderr(cli_main, argv: list[str]) -> str:
    """Runs the port's CLI; returns its stderr, raises on a non-zero
    return."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    for line in err.getvalue().strip().splitlines():
        log("[smoke] cli: " + line)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} returned {rc}")
    return err.getvalue()


def cli_traces(text: str) -> tuple[int, float]:
    """(traces, seconds) from cli render's last stderr line."""
    m = re.search(r"traces=(\d+)\s+seconds=([0-9.]+)", text)
    if m is None:
        raise AssertionError("cli render printed no trace count")
    return int(m.group(1)), float(m.group(2))


def vjp_bound(traces, n_samples: int, n_pix: int, k: int):
    """The adjoint traces every bounce of every sample twice, unfolded (the
    forward's extend count), and updates the gradients once a bounce.
    Bytes: the cotangent image and the tables in, the gradients out."""
    extend, _ = traces
    per_pass = (extend * (query_ops(k) + FP_SHADE + FP_PROBE)
                + n_samples * FP_SPAWN)
    fp = 2 * per_pass + extend * FP_GRAD
    it = 2 * (extend * INT_BOUNCE + n_samples * INT_SPAWN)
    return bound(fp, it, n_pix * 12 + 4 * k * 3 * 4)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the smoke run needs a GPU")
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.cli import main as cli_main
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.integrator.wavefront import render_counts
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
    phase("build")
    built, build_s = timed(_build.build_kernels)
    log(f"[smoke] kernel build {built.build_seconds:.2f}s "
        f"(load included {build_s:.2f}s) from {CSRC}*.cu")
    for line in built.build_output.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[smoke] ptxas: {line.strip()}")

    # Phase 3: the baked kernel against the committed golden (rendered by
    # the JAX package on the CPU).
    phase("golden 64x48x16, kernel and plain version")
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
    phase("parity 1024x768x4, kernel against plain version")
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
    phase("runtime-material forward 1024x768x4 against the baked kernel "
          "and the plain version")
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
    phase("material adjoint 1024x768x4 against its plain version")
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
    phase("main path, cli render 1024x768x512")
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
    phase(f"training path, cli fit 1024x768x512, 5 steps, lr {FIT_LR}")
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

    # Phase (d): the sphere-table kernel against its plain version, bit for
    # bit, in turns as in phase 4.
    def tab_parity(name, width, height, spp, seed):
        sc = get_scene(name)
        cam = make_camera(aspect=width / height)
        cfg = RenderConfig(width=width, height=height, spp=spp, seed=seed)
        before = megakernel.LAUNCHES_TAB
        outs, med = in_turns(
            {"kernel": lambda: megakernel.render_megakernel(sc, cam, cfg,
                                                            seed),
             "plain": lambda: megakernel.render_megakernel_plain(
                 sc, cam, cfg, seed)},
            ("plain", "kernel", "kernel", "plain", "plain", "kernel"))
        if megakernel.LAUNCHES_TAB != before + 3:
            raise AssertionError(f"{name} did not go through "
                                 "megakernel_nee_tab")
        for which, runs in outs.items():
            for img_i, tr_i in runs[1:]:
                if not (torch.equal(img_i, runs[0][0])
                        and torch.equal(tr_i, runs[0][1])):
                    raise AssertionError(f"{name}: {which} runs differ")
        (k_img, k_tr), (p_img, p_tr) = outs["kernel"][0], outs["plain"][0]
        err_ = float((k_img - p_img).abs().max())
        log(f"[smoke] {name} {width}x{height}x{spp} seed {seed}: kernel "
            f"{med['kernel'] * 1e3:.3f} ms traces {k_tr.tolist()}; plain "
            f"{med['plain'] * 1e3:.3f} ms traces {p_tr.tolist()}; max |img "
            f"diff| {err_:.3e}")
        if not (torch.equal(k_tr, p_tr) and err_ == 0.0):
            raise AssertionError(f"{name}: kernel and plain version differ")
        n_pix = width * height
        b = forward_bound(k_tr.tolist(), n_pix * spp, n_pix,
                          sc.rects.k.shape[0], sc.spheres.radius.shape[0])
        return {"img": k_img / spp, "err": err_, "ms": med["kernel"] * 1e3,
                "plain_ms": med["plain"] * 1e3, "bound": b}

    phase("sphere-table kernel against its plain version, sphere_grid "
          "1024x768x4")
    tab = {"sphere_grid": tab_parity("sphere_grid", 1024, 768, 4, 4)}
    phase("sphere-table kernel against its plain version, smallpt_original "
          "1024x768x4 (SPEC + REFR)")
    tab["smallpt_original"] = tab_parity("smallpt_original", 1024, 768, 4, 5)
    # The plain version picks each ray's material with one torch.where per
    # object (1031 here) and scans the spheres in chunks of 64: at
    # 1024x768x4 that is minutes, so this scene is held at 256x192x4.
    phase("sphere-table kernel against its plain version, sphere_grid_1024 "
          "256x192x4")
    tab["sphere_grid_1024"] = tab_parity("sphere_grid_1024", 256, 192, 4, 4)

    # Phase (e): the sphere-table kernel against the committed sphere golden
    # (rendered by the JAX package on the CPU), and its plain version.
    phase("sphere golden cornell_spheres 64x48x16, kernel and plain version")
    golden_s = film.read_ppm(str(GOLDEN_SPH))
    scene_s = get_scene("cornell_spheres")
    before = megakernel.LAUNCHES_TAB
    img, tr = megakernel.render_megakernel(scene_s, cam_g, cfg_g, 42)
    if megakernel.LAUNCHES_TAB != before + 1:
        raise AssertionError("cornell_spheres did not go through "
                             "megakernel_nee_tab")
    got = film.tonemap_u8(film.finalize(img / cfg_g.spp)).cpu().numpy()
    eq, gap = golden_bound(got, golden_s, SPH_GOLDEN_EQ)
    p_img, p_tr = megakernel.render_megakernel_plain(scene_s, cam_g, cfg_g, 42)
    if not (torch.equal(img, p_img) and torch.equal(tr, p_tr)):
        raise AssertionError("kernel and plain version differ on "
                             "cornell_spheres 64x48x16")
    log(f"[smoke] sphere golden 64x48x16: {eq:.4%} bytes equal (floor "
        f"{SPH_GOLDEN_EQ:.0%}), channel mean gap {gap:.3f} levels; kernel "
        f"== plain, traces {tr.tolist()}: ok")

    # Phase (f): the sphere render path, as a user calls it.
    def cli_render_tab(name, spp):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, f"{name}.ppm")
            err_ = io.StringIO()
            megakernel.LAUNCHES_TAB = 0
            with contextlib.redirect_stderr(err_):
                rc = cli_main(["render", "--scene", name, "--width", "1024",
                               "--height", "768", "--spp", spp, "-o", out])
            n_launch = megakernel.LAUNCHES_TAB
            log("[smoke] cli: " + err_.getvalue().strip())
            if rc != 0:
                raise AssertionError(f"cli render {name} returned {rc}")
            if n_launch < 1:
                raise AssertionError(f"cli render {name} did not launch "
                                     "megakernel_nee_tab")
            image = film.read_ppm(out)
        mm = re.search(r"traces=(\d+)\s+seconds=([0-9.]+)", err_.getvalue())
        if mm is None or image.shape != (768, 1024, 3):
            raise AssertionError(f"cli render {name}: no trace count, or "
                                 f"image shape {image.shape}")
        rays, secs = int(mm.group(1)), float(mm.group(2))
        got_means = image.reshape(-1, 3).astype(np.float64).mean(0)
        ref = film.tonemap_u8(film.finalize(tab[name]["img"])).cpu().numpy()
        ref_means = ref.reshape(-1, 3).astype(np.float64).mean(0)
        log(f"[smoke] main path {name} 1024x768x{spp}: {n_launch} launch(es) "
            f"of megakernel_nee_tab, {rays} rays in {secs:.3f}s = "
            f"{rays / secs / 1e6:.1f} Mrays/s on {card}; channel means "
            f"{got_means.round(2).tolist()} vs its x4 parity render "
            f"{ref_means.round(2).tolist()}")
        if np.any(np.abs(got_means - ref_means) > MEAN_TOL * ref_means):
            raise AssertionError(f"{name}: channel means off the parity "
                                 "render's")
        return n_launch

    phase("main path, cli render --scene sphere_grid 1024x768x512")
    tab_launches = cli_render_tab("sphere_grid", "512")
    phase(f"main path, cli render --scene sphere_grid_1024 1024x768x"
          f"{SPP_1024}")
    cli_render_tab("sphere_grid_1024", SPP_1024)

    # Device time of the sphere-table kernel at the main path's shape.
    phase("sphere-table kernel at 1024x768x512, CUDA events")
    scene_g = get_scene("sphere_grid")
    _, tr_g = megakernel.render_megakernel(scene_g, cam_f, cfg_f, 0)
    tab_ms = event_ms(lambda: megakernel.render_megakernel(
        scene_g, cam_f, cfg_f, 0), 3)
    tab_b512 = forward_bound(tr_g.tolist(), n_pix_f * 512, n_pix_f,
                             scene_g.rects.k.shape[0],
                             scene_g.spheres.radius.shape[0])
    log(f"[smoke] sphere_grid 1024x768x512 seed 0, traces {tr_g.tolist()}: "
        f"megakernel_nee_tab {tab_ms:.3f} ms a launch; bound "
        f"{tab_b512[0]:.3f} ms ({tab_b512[1]})")
    # Phases (g)-(l): per-pixel budgets (row 3) and the rest of cli render.
    from small_pathtracer_tpu_torch.core import imageio
    from small_pathtracer_tpu_torch.utils import adaptive, checkpoint
    from small_pathtracer_tpu_torch.utils.aov import render_aovs
    from small_pathtracer_tpu_torch.utils.denoise import denoise

    def budgets_parity(name, spp, start_hi, len_hi, seed):
        """A budget kernel against its plain version on ragged spans, bit
        for bit, in turns (plain, kernel, kernel, plain)."""
        sc = get_scene(name)
        cfg = RenderConfig(width=1024, height=768, spp=spp, seed=seed)
        n_pix = cfg.width * cfg.height
        s_start, s_stop = ragged_spans(n_pix, start_hi, len_hi, seed)
        counter = ("LAUNCHES_TAB_BUDGETS" if megakernel.uses_sphere_table(sc)
                   else "LAUNCHES_BUDGETS")
        before = getattr(megakernel, counter)
        outs, med = in_turns(
            {"kernel": lambda: megakernel.render_megakernel_budgets(
                sc, cam_f, cfg, seed, s_start, s_stop),
             "plain": lambda: megakernel.render_megakernel_budgets_plain(
                 sc, cam_f, cfg, seed, s_start, s_stop)},
            ("plain", "kernel", "kernel", "plain"))
        if getattr(megakernel, counter) != before + 2:
            raise AssertionError(f"{name}: the budgets wrapper did not "
                                 f"count 2 launches in {counter}")
        for which, runs in outs.items():
            if not (torch.equal(runs[1][0], runs[0][0])
                    and torch.equal(runs[1][1], runs[0][1])):
                raise AssertionError(f"{name}: {which} runs differ")
        (k_l, k_tr), (p_l, p_tr) = outs["kernel"][0], outs["plain"][0]
        err_ = float((k_l - p_l).abs().max())
        n_samples = int((s_stop - s_start).sum())
        b = forward_bound(k_tr.tolist(), n_samples, n_pix,
                          sc.rects.k.shape[0], sc.spheres.radius.shape[0],
                          span_bytes=2 * 4 * n_pix)
        log(f"[smoke] budgets {name} 1024x768 spp {spp}, spans [0,{start_hi})"
            f" + [0,{len_hi}] ({n_samples} samples, "
            f"{float(np.mean(s_stop == s_start)):.1%} empty), seed {seed}: "
            f"kernel {med['kernel'] * 1e3:.3f} ms traces {k_tr.tolist()}; "
            f"plain {med['plain'] * 1e3:.3f} ms traces {p_tr.tolist()}; max "
            f"|diff| {err_:.3e}; bound {b[0]:.3f} ms ({b[1]})")
        if not (torch.equal(k_tr, p_tr) and err_ == 0.0):
            raise AssertionError(f"budgets {name}: kernel and plain version "
                                 "differ")
        return {"err": err_, "ms": med["kernel"] * 1e3,
                "plain_ms": med["plain"] * 1e3, "bound": b}

    phase("budgets kernel against its plain version, cornell_box 1024x768, "
          "ragged spans")
    bud = {"cornell_box": budgets_parity("cornell_box", 64, 32, 32, 6)}
    phase("table budgets kernel against its plain version, sphere_grid and "
          "smallpt_original 1024x768, ragged spans")
    bud["sphere_grid"] = budgets_parity("sphere_grid", 64, 8, 6, 7)
    bud["smallpt_original"] = budgets_parity("smallpt_original", 64, 8, 6, 8)

    base = ["render", "--width", "1024", "--height", "768", "--spp", "512"]
    with tempfile.TemporaryDirectory() as tmp:
        # tol 0: every pixel to 512 samples in 8 waves of 64.
        phase("cli render --adaptive-tol 0 --adaptive-wave 64 1024x768x512")
        megakernel.LAUNCHES_BUDGETS = 0
        text = cli_stderr(cli_main, base + [
            "--adaptive-tol", "0", "--adaptive-wave", "64",
            "-o", os.path.join(tmp, "tol0.png")])
        n_launch = megakernel.LAUNCHES_BUDGETS
        waves = int(re.search(r"\[adaptive\] (\d+) waves", text).group(1))
        tol0_traces, _ = cli_traces(text)
        log(f"[smoke] adaptive tol 0: {waves} waves, {n_launch} launches of "
            f"megakernel_nee_budgets, traces {tol0_traces} (uniform "
            f"{traces})")
        if not (waves == 8 and n_launch == waves and tol0_traces == traces):
            raise AssertionError("adaptive tol 0 differs from the uniform "
                                 "render")

        # tol 0.01, with each wave's spans kept to time its kernel after.
        def adaptive_run(name):
            spans = []
            real = adaptive.render_megakernel_budgets

            def keep(sc, cam, cfg, seed, s_start, s_stop):
                spans.append((s_start.clone(), s_stop.clone()))
                return real(sc, cam, cfg, seed, s_start, s_stop)

            megakernel.LAUNCHES_BUDGETS = megakernel.LAUNCHES_TAB_BUDGETS = 0
            adaptive.render_megakernel_budgets = keep
            try:
                text_ = cli_stderr(cli_main, base + [
                    "--scene", name, "--adaptive-tol", "0.01",
                    "-o", os.path.join(tmp, f"{name}_adaptive.png")])
            finally:
                adaptive.render_megakernel_budgets = real
            launches_ = {
                "megakernel_nee_budgets": megakernel.LAUNCHES_BUDGETS,
                "megakernel_nee_tab_budgets":
                    megakernel.LAUNCHES_TAB_BUDGETS}
            m_ = re.search(r"\[adaptive\] (\d+) waves, (\d+) samples "
                           r"\((\d+)% .*spp range (\d+)-(\d+)", text_)
            n_waves = int(m_.group(1))
            rays, secs = cli_traces(text_)
            sc = get_scene(name)
            kernel = ("megakernel_nee_tab_budgets"
                      if megakernel.uses_sphere_table(sc)
                      else "megakernel_nee_budgets")
            if launches_[kernel] != n_waves or len(spans) != n_waves:
                raise AssertionError(f"{name}: {launches_} launches for "
                                     f"{n_waves} waves")
            cfg = RenderConfig(width=1024, height=768, spp=512, seed=0)
            wave_ms = [event_ms(lambda: megakernel.render_megakernel_budgets(
                sc, cam_f, cfg, 0, a, b), 3) for a, b in spans]
            active = [int((b > a).sum()) for a, b in spans]
            log(f"[smoke] adaptive {name} 1024x768x512 tol 0.01: {n_waves} "
                f"waves ({launches_[kernel]} launches of {kernel}), "
                f"{m_.group(2)} samples = {m_.group(3)}% of uniform, spp "
                f"{m_.group(4)}-{m_.group(5)}, {rays} rays in {secs:.3f} s = "
                f"{rays / secs / 1e6:.1f} Mrays/s on {card}")
            log(f"[smoke] adaptive {name}: card ms a wave "
                f"{[round(x, 3) for x in wave_ms]}, active pixels a wave "
                f"{active}")
            return launches_[kernel]

        phase("cli render --adaptive-tol 0.01 cornell_box 1024x768x512")
        adaptive_launches = {"cornell_box": adaptive_run("cornell_box")}
        phase("cli render --adaptive-tol 0.01 sphere_grid 1024x768x512")
        adaptive_launches["sphere_grid"] = adaptive_run("sphere_grid")

        phase("cli render --checkpoint --checkpoint-every 128 --preview "
              "1024x768x512")
        ck, pv = os.path.join(tmp, "r.ckpt"), os.path.join(tmp, "prev.png")
        megakernel.LAUNCHES = 0
        text = cli_stderr(cli_main, base + [
            "--checkpoint", ck, "--checkpoint-every", "128", "--preview", pv,
            "-o", os.path.join(tmp, "ck.png")])
        ck_launches = megakernel.LAUNCHES
        ck_traces, _ = cli_traces(text)
        preview = imageio.read_image(pv)
        cfg_u = RenderConfig(width=1024, height=768, spp=512, seed=0)
        img_ck, _ = checkpoint.render_with_checkpoints(scene, cam_f, cfg_u,
                                                       "", 128)
        img_u, _ = render_counts(scene, cam_f, cfg_u)
        ck_err = float((img_ck - img_u).abs().max())
        log(f"[smoke] checkpoint: {ck_launches} launches of megakernel_nee, "
            f"traces {ck_traces} (uniform {traces}), preview "
            f"{preview.shape}, max |span image - uniform| {ck_err:.3e}")
        if not (ck_launches == 4 and ck_traces == traces
                and preview.shape == (768, 1024, 3) and ck_err <= 1e-5):
            raise AssertionError("the checkpointed render differs from the "
                                 "uniform one")

        phase("cli render --aov --denoise 1024x768x512")
        prefix = os.path.join(tmp, "aov")
        out_d = os.path.join(tmp, "denoised.png")
        cli_stderr(cli_main, base + ["--aov", prefix, "--denoise",
                                     "-o", out_d])
        with np.load(prefix + ".npz") as z:
            aovs = {k: z[k] for k in z.files}
        shapes = {k: v.shape for k, v in aovs.items()}
        den = imageio.read_image(out_d)
        ppms = [film.read_ppm(f"{prefix}.{k}.ppm").shape for k in aovs]
        if not (all(np.isfinite(v).all() for v in aovs.values())
                and shapes["albedo"] == (768, 1024, 3)
                and shapes["depth"] == (768, 1024)
                and den.shape == (768, 1024, 3)):
            raise AssertionError("the AOV or denoised outputs are wrong")
        # The two passes' own times (plain torch on the card).
        feats, aov_s = timed(lambda: render_aovs(scene, cam_f, cfg_u))
        _, den_s = timed(lambda: denoise(img_u, feats, iterations=5,
                                         sigma_l=0.5))
        log(f"[smoke] aov: {shapes}, PPMs {ppms}; denoised {den.shape}; "
            f"AOV pass (64 samples) {aov_s:.3f} s, denoiser (5 passes) "
            f"{den_s:.3f} s")

    PHASES.append(("end", time.perf_counter()))
    for (name, t0), (_, t1) in zip(PHASES, PHASES[1:]):
        log(f"[smoke] {t1 - t0:8.3f} s  {name}")

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
        entry("megakernel_nee_tab", "megakernel.cu",
              "megakernel.py:1203 (sphere_tab, call :2670)", tab_launches,
              tab["sphere_grid"]["err"], tab["sphere_grid"]["ms"],
              tab["sphere_grid"]["plain_ms"], tab["sphere_grid"]["bound"]),
        entry("megakernel_nee_budgets", "megakernel.cu", "megakernel.py:2783",
              adaptive_launches["cornell_box"], bud["cornell_box"]["err"],
              bud["cornell_box"]["ms"], bud["cornell_box"]["plain_ms"],
              bud["cornell_box"]["bound"]),
        entry("megakernel_nee_tab_budgets", "megakernel.cu",
              "megakernel.py:2783", adaptive_launches["sphere_grid"],
              bud["sphere_grid"]["err"], bud["sphere_grid"]["ms"],
              bud["sphere_grid"]["plain_ms"], bud["sphere_grid"]["bound"]),
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
