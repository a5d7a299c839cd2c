"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version (and
the forwards against the committed golden images), then drives the paths a
user calls: ``cli render`` of the Cornell box (``nee``, 1024x768x512),
``cli fit`` (SGD on albedo and emission, 1024x768x512, 5 steps) and ``cli
render`` of the sphere scenes ``sphere_grid`` (1024x768x512) and
``sphere_grid_1024`` (1024x768, fewer samples); the sphere-table kernels
scan the spheres through a tree, and row 2's counting instance gives that
algorithm's bound beside the linear scan's. Then the per-pixel budget
kernels (``megakernel_nee_budgets``, ``megakernel_nee_tab_budgets``, one
lane a live pixel) bit for bit against their plain version on ragged spans
where most pixels are empty (``cornell_box``, ``sphere_grid``,
``smallpt_original``), and the rest of ``cli render`` at 1024x768x512:
``--adaptive-tol 0`` (it must count the uniform render's traces, one launch
a wave), ``--adaptive-tol 0.01`` on ``cornell_box`` and ``sphere_grid``
(waves, samples; each wave's active share, card time and host time),
``--checkpoint`` with
``--preview`` (the uniform render's traces and image) and ``--aov
--denoise``. Then the ``cosine`` and ``nee_textbook`` estimators and path
guiding: ``pow_pos`` against ``torch.pow``; ``train_guide`` twice (the same
bits); the guided kernels (rows 4 and 5: ``megakernel_guided``,
``megakernel_guided_primary`` and their ``_tab`` twins) and the unguided
``megakernel_cosine`` / ``megakernel_textbook`` (and ``_tab``) bit for bit
against their plain versions, the ``_tab`` kernels on ``smallpt_original``
(their linear instances) and on ``sphere_grid`` with both estimators (their
tree instances); an all-sentinel table against the unguided kernel; ``cli render --guided --scene cornell_alcove_baffled --estimator
nee_textbook`` at 1024x768x512 (one launch, its linear mean within 2% of
the unguided render's, the pixel variance of both at x64), with
``--guide-online 4`` (4 launches) and with ``--checkpoint --preview`` (4
spans); and each new kernel's own main path at 1024x768x512. Then the
sphere table's two scans through the tree (the query kernel
``sphere_queries``) against the plain version's in-order scan on seeded
grazing rays, rays in a sphere's tangent plane and rays leaving a sphere,
on four sphere presets and on ``smallpt_original`` with the original
smallpt's radius-1e5 walls. Then the
rect scan's tie rule through rows 1 and 4 on ``cornell_box`` at 256x192x4
(a copy of a wall after it changes nothing, before it takes its place, a
dark copy of the light before it hides the light), and with quads on
``cornell_tilted_light`` (a copy of the light quad after it changes
nothing, a dark copy before it hides the light, a quad on the floor's
plane), each launch bit for bit its plain version. Then the
geometry adjoint ``megakernel_geom``: its image-only launch bit for bit
against ``megakernel_nee_tab`` and the plain version, its adjoint against
autograd through the plain version row by row and against itself (``cornell_spheres``
and ``smallpt_original`` at 1024x768x4, where some paths must outrun the
adjoint's tape, ``sphere_grid`` at 256x192x4), ``cli fit --train
center,radius --scene cornell_spheres`` at 1024x768x512 (5 steps: 1 + 2
launches a step, the best loss below the first, sphere 0 nearer the truth)
and the adjoint's event time and counters at x512; both adjoints on
200-bounce paths against autograd (every albedo 0.98; the geometry
adjoint's sphere rows with the light black, and at 5 bounces with the
cotangent zeroed on the pixels whose NEE probe re-hits the light from its
own underside). Then material training grown to sphere scenes, SPEC/REFR
and the ``cosine`` and ``nee_textbook`` estimators (``mat_phases`` of
MAT_GROWN: row 8 at 1024x768x4, row 9 at 256x192x4 on the box and
128x96x4 on the sphere scenes, row 10 at 128x96x4): row 8's new instances
bit for bit against their plain version and the render, row 9's against
autograd through its plain version (and on 200-bounce paths), row 10's on
each shard, the main path ``cli fit --scene smallpt_original --estimator
cosine --train emission,albedo`` at 1024x768x512 (5 steps, the loss must
fall) and a short fit of every other instance, with their x512 times; the
sharded main path also takes one step of that fit over the mesh. Then the
other estimators in rows 1-7 (``est_phases``): ``uniform``,
``uniform_corrected``, ``mixture``, ``mis`` and ``nee`` / ``mixture``
with ``glibc_overflow`` through rows 1 and 2, every estimator but ``nee``
through row 3, and guided ``mis`` through rows 4 and 5, each instance bit
for bit against its plain version at 1024x768x4; ``cli render
--estimator mis`` (this slice's main path) and every other case at
1024x768x512, adaptive, checkpointed, ``--mesh 1x1``, per-shard and
``--guided`` paths with their launches counted, each instance's x512
event time and bound, and guiding's clamped MSE (guided against
unguided ``mis`` on ``cornell_alcove_baffled``). Then general quads and
GLOS materials in rows 1-7 (``ext_phases``): every ``_ext`` instance
(``csrc/megakernel_ext.cu``, ``_ext_budgets.cu``, ``_ext_guided.cu``) bit
for bit against its plain version at 1024x768x4 on
``cornell_tilted_light``, ``cornell_glossy`` and the tilted light with
``sphere_grid``'s spheres (the tree), row 3 on ragged spans; the main paths
``cli render --scene cornell_tilted_light`` and ``--scene cornell_glossy
--estimator mis`` at 1024x768x512 (and ``nee`` refused on the glossy
scene), ``cli render``, ``--adaptive-tol 0`` and ``--guided`` of every
other instance, rows 7 and 6 on each shard of a 2x2 mesh, each instance's
x512 event time and bound. Then material training
with those estimators (``mat_phases`` of MAT_EST): row 8's 18 new
instances (rect, linear, tree) bit for bit against their plain version and
the render at 256x192x4, row 9's against autograd (256x192x4 on the box,
128x96x4 on the sphere scenes; and ``mis`` and
``mixture`` on 200-bounce paths), row 10 with ``mis`` on each shard, the
main path ``cli fit --estimator mis --train emission --lr 1`` at
1024x768x512 (5 steps, the loss must fall, 5 + 5 launches) and a 1-step
fit of each other instance, and their x512 times;
the 4-rank main path takes one ``mis`` step over the mesh too. Then
material training with quads and GLOS (``mat_ext_phases``): row 8's
``_mat_ext`` instances bit for bit against the forward ``_ext`` kernel
(and with perturbed tables against the plain version), row 9's
``megakernel_vjp[_<est>]_ext`` against autograd at 128x96x4 on
``cornell_tilted_light``, ``cornell_glossy`` and the tree scene, on
200-bounce paths, row 10 with ``mis`` on each shard, the main path ``cli
fit --scene cornell_glossy --estimator mis --train emission --lr 1`` at
1024x768x512 (5 steps, the loss must fall, 5 + 5 launches), an albedo fit
of that scene, ``fit_megakernel`` on the tilted light (its quad light's
row moves toward the truth), a 1-step fit of each other code, and each
instance's x512 time. Then the
geometry adjoint with the other estimators (``geom_est_phases``: the
eight codes of GEOM_EST_CASES): each instance's image-only launch bit for
bit against its plain version and ``megakernel_<est>_tab``, its adjoint
against autograd row by row at 128x96x4, max_bounces 24, on
``cornell_spheres`` (``mis`` and ``cosine`` also on ``smallpt_original``'s
glass), ``mis`` on 200-bounce paths and on each coordinate of a 2x2 mesh
(max_bounces 8), the main path
``cli fit --train center,radius --estimator mis`` at 1024x768x512 (5
steps, the loss must fall, 1 + 2 launches a step), a 1-step fit of each
other instance at 256x192x64, and each instance's x512 event time; the
4-rank main path takes one ``mis`` geometry step over the mesh. The
adjoint kernels'
registers, stack frames (their tapes) and spills are logged from ptxas,
their times against the function's bound and their algorithm's. Each path
runs with its kernels' launch counts set to 0 just before it and read just
after, and fails unless its kernels launched. The x4 parity runs of rows
1-3 with the other estimators, rows 8, 9 and 11 take at most
PARITY_BOUNCES bounces a path (the plain versions' time goes with their
longest path). Every phase raises on
failure, and the seconds each phase took are logged at the end. The second-to-last line of
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
from typing import NamedTuple

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
# max_bounces of the parity runs against the plain versions at x4 (rows 1-3
# of the other estimators, rows 8 and 9, row 11): the plain versions take a
# launch-bound iteration a bounce of their longest path (PERF.md §6), and
# the script's phases must end within its time limit (24 before the quad
# and GLOS phases came). Past kSeg (16), so the adjoints' paths still
# outrun their tape; the deep-path phases run 200.
PARITY_BOUNCES = 18
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
# The sphere tree's work (csrc/megakernel_bvh.cuh), for this algorithm's
# bound of the table kernels, counted from the source the same way: a
# child's box test 32 (the padding, six face distances, the slab min/max
# and the clamps), a row's test before the square root 22 (sphere_pre's 19
# and the two rejects), a row past the rejects 16 (sphere_root and the
# merge); the counting instance counts each in a launch.
FP_NODE, FP_ROW, FP_ROOT = 32, 22, 16
# The cosine and nee_textbook kernels and path guiding, counted the same way
# from csrc/megakernel_lane.cuh (FP_SHADE = 162 is about the first three
# plus the selects): every traced bounce's least shading (hit point,
# orientation, RR, throughput, pickup) 33; the cosine sample at a diffuse
# bounce 83; the light sample and NEE weight of a textbook probe 41 and its
# direct term 12. int32: a draw 16 (the RR draw a bounce, two scatter
# draws a diffuse bounce, two light draws a probe), the path-id word 6 a
# bounce. A guided vertex's mixture (~150 fp32: voxel id, decode, lobe
# frame, pow_pos, lobe sample, pdfs) is left out: the kernels do not count
# their guided vertices, so the guided kernels' bound is their unguided
# twin's plus the guide's bytes, still a lower bound.
FP_SHADE_MIN, FP_COS_SAMPLE, FP_NEE, FP_DIRECT = 33, 83, 41, 12
INT_DRAW, INT_WORD = 16, 6
# mis's balance weights, counted from csrc/megakernel_lane.cuh as FP_SHADE:
# at each probe p_bsdf 7, |cos_l| 6, p_light 4, the weight 3 and the
# continuation's pdf 7 (the pickup's weight, on light hits only, is left
# out: a lower bound).
FP_MIS = 27
# Path guiding's smoke runs: the CLI's defaults (beta 0.6, k 8, the
# pre-pass at 1/8 of 1024x768 with 16 samples, 8 bounces, seed + 1) and the
# agreement of a guided and an unguided render's linear means (the
# estimator is unbiased; at 512 samples the means' noise is far below it).
GUIDE_BETA, GUIDE_K, GUIDE_MEAN_TOL = 0.6, 8.0, 0.02
# Quads and GLOS (ext_phases), counted from the .cu sources as FP_RECT: a
# quad test (csrc/megakernel_common.cuh quad_hit) 49: the plane's d . n 5,
# (c - o) . n 8, the divide and its guard 3, the point 9, the Gram
# products 10, a and b 8, the bounds and the eps 6. The GLOS lobe at a
# GLOS vertex (csrc/megakernel_lane.cuh, the kWithGlos branches) 112: the
# mirror 11, its frame 30, 1 / (n + 1) 2, pow_pos 31, the sine 4, the
# direction and its norm 25, the weight 9; at a GLOS probe (nee_textbook,
# mis) the lobe's BRDF in the direct term 48 (|A cos_l| / t^2 8, a dot 5,
# pow_pos 31, 4 more) and, for mis, the lobe's two pdfs 80. The kernels do
# not count GLOS vertices: the parity runs count them on the plain version
# (glos_vertices), so the x4 bounds carry the lobe and the logged x512
# bounds leave it out (still lower bounds).
FP_QUAD = 49
FP_GLOS, FP_GLOS_NEE, FP_GLOS_MIS = 112, 48, 80


# The kernels of the cosine and nee_textbook estimators and of path guiding:
# (name, source under CSRC, the TPU kernel it replaces).
NEW_KERNELS = (
    ("megakernel_cosine", "megakernel.cu",
     "megakernel.py:1203 (estimator cosine, call :2670)"),
    ("megakernel_textbook", "megakernel.cu",
     "megakernel.py:1203 (estimator nee_textbook, call :2670)"),
    ("megakernel_cosine_tab", "megakernel.cu",
     "megakernel.py:1203 (sphere_tab, cosine, call :2670)"),
    ("megakernel_textbook_tab", "megakernel.cu",
     "megakernel.py:1203 (sphere_tab, nee_textbook, call :2670)"),
    ("megakernel_guided", "megakernel_guided.cu", "megakernel.py:2972"),
    ("megakernel_guided_tab", "megakernel_guided.cu",
     "megakernel.py:2972 (sphere scenes)"),
    ("megakernel_guided_primary", "megakernel_guided.cu",
     "megakernel.py:3111"),
    ("megakernel_guided_primary_tab", "megakernel_guided.cu",
     "megakernel.py:3111 (sphere scenes)"),
)


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


def query_ops(n_rects: int, n_spheres: int = 0, n_quads: int = 0) -> int:
    """fp32 operations of one nearest-hit query: 210 on the Cornell box."""
    return (FP_RAY + FP_RECT * n_rects + FP_SPHERE * n_spheres
            + FP_QUAD * n_quads)


def forward_ops(traces, n_samples: int, n_rects: int, n_spheres: int = 0,
                est: str = "nee", diffuse_only: bool = True,
                counted_spheres: bool = True,
                n_quads: int = 0) -> tuple[float, float]:
    """The least (fp32, int32) operations of a forward launch with these
    [extend, probe] counts. nee (and its glibc instance): every counted
    probe follows one traced, unfolded bounce (query, shading, probe, five
    draws); the extends beyond it (RR deaths, folded bounces, SPEC/REFR
    bounces) are left out. mixture: the same, and the extends beyond two a
    probe (its bounce and the folded one after it) each a query with the
    least shading. cosine, uniform, uniform_corrected, nee_textbook and
    mis: every extend is a query with the least shading; the diffuse
    bounces (nee_textbook, mis: its probes; the others: every extend when
    ``diffuse_only``, else none) add the hemisphere sample, each textbook
    or mis probe the light sample, weight and direct term, each mis probe
    its balance weights (FP_MIS); the guided mixture is left out. Queries
    test every rect and quad and, with ``counted_spheres``, every
    sphere."""
    extend, probe = traces
    q = query_ops(n_rects, n_spheres if counted_spheres else 0, n_quads)
    direct = est in ("nee_textbook", "mis")
    if est in ("nee", "mixture"):
        fp = probe * (q + FP_SHADE + FP_PROBE) + n_samples * FP_SPAWN
        it = probe * INT_BOUNCE + n_samples * INT_SPAWN
        if est == "mixture":
            rest = max(extend - 2 * probe, 0)
            fp += rest * (q + FP_SHADE_MIN)
            it += rest * (INT_DRAW + INT_WORD)
    else:
        diffuse = probe if direct else (extend if diffuse_only else 0)
        fp = (extend * (q + FP_SHADE_MIN) + diffuse * FP_COS_SAMPLE
              + n_samples * FP_SPAWN)
        it = (extend * (INT_DRAW + INT_WORD) + diffuse * 2 * INT_DRAW
              + n_samples * INT_SPAWN)
        if direct:
            fp += probe * (FP_PROBE + FP_NEE + FP_DIRECT
                           + (FP_MIS if est == "mis" else 0))
            it += probe * 2 * INT_DRAW
    return fp, it


def forward_bound(traces, n_samples: int, n_lanes: int, n_rects: int,
                  n_spheres: int = 0, span_bytes: int = 0, est: str = "nee",
                  diffuse_only: bool = True, scan=None, n_quads: int = 0,
                  extra_fp: float = 0.0):
    """Forward kernels: ``forward_ops`` over the peak rates, so this is a
    lower bound. Bytes: the per-lane radiance and the counters out, the
    material tables (and, with spheres, the codes and sphere rows) in, and
    the budget kernels' span bounds or the guide table (span_bytes) in.

    With spheres this is the linear scan's bound (every query tests every
    sphere); ``scan`` (the counting instance's [node tests, rows tested,
    rows at the square root] of the same launch) gives the tree's: its
    counted sphere work, every query's, in place of the linear scan's, and
    the tree's bytes. Quads (n_quads) add their tests to every query, the
    quads' kernel parameters and the codes and Phong exponents of every
    object; extra_fp is added as it is (the GLOS lobe's work)."""
    fp, it = forward_ops(traces, n_samples, n_rects, n_spheres, est,
                         diffuse_only, scan is None, n_quads)
    fp += extra_fp
    k = n_rects + n_quads + n_spheres
    tables = 2 * k * 3 * 4 + (k * 4 + n_spheres * 16 if n_spheres else 0)
    if n_quads:  # the quads' rows, the Phong exponents (and the codes)
        tables += n_quads * 19 * 4 + k * 4 + (0 if n_spheres else k * 4)
    if scan is not None:
        from small_pathtracer_tpu_torch.ops.megakernel import bvh_floats

        nodes, rows, roots = scan
        fp += nodes * FP_NODE + rows * FP_ROW + roots * FP_ROOT
        tables += 4 * bvh_floats(n_spheres)
    return bound(fp, it, n_lanes * 12 + 16 + tables + span_bytes)


def ragged_spans(n_pix: int, start_hi: int, len_hi: int, seed: int,
                 empty: float = 0.1):
    """Seeded per-pixel spans: s_start in [0, start_hi), lengths in
    [0, len_hi], about a share ``empty`` of them empty. Returns int32
    (s_start, s_stop)."""
    r = np.random.default_rng(seed)
    s_start = r.integers(0, start_hi, n_pix)
    length = r.integers(0, len_hi + 1, n_pix)
    length[r.random(n_pix) < empty] = 0
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


# Bytes of one tape entry of the adjoint kernels, written once and read
# once a taped bounce: csrc/megakernel_vjp.cuh `VjpEntry` and
# csrc/megakernel_geom.cuh `GeomEntry` (the state before the bounce and
# what its two queries found; nee_textbook's `TbEntry` and mis's
# `MisEntry` the same 64 bytes).
class MatSpec(NamedTuple):
    """One slice of rows 8, 9 and 10 for ``mat_phases``: its phases' title;
    its kernels in the ``kernels`` line, (the name its wrapper counts its
    launches under: ``mat_kernel_name``, ``vjp_kernel_name``; its source
    under CSRC; the TPU kernel it replaces); its cases, (scene, label,
    RenderConfig fields); the (width, height) of row 8's and row 9's
    parity runs on each scene (x4); the RenderConfig fields of the
    200-bounce check (``smallpt_original``, every albedo DEEP_ALBEDO, the
    light black); row 10's per-shard case, (scene, fields, (width,
    height)); its cli fit
    runs at 1024x768x512, (scene, fields, --train, steps, --lr or None for
    the CLI's default), the first its main path (the loss must fall); and
    the CUDA-event launches of each instance's x512 time (row 8, row 9).
    The ``_tab`` instances of row 8 are row 2's table kernels launched with
    the runtime tables; those of row 9 are a linear and a tree instance
    each, counted together (``sphere_grid``'s tree runs are logged, not
    reported)."""

    title: str
    kernels: tuple
    cases: tuple
    size8: dict
    size9: dict
    deep: tuple
    shard: tuple
    fits: tuple
    x512_n: tuple


# Rows 8, 9 and 10 grown to sphere scenes, SPEC/REFR and the
# cosine and nee_textbook estimators. Its main path is ``cli fit --scene
# smallpt_original --estimator cosine --train emission,albedo`` at the
# CLI's default learning rate (on the CPU its loss falls at 64x48x32 and
# diverges at 32x24x32: the gradient's noise shrinks with the samples);
# then a 2-step fit for each other instance (emission only:
# nee_textbook's light-albedo row is knife-edge 1/t^2 noise, which makes
# an albedo step diverge), and sphere_grid's for the tree instances.
MAT_GROWN = MatSpec(
    title="rows 8, 9 and 10 grown (cosine, nee_textbook, spheres)",
    kernels=(
        ("megakernel_cosine_mat", "megakernel.cu",
         "megakernel_grad.py:980 (estimator cosine)"),
        ("megakernel_textbook_mat", "megakernel.cu",
         "megakernel_grad.py:980 (estimator nee_textbook)"),
        ("megakernel_nee_mat_tab", "megakernel.cu",
         "megakernel_grad.py:980 (spheres, SPEC/REFR)"),
        ("megakernel_cosine_mat_tab", "megakernel.cu",
         "megakernel_grad.py:980 (spheres, SPEC/REFR, cosine)"),
        ("megakernel_textbook_mat_tab", "megakernel.cu",
         "megakernel_grad.py:980 (spheres, SPEC/REFR, nee_textbook)"),
        ("megakernel_vjp_cosine", "megakernel_grad.cu",
         "megakernel_grad.py:1049 (estimator cosine)"),
        ("megakernel_vjp_textbook", "megakernel_grad.cu",
         "megakernel_grad.py:1049 (estimator nee_textbook)"),
        ("megakernel_vjp_tab", "megakernel_grad.cu",
         "megakernel_grad.py:1049 (spheres, SPEC/REFR)"),
        ("megakernel_vjp_cosine_tab", "megakernel_grad.cu",
         "megakernel_grad.py:1049 (spheres, SPEC/REFR, cosine)"),
        ("megakernel_vjp_textbook_tab", "megakernel_grad.cu",
         "megakernel_grad.py:1049 (spheres, SPEC/REFR, nee_textbook)"),
    ),
    cases=(("cornell_box", "cosine", {"estimator": "cosine"}),
           ("cornell_box", "nee_textbook", {"estimator": "nee_textbook"}),
           *((n, e, {"estimator": e})
             for n in ("smallpt_original", "sphere_grid")
             for e in ("nee", "cosine", "nee_textbook"))),
    size8={"cornell_box": (1024, 768), "smallpt_original": (1024, 768),
           "sphere_grid": (1024, 768)},
    size9={"cornell_box": (256, 192), "smallpt_original": (128, 96),
           "sphere_grid": (128, 96)},
    deep=({"estimator": "cosine"}, {"estimator": "nee_textbook"}),
    shard=("smallpt_original", {"estimator": "cosine"}, (128, 96)),
    fits=(("smallpt_original", {"estimator": "cosine"}, "emission,albedo",
           5, None),
          *((n, {"estimator": e}, "emission", 2, None) for n, e in (
              ("smallpt_original", "nee"),
              ("smallpt_original", "nee_textbook"),
              ("cornell_box", "cosine"), ("cornell_box", "nee_textbook"),
              ("sphere_grid", "nee_textbook")))),
    x512_n=(2, 1),
)


VJP_ENTRY_BYTES, GEOM_ENTRY_BYTES = 48, 64


def vjp_bound(traces, n_samples: int, n_pix: int, k: int,
              algorithm: bool = False, n_spheres: int = 0,
              est: str = "nee", diffuse_only: bool = True, n_quads: int = 0,
              extra_fp: float = 0.0):
    """megakernel_vjp. The function's bound: every bounce of every sample
    traced once, unfolded (the forward's extend count: a folded bounce is
    an extend too), and one gradient update a bounce. nee: each bounce a
    query, the shading and a probe; the other estimators: the forward's
    operations (``forward_ops``: for mis with FP_MIS) and the updates. The
    queries are the linear scan's (n_spheres of the k objects are
    spheres, n_quads quads). extra_fp is added as it is (the GLOS lobe's
    work). Bytes: the cotangent image and the tables in (with quads, their
    rows and every object's code and Phong exponent), the gradients out.
    With ``algorithm`` this kernel's bound: also its tape, an entry a
    bounce written once and read once (the segment replays of paths longer
    than the tape, about 1e-5 of the paths, left out)."""
    extend = traces[0]
    n_rects = k - n_spheres - n_quads
    if est == "nee":
        q = query_ops(n_rects, n_spheres, n_quads)
        fp = extend * (q + FP_SHADE + FP_PROBE + FP_GRAD) + n_samples * FP_SPAWN
        it = extend * INT_BOUNCE + n_samples * INT_SPAWN
    else:
        fp, it = forward_ops(traces, n_samples, n_rects, n_spheres,
                             est, diffuse_only, n_quads=n_quads)
        fp += extend * FP_GRAD
    fp += extra_fp
    n_bytes = n_pix * 12 + 4 * k * 3 * 4 + (
        k * 4 + n_spheres * 16 if n_spheres else 0)
    if n_quads:
        n_bytes += n_quads * 19 * 4 + k * 4 + (0 if n_spheres else k * 4)
    if algorithm:
        n_bytes += 2 * extend * VJP_ENTRY_BYTES
    return bound(fp, it, n_bytes)


# The geometry adjoint (row 11) against autograd through its plain version,
# row by row: each object's albedo and emission rows and each sphere's
# [cx, cy, cz, r] row within these shares of that row's own largest entry
# (the hand pullback and autograd compute one linearization in two formula
# orders; grazing sphere hits amplify the rounding, PERF.md). A row held to
# its own scale shows a contribution summed into the wrong object's row.
# (materials, sphere rows) a scene. Measured on an H100 (PERF.md §6): every
# material row within 2.3e-6; sphere rows within 2.7e-7 on cornell_spheres
# and 9.0e-7 on sphere_grid, held to 1e-5; the glass of smallpt_original
# refracts at grazing angles, 6.9e-4 under cotangent seed 5, held to 1e-3.
GEOM_TOL = {"cornell_spheres": (1e-4, 1e-5), "smallpt_original": (1e-4, 1e-3),
            "sphere_grid": (1e-4, 1e-5)}
# The least fp32 operations of a VJP bounce beyond its replayed bounce,
# counted from csrc/megakernel_geom.cuh: the material terms (~40) and the
# cheapest pullback (a rect winner's cosine sample and hit point, ~60).
FP_VJP = 100


def geom_bound(counts, n_samples: int, n_pix: int, n_rects: int,
               n_spheres: int, n_blocks: int, algorithm: bool = False,
               est: str = "nee", diffuse_only: bool = True):
    """megakernel_geom from its own counters [extend, probe, replayed, VJP,
    paths longer than the tape]. The function's bound: the gradient needs
    pass A's bounces (a query with the least shading each), pass A's probes
    at their least, one pullback a bounce (FP_VJP, one a VJP bounce) and a
    spawn a sample. The other estimators' pass A (``est``, the RenderConfig
    estimator: glibc's instances count as theirs) is ``forward_ops`` of its
    counts: the hemisphere samples, the textbook and mis probes' light
    samples, weights and direct terms, mis's balance weights (FP_MIS).
    Bytes: the cotangent and the image, the tables, the per-block partials
    out and in. With ``algorithm`` this kernel's bound: also its segment
    replays (a query and the least shading each, their probes left out),
    each VJP bounce's shading (its queries come from the tape), and the
    tape: an entry written a traced or replayed bounce and read a VJP
    bounce."""
    extend, probe, replay, vjp = counts[:4]
    q = query_ops(n_rects, n_spheres)
    if est == "nee":
        fp = (extend * (q + FP_SHADE_MIN) + probe * (FP_PROBE + FP_NEE)
              + vjp * FP_VJP + n_samples * FP_SPAWN)
        it = extend * (INT_DRAW + INT_WORD) + n_samples * INT_SPAWN
    else:
        fp, it = forward_ops((extend, probe), n_samples, n_rects, n_spheres,
                             est, diffuse_only)
        fp += vjp * FP_VJP
    k = n_rects + n_spheres
    slots = 6 * k + 4 * n_spheres
    n_bytes = (n_pix * 24 + k * 28 + n_spheres * 16
               + 2 * n_blocks * slots * 4)
    if algorithm:
        fp += replay * (q + FP_SHADE_MIN) + vjp * FP_SHADE_MIN
        it += (replay + vjp) * (INT_DRAW + INT_WORD)
        n_bytes += (extend + replay + vjp) * GEOM_ENTRY_BYTES
    return bound(fp, it, n_bytes)


def ptxas_report(output: str, names: tuple) -> dict:
    """From nvcc's ptxas -v output: {kernel: (registers, stack frame bytes
    (its local memory: the tape), spill store bytes, spill load bytes)} for
    each entry function whose mangled name holds one of ``names``; a
    template instance on ints (the sphere scan, the estimator) as
    ``name<k>`` or ``name<k,e>``."""
    found, cur, entry, props = {}, None, None, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            cur = next((n for n in names
                        if re.search(rf"\d{n}(I|P|E|v|$)", entry)), None)
            inst = cur and re.search(rf"\d{cur}I((?:Li\d+E)+)E", entry)
            if inst:
                cur = f"{cur}<{','.join(re.findall(r'Li(\d+)E', inst.group(1)))}>"
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur and props == entry:
            found[cur] = [None, *map(int, m.groups())]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in found:
            found[cur][0] = int(m.group(1))
            cur = None
    return {k: tuple(v) for k, v in found.items()}


def worst_row(kt: torch.Tensor, pt: torch.Tensor):
    """(ratio, row, row's largest |plain| entry) of the row with the largest
    max |kernel - plain| over its own largest |plain| entry; a row whose
    plain entries are all 0 has ratio 0 when the kernel's are too, else
    inf."""
    err = (kt - pt).abs().amax(dim=1)
    scale = pt.abs().amax(dim=1)
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    i = int(ratio.argmax())
    return float(ratio[i]), i, float(scale[i])


def geom_phases(card: str, cli_main) -> dict:
    """The geometry adjoint, megakernel_geom (row 11): the image-only launch
    against megakernel_nee_tab and the plain version, bit for bit; the
    adjoint against autograd through the plain version and against itself;
    ``cli fit --train center,radius``; the x512 event time. Returns its
    ``kernels`` entry's numbers."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import _build, megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo

    def parity(name, width, height, seed, g_seeds, long_paths=False):
        """Image-only parity, then the adjoint under the cotangent of each
        of g_seeds; returns the first cotangent's numbers. With
        ``long_paths`` some path must have outrun the tape, so the segment
        replays ran."""
        sc = get_scene(name)
        cam = make_camera(aspect=width / height)
        cfg = RenderConfig(width=width, height=height, spp=4, seed=seed,
                           max_bounces=PARITY_BOUNCES)
        t_img, t_tr = megakernel.render_megakernel(sc, cam, cfg, seed)
        outs, med = in_turns(
            {"kernel": lambda: mgeo.geom_run(sc, cam, cfg, seed,
                                             with_counts=True),
             "plain": lambda: mgeo.geom_run_plain(sc, cam, cfg, seed)},
            ("plain", "kernel", "kernel", "plain"))
        for img_i, *_, c_i in outs["kernel"] + outs["plain"]:
            if not (torch.equal(img_i, t_img) and torch.equal(c_i[:2], t_tr)):
                raise AssertionError(f"{name}: the image-only launch or its "
                                     "plain version differs from "
                                     "megakernel_nee_tab")
        return [adjoint(sc, cam, cfg, name, seed, g_seed, t_img, t_tr,
                        med, long_paths) for g_seed in g_seeds][0]

    def adjoint(sc, cam, cfg, name, seed, g_seed, t_img, t_tr, med,
                long_paths):
        width, height = cfg.width, cfg.height
        n_pix = width * height
        g = torch.from_numpy(np.random.default_rng(g_seed).standard_normal(
            (height, width, 3)).astype(np.float32)).to("cuda")
        runs, secs = [], []
        for _ in range(3):
            out, sec = timed(lambda: mgeo.geom_run(sc, cam, cfg, seed, g,
                                                   with_counts=True))
            runs.append(out)
            secs.append(sec)
        for out in runs[1:]:
            if not all(torch.equal(a, b) for a, b in zip(out, runs[0])):
                raise AssertionError(f"{name}: adjoint runs differ")
        k_img, k_sph, k_alb, k_emi, counts = runs[0]
        if not (torch.equal(k_img, t_img) and torch.equal(counts[:2], t_tr)
                and int(counts[3]) == int(t_tr[0])):
            raise AssertionError(f"{name}: the adjoint's pass A differs from "
                                 "megakernel_nee_tab, or it ran a VJP bounce "
                                 "count other than the extends")
        # Segment replays are O(D): fewer than the bounces traced.
        if not int(counts[2]) < int(counts[0]):
            raise AssertionError(f"{name}: {int(counts[2])} replayed bounces "
                                 f"for {int(counts[0])} traced")
        if long_paths and not int(counts[4]) > 0:
            raise AssertionError(f"{name}: no path outran the tape, so the "
                                 "segment replays did not run")
        torch.cuda.reset_peak_memory_stats()
        (_, p_sph, p_alb, p_emi, _), p_s = timed(
            lambda: mgeo.geom_run_plain(sc, cam, cfg, seed, g))
        peak = torch.cuda.max_memory_allocated()
        err_, bad = 0.0, []
        tol_mat, tol_sph = GEOM_TOL[name]
        for label, kt, pt, tol in (("albedo", k_alb, p_alb, tol_mat),
                                   ("emission", k_emi, p_emi, tol_mat),
                                   ("sphere rows", k_sph, p_sph, tol_sph)):
            e = float((kt - pt).abs().max())
            ratio, row, scale = worst_row(kt, pt)
            err_ = max(err_, e)
            log(f"[smoke] geom adjoint {name} (cotangent seed {g_seed}) d/d "
                f"{label}: max |kernel - plain| {e:.3e} (table's largest "
                f"entry {float(pt.abs().max()):.3e}); worst row {row}: "
                f"ratio {ratio:.3e} to its largest entry {scale:.3e} (limit "
                f"{tol:g})")
            if not ratio <= tol:
                bad.append(f"d/d {label} row {row} off by {ratio:.3e} of "
                           f"its largest entry > {tol}")
        if bad:
            raise AssertionError(f"{name}: " + "; ".join(bad))
        groups = megakernel.full_layout(cfg).g
        b = geom_bound(counts.tolist(), n_pix * 4, n_pix,
                       sc.rects.k.shape[0], sc.spheres.radius.shape[0],
                       -(-n_pix * groups // mgeo.KERNEL_BLOCK))
        b_alg = geom_bound(counts.tolist(), n_pix * 4, n_pix,
                           sc.rects.k.shape[0], sc.spheres.radius.shape[0],
                           -(-n_pix * groups // mgeo.KERNEL_BLOCK), True)
        ms = float(np.median(secs)) * 1e3
        log(f"[smoke] geom {name} {width}x{height}x4 seed {seed}: image-only "
            f"{med['kernel'] * 1e3:.3f} ms (plain {med['plain'] * 1e3:.3f} "
            f"ms) == megakernel_nee_tab, traces {t_tr.tolist()}; adjoint "
            f"{ms:.3f} ms, counts {counts.tolist()} [extend, probe, "
            f"replayed, VJP, paths longer than the tape], three runs "
            f"bit-identical; plain adjoint {p_s:.3f} s, peak memory "
            f"{peak / 2**30:.2f} GiB; bound {b[0]:.3f} ms ({b[1]}; the "
            f"taped algorithm's {b_alg[0]:.3f} ms, {b_alg[1]})")
        return {"err": err_, "ms": ms, "plain_ms": p_s * 1e3, "bound": b}

    phase("geometry adjoint against megakernel_nee_tab and its plain "
          "version, cornell_spheres 1024x768x4")
    res = {"cornell_spheres": parity("cornell_spheres", 1024, 768, 3, (3,),
                                     long_paths=True)}
    # The glass scene under cotangent seed 5, where grazing refraction puts
    # the sphere rows' largest rounding gap nearest its limit (each further
    # cotangent costs 50-60 s of autograd).
    phase("geometry adjoint, smallpt_original 1024x768x4 (SPEC + REFR), "
          "cotangent seed 5")
    res["smallpt_original"] = parity("smallpt_original", 1024, 768, 3,
                                     (5,), long_paths=True)
    phase("geometry adjoint, sphere_grid 256x192x4 (64 spheres)")
    res["sphere_grid"] = parity("sphere_grid", 256, 192, 3, (3,))

    phase("main path, cli fit --train center,radius --scene cornell_spheres "
          "1024x768x512, 5 steps")
    out, err_io = io.StringIO(), io.StringIO()
    megakernel.LAUNCHES.clear()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err_io):
        rc = cli_main(["fit", "--scene", "cornell_spheres", "--width", "1024",
                       "--height", "768", "--spp", "512", "--steps", "5",
                       "--train", "center,radius"])
    launches = megakernel.LAUNCHES["megakernel_geom"]
    for line in err_io.getvalue().strip().splitlines():
        log("[smoke] cli fit: " + line)
    if rc != 0:
        raise AssertionError(f"cli fit --train center,radius returned {rc}")
    fit = json.loads(out.getvalue().strip().splitlines()[-1])
    log("[smoke] cli fit: " + json.dumps(fit))
    steps = [(float(a), float(b)) for a, b in re.findall(
        r"loss (\S+).*?seconds (\S+)", err_io.getvalue())]
    losses = [a for a, _ in steps]
    truth = get_scene("cornell_spheres").spheres.center[0].cpu().numpy()
    start = truth + np.array([4.0, 0.0, -3.0], np.float32)
    d0 = float(np.linalg.norm(start - truth))
    d1 = float(np.linalg.norm(np.asarray(fit["center"]) - truth))
    if launches != 1 + 2 * 5:
        raise AssertionError(f"cli fit launched megakernel_geom {launches} "
                             "times, not 1 + 2 a step")
    if len(losses) != 5 or not min(losses) < losses[0] or not d1 < d0:
        raise AssertionError(f"the geometry fit did not descend: losses "
                             f"{losses}, sphere 0 {d0:.3f} -> {d1:.3f} from "
                             "the truth")
    if _build.build_kernels().build_seconds != 0.0:
        raise AssertionError("moving the spheres rebuilt the library")
    step_s = float(np.median([b for _, b in steps]))
    log(f"[smoke] geometry fit: {launches} launches of megakernel_geom "
        f"(1 + 2 a step); loss {losses[0]:.6f} -> best {min(losses):.6f}; "
        f"sphere 0 {d0:.3f} -> {d1:.3f} from the truth; {step_s:.4f} s a "
        f"step (median of 5) on {card}; no rebuild")

    phase("geometry adjoint at 1024x768x512, CUDA events")
    sc = get_scene("cornell_spheres")
    cam = make_camera(aspect=1024 / 768)
    cfg = RenderConfig(width=1024, height=768, spp=512, seed=0)
    geometry = megakernel.pack_geometry(sc, cam)
    g = torch.full((768, 1024, 3), 1e-7, device="cuda")
    counts = mgeo.geom_run(sc, cam, cfg, 0, g, geometry=geometry,
                           with_counts=True)[4].tolist()
    img_ms = event_ms(lambda: mgeo.geom_run(sc, cam, cfg, 0,
                                            geometry=geometry), 3)
    before = megakernel.LAUNCHES["megakernel_nee_tab"]
    tab_ms = event_ms(lambda: megakernel.render_megakernel(sc, cam, cfg, 0),
                      3)
    if megakernel.LAUNCHES["megakernel_nee_tab"] != before + 3:
        raise AssertionError("cornell_spheres did not go through "
                             "megakernel_nee_tab")
    adj_ms = event_ms(lambda: mgeo.geom_run(sc, cam, cfg, 0, g,
                                            geometry=geometry), 2)
    n_pix = 1024 * 768
    b512, b512_alg = (geom_bound(counts, n_pix * 512, n_pix,
                                 sc.rects.k.shape[0],
                                 sc.spheres.radius.shape[0],
                                 -(-n_pix // 128), alg) for alg in (False, True))
    log(f"[smoke] cornell_spheres 1024x768x512 seed 0: megakernel_geom "
        f"image-only {img_ms:.3f} ms (megakernel_nee_tab {tab_ms:.3f} ms, "
        f"ratio {img_ms / tab_ms:.3f}), adjoint {adj_ms:.3f} ms a launch, "
        f"counts {counts} [extend, probe, replayed, VJP, paths longer than "
        f"the tape]; bound {b512[0]:.3f} ms ({b512[1]}; the taped "
        f"algorithm's {b512_alg[0]:.3f} ms, {b512_alg[1]})")
    if not counts[2] < counts[0]:
        raise AssertionError(f"{counts[2]} replayed bounces for {counts[0]} "
                             "traced")
    res["cornell_spheres"]["launches"] = launches
    return res["cornell_spheres"]


# The deep-path phase of the two adjoints: rr_start_depth = max_bounces =
# DEEP_BOUNCES, past (kCkpt + 2)·kSeg bounces, so every path replays
# segments from the last checkpoint (megakernel_tape.cuh); every albedo
# DEEP_ALBEDO, so that no path ends on a black surface (the light) and
# bounce 160 still carries 0.98^160 = 4% of a path's throughput.
DEEP_BOUNCES, DEEP_ALBEDO = 200, 0.98


def self_hit_pixels(sc, cam, cfg, seed) -> torch.Tensor:
    """(h, w) bool: the pixels of which some sample's NEE probe leaves a
    point on the light's plane (within 1e-3) and meets the light, found by
    spying on the plain version's probes (one chunk of every lane). Such a
    probe starts one float below the plane, meets the light just past the
    self-hit epsilon and weighs above 1e3 (tests/test_torch_geom.py
    test_reflecting_light_gradients)."""
    from small_pathtracer_tpu_torch.integrator import wavefront
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.ops.megakernel import full_layout
    from small_pathtracer_tpu_torch.parallel.sharded import shard_lanes

    lid = sc.light.light_obj_id
    a, k = int(sc.rects.axis[lid]), sc.rects.k[lid]
    pix = shard_lanes(full_layout(cfg), "cuda")[0]
    flag = torch.zeros(pix.shape[0], dtype=torch.bool, device="cuda")
    probe = wavefront._probe_light

    def spy(scene, x, nl, u):
        d_l, success, w = probe(scene, x, nl, u)
        flag.logical_or_(success & ((x[:, a] - k).abs() < 1e-3))
        return d_l, success, w

    wavefront._probe_light = spy
    try:
        mgeo.geom_run_plain(sc, cam, cfg, seed)
    finally:
        wavefront._probe_light = probe
    mask = torch.zeros(cfg.height * cfg.width, dtype=torch.bool,
                       device="cuda")
    mask[pix[flag]] = True
    return mask.reshape(cfg.height, cfg.width)


def tape_sizes() -> tuple[int, int]:
    """(kSeg, kCkpt) of csrc/megakernel_tape.cuh."""
    text = (ROOT / CSRC / "megakernel_tape.cuh").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
                 for n in ("kSeg", "kCkpt"))


def replayed_bounces(depth: int, k_seg: int, k_ckpt: int) -> int:
    """The bounces the adjoints replay for a path of ``depth`` bounces
    (megakernel_tape.cuh): each segment i below the last, from the spawn or
    checkpoint min(i, kCkpt) to the segment's end."""
    n_seg = -(-depth // k_seg)
    return sum((i + 1 - min(i, k_ckpt)) * k_seg for i in range(n_seg - 1))


def deep_phase() -> None:
    """megakernel_vjp on cornell_box and the adjoint launch of
    megakernel_geom on cornell_spheres with every path DEEP_BOUNCES long,
    64x48x4: each against autograd through its plain version, three runs
    bit-identical; the geometry adjoint's image and [extend, probe] against
    megakernel_nee_tab and its counters against the tape's schedule."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg

    k_seg, k_ckpt = tape_sizes()
    phase(f"deep paths: both adjoints at rr_start_depth = max_bounces = "
          f"{DEEP_BOUNCES} (> (kCkpt + 2)·kSeg = {(k_ckpt + 2) * k_seg}), "
          f"every albedo {DEEP_ALBEDO}, 64x48x4")
    if not DEEP_BOUNCES > (k_ckpt + 2) * k_seg:
        raise AssertionError("DEEP_BOUNCES does not reach the segments "
                             "replayed from the last checkpoint")
    width, height = 64, 48
    n = width * height * 4
    cam = make_camera(aspect=width / height)
    cfg = RenderConfig(width=width, height=height, spp=4, seed=3,
                       rr_start_depth=DEEP_BOUNCES, max_bounces=DEEP_BOUNCES)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (height, width, 3)).astype(np.float32)).to("cuda")

    def three_runs(label, fn):
        runs = [fn() for _ in range(3)]
        for out in runs[1:]:
            if not all(torch.equal(a, b) for a, b in zip(out, runs[0])):
                raise AssertionError(f"deep paths: {label} runs differ")
        return runs[0]

    box = get_scene("cornell_box")
    alb, emi = mg.pack_materials(box)
    alb = torch.full_like(alb, DEEP_ALBEDO)
    _, traces = mg.render_megakernel_mat(box, cam, cfg, alb, emi, 3)
    if int(traces[0]) != DEEP_BOUNCES * n:
        raise AssertionError(f"deep paths: cornell_box traced "
                             f"{int(traces[0])} bounces, not {DEEP_BOUNCES} "
                             f"for each of {n} paths")
    k_alb, k_emi = three_runs("megakernel_vjp", lambda: mg.render_megakernel_vjp(
        box, cam, cfg, alb, emi, 3, g))
    p_alb, p_emi = mg.render_megakernel_vjp_plain(box, cam, cfg, alb, emi, 3,
                                                  g)
    for label, kt, pt in (("albedo", k_alb, p_alb), ("emission", k_emi,
                                                      p_emi)):
        err, scale = float((kt - pt).abs().max()), float(pt.abs().max())
        log(f"[smoke] deep paths, megakernel_vjp d/d {label}: max |kernel - "
            f"plain| {err:.3e}, largest entry {scale:.3e}, ratio "
            f"{err / scale:.3e} (limit {VJP_TOL:g})")
        if not err <= VJP_TOL * scale:
            raise AssertionError(f"deep paths: megakernel_vjp d/d {label} off "
                                 f"by {err} > {VJP_TOL} x {scale}")

    sph = get_scene("cornell_spheres")
    t_sph, t_alb, t_emi = mgeo.pack_tables(sph)
    sc = mgeo.scene_with_tables(sph, t_sph, torch.full_like(t_alb, DEEP_ALBEDO),
                                t_emi)
    t_img, t_tr = megakernel.render_megakernel(sc, cam, cfg, 3)
    img, k_sph, k_alb, k_emi, counts = three_runs(
        "megakernel_geom", lambda: mgeo.geom_run(sc, cam, cfg, 3, g,
                                                 with_counts=True))
    want = [DEEP_BOUNCES * n, int(t_tr[1]),
            replayed_bounces(DEEP_BOUNCES, k_seg, k_ckpt) * n,
            DEEP_BOUNCES * n, n]
    log(f"[smoke] deep paths, megakernel_geom counts {counts.tolist()} "
        f"[extend, probe, replayed, VJP, paths longer than the tape]; the "
        f"schedule's {want}")
    if not (torch.equal(img, t_img) and torch.equal(counts[:2], t_tr)
            and counts.tolist() == want):
        raise AssertionError("deep paths: megakernel_geom's image or "
                             "counters differ from megakernel_nee_tab's or "
                             "from the tape's schedule")
    # Every row against autograd through the plain version: the material
    # rows at the phases' limit in every case. The sphere rows with the
    # light black (no path scatters off it) at the phases' 1e-5. Once the
    # light reflects, a probe from its own underside meets it just past
    # the self-hit epsilon with a weight above 1e3, and such a lane's
    # derivatives rest on rounding, which the kernel and autograd round in
    # other orders (PERF.md §7). The witness: at max_bounces 5, with the
    # cotangent zeroed on the pixels that hold such a probe, the sphere
    # rows are held to 1e-5 again. Unmasked, and at 200 bounces, where
    # every pixel holds one, they are logged only.
    tol_mat, tol_sph = GEOM_TOL["cornell_spheres"]
    lid = sph.light.light_obj_id
    dark_alb = torch.full_like(t_alb, DEEP_ALBEDO)
    dark_alb[lid] = 0.0
    dark = mgeo.scene_with_tables(sph, t_sph, dark_alb, t_emi)
    cfg5 = RenderConfig(width=width, height=height, spp=4, seed=3,
                        rr_start_depth=5, max_bounces=5)
    hit, hit5 = (self_hit_pixels(sc, cam, c, 3) for c in (cfg, cfg5))
    log(f"[smoke] deep paths: the pixels that hold a probe from the light's "
        f"underside that meets it: {int(hit.sum())} of {hit.numel()} at "
        f"{DEEP_BOUNCES} bounces, {int(hit5.sum())} at max_bounces 5")
    g5 = g * ~hit5[..., None]
    cases = [("", (k_sph, k_alb, k_emi),
              mgeo.geom_run_plain(sc, cam, cfg, 3, g)[1:4], None)]
    for label, sc_, cfg_, g_, tol in (
            (" at max_bounces 5", sc, cfg5, g, None),
            (" at max_bounces 5, the cotangent 0 on those pixels", sc, cfg5,
             g5, tol_sph),
            (" with the light black", dark, cfg, g, tol_sph)):
        cases.append((label, mgeo.geom_run(sc_, cam, cfg_, 3, g_)[1:4],
                      mgeo.geom_run_plain(sc_, cam, cfg_, 3, g_)[1:4], tol))
    for label, k_tabs, p_tabs, tol in cases:
        for name, kt, pt, lim in zip(("sphere rows", "albedo", "emission"),
                                     k_tabs, p_tabs, (tol, tol_mat, tol_mat)):
            ratio, row, scale = worst_row(kt, pt)
            gate = "logged only" if lim is None else f"limit {lim:g}"
            log(f"[smoke] deep paths{label}, megakernel_geom d/d {name}: "
                f"worst row {row}: ratio {ratio:.3e} to its largest entry "
                f"{scale:.3e} ({gate})")
            if lim is not None and not ratio <= lim:
                raise AssertionError(f"deep paths{label}: megakernel_geom "
                                     f"d/d {name} row {row} off by "
                                     f"{ratio:.3e} > {lim}")


# The tie phase: the left wall of cornell_box, and the albedo of its copy.
TIE_WALL, TIE_TINT = 2, (0.3, 0.6, 0.9)


# The original smallpt's spheres: radius-1e5 walls (over smallpt_original's
# rect walls, so sphere-rect near ties), the two balls and the light ball.
SMALLPT_WALLS = ((1e5 + 1, 40.8, 81.6, 1e5), (-1e5 + 99, 40.8, 81.6, 1e5),
                 (50, 40.8, 1e5, 1e5), (50, 40.8, -1e5 + 170, 1e5),
                 (50, 1e5, 81.6, 1e5), (50, -1e5 + 81.6, 81.6, 1e5),
                 (27, 16.5, 47, 16.5), (73, 16.5, 78, 16.5),
                 (50, 681.6 - .27, 81.6, 600))


def grazing_rays(sph: np.ndarray, light, n: int, seed: int):
    """Seeded rays (o, d), float32 (N, 3) numpy arrays: from inside the room
    every way and toward light samples; tangent to a sphere within a few
    ulps either side; in a sphere's tangent plane x_j = c_j +- r (its
    box's face) with d_j = 0; and from points on a sphere inside its
    self-hit epsilon (tests/test_torch_sphere_bvh.py keeps a copy)."""
    r = np.random.default_rng(seed)
    lo, hi = np.array([2.0, 1.0, 2.0]), np.array([98.0, 80.0, 168.0])
    os_, ds = [], []
    o = r.uniform(lo, hi, (n, 3))
    lp = (light.corner.cpu().numpy() + r.random((n, 1))
          * light.edge_u.cpu().numpy() + r.random((n, 1))
          * light.edge_v.cpu().numpy())
    os_ += [o, o]
    ds += [r.standard_normal((n, 3)), lp - o]
    k = r.integers(len(sph), size=n)
    c, rad = sph[k, :3].astype(np.float64), np.abs(sph[k, 3:4]).astype(
        np.float64)
    d = r.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = np.cross(d, r.standard_normal((n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    off = r.choice([-2.4e-7, -1.2e-7, 0.0, 1.2e-7, 2.4e-7], (n, 1))
    os_.append(c + u * rad * (1.0 + off) - d * r.uniform(1.0, 60.0, (n, 1)))
    ds.append(d)
    j = r.integers(0, 3, n)
    sgn = r.choice([-1.0, 1.0], n)
    face = (c[np.arange(n), j] + sgn * rad[:, 0]).astype(np.float32)
    step = r.choice([-1, 0, 1], n)
    face = np.where(step > 0, np.nextafter(face, np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(face, np.float32(-np.inf)),
                             face))
    d = r.standard_normal((n, 3))
    d[np.arange(n), j] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tp = c.copy()
    tp[np.arange(n), j] = face
    o4 = tp - d * r.uniform(2.0, 60.0, (n, 1))
    o4[np.arange(n), j] = face
    os_.append(o4)
    ds.append(d)
    nrm = r.standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    os_.append(c + nrm * rad * (1.0 + r.uniform(-2e-6, 2e-6, (n, 1))))
    ds.append(r.standard_normal((n, 3)))
    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = np.isfinite(d).all(1) & np.isfinite(o).all(1)
    return o[keep], d[keep].astype(np.float32)


def grazing_phase() -> dict:
    """The sphere table's scans through the tree (the query kernel
    ``sphere_queries``: nearest_tab and probe_light_tab) against the plain
    version's in-order scan on the card, bit for bit: the nearest (t, id)
    and the probe's success and t_light, on grazing and face rays."""
    from small_pathtracer_tpu_torch import get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.scene.types import Spheres

    phase("grazing rays: the sphere scans against the plain version on "
          "sphere_grid, sphere_grid_1024, cornell_spheres, smallpt_original "
          "and smallpt_original with the original radius-1e5 walls (alone "
          "and with sphere_grid's spheres)")
    cam = make_camera()
    out = {}
    walls = np.asarray(SMALLPT_WALLS, np.float32)
    grid = get_scene("sphere_grid")
    grid = torch.cat([grid.spheres.center, grid.spheres.radius[:, None]],
                     1).cpu().numpy()
    for name in ("sphere_grid", "sphere_grid_1024", "cornell_spheres",
                 "smallpt_original", "smallpt_walls", "smallpt_walls_grid"):
        sc = get_scene("smallpt_original" if name.startswith("smallpt_walls")
                       else name)
        if name.startswith("smallpt_walls"):
            rows = walls if name == "smallpt_walls" else np.concatenate(
                [walls, grid])
            t = torch.from_numpy(rows).cuda()
            n = len(rows)
            sp = sc.spheres
            sc = sc._replace(spheres=Spheres(
                center=t[:, :3], radius=t[:, 3],
                albedo=sp.albedo[:1].repeat(n, 1),
                emission=sp.emission[:1].repeat(n, 1),
                refl=sp.refl[:1].repeat(n), gloss=sp.gloss[:1].repeat(n)))
        sph = torch.cat([sc.spheres.center, sc.spheres.radius[:, None]],
                        1).cpu().numpy()
        o, d = (torch.from_numpy(a).cuda()
                for a in grazing_rays(sph, sc.light, 20000, 21))
        before = megakernel.LAUNCHES["sphere_queries"]
        k = megakernel.sphere_queries(sc, cam, o, d)
        torch.cuda.synchronize()
        if megakernel.LAUNCHES["sphere_queries"] != before + 1:
            raise AssertionError(f"{name}: the query kernel did not launch")
        p = megakernel.sphere_queries_plain(sc, o, d)
        same = [torch.equal(a, b) for a, b in zip(k, p)]
        n_sph = int((k[1] >= sc.rects.k.shape[0]).sum())
        log(f"[smoke] grazing {name}: {o.shape[0]} rays, {n_sph} nearest "
            f"hits on spheres, {int(k[2].sum())} probes reach the light; "
            f"kernel == plain [t, id, success, t_light]: {same}")
        if not all(same):
            bad = int(((k[0] != p[0]) | (k[1] != p[1])
                       | (k[2] != p[2])).sum())
            raise AssertionError(f"grazing {name}: {bad} rays differ")
        out[name] = o.shape[0]
    return out


def tie_phase(guide) -> None:
    """The rect scan's tie rule (the smallest (t, id) wins; a rect before
    the light blocks it at t == t_light) through rows 1 and 4
    (megakernel_nee; megakernel_guided, nee_textbook, with the guide table
    of cornell_box) at 256x192x4 on cornell_box, each launch against its
    plain version bit for bit: a copy of the left wall with another albedo
    and a later id leaves image and traces as they were; the same copy with
    an earlier id takes the wall's place (the image of the scene whose wall
    has the copy's albedo); a zero-emission copy of the light before the
    light's id blocks every probe and hides the light (an all-black
    image). tests/test_torch_scan.py holds the plain version to the same on
    the CPU."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.scene.types import insert_rect

    phase("tie phase: rows 1 and 4 on cornell_box 256x192x4 with a copy of "
          "a wall after and before it and a dark copy of the light")
    box = get_scene("cornell_box")
    cam = make_camera(aspect=256 / 192)
    cfg = RenderConfig(width=256, height=192, spp=4, seed=4)
    cfg_t = RenderConfig(width=256, height=192, spp=4, seed=4,
                         estimator="nee_textbook")
    renders = {
        "megakernel_nee": lambda sc, plain: (
            megakernel.render_megakernel_plain if plain
            else megakernel.render_megakernel)(sc, cam, cfg, 4),
        "megakernel_guided": lambda sc, plain: (
            megakernel.render_megakernel_guided_plain if plain
            else megakernel.render_megakernel_guided)(
                sc, cam, cfg_t, 4, guide, GUIDE_BETA, GUIDE_K),
    }
    alb = box.rects.albedo.clone()
    alb[TIE_WALL] = torch.tensor(TIE_TINT)
    scenes = {
        "as built": box,
        "wall copy after": insert_rect(box, box.rects.k.shape[0], TIE_WALL,
                                       TIE_TINT),
        # Just before the wall: id 0 keeps its rect, whose materials a
        # miss takes (the reference's C15).
        "wall copy before": insert_rect(box, TIE_WALL, TIE_WALL, TIE_TINT),
        "tinted wall": box._replace(rects=box.rects._replace(albedo=alb)),
        "dark light copy before": insert_rect(
            box, box.light.light_obj_id, box.light.light_obj_id,
            emission=(0.0, 0.0, 0.0)),
    }
    for name, render in renders.items():
        out = {}
        for label, sc in scenes.items():
            before = megakernel.LAUNCHES[name]
            img, tr = render(sc, False)
            p_img, p_tr = render(sc, True)
            if megakernel.LAUNCHES[name] != before + 1:
                raise AssertionError(f"tie phase: {name} did not launch once "
                                     f"on {label}")
            if not (torch.equal(img, p_img) and torch.equal(tr, p_tr)):
                raise AssertionError(f"tie phase: {name} on {label} differs "
                                     "from its plain version")
            out[label] = (img, tr)

        def same(a, b):
            return (torch.equal(out[a][0], out[b][0])
                    and torch.equal(out[a][1], out[b][1]))
        dark_img, dark_tr = out["dark light copy before"]
        checks = {
            "a later copy changes nothing": same("wall copy after",
                                                 "as built"),
            "an earlier copy takes the wall's place": (
                same("wall copy before", "tinted wall")
                and not same("tinted wall", "as built")),
            "a dark copy before the light blocks every probe": (
                not bool(dark_img.any()) and int(dark_tr[0]) > 0),
        }
        log(f"[smoke] tie phase {name}: every scene == plain version; "
            + "; ".join(f"{k}: {'ok' if v else 'FAILED'}"
                        for k, v in checks.items())
            + f"; traces as built {out['as built'][1].tolist()}, dark "
            f"light {dark_tr.tolist()}")
        if not all(checks.values()):
            raise AssertionError(f"tie phase: {name} breaks a tie rule")
    quad_ties(guide)


def quad_ties(guide) -> None:
    """The tie rule with quads (ids after the rects, scanned after the
    axis groups) through the _ext instances of rows 1 and 4
    (megakernel_nee_ext; megakernel_guided_ext, nee_textbook, with the guide
    table of cornell_box) at 256x192x4 on cornell_tilted_light, each launch
    bit for bit its plain version: a copy of the light quad with another
    emission after it changes nothing; a dark copy before it blocks every
    probe and hides the light (an all-black image); a tinted quad on the
    floor's plane after the light, whose t ties with the floor rect's up to
    rounding, renders as its plain version's in-order scan says."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.scene.types import Quads, insert_quad

    phase("tie phase with quads: rows 1 and 4 (_ext) on cornell_tilted_light "
          "256x192x4 with copies of the light quad after and before it and "
          "a quad on the floor's plane")
    tl = get_scene("cornell_tilted_light")
    cam = make_camera(aspect=256 / 192)
    cfg = RenderConfig(width=256, height=192, spp=4, seed=4)
    cfg_t = RenderConfig(width=256, height=192, spp=4, seed=4,
                         estimator="nee_textbook")
    renders = {
        "megakernel_nee_ext": lambda sc, plain: (
            megakernel.render_megakernel_plain if plain
            else megakernel.render_megakernel)(sc, cam, cfg, 4),
        "megakernel_guided_ext": lambda sc, plain: (
            megakernel.render_megakernel_guided_plain if plain
            else megakernel.render_megakernel_guided)(
                sc, cam, cfg_t, 4, guide, GUIDE_BETA, GUIDE_K),
    }
    floor = Quads(*(torch.tensor(v, dtype=torch.float32, device="cuda")
                    for v in ([[1.0, 0.0, 0.0]], [[98.0, 0.0, 0.0]],
                              [[0.0, 0.0, 170.0]], [TIE_TINT],
                              [[0.0, 0.0, 0.0]])),
                  refl=torch.zeros(1, dtype=torch.int64, device="cuda"),
                  gloss=torch.zeros(1, device="cuda"))
    scenes = {
        "as built": tl,
        "light copy after": insert_quad(tl, 1, 0, emission=TIE_TINT),
        "dark light copy before": insert_quad(tl, 0, 0,
                                              emission=(0.0, 0.0, 0.0)),
        "floor quad after": tl._replace(quads=Quads(*(
            torch.cat([a, b]) for a, b in zip(tl.quads, floor)))),
    }
    for name, render in renders.items():
        out = {}
        for label, sc in scenes.items():
            before = megakernel.LAUNCHES[name]
            img, tr = render(sc, False)
            p_img, p_tr = render(sc, True)
            if megakernel.LAUNCHES[name] != before + 1:
                raise AssertionError(f"quad ties: {name} did not launch once "
                                     f"on {label}")
            if not (torch.equal(img, p_img) and torch.equal(tr, p_tr)):
                raise AssertionError(f"quad ties: {name} on {label} differs "
                                     "from its plain version")
            out[label] = (img, tr)
        dark_img, dark_tr = out["dark light copy before"]
        checks = {
            "a later copy of the light changes nothing": (
                torch.equal(out["light copy after"][0], out["as built"][0])
                and torch.equal(out["light copy after"][1],
                                out["as built"][1])),
            "a dark copy before the light blocks every probe": (
                not bool(dark_img.any()) and int(dark_tr[0]) > 0),
        }
        log(f"[smoke] quad ties {name}: every scene == plain version; "
            + "; ".join(f"{k}: {'ok' if v else 'FAILED'}"
                        for k, v in checks.items())
            + f"; traces as built {out['as built'][1].tolist()}, floor quad "
            f"{out['floor quad after'][1].tolist()}")
        if not all(checks.values()):
            raise AssertionError(f"quad ties: {name} breaks a tie rule")


# The sharded rows (6, 7, 10 and 12): the mesh of the per-shard phases and
# of the main path, and the main path's 4 ranks on the one card. NCCL
# refuses two ranks on one device, so those ranks use gloo, which stages the
# CUDA tensors of each collective through host memory.
SHARD_MESH = (2, 2)
MESH_RANKS = 4
MESH_BACKEND = "gloo"
MESH_TIMEOUT = 300.0
FIT_MESH_STEPS = 2
# The sharded against the unsharded run (tests/test_distributed.py's bar):
# images within the sum order, traces exactly; the train steps' loss within
# 1e-5 and gradients within 1e-5 absolute (__graft_entry__.py:151-183).
SHARD_RTOL, SHARD_ATOL, STEP_TOL = 2e-5, 2e-6, 1e-5


def mesh_rank(paths: list, mat_step: bool) -> dict:
    """One rank of the main path over the 2x2 mesh (run by
    ``launcher.spawn``): each ``cli`` argv of ``paths`` [(label, argv)],
    ``launcher.distributed_render`` of ``cornell_box`` at 1024x768x512
    (the multi-rank entry point of the library), then, with ``mat_step``,
    one ``material_train_step_sharded`` step at 1024x768x512 of each of
    MESH_MAT_STEPS (the entry point a user calls: the JAX package has no
    CLI path for it) and one ``geom_train_step_sharded`` step of each of
    MESH_GEOM_STEPS (cli fit's self-test scene and target). The launch
    counts are set to 0 just before each path and read just after. Returns
    {label: {rc, launches, stdout, stderr, seconds}} with host values
    only."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.cli import main as cli_main
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
    from small_pathtracer_tpu_torch.parallel import launcher
    from small_pathtracer_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for label, argv in paths:
        out_io, err_io = io.StringIO(), io.StringIO()
        megakernel.LAUNCHES.clear()
        t0 = time.perf_counter()
        with (contextlib.redirect_stdout(out_io),
              contextlib.redirect_stderr(err_io)):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        out[label] = {"rc": rc, "launches": dict(megakernel.LAUNCHES),
                      "stdout": out_io.getvalue(),
                      "stderr": err_io.getvalue(),
                      "seconds": time.perf_counter() - t0}
    sc = get_scene("cornell_box")
    cam = make_camera(aspect=1024 / 768)
    cfg = RenderConfig(width=1024, height=768, spp=512, seed=0)
    megakernel.LAUNCHES.clear()
    t0 = time.perf_counter()
    img, traces = launcher.distributed_render(
        sc, cam, cfg, backend=MESH_BACKEND, device="cuda",
        mesh_shape=SHARD_MESH)
    torch.cuda.synchronize()
    out["distributed_render"] = {
        "rc": 0, "launches": dict(megakernel.LAUNCHES), "traces": traces,
        "u8": film.tonemap_u8(img).cpu().numpy(),
        "seconds": time.perf_counter() - t0}
    if mat_step:
        mesh = make_mesh(SHARD_MESH)
        for label, nm, fields in MESH_MAT_STEPS:
            sc_ = get_scene(nm)
            cfg_ = RenderConfig(width=1024, height=768, spp=512, seed=0,
                                **fields)
            target = _mat_target(sc_, cam, cfg_)
            step = mg.material_train_step_sharded(sc_, cam, cfg_, mesh,
                                                  target)
            alb, emi = mg.pack_materials(sc_)
            megakernel.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, galb, gemi = step(alb, emi, 0)
            torch.cuda.synchronize()
            out[label] = {"rc": 0, "launches": dict(megakernel.LAUNCHES),
                          "loss": float(loss), "galb": galb.cpu().numpy(),
                          "gemi": gemi.cpu().numpy(),
                          "seconds": time.perf_counter() - t0}
        from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
        for label, nm, fields, (w, h, spp) in MESH_GEOM_STEPS:
            sc_ = get_scene(nm)
            cam_ = make_camera(aspect=w / h)
            cfg_ = RenderConfig(width=w, height=h, spp=spp, seed=0, **fields)
            target = mgeo.geom_run(sc_, cam_, cfg_, 1)[0] / cfg_.spp
            moved = displaced(sc_)
            step = mgeo.geom_train_step_sharded(moved, cam_, cfg_, mesh,
                                                target)
            tables = mgeo.pack_tables(moved)
            megakernel.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, *grads = step(*tables, 0)
            torch.cuda.synchronize()
            out[label] = {"rc": 0, "launches": dict(megakernel.LAUNCHES),
                          "loss": float(loss),
                          "grads": [t.cpu().numpy() for t in grads],
                          "seconds": time.perf_counter() - t0}
    return out


def _mat_target(sc, cam, cfg):
    """cli fit's self-test target: the scene with its rects' emission x1.5
    at seed 1."""
    from small_pathtracer_tpu_torch.ops import megakernel

    bright = sc._replace(rects=sc.rects._replace(
        emission=sc.rects.emission * 1.5))
    return megakernel.render_megakernel(bright, cam, cfg, 1)[0] / cfg.spp


def shard_phases(card: str, cli_main, guide_alcove, mat_shard: dict,
                 geom_shard: dict) -> list:
    """Rows 7, 6, 10 and 12 on a shard's lanes: each coordinate of a 2x2
    mesh (``Mesh.single``, one process) at 1024x768x4 against its plain
    version (forward launches bit for bit, adjoint partials to rows 9 and
    11's contracts), the shards' sums against the unsharded kernels; ``cli
    render --mesh 1x1`` in one NCCL process against ``cli render`` byte for
    byte; and the main path as 4 gloo ranks on the card: ``cli render
    --mesh 2x2`` (``cornell_box``, ``sphere_grid``, ``--guided`` alcove),
    ``distributed_render`` of ``cornell_box``, one
    ``material_train_step_sharded`` step and ``cli fit --train
    center,radius --mesh 2x2`` (2 steps), all at 1024x768x512, and one
    ``material_train_step_sharded`` step of each material fit's main path
    (MESH_MAT_STEPS after the first) and a ``geom_train_step_sharded``
    step of each of MESH_GEOM_STEPS over the mesh. Returns the ``kernels``
    entries of the four rows; ``mat_shard`` holds row 10's per-shard
    numbers for those main paths' kernels (``mat_phases``), ``geom_shard``
    row 12's for MESH_GEOM_STEPS' (``geom_est_phases``)."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.ops import _build, megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
    from small_pathtracer_tpu_torch.parallel import launcher
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    width, height = 1024, 768
    n_pix = width * height
    cam = make_camera(aspect=width / height)
    coords = [(i, j) for i in range(SHARD_MESH[0])
              for j in range(SHARD_MESH[1])]
    n_loc = n_pix // SHARD_MESH[0]
    coll_bytes = n_pix * 3 * 4  # the image all-reduce of a span
    launched = megakernel.LAUNCHES

    def lanes(cfg):
        """The lanes of all the coordinates' launches."""
        return sum(lay.n_pix_loc * lay.g for lay in (
            megakernel.shard_of(cfg, Mesh.single(SHARD_MESH, c))
            for c in coords))

    def assemble(parts):
        rows = []
        for i in range(SHARD_MESH[0]):
            acc = parts[(i, 0)]
            for j in range(1, SHARD_MESH[1]):
                acc = acc + parts[(i, j)]
            rows.append(acc)
        return torch.cat(rows)

    def per_shard(label, name, kernel_fn, plain_fn, exact=True):
        """Each coordinate's launch against its plain version, in turns
        (plain, kernel, kernel, plain): bit for bit when ``exact``; the
        kernel runs of a coordinate bit-identical. Returns ({coord: kernel
        output}, largest |kernel - plain|, summed medians (kernel s, plain
        s))."""
        ks, err, k_sum, p_sum = {}, 0.0, 0.0, 0.0
        for c in coords:
            m = Mesh.single(SHARD_MESH, c)
            before = launched[name]
            outs, med = in_turns({"kernel": lambda: kernel_fn(m),
                                  "plain": lambda: plain_fn(m)},
                                 ("plain", "kernel", "kernel", "plain"))
            if launched[name] != before + 2:
                raise AssertionError(f"{label} {c}: {name} did not count 2 "
                                     "launches")
            k1, k2 = outs["kernel"]
            if not all(torch.equal(a, b) for a, b in zip(k1, k2)):
                raise AssertionError(f"{label} {c}: kernel runs differ")
            if exact and not all(torch.equal(a, b)
                                 for a, b in zip(k1, outs["plain"][0])):
                raise AssertionError(f"{label} {c}: kernel and plain "
                                     "version differ")
            ks[c] = k1
            err = max([err] + [float((a.double() - b.double()).abs().max())
                               for a, b in zip(k1, outs["plain"][0])])
            k_sum += med["kernel"]
            p_sum += med["plain"]
        log(f"[smoke] {label} per shard {width}x{height}x4, mesh "
            f"{SHARD_MESH}, coords {coords}: {name} == plain"
            f"{' bit for bit' if exact else ''} on every coordinate; "
            f"kernel {k_sum * 1e3:.3f} ms, plain {p_sum * 1e3:.3f} ms "
            f"(sums of the coordinates' medians)")
        return ks, err, (k_sum, p_sum)

    def check_sum(label, img, tr, want_img, want_tr):
        err = float((img.reshape(want_img.shape) - want_img).abs().max())
        ok = torch.allclose(img.reshape(want_img.shape), want_img,
                            rtol=SHARD_RTOL, atol=SHARD_ATOL)
        log(f"[smoke] {label} shard sum: traces {tr.tolist()} (unsharded "
            f"{want_tr.tolist()}), max |image - unsharded| {err:.3e}")
        if not (ok and torch.equal(tr, want_tr)):
            raise AssertionError(f"{label}: the shards' sum differs from the "
                                 "unsharded kernel")
        return err

    entries, res = {}, {}
    # Row 7 on cornell_box (megakernel_nee) and sphere_grid (_tab).
    for scene_name, name in (("cornell_box", "megakernel_nee"),
                             ("sphere_grid", "megakernel_nee_tab")):
        phase(f"row 7 per shard on {scene_name} {width}x{height}x4, mesh "
              f"{SHARD_MESH}")
        sc = get_scene(scene_name)
        cfg = RenderConfig(width=width, height=height, spp=4, seed=3)
        ks, err, (k_s, p_s) = per_shard(
            f"row 7 {scene_name}", name,
            lambda m: megakernel.render_megakernel_sharded(sc, cam, cfg, m, 3),
            lambda m: megakernel.render_megakernel_sharded_plain(
                sc, cam, cfg, m, 3))
        tr = sum(v[1] for v in ks.values())
        want, want_tr = megakernel.render_megakernel(sc, cam, cfg, 3)
        check_sum(f"row 7 {scene_name}", assemble(
            {c: v[0] for c, v in ks.items()}), tr, want, want_tr)
        b = forward_bound(tr.tolist(), n_pix * 4, lanes(cfg),
                          sc.rects.k.shape[0], sc.spheres.radius.shape[0],
                          coll_bytes)
        res[name] = {"err": err, "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
                     "bound": b}

    phase(f"row 6 per shard on cornell_alcove_baffled nee_textbook "
          f"{width}x{height}x4, mesh {SHARD_MESH}")
    alcove = get_scene("cornell_alcove_baffled")
    cfg = RenderConfig(width=width, height=height, spp=4, seed=12,
                       estimator="nee_textbook")
    ks, err, (k_s, p_s) = per_shard(
        "row 6", "megakernel_guided",
        lambda m: megakernel.render_megakernel_guided_sharded(
            alcove, cam, cfg, m, 12, guide_alcove, GUIDE_BETA, GUIDE_K),
        lambda m: megakernel.render_megakernel_guided_sharded_plain(
            alcove, cam, cfg, m, 12, guide_alcove, GUIDE_BETA, GUIDE_K))
    tr = sum(v[1] for v in ks.values())
    want, want_tr = megakernel.render_megakernel_guided(
        alcove, cam, cfg, 12, guide_alcove, GUIDE_BETA, GUIDE_K)
    check_sum("row 6", assemble({c: v[0] for c, v in ks.items()}), tr,
              want, want_tr)
    b = forward_bound(tr.tolist(), n_pix * 4, lanes(cfg),
                      alcove.rects.k.shape[0], 0, 1620 * 4 + coll_bytes,
                      "nee_textbook")
    res["megakernel_guided"] = {"err": err, "ms": k_s * 1e3,
                                "plain_ms": p_s * 1e3, "bound": b}

    # Rows 10 and 12: each shard's forward and adjoint partials, then a
    # train step's collectives done by hand over the shards against the
    # unsharded step (a seeded target, so the gradients are a loss's).
    rng = np.random.default_rng(21)
    target = torch.from_numpy(rng.uniform(0.0, 0.6, (height, width, 3))
                              .astype(np.float32)).to("cuda")

    def step_by_hand(forward, adjoint, cfg):
        fw = {c: forward(Mesh.single(SHARD_MESH, c)) for c in coords}
        img = assemble(fw)
        diff = img / torch.tensor(float(cfg.spp), device="cuda") \
            - target.reshape(n_pix, 3)
        loss = float(torch.sum(diff.double() ** 2)) / (n_pix * 3)
        g = diff * torch.tensor(2.0 / (n_pix * 3 * cfg.spp), device="cuda")
        grads = None
        for c in coords:
            part = adjoint(Mesh.single(SHARD_MESH, c),
                           g[c[0] * n_loc:(c[0] + 1) * n_loc])
            grads = list(part) if grads is None else [
                a + b_ for a, b_ in zip(grads, part)]
        return loss, g, grads

    phase(f"row 10 per shard on cornell_box {width}x{height}x4: forward and "
          "adjoint partials, and a train step by hand")
    box = get_scene("cornell_box")
    cfg = RenderConfig(width=width, height=height, spp=4, seed=3)
    alb, emi = mg.pack_materials(box)
    ks, err, (k_s, p_s) = per_shard(
        "row 10 forward", "megakernel_nee_mat",
        lambda m: mg.render_megakernel_mat_shard(box, cam, cfg, m, alb, emi,
                                                 3),
        lambda m: mg.render_megakernel_mat_shard_plain(box, cam, cfg, m, alb,
                                                       emi, 3))
    tr10 = sum(v[1] for v in ks.values())
    loss, g, grads = step_by_hand(
        lambda m: mg.render_megakernel_mat_shard(box, cam, cfg, m, alb, emi,
                                                 3)[0],
        lambda m, g_: mg.render_megakernel_vjp_shard(box, cam, cfg, m, alb,
                                                     emi, 3, g_), cfg)
    worst = vjp_err = 0.0
    vk_s = vp_s = 0.0
    for c in coords:
        m = Mesh.single(SHARD_MESH, c)
        g_c = g[c[0] * n_loc:(c[0] + 1) * n_loc]
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_vjp_shard(
                box, cam, cfg, m, alb, emi, 3, g_c),
             "plain": lambda: mg.render_megakernel_vjp_shard_plain(
                 box, cam, cfg, m, alb, emi, 3, g_c)},
            ("plain", "kernel", "kernel", "plain"))
        vk_s += med["kernel"]
        vp_s += med["plain"]
        for kt, pt in zip(outs["kernel"][0], outs["plain"][0]):
            scale = float(pt.abs().max())
            e = float((kt - pt).abs().max())
            worst = max(worst, e / scale)
            vjp_err = max(vjp_err, e)
            if not e <= VJP_TOL * scale:
                raise AssertionError(f"row 10 adjoint partial {c}: {e} > "
                                     f"{VJP_TOL} x {scale}")
        if not all(torch.equal(a, b_) for a, b_ in zip(*outs["kernel"])):
            raise AssertionError(f"row 10 adjoint partial {c}: runs differ")
    w_loss, w_alb, w_emi = mg.loss_and_material_grads(box, cam, cfg, 3,
                                                      target)
    d_loss = abs(loss - float(w_loss))
    d_g = max(float((grads[0] - w_alb).abs().max()),
              float((grads[1] - w_emi).abs().max()))
    log(f"[smoke] row 10 adjoint partials: within {worst:.3e} of each "
        f"table's largest entry of autograd (limit {VJP_TOL:g}), kernel "
        f"{vk_s * 1e3:.3f} ms, plain {vp_s * 1e3:.3f} ms; step by hand: "
        f"loss {loss:.9f} vs unsharded {float(w_loss):.9f} (|d| {d_loss:.3e})"
        f", gradients |d| {d_g:.3e} (limits {STEP_TOL:g})")
    if not (d_loss <= STEP_TOL and d_g <= STEP_TOL):
        raise AssertionError("row 10: the shards' step differs from the "
                             "unsharded step")
    k_box = box.rects.k.shape[0]
    res["megakernel_nee_mat"] = {
        "err": err, "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
        "bound": forward_bound(tr10.tolist(), n_pix * 4, lanes(cfg), k_box,
                               0, coll_bytes)}
    vb = vjp_bound(tr10.tolist(), n_pix * 4, n_pix, k_box)
    res["megakernel_vjp"] = {
        "err": vjp_err, "ms": vk_s * 1e3, "plain_ms": vp_s * 1e3,
        "bound": (vb[0] + 2 * k_box * 12 / BYTES_PER_S * 1e3, vb[1])}

    phase(f"row 12 per shard on cornell_spheres {width}x{height}x4: image "
          "and adjoint partials, and a train step by hand")
    sph_sc = get_scene("cornell_spheres")
    cfg = RenderConfig(width=width, height=height, spp=4, seed=3)
    ks, err, (k_s, p_s) = per_shard(
        "row 12 image", "megakernel_geom",
        lambda m: mgeo.geom_run_shard(sph_sc, cam, cfg, m, 3)[0:1],
        lambda m: mgeo.geom_run_shard_plain(sph_sc, cam, cfg, m, 3)[0:1])
    loss, g, grads = step_by_hand(
        lambda m: mgeo.geom_run_shard(sph_sc, cam, cfg, m, 3)[0],
        lambda m, g_: mgeo.geom_run_shard(sph_sc, cam, cfg, m, 3, g_)[1:4],
        cfg)
    worst, gk_s, gp_s, counts = 0.0, 0.0, 0.0, None
    tol_mat, tol_sph = GEOM_TOL["cornell_spheres"]
    for c in coords:
        m = Mesh.single(SHARD_MESH, c)
        g_c = g[c[0] * n_loc:(c[0] + 1) * n_loc]
        out_k, sec_k = timed(lambda: mgeo.geom_run_shard(sph_sc, cam, cfg, m,
                                                          3, g_c))
        out_p, sec_p = timed(lambda: mgeo.geom_run_shard_plain(
            sph_sc, cam, cfg, m, 3, g_c))
        gk_s += sec_k
        gp_s += sec_p
        counts = out_k[4] if counts is None else counts + out_k[4]
        for kt, pt, tol in zip(out_k[1:4], out_p[1:4],
                               (tol_sph, tol_mat, tol_mat)):
            ratio, row, _ = worst_row(kt, pt)
            worst = max(worst, ratio)
            err = max(err, float((kt - pt).abs().max()))
            if not ratio <= tol:
                raise AssertionError(f"row 12 adjoint partial {c}: row {row} "
                                     f"off by {ratio:.3e} > {tol}")
    w_loss, w_sph, w_alb, w_emi = mgeo.loss_and_geom_grads(sph_sc, cam, cfg,
                                                           3, target)
    d_loss = abs(loss - float(w_loss))
    d_g = max(float((a - b_).abs().max())
              for a, b_ in zip(grads, (w_sph, w_alb, w_emi)))
    log(f"[smoke] row 12 adjoint partials: worst row {worst:.3e} of its own "
        f"largest entry of autograd (limits {GEOM_TOL['cornell_spheres']}), "
        f"kernel {gk_s * 1e3:.3f} ms, plain {gp_s * 1e3:.3f} ms; counts "
        f"{counts.tolist()}; step by hand: loss {loss:.9f} vs unsharded "
        f"{float(w_loss):.9f} (|d| {d_loss:.3e}), gradients |d| {d_g:.3e} "
        f"(limits {STEP_TOL:g})")
    if not (d_loss <= STEP_TOL and d_g <= STEP_TOL):
        raise AssertionError("row 12: the shards' step differs from the "
                             "unsharded step")
    gb = geom_bound(counts.tolist(), n_pix * 4, n_pix,
                    sph_sc.rects.k.shape[0], sph_sc.spheres.radius.shape[0],
                    -(-lanes(cfg) // mgeo.KERNEL_BLOCK))
    res["megakernel_geom"] = {
        "err": err, "ms": gk_s * 1e3, "plain_ms": gp_s * 1e3,
        "bound": (gb[0] + coll_bytes / BYTES_PER_S * 1e3, gb[1])}

    phase("the shard kernels at 1024x768x512, CUDA events around the four "
          "coordinates' launches")
    cfg512 = RenderConfig(width=width, height=height, spp=512, seed=0)
    cfg512_tb = RenderConfig(width=width, height=height, spp=512, seed=0,
                             estimator="nee_textbook")
    meshes = [Mesh.single(SHARD_MESH, c) for c in coords]
    g512 = torch.full((n_loc, 3), 1e-7, device="cuda")

    def mesh_ms(fn, n=2):
        """ms of the four coordinates' launches, and their summed traces
        or counts."""
        counts = sum(fn(m)[-1] for m in meshes)
        return event_ms(lambda: [fn(m) for m in meshes], n), counts.tolist()

    x512 = {
        "megakernel_nee": mesh_ms(lambda m: megakernel.render_megakernel_sharded(
            box, cam, cfg512, m, 0)),
        "megakernel_nee_tab": mesh_ms(
            lambda m: megakernel.render_megakernel_sharded(
                get_scene("sphere_grid"), cam, cfg512, m, 0)),
        "megakernel_guided": mesh_ms(
            lambda m: megakernel.render_megakernel_guided_sharded(
                alcove, cam, cfg512_tb, m, 0, guide_alcove, GUIDE_BETA,
                GUIDE_K)),
        "megakernel_nee_mat": mesh_ms(lambda m: mg.render_megakernel_mat_shard(
            box, cam, cfg512, m, alb, emi, 0)),
        "megakernel_vjp": (event_ms(lambda: [mg.render_megakernel_vjp_shard(
            box, cam, cfg512, m, alb, emi, 0, g512) for m in meshes], 2),
            None),
        "megakernel_geom": mesh_ms(lambda m: mgeo.geom_run_shard(
            sph_sc, cam, cfg512, m, 0, g512), 1),
    }
    geom_img_ms = event_ms(lambda: [mgeo.geom_run_shard(
        sph_sc, cam, cfg512, m, 0) for m in meshes], 2)
    tr_box512 = x512["megakernel_nee_mat"][1]
    b512 = {
        "megakernel_nee": forward_bound(x512["megakernel_nee"][1],
                                        n_pix * 512, lanes(cfg512), k_box, 0,
                                        coll_bytes),
        "megakernel_nee_tab": forward_bound(
            x512["megakernel_nee_tab"][1], n_pix * 512, lanes(cfg512),
            get_scene("sphere_grid").rects.k.shape[0],
            get_scene("sphere_grid").spheres.radius.shape[0], coll_bytes),
        "megakernel_guided": forward_bound(
            x512["megakernel_guided"][1], n_pix * 512, lanes(cfg512),
            alcove.rects.k.shape[0], 0, 1620 * 4 + coll_bytes,
            "nee_textbook"),
        "megakernel_nee_mat": forward_bound(tr_box512, n_pix * 512,
                                            lanes(cfg512), k_box, 0,
                                            coll_bytes),
        "megakernel_vjp": vjp_bound(tr_box512, n_pix * 512, n_pix, k_box),
        "megakernel_geom": geom_bound(
            x512["megakernel_geom"][1], n_pix * 512, n_pix,
            sph_sc.rects.k.shape[0], sph_sc.spheres.radius.shape[0],
            -(-lanes(cfg512) // mgeo.KERNEL_BLOCK)),
    }
    for name, (ms, counts) in x512.items():
        res[name]["ms512"] = ms
        log(f"[smoke] {name} on the 2x2 shards 1024x768x512 seed 0: "
            f"{ms:.3f} ms for the four launches (CUDA events), counts "
            f"{counts if counts is not None else tr_box512}; bound "
            f"{b512[name][0]:.3f} ms ({b512[name][1]})")
    log(f"[smoke] megakernel_geom image-only on the 2x2 shards 1024x768x512: "
        f"{geom_img_ms:.3f} ms for the four launches")

    base = ["--width", str(width), "--height", str(height), "--spp", "512"]
    with tempfile.TemporaryDirectory() as tmp:
        phase("cli render --mesh 1x1 1024x768x512 in one NCCL process "
              "against cli render")
        a, b_ = os.path.join(tmp, "plain.ppm"), os.path.join(tmp, "m11.ppm")
        launched.clear()
        text_a = cli_stderr(cli_main, ["render", *base, "-o", a])
        n_plain = launched["megakernel_nee"]
        launched.clear()
        text_b = cli_stderr(cli_main, ["render", *base, "--mesh", "1x1",
                                       "--dist-backend", "nccl", "-o", b_])
        n_mesh = launched["megakernel_nee"]
        same = Path(a).read_bytes() == Path(b_).read_bytes()
        tr_a, tr_b = cli_traces(text_a)[0], cli_traces(text_b)[0]
        log(f"[smoke] cli render --mesh 1x1 (nccl): {n_mesh} shard launch of "
            f"megakernel_nee, traces {tr_b} (cli render: {n_plain} launch, "
            f"{tr_a}); output bytes equal: {same}")
        if not (same and n_plain == 1 and n_mesh == 1 and tr_a == tr_b):
            raise AssertionError("cli render --mesh 1x1 differs from cli "
                                 "render")
        ref_img = film.read_ppm(a)

        phase("unsharded references at 1024x768x512: cli render sphere_grid, "
              "--guided alcove, cli fit --train center,radius (2 steps), the "
              "material step")
        sg_ppm = os.path.join(tmp, "sg.ppm")
        tr_sg = cli_traces(cli_stderr(cli_main, [
            "render", *base, "--scene", "sphere_grid", "-o", sg_ppm]))[0]
        gd_ppm = os.path.join(tmp, "gd.ppm")
        alc = ["--scene", "cornell_alcove_baffled", "--estimator",
               "nee_textbook", "--guided"]
        text_g = cli_stderr(cli_main, ["render", *base, *alc, "-o", gd_ppm])
        tr_gd, sec_gd = cli_traces(text_g)
        fit_argv = ["fit", *base, "--scene", "cornell_spheres", "--steps",
                    str(FIT_MESH_STEPS), "--train", "center,radius"]
        out_io, err_io = io.StringIO(), io.StringIO()
        with (contextlib.redirect_stdout(out_io),
              contextlib.redirect_stderr(err_io)):
            if cli_main(fit_argv) != 0:
                raise AssertionError("cli fit returned non-zero")
        fit_losses = [float(x) for x in re.findall(
            r"step \d+: loss (\S+)", err_io.getvalue())]
        w_loss, w_alb, w_emi = mg.loss_and_material_grads(
            box, cam, cfg512, 0, _mat_target(box, cam, cfg512))

        phase(f"main path over a {SHARD_MESH[0]}x{SHARD_MESH[1]} mesh: "
              f"{MESH_RANKS} {MESH_BACKEND} ranks on the card, cli render "
              "(cornell_box, sphere_grid, --guided alcove), distributed_render"
              " (cornell_box), the material "
              f"step, cli fit --train center,radius ({FIT_MESH_STEPS} steps)"
              ", all 1024x768x512")
        mesh_arg = ["--mesh", f"{SHARD_MESH[0]}x{SHARD_MESH[1]}",
                    "--dist-backend", MESH_BACKEND]
        paths = [
            ("box", ["render", *base, *mesh_arg,
                     "-o", os.path.join(tmp, "mbox.ppm")]),
            ("sphere_grid", ["render", *base, "--scene", "sphere_grid",
                             *mesh_arg, "-o", os.path.join(tmp, "msg.ppm")]),
            ("guided", ["render", *base, *alc, *mesh_arg,
                        "-o", os.path.join(tmp, "mgd.ppm")]),
            ("fit", [*fit_argv, *mesh_arg]),
        ]
        t0 = time.perf_counter()
        ranks = launcher.spawn(mesh_rank, MESH_RANKS, MESH_BACKEND, "cuda",
                               MESH_TIMEOUT, args=(paths, True))
        spawn_s = time.perf_counter() - t0
        r0 = ranks[0]
        for r in ranks:
            for label, v in r.items():
                if v["rc"] != 0:
                    raise AssertionError(f"mesh path {label} returned "
                                         f"{v['rc']}")
        launches = {}
        for label in ("box", "sphere_grid", "guided", "fit",
                      "distributed_render",
                      *(step[0] for step in MESH_MAT_STEPS),
                      *(step[0] for step in MESH_GEOM_STEPS)):
            tot = {}
            for r in ranks:
                for k, n in r[label]["launches"].items():
                    tot[k] = tot.get(k, 0) + n
            launches[label] = tot
            log(f"[smoke] mesh {label}: launches over the ranks {tot}, "
                f"rank seconds {[round(r[label]['seconds'], 3) for r in ranks]}")
        for line in (r0["box"]["stderr"] + r0["guided"]["stderr"]
                     + r0["fit"]["stderr"]).strip().splitlines():
            log("[smoke] mesh rank 0: " + line)
        need = {"box": ("megakernel_nee", MESH_RANKS),
                "sphere_grid": ("megakernel_nee_tab", MESH_RANKS),
                "guided": ("megakernel_guided", MESH_RANKS),
                "distributed_render": ("megakernel_nee", MESH_RANKS),
                "row10": ("megakernel_nee_mat", MESH_RANKS),
                # Each rank's cli fit renders its target in one image-only
                # launch, then takes 2 shard launches a step.
                "fit": ("megakernel_geom",
                        (1 + 2 * FIT_MESH_STEPS) * MESH_RANKS)}
        for label, (name, n) in need.items():
            if launches[label].get(name, 0) != n:
                raise AssertionError(f"mesh {label}: {name} launched "
                                     f"{launches[label].get(name, 0)} times, "
                                     f"not {n}")
        if launches["row10"].get("megakernel_vjp", 0) != MESH_RANKS:
            raise AssertionError("the material step did not launch "
                                 "megakernel_vjp on every rank")
        tr_box, sec_box = cli_traces(r0["box"]["stderr"])
        m_img = film.read_ppm(os.path.join(tmp, "mbox.ppm"))
        eq = float(np.mean(m_img == ref_img))
        gap = int(np.abs(m_img.astype(int) - ref_img.astype(int)).max())
        tr_msg = cli_traces(r0["sphere_grid"]["stderr"])[0]
        tr_mgd, sec_mgd = cli_traces(r0["guided"]["stderr"])
        m_losses = [float(x) for x in re.findall(
            r"step \d+: loss (\S+)", r0["fit"]["stderr"])]
        sec_1 = cli_traces(text_a)[1]
        log(f"[smoke] main path mesh 2x2 ({MESH_BACKEND}, {MESH_RANKS} ranks "
            f"on one card, {spawn_s:.3f} s with start-up): cli render box "
            f"{sec_box:.3f} s wall, traces {tr_box} (one rank: {sec_1:.3f} s,"
            f" {tr_a}); {eq:.4%} of bytes equal, largest gap {gap} levels; "
            f"sphere_grid traces {tr_msg} (one rank {tr_sg}); guided "
            f"{sec_mgd:.3f} s, traces {tr_mgd} (one rank {sec_gd:.3f} s, "
            f"{tr_gd}); fit losses {m_losses} (one rank {fit_losses}); "
            f"material step loss {r0['row10']['loss']:.9f} (unsharded "
            f"{float(w_loss):.9f}) in {r0['row10']['seconds']:.3f} s on "
            f"{card}")
        if not (tr_box == tr_a and tr_msg == tr_sg and tr_mgd == tr_gd
                and eq >= 0.999 and gap <= 1):
            raise AssertionError("the mesh renders differ from the unsharded "
                                 "ones")
        dr = r0["distributed_render"]
        dr_eq = float(np.mean(dr["u8"] == ref_img))
        dr_gap = int(np.abs(dr["u8"].astype(int) - ref_img.astype(int)).max())
        log(f"[smoke] distributed_render box 2x2 ({MESH_BACKEND}): "
            f"{dr['seconds']:.3f} s on rank 0, traces "
            f"{[r['distributed_render']['traces'] for r in ranks]} (one "
            f"rank: {tr_a}); {dr_eq:.4%} of bytes equal to cli render's, "
            f"largest gap {dr_gap} levels; bytes equal to cli render --mesh "
            f"2x2: {bool(np.array_equal(dr['u8'], m_img))}")
        if not (all(r["distributed_render"]["traces"] == tr_a for r in ranks)
                and dr_eq >= 0.999 and dr_gap <= 1):
            raise AssertionError("distributed_render differs from the "
                                 "unsharded render")
        if not (len(m_losses) == FIT_MESH_STEPS
                and m_losses[-1] < m_losses[0]
                and all(abs(x - y) <= STEP_TOL
                        for x, y in zip(m_losses, fit_losses))):
            raise AssertionError(f"the mesh fit's losses {m_losses} did not "
                                 f"fall or differ from {fit_losses}")
        d_g = max(float(np.abs(r0["row10"]["galb"]
                               - w_alb.cpu().numpy()).max()),
                  float(np.abs(r0["row10"]["gemi"]
                               - w_emi.cpu().numpy()).max()))
        if not (abs(r0["row10"]["loss"] - float(w_loss)) <= STEP_TOL
                and d_g <= STEP_TOL):
            raise AssertionError(f"the material step over the mesh differs "
                                 f"from the unsharded one (gradients {d_g})")
        for r in ranks[1:]:
            if r["row10"]["loss"] != r0["row10"]["loss"]:
                raise AssertionError("the ranks' losses differ")
        if _build.build_kernels().build_seconds != 0.0:
            raise AssertionError("a rank rebuilt the library")
        # Each material fit's main path as one step over the mesh.
        step_launch = {}
        for label, nm, fields in MESH_MAT_STEPS[1:]:
            m_sc = get_scene(nm)
            m_cfg = RenderConfig(width=width, height=height, spp=512, seed=0,
                                 **fields)
            m_loss, m_alb, m_emi = mg.loss_and_material_grads(
                m_sc, cam, m_cfg, 0, _mat_target(m_sc, cam, m_cfg))
            rt = r0[label]
            m_dg = max(float(np.abs(rt[k] - w.cpu().numpy()).max())
                       / max(1.0, float(w.abs().max()))
                       for k, w in (("galb", m_alb), ("gemi", m_emi)))
            names = (mg.mat_kernel_name(m_sc, m_cfg),
                     mg.vjp_kernel_name(m_sc, m_cfg))
            got = {n: launches[label].get(n, 0) for n in names}
            step_launch.update(got)
            log(f"[smoke] mesh {label} ({nm} {m_cfg.estimator}): loss "
                f"{rt['loss']:.9f} (unsharded {float(m_loss):.9f}), "
                f"gradients within {m_dg:.3e} of max(1, the largest entry) "
                f"(limit {STEP_TOL:g}); launches over the ranks {got}")
            if not (abs(rt["loss"] - float(m_loss)) <= STEP_TOL
                    * max(1.0, abs(float(m_loss))) and m_dg <= STEP_TOL):
                raise AssertionError(f"the material step {label} over the "
                                     "mesh differs from the unsharded one")
            if any(r[label]["loss"] != rt["loss"] for r in ranks[1:]):
                raise AssertionError(f"the ranks' losses differ ({label})")
            if any(n != MESH_RANKS for n in got.values()):
                raise AssertionError(f"the sharded step {label} launched "
                                     f"{got}")
        # Row 12 with mis: the 4-rank step against the one-rank one.
        from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
        for label, nm, fields, (w, h, spp) in MESH_GEOM_STEPS:
            g_sc = get_scene(nm)
            g_cam = make_camera(aspect=w / h)
            g_cfg = RenderConfig(width=w, height=h, spp=spp, seed=0,
                                 **fields)
            target = mgeo.geom_run(g_sc, g_cam, g_cfg, 1)[0] / g_cfg.spp
            g_loss, *g_want = mgeo.loss_and_geom_grads(
                displaced(g_sc), g_cam, g_cfg, 0, target)
            rt = r0[label]
            g_d = max(float(np.abs(a - w.cpu().numpy()).max())
                      / max(1.0, float(w.abs().max()))
                      for a, w in zip(rt["grads"], g_want))
            name = mgeo.geom_kernel_name(g_cfg)
            got = launches[label].get(name, 0)
            step_launch[name] = got
            log(f"[smoke] mesh {label} ({nm} {g_cfg.estimator} {w}x{h}x"
                f"{spp}): loss {rt['loss']:.9f} (one rank "
                f"{float(g_loss):.9f}), gradients within {g_d:.3e} of "
                f"max(1, the largest entry) (limit {STEP_TOL:g}); {got} "
                f"launches of {name} over the ranks, rank seconds "
                f"{[round(r[label]['seconds'], 3) for r in ranks]}")
            if not (abs(rt["loss"] - float(g_loss)) <= STEP_TOL
                    * max(1.0, abs(float(g_loss))) and g_d <= STEP_TOL):
                raise AssertionError(f"the geometry step {label} over the "
                                     "mesh differs from the one-rank step")
            if any(r[label]["loss"] != rt["loss"] for r in ranks[1:]):
                raise AssertionError(f"the ranks' losses differ ({label})")
            if got != 2 * MESH_RANKS or len(launches[label]) != 1:
                raise AssertionError(f"the sharded step {label} launched "
                                     f"{launches[label]}")

    main = {"megakernel_nee": launches["box"]["megakernel_nee"]
            + launches["distributed_render"]["megakernel_nee"],
            "megakernel_nee_tab": launches["sphere_grid"]["megakernel_nee_tab"],
            "megakernel_guided": launches["guided"]["megakernel_guided"],
            "megakernel_nee_mat": launches["row10"]["megakernel_nee_mat"],
            "megakernel_vjp": launches["row10"]["megakernel_vjp"],
            "megakernel_geom": launches["fit"]["megakernel_geom"]}
    replaces = {"megakernel_nee": "megakernel.py:3370",
                "megakernel_nee_tab": "megakernel.py:3370 (sphere_tab)",
                "megakernel_guided": "megakernel.py:3241",
                "megakernel_nee_mat": "megakernel_grad.py:1156",
                "megakernel_vjp": "megakernel_grad.py:1195",
                "megakernel_geom": "megakernel_geom.py:1686"}
    sources = {"megakernel_guided": "megakernel_guided.cu",
               "megakernel_vjp": "megakernel_grad.cu",
               "megakernel_geom": "megakernel_geom.cu"}
    for label, nm, fields in MESH_MAT_STEPS[1:]:
        m_sc = get_scene(nm)
        m_cfg = RenderConfig(width=8, height=8, spp=1, **fields)
        where = ("spheres, SPEC/REFR, " if megakernel.uses_sphere_table(m_sc)
                 else "estimator ")
        for name in (mg.mat_kernel_name(m_sc, m_cfg),
                     mg.vjp_kernel_name(m_sc, m_cfg)):
            main[name] = step_launch[name]
            res[name] = mat_shard[name]
            vjp = "vjp" in name
            replaces[name] = (("megakernel_grad.py:1195" if vjp
                               else "megakernel_grad.py:1156")
                              + f" ({where}{m_cfg.estimator})")
            own = megakernel.est_code(m_cfg) in (0, 1, 2)
            sources[name] = (("megakernel_grad.cu" if own
                              else "megakernel_grad_est.cu") if vjp
                             else ("megakernel.cu" if own
                                   else "megakernel_est.cu"))
    for label, nm, fields, _ in MESH_GEOM_STEPS:
        name = mgeo.geom_kernel_name(RenderConfig(width=8, height=8, spp=1,
                                                  **fields))
        main[name] = step_launch[name]
        res[name] = geom_shard[name]
        replaces[name] = ("megakernel_geom.py:1686 (estimator "
                          f"{fields['estimator']})")
        sources[name] = ("megakernel_geom_direct.cu"
                         if fields["estimator"] in mgeo.DIRECT
                         else "megakernel_geom_est.cu")
    return [(name + " (shard)", sources.get(name, "megakernel.cu"),
             replaces[name], main[name], res[name]) for name in main]



def cotangent_image(height: int, width: int, seed: int) -> torch.Tensor:
    """A seeded standard-normal (height, width, 3) cotangent on the card."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (height, width, 3)).astype(np.float32)).to("cuda")


def held_tables(label, kt, pt, light) -> float:
    """A table of the kernel within VJP_TOL of autograd's largest entry,
    and so are its rows other than the light's (nee_textbook's and mis's
    light albedo row is knife-edge 1/t^2 noise that dominates its scale).
    Returns |kernel - plain| / the largest entry."""
    ratio = 0.0
    keep = torch.arange(kt.shape[0], device=kt.device) != light
    for k_, p_ in ((kt, pt), (kt[keep], pt[keep])):
        err = float((k_ - p_).abs().max())
        scale = float(p_.abs().max())
        if not err <= VJP_TOL * scale:
            raise AssertionError(f"{label}: {err} > {VJP_TOL} x {scale}")
        ratio = max(ratio, err / scale)
    return ratio


def mat_phases(card: str, cli_main, spec: MatSpec) -> tuple[list, dict]:
    """Rows 8, 9 and 10 of one slice (``spec``): row 8's instances bit for
    bit against their plain version and the render (``spec.size8``: on
    ``cornell_box`` the rect instances, on ``smallpt_original`` the linear
    scan, on ``sphere_grid`` the tree), row 9's against autograd through
    its plain version (``spec.size9``: autograd keeps every bounce's
    temporaries) and against itself, and on 200-bounce paths through the
    tape's checkpoints; row 10's on each coordinate of a 2x2 mesh
    (``spec.shard``); the cli fit runs (``spec.fits``, the first the main path) at
    1024x768x512, launches counted; and each instance's x512 event time
    (``spec.x512_n`` launches of row 8 and of row 9, after the launch that
    reads the traces; ms and plain_ms in the entries: medians of three
    wrapper calls and one at the parity shapes). Returns (the ``kernels``
    entries, row 10's per-shard numbers for ``shard_phases``)."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    lbn = megakernel.LAUNCHES
    scenes = {n: get_scene(n) for n in ("cornell_box", "smallpt_original",
                                        "sphere_grid")}
    cam = make_camera(aspect=4 / 3)

    def sizes(sc):
        return sc.rects.k.shape[0], sc.spheres.radius.shape[0]

    def cfg_of(width, height, spp, fields, seed, **kw):
        return RenderConfig(width=width, height=height, spp=spp, seed=seed,
                            **fields, **kw)

    def f_bound(sc, tr, n_samples, n_lanes, est):
        R, S = sizes(sc)
        return forward_bound(tr, n_samples, n_lanes, R, S, 0, est,
                             not megakernel.uses_sphere_table(sc))

    def v_bound(sc, tr, n_samples, n_pix, est):
        R, S = sizes(sc)
        return vjp_bound(tr, n_samples, n_pix, R + S, False, S, est,
                         not megakernel.uses_sphere_table(sc))

    g_of, held = cotangent_image, held_tables

    par = {}  # name -> its reported parity run (linear or rect instance)
    phase(f"{spec.title}: row 8 against its plain version and the render, "
          "bit for bit, " + ", ".join(
              f"{n} {w}x{h}x4" for n, (w, h) in spec.size8.items()))
    for nm, label, fields in spec.cases:
        sc = scenes[nm]
        width, height = spec.size8[nm]
        n_pix = width * height
        cam_8 = make_camera(aspect=width / height)
        cfg = cfg_of(width, height, 4, fields, 16,
                     max_bounces=PARITY_BOUNCES)
        alb, emi = mg.pack_materials(sc)
        name = mg.mat_kernel_name(sc, cfg)
        before = lbn[name]
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_mat(sc, cam_8, cfg, alb,
                                                        emi, 16),
             "plain": lambda: mg.render_megakernel_mat_plain(
                 sc, cam_8, cfg, alb, emi, 16)},
            ("kernel", "kernel", "plain", "kernel"))
        if lbn[name] != before + 3:
            raise AssertionError(f"row 8 {nm} {label}: {name} did not count "
                                 "3 launches")
        (k_img, k_tr), (k2_img, k2_tr), _ = outs["kernel"]
        p_img, p_tr = outs["plain"][0]
        r_img, r_tr = megakernel.render_megakernel(sc, cam_8, cfg, 16)
        err = float((k_img - p_img).abs().max())
        b = f_bound(sc, k_tr.tolist(), n_pix * 4, n_pix, cfg.estimator)
        log(f"[smoke] row 8 {nm} {label} {width}x{height}x4: {name} "
            f"{med['kernel'] * 1e3:.3f} ms traces {k_tr.tolist()}; plain "
            f"{med['plain'] * 1e3:.3f} ms traces {p_tr.tolist()}; max |img "
            f"diff| {err:.3e}; == the render: "
            f"{torch.equal(k_img, r_img) and torch.equal(k_tr, r_tr)}; "
            f"bound {b[0]:.3f} ms ({b[1]})")
        if not all(torch.equal(a, b_) for a, b_ in (
                (k_img, k2_img), (k_tr, k2_tr), (k_img, p_img), (k_tr, p_tr),
                (k_img, r_img), (k_tr, r_tr))):
            raise AssertionError(f"row 8 {nm} {label}: the kernel, its plain "
                                 "version and the render differ")
        if nm != "sphere_grid":
            par[name] = {"err": err, "ms": med["kernel"] * 1e3,
                         "plain_ms": med["plain"] * 1e3, "bound": b}

    phase(f"{spec.title}: row 9 against autograd through its plain version "
          "and against itself, " + ", ".join(
              f"{n} {w}x{h}x4" for n, (w, h) in spec.size9.items()))
    for nm, label, fields in spec.cases:
        sc = scenes[nm]
        width, height = spec.size9[nm]
        n_pix = width * height
        cam_v = make_camera(aspect=width / height)
        cfg = cfg_of(width, height, 4, fields, 17,
                     max_bounces=PARITY_BOUNCES)
        alb, emi = mg.pack_materials(sc)
        g = g_of(height, width, 5)
        name = mg.vjp_kernel_name(sc, cfg)
        before = lbn[name]
        torch.cuda.reset_peak_memory_stats()
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_vjp(sc, cam_v, cfg, alb,
                                                        emi, 17, g),
             "plain": lambda: mg.render_megakernel_vjp_plain(
                 sc, cam_v, cfg, alb, emi, 17, g)},
            ("kernel", "kernel", "plain", "kernel"))
        peak = torch.cuda.max_memory_allocated()
        if lbn[name] != before + 3:
            raise AssertionError(f"row 9 {nm} {label}: {name} did not count "
                                 "3 launches")
        (ka, ke), (ka2, ke2), _ = outs["kernel"]
        if not (torch.equal(ka, ka2) and torch.equal(ke, ke2)):
            raise AssertionError(f"row 9 {nm} {label}: kernel runs differ")
        pa, pe = outs["plain"][0]
        light = int(sc.light.light_obj_id)
        r_a = held(f"row 9 {nm} {label} d/d albedo", ka, pa, light)
        r_e = held(f"row 9 {nm} {label} d/d emission", ke, pe, light)
        tr = megakernel.render_megakernel(sc, cam_v, cfg, 17)[1].tolist()
        b = v_bound(sc, tr, n_pix * 4, n_pix, cfg.estimator)
        err = max(float((ka - pa).abs().max()), float((ke - pe).abs().max()))
        log(f"[smoke] row 9 {nm} {label} {width}x{height}x4: {name} "
            f"{med['kernel'] * 1e3:.3f} ms, plain {med['plain'] * 1e3:.3f} ms"
            f" (peak memory {peak / 2**30:.2f} GiB); d/d albedo within "
            f"{r_a:.3e}, d/d emission within {r_e:.3e} of the largest entry "
            f"(limit {VJP_TOL:g}); two runs bit-identical; traces {tr}, "
            f"bound {b[0]:.3f} ms ({b[1]})")
        if nm != "sphere_grid":
            par[name] = {"err": err, "ms": med["kernel"] * 1e3,
                         "plain_ms": med["plain"] * 1e3, "bound": b}

    labels = [f["estimator"] + ("_glibc" if "light_sample_mode" in f else "")
              for f in spec.deep]
    phase(f"{spec.title}: row 9 on deep paths, smallpt_original "
          f"{' and '.join(labels)}, rr_start_depth = max_bounces = "
          f"{DEEP_BOUNCES}, every albedo {DEEP_ALBEDO} but the light's "
          "(black), 64x48x4")
    sp = scenes["smallpt_original"]
    L = int(sp.light.light_obj_id)
    r_alb = torch.full_like(sp.rects.albedo, DEEP_ALBEDO)
    r_alb[L] = 0.0
    deep = sp._replace(
        rects=sp.rects._replace(albedo=r_alb),
        spheres=sp.spheres._replace(
            albedo=torch.full_like(sp.spheres.albedo, DEEP_ALBEDO)))
    cam_d = make_camera(aspect=64 / 48)
    g = g_of(48, 64, 5)
    for label, fields in zip(labels, spec.deep):
        cfg = cfg_of(64, 48, 4, fields, 3, rr_start_depth=DEEP_BOUNCES,
                     max_bounces=DEEP_BOUNCES)
        alb, emi = mg.pack_materials(deep)
        ka, ke = mg.render_megakernel_vjp(deep, cam_d, cfg, alb, emi, 3, g)
        ka2, ke2 = mg.render_megakernel_vjp(deep, cam_d, cfg, alb, emi, 3, g)
        pa, pe = mg.render_megakernel_vjp_plain(deep, cam_d, cfg, alb, emi,
                                                3, g)
        if not (torch.equal(ka, ka2) and torch.equal(ke, ke2)):
            raise AssertionError(f"deep row 9 {label}: kernel runs differ")
        r_a = held(f"deep row 9 {label} d/d albedo", ka, pa, L)
        r_e = held(f"deep row 9 {label} d/d emission", ke, pe, L)
        tr = megakernel.render_megakernel(deep, cam_d, cfg, 3)[1].tolist()
        per = tr[0] / (64 * 48 * 4)
        log(f"[smoke] deep row 9 {label}: traces {tr} ({per:.1f} bounces a "
            f"sample); d/d albedo within {r_a:.3e}, d/d "
            f"emission within {r_e:.3e} of autograd's largest entry; runs "
            "bit-identical")

    sh_nm, sh_fields, (width, height) = spec.shard
    phase(f"{spec.title}: row 10 per shard, {sh_nm} "
          f"{sh_fields['estimator']} {width}x{height}x4, mesh {SHARD_MESH}: "
          "forward partials bit for bit, adjoint partials against autograd, "
          "the sums against the unsharded kernels")
    n_pix = width * height
    cam_s = make_camera(aspect=width / height)
    sc = scenes[sh_nm]
    cfg = cfg_of(width, height, 4, sh_fields, 18)
    alb, emi = mg.pack_materials(sc)
    g = g_of(height, width, 6).reshape(n_pix, 3)
    coords = [(i, j) for i in range(SHARD_MESH[0])
              for j in range(SHARD_MESH[1])]
    n_loc = n_pix // SHARD_MESH[0]
    shard = {"fwd": [0.0, 0.0, 0.0], "vjp": [0.0, 0.0, 0.0]}
    tr_sum, ga_sum, ge_sum = 0, 0, 0
    for c in coords:
        m = Mesh.single(SHARD_MESH, c)
        g_c = g[c[0] * n_loc:(c[0] + 1) * n_loc]
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_mat_shard(
                sc, cam_s, cfg, m, alb, emi, 18),
             "plain": lambda: mg.render_megakernel_mat_shard_plain(
                 sc, cam_s, cfg, m, alb, emi, 18)},
            ("kernel", "kernel", "plain", "kernel"))
        (k1, t1), (k2, t2), _ = outs["kernel"]
        if not all(torch.equal(a, b_) for a, b_ in (
                (k1, k2), (t1, t2), (k1, outs["plain"][0][0]),
                (t1, outs["plain"][0][1]))):
            raise AssertionError(f"row 10 forward {c}: kernel and plain "
                                 "version differ")
        tr_sum = tr_sum + t1
        shard["fwd"][1] += med["kernel"]
        shard["fwd"][2] += med["plain"]
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_vjp_shard(
                sc, cam_s, cfg, m, alb, emi, 18, g_c),
             "plain": lambda: mg.render_megakernel_vjp_shard_plain(
                 sc, cam_s, cfg, m, alb, emi, 18, g_c)},
            ("kernel", "kernel", "plain", "kernel"))
        (ka, ke), (ka2, ke2), _ = outs["kernel"]
        if not (torch.equal(ka, ka2) and torch.equal(ke, ke2)):
            raise AssertionError(f"row 10 adjoint {c}: kernel runs differ")
        pa, pe = outs["plain"][0]
        L = int(sc.light.light_obj_id)
        held(f"row 10 adjoint {c} d/d albedo", ka, pa, L)
        held(f"row 10 adjoint {c} d/d emission", ke, pe, L)
        shard["vjp"][0] = max(shard["vjp"][0], float((ka - pa).abs().max()),
                              float((ke - pe).abs().max()))
        shard["vjp"][1] += med["kernel"]
        shard["vjp"][2] += med["plain"]
        ga_sum, ge_sum = ga_sum + ka, ge_sum + ke
    want_tr = mg.render_megakernel_mat(sc, cam_s, cfg, alb, emi, 18)[1]
    wa, we = mg.render_megakernel_vjp(sc, cam_s, cfg, alb, emi, 18,
                                      g.reshape(height, width, 3))
    d_sum = max(float((ga_sum - wa).abs().max()) / float(wa.abs().max()),
                float((ge_sum - we).abs().max()) / float(we.abs().max()))
    log(f"[smoke] row 10 {sh_nm} {cfg.estimator} per shard: forward == "
        f"plain bit for bit, adjoint within {VJP_TOL:g} of autograd on every "
        f"coordinate; kernel {shard['fwd'][1] * 1e3:.3f} / "
        f"{shard['vjp'][1] * 1e3:.3f} ms, plain {shard['fwd'][2] * 1e3:.3f} / "
        f"{shard['vjp'][2] * 1e3:.3f} ms (forward / adjoint, sums of the "
        f"coordinates' medians); traces summed {tr_sum.tolist()} (unsharded "
        f"{want_tr.tolist()}), adjoint partials summed within {d_sum:.3e} of "
        "the unsharded kernel's largest entry")
    if not (torch.equal(tr_sum, want_tr) and d_sum <= SHARD_RTOL):
        raise AssertionError("row 10: the shards' sums differ from the "
                             "unsharded kernels")
    lanes = sum(lay.n_pix_loc * lay.g for lay in (
        megakernel.shard_of(cfg, Mesh.single(SHARD_MESH, c), what="spp")
        for c in coords))
    mat_shard = {
        mg.mat_kernel_name(sc, cfg): {
            "err": 0.0, "ms": shard["fwd"][1] * 1e3,
            "plain_ms": shard["fwd"][2] * 1e3,
            "bound": f_bound(sc, want_tr.tolist(), n_pix * 4, lanes,
                             cfg.estimator)},
        mg.vjp_kernel_name(sc, cfg): {
            "err": shard["vjp"][0], "ms": shard["vjp"][1] * 1e3,
            "plain_ms": shard["vjp"][2] * 1e3,
            "bound": v_bound(sc, want_tr.tolist(), n_pix * 4, n_pix,
                             cfg.estimator)}}

    main_launch = {}
    base = ["fit", "--width", "1024", "--height", "768", "--spp", "512"]
    for i, (nm, fields, train, steps, lr) in enumerate(spec.fits):
        sc = scenes[nm]
        cfg = cfg_of(1024, 768, 512, fields, 0)
        argv = [*base, "--scene", nm, *est_argv(fields), "--steps",
                str(steps), "--train", train,
                *(["--lr", lr] if lr is not None else [])]
        phase(f"{'main path' if i == 0 else 'path'}: cli {' '.join(argv)}")
        out, err_io = io.StringIO(), io.StringIO()
        lbn.clear()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                err_io):
            rc = cli_main(argv)
        counts = dict(lbn)
        label = f"{nm} {' '.join(est_argv(fields))}"
        text = err_io.getvalue()
        for line in text.strip().splitlines():
            log(f"[smoke] cli fit {label}: {line}")
        if rc != 0:
            raise AssertionError(f"cli fit {label} returned {rc}")
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        losses = [float(x) for x in re.findall(r"loss (\S+)", text)]
        secs = [float(x) for x in re.findall(r"seconds (\S+)", text)]
        m_name, v_name = mg.mat_kernel_name(sc, cfg), mg.vjp_kernel_name(
            sc, cfg)
        target_kernel = megakernel.kernel_name(sc, cfg)
        step_s = float(np.median(secs[1:] if steps > 1 else secs))
        log(f"[smoke] {'main path ' if i == 0 else ''}cli fit {label}: "
            f"launches {counts}; losses {losses}; light emission "
            f"{res['light_emission']}; {step_s:.4f} s a step (median of "
            f"{'steps 1-' + str(steps - 1) if steps > 1 else 'its step'}) on "
            f"{card}")
        if not (len(losses) == steps and np.all(np.isfinite(losses))):
            raise AssertionError(f"cli fit {label}: losses {losses}")
        if i == 0 and not losses[-1] < losses[0]:
            raise AssertionError(f"the main path's loss did not fall: "
                                 f"{losses}")
        if counts != {m_name: steps, v_name: steps, target_kernel: 1}:
            raise AssertionError(f"cli fit {label} launched {counts}")
        if nm != "sphere_grid":
            main_launch.setdefault(m_name, counts[m_name])
            main_launch.setdefault(v_name, counts[v_name])

    n_m, n_v = spec.x512_n
    phase(f"{spec.title}: rows 8 and 9 at 1024x768x512 seed 0, CUDA-event "
          f"times of each instance ({n_m} and {n_v} launches; "
          "smallpt_original: linear; sphere_grid: tree)")
    g = torch.full((768, 1024, 3), 1e-7, device="cuda")
    n_pix = 1024 * 768
    for nm, label, fields in spec.cases:
        sc = scenes[nm]
        cfg = cfg_of(1024, 768, 512, fields, 0)
        alb, emi = mg.pack_materials(sc)
        geom = megakernel.pack_geometry(sc, cam)
        tr = mg.render_megakernel_mat(sc, cam, cfg, alb, emi, 0,
                                      geometry=geom)[1].tolist()
        ms_m = event_ms(lambda: mg.render_megakernel_mat(
            sc, cam, cfg, alb, emi, 0, geometry=geom), n_m)
        ms_v = event_ms(lambda: mg.render_megakernel_vjp(
            sc, cam, cfg, alb, emi, 0, g, geometry=geom), n_v)
        b_m = f_bound(sc, tr, n_pix * 512, n_pix, cfg.estimator)
        b_v = v_bound(sc, tr, n_pix * 512, n_pix, cfg.estimator)
        log(f"[smoke] {nm} {label} 1024x768x512 seed 0, traces {tr}: "
            f"{mg.mat_kernel_name(sc, cfg)} {ms_m:.3f} ms (bound "
            f"{b_m[0]:.3f} ms, {b_m[1]}), {mg.vjp_kernel_name(sc, cfg)} "
            f"{ms_v:.3f} ms (bound {b_v[0]:.3f} ms, {b_v[1]}) a launch "
            f"(CUDA events) on {card}")

    def entry(name, source, replaces):
        r = par[name]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": "small_pathtracer_tpu/ops/" + replaces,
                "launches": main_launch[name], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None}

    return [entry(*k) for k in spec.kernels], mat_shard


# ROADMAP item 10's forward half: rows 1 and 2 with the other estimators and
# light_sample_mode='glibc_overflow' (csrc/megakernel_est.cu), row 3 with
# every estimator but nee (csrc/megakernel_budgets.cu), rows 4 and 5 with
# mis (csrc/megakernel_guided.cu), rows 6 and 7 through them. Each case:
# its label and RenderConfig fields; the kernels count their launches under
# megakernel.kernel_name / guided_kernel_name.
EST_CASES = {
    "uniform": {"estimator": "uniform"},
    "uniform_corrected": {"estimator": "uniform_corrected"},
    "mixture": {"estimator": "mixture", "mixture_q": 0.5},
    "mis": {"estimator": "mis"},
    "nee_glibc": {"estimator": "nee", "light_sample_mode": "glibc_overflow"},
    "mixture_glibc": {"estimator": "mixture",
                      "light_sample_mode": "glibc_overflow"},
}
# Material training with the EST_CASES estimators. Its main path is ``cli
# fit --estimator mis --train emission`` of the Cornell box at MIS_FIT_LR,
# chosen on the CPU at 32x24x16: the loss falls for 5 steps (1.319 ->
# 1.092), at 8 it diverges. With ``--train emission,albedo`` it diverges at
# every rate from 8 down to 1e-4: mis's light-albedo row is knife-edge
# 1/t^2 noise (about -30 there), and any albedo above 0 on the light makes
# probes from its own underside re-hit it. Each other instance takes a
# 1-step ``--train emission`` fit (the rect ones on the box, the ``_tab``
# ones on smallpt_original). Row 8 is held at 256x192x4, row 9 at
# 256x192x4 on the box and 128x96x4 on the sphere scenes: its autograd
# runs in chunks of lanes (megakernel_grad.plain_chunk), 2 on
# smallpt_original and 8 on sphere_grid at 256x192x4, 11.8-21.7 s an
# instance there (an H100 80GB HBM3 at 700 W, PERF.md §6), and one at
# 128x96x4.
MIS_FIT_LR = "1"
MAT_EST = MatSpec(
    title="rows 8, 9 and 10 with the item 10 estimators",
    kernels=tuple(
        (name, source, f"megakernel_grad.py:{line} ({where}{label})")
        for label in EST_CASES
        for name, source, line, where in (
            (f"megakernel_{label}_mat", "megakernel_est.cu", 980,
             "estimator "),
            (f"megakernel_{label}_mat_tab", "megakernel_est.cu", 980,
             "spheres, SPEC/REFR, "),
            (f"megakernel_vjp_{label}", "megakernel_grad_est.cu", 1049,
             "estimator "),
            (f"megakernel_vjp_{label}_tab", "megakernel_grad_est.cu", 1049,
             "spheres, SPEC/REFR, "))),
    cases=tuple((n, label, fields)
                for n in ("cornell_box", "smallpt_original", "sphere_grid")
                for label, fields in EST_CASES.items()),
    size8={n: (256, 192) for n in ("cornell_box", "smallpt_original",
                                   "sphere_grid")},
    size9={"cornell_box": (256, 192), "smallpt_original": (128, 96),
           "sphere_grid": (128, 96)},
    deep=(EST_CASES["mis"], EST_CASES["mixture"]),
    shard=("cornell_box", EST_CASES["mis"], (256, 192)),
    fits=(("cornell_box", EST_CASES["mis"], "emission", 5, MIS_FIT_LR),
          *((n, fields, "emission", 1, None)
            for n in ("cornell_box", "smallpt_original")
            for label, fields in EST_CASES.items()
            if (n, label) != ("cornell_box", "mis"))),
    x512_n=(1, 1),
)
# The material steps each rank of the 4-rank main path takes
# (``mesh_rank``): (label, scene, RenderConfig fields). The first is row
# 10's own main path (``cornell_box`` nee), the others each material
# slice's per-shard case as one step over the mesh.
MESH_MAT_STEPS = (("row10", "cornell_box", {}),
                  ("row10_tab", *MAT_GROWN.shard[:2]),
                  ("row10_mis", *MAT_EST.shard[:2]))
BUDGET_CASES = {"cosine": {"estimator": "cosine"},
                "nee_textbook": {"estimator": "nee_textbook"}, **EST_CASES}
# Guiding's own metric (tests/test_path_guiding.py): the clamped MSE of
# guided and unguided mis at equal spp against a high-spp unguided mis
# render, over seeds.
MSE_SPPS, MSE_SEEDS, MSE_REF_SPP, MSE_REF_SEED = (16, 64), (0, 1, 2, 3), 4096, 100

# The geometry adjoint with the other estimators: rows 11 and 12's
# instances in csrc/megakernel_geom_est.cu and csrc/megakernel_geom_direct.cu.
# Each case: the part of its kernel's name after megakernel_geom_
# (ops/megakernel_geom.geom_kernel_name) and its RenderConfig fields.
GEOM_EST_CASES = {"cosine": {"estimator": "cosine"},
                  "textbook": {"estimator": "nee_textbook"},
                  **EST_CASES}
# The parity runs of each instance, against autograd through its plain
# version: cornell_spheres at GEOM_EST_SIZE x4 (the plain versions are
# bound by the longest path's bounce count, not by pixels), and the glass
# of smallpt_original for GEOM_EST_GLASS. Every other check of the phase
# runs mis, the main path's estimator: on 200-bounce paths (DEEP_ALBEDO,
# the light black: DEEP_SIZE x4), each coordinate of the 2x2 mesh (row 12)
# at GEOM_EST_SIZE, and ``cli fit --train center,radius --estimator mis``
# at 1024x768x512 (5 steps, the loss must fall).
GEOM_EST_SIZE, GEOM_EST_GLASS = (128, 96), ("mis", "cosine")
DEEP_SIZE = (32, 24)
# max_bounces of the per-shard runs (the lanes' split is what they check;
# the parity runs take PARITY_BOUNCES: at the default 256 their autograd
# took 0.7-10.9 s each, an H100, PERF.md §6).
GEOM_SHARD_BOUNCES = 8
# Sphere rows whose exact value is 0: on a scene of DIFF objects only the
# cosine and uniform estimators' weights do not depend on the geometry
# (uniform_corrected's 2 max(d'.n, 0) is wz / |sv| for the sample drawn in
# n's frame), so their sphere rows are rounding. Such a row is held to
# GEOM_ZERO of the albedo table's largest entry instead of its own
# (measured on an H100, uniform_corrected at 128x96x4: 5.8e-5 against an
# albedo table of 3.8e3; cosine and uniform exactly 0; PERF.md §6).
# Mirrors and glass weigh and turn paths by the geometry, so there the
# rows are held as every other row.
GEOM_ZERO = 1e-6
# The 4-rank step of row 12 with mis (``mesh_rank``): label, scene, fields,
# (width, height, spp).
MESH_GEOM_STEPS = (("row12_mis", "cornell_spheres", {"estimator": "mis"},
                    (512, 384, 64)),)


def displaced(sc):
    """cli fit's geometry self-test scene: sphere 0 moved by (4, 0, -3),
    its radius scaled by 1.1."""
    sp = sc.spheres
    center, radius = sp.center.clone(), sp.radius.clone()
    center[0] += torch.tensor([4.0, 0.0, -3.0], device=center.device)
    radius[0] *= 1.1
    return sc._replace(spheres=sp._replace(center=center, radius=radius))


def geom_est_phases(card: str, cli_main) -> tuple[list, dict]:
    """Rows 11 and 12 with GEOM_EST_CASES: each instance's image-only
    launch bit for bit against its plain version and megakernel_<est>_tab,
    its adjoint against autograd through the plain version row by row
    (GEOM_TOL; GEOM_ZERO for rows that are 0) and against itself; mis on
    200-bounce paths and on each coordinate of the 2x2 mesh; the main path
    ``cli fit --train center,radius --estimator mis`` at 1024x768x512; each
    instance's x512 event time. Returns the ``kernels`` entries and row
    12's mis numbers for shard_phases."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.integrator.wavefront import has_spec_refr
    from small_pathtracer_tpu_torch.ops import _build, megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    def cfg_of(fields, width, height, spp, seed, **kw):
        return RenderConfig(width=width, height=height, spp=spp, seed=seed,
                            **fields, **kw)

    def g_of(height, width, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (height, width, 3)).astype(np.float32)).to("cuda")

    def held(label, got, want, tols, zero_rows=False):
        """Each table (sphere rows, albedo, emission) row by row against
        autograd; returns the largest |kernel - plain|."""
        err, bad = 0.0, []
        for name, kt, pt, tol in zip(("sphere rows", "albedo", "emission"),
                                     got, want, tols):
            e = float((kt - pt).abs().max())
            err = max(err, e)
            if name == "sphere rows" and zero_rows:
                floor = GEOM_ZERO * float(want[1].abs().max())
                msg = (f"largest |kernel| {float(kt.abs().max()):.3e}, "
                       f"|plain| {float(pt.abs().max()):.3e} (exactly 0; "
                       f"limit {floor:.3e})")
                if not max(float(kt.abs().max()),
                           float(pt.abs().max())) <= floor:
                    bad.append(f"{name} not 0")
            else:
                ratio, row, scale = worst_row(kt, pt)
                msg = (f"worst row {row}: ratio {ratio:.3e} to its largest "
                       f"entry {scale:.3e} (limit {tol:g})")
                if not ratio <= tol:
                    bad.append(f"{name} row {row} off by {ratio:.3e}")
            log(f"[smoke] {label} d/d {name}: max |kernel - plain| {e:.3e}; "
                + msg)
        if bad:
            raise AssertionError(f"{label}: " + "; ".join(bad))
        return err

    par, cam_cache = {}, {}

    def camera(width, height):
        if (width, height) not in cam_cache:
            cam_cache[(width, height)] = make_camera(aspect=width / height)
        return cam_cache[(width, height)]

    phase(f"rows 11 and 12 with the other estimators: each instance against "
          f"megakernel_<est>_tab and autograd through its plain version, "
          f"cornell_spheres {GEOM_EST_SIZE[0]}x{GEOM_EST_SIZE[1]}x4 and the "
          f"glass of smallpt_original ({', '.join(GEOM_EST_GLASS)})")
    width, height = GEOM_EST_SIZE
    cam = camera(width, height)
    runs = [("cornell_spheres", label) for label in GEOM_EST_CASES]
    runs += [("smallpt_original", label) for label in GEOM_EST_GLASS]
    for nm, label in runs:
        sc = get_scene(nm)
        fields = GEOM_EST_CASES[label]
        cfg = cfg_of(fields, width, height, 4, 3,
                     max_bounces=PARITY_BOUNCES)
        name = mgeo.geom_kernel_name(cfg)
        t_img, t_tr = megakernel.render_megakernel(sc, cam, cfg, 3)
        g = g_of(height, width, 3)
        before = megakernel.LAUNCHES[name]
        (img_i, _, _, _, c_i), img_s = timed(
            lambda: mgeo.geom_run(sc, cam, cfg, 3, with_counts=True))
        outs, secs = [], []
        for _ in range(2):
            out, sec = timed(lambda: mgeo.geom_run(sc, cam, cfg, 3, g,
                                                   with_counts=True))
            outs.append(out)
            secs.append(sec)
        if megakernel.LAUNCHES[name] != before + 3:
            raise AssertionError(f"{label}: {name} did not count 3 launches")
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{nm} {label}: adjoint runs differ")
        k_img, k_sph, k_alb, k_emi, counts = outs[0]
        torch.cuda.reset_peak_memory_stats()
        (p_img, p_sph, p_alb, p_emi, p_tr), p_s = timed(
            lambda: mgeo.geom_run_plain(sc, cam, cfg, 3, g))
        peak = torch.cuda.max_memory_allocated()
        if not (torch.equal(img_i, t_img) and torch.equal(k_img, t_img)
                and torch.equal(p_img, t_img)
                and torch.equal(c_i[:2], t_tr) and torch.equal(p_tr, t_tr)
                and torch.equal(counts[:2], t_tr)
                and int(counts[3]) == int(t_tr[0]) and int(counts[4]) > 0):
            raise AssertionError(f"{nm} {label}: the image-only launch, the "
                                 "adjoint's pass A or the plain version "
                                 "differs from "
                                 f"{megakernel.kernel_name(sc, cfg)}, or no "
                                 "path outran the tape")
        tols = (GEOM_TOL[nm][1], GEOM_TOL[nm][0], GEOM_TOL[nm][0])
        spec = has_spec_refr(sc)  # SPEC or REFR objects
        err = held(f"{name} {nm}", (k_sph, k_alb, k_emi),
                   (p_sph, p_alb, p_emi), tols,
                   zero_rows=not spec and fields["estimator"] in (
                       "cosine", "uniform", "uniform_corrected"))
        n_pix = width * height
        b = geom_bound(counts.tolist(), n_pix * 4, n_pix,
                       sc.rects.k.shape[0], sc.spheres.radius.shape[0],
                       -(-n_pix * megakernel.full_layout(cfg).g
                         // mgeo.KERNEL_BLOCK), est=fields["estimator"],
                       diffuse_only=not spec)
        ms = float(np.median(secs)) * 1e3
        log(f"[smoke] {name} {nm} {width}x{height}x4 seed 3: image-only "
            f"{img_s * 1e3:.3f} ms == {megakernel.kernel_name(sc, cfg)} and "
            f"the plain version, traces {t_tr.tolist()}; adjoint {ms:.3f} ms, "
            f"counts {counts.tolist()}, two runs bit-identical; plain "
            f"adjoint {p_s:.3f} s, peak {peak / 2**30:.2f} GiB; bound "
            f"{b[0]:.3f} ms ({b[1]})")
        if nm == "cornell_spheres":
            par[name] = {"err": err, "ms": ms, "plain_ms": p_s * 1e3,
                         "bound": b, "label": label}

    k_seg, k_ckpt = tape_sizes()
    dw, dh = DEEP_SIZE
    phase(f"mis geometry adjoint on {DEEP_BOUNCES}-bounce paths, "
          f"cornell_spheres {dw}x{dh}x4, every albedo {DEEP_ALBEDO} but the "
          "light's (black)")
    sph = get_scene("cornell_spheres")
    t_sph, t_alb, t_emi = mgeo.pack_tables(sph)
    dark_alb = torch.full_like(t_alb, DEEP_ALBEDO)
    dark_alb[sph.light.light_obj_id] = 0.0
    dark = mgeo.scene_with_tables(sph, t_sph, dark_alb, t_emi)
    cfg = cfg_of(EST_CASES["mis"], dw, dh, 4, 3, rr_start_depth=DEEP_BOUNCES,
                 max_bounces=DEEP_BOUNCES)
    dcam = camera(dw, dh)
    g = g_of(dh, dw, 5)
    runs = [mgeo.geom_run(dark, dcam, cfg, 3, g, with_counts=True)
            for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("deep paths, mis: adjoint runs differ")
    img, k_sph, k_alb, k_emi, counts = runs[0]
    t_img, t_tr = megakernel.render_megakernel(dark, dcam, cfg, 3)
    deepest = int(counts[4])
    log(f"[smoke] deep paths, megakernel_geom_mis counts {counts.tolist()} "
        f"[extend, probe, replayed, VJP, paths longer than the tape]; "
        f"(kCkpt + 2)·kSeg = {(k_ckpt + 2) * k_seg}")
    if not (torch.equal(img, t_img) and torch.equal(counts[:2], t_tr)
            and deepest > 0 and int(counts[3]) == int(t_tr[0])):
        raise AssertionError("deep paths, mis: the image or counters differ "
                             "from megakernel_mis_tab's, or no path outran "
                             "the tape")
    _, p_sph, p_alb, p_emi, _ = mgeo.geom_run_plain(dark, dcam, cfg, 3, g)
    tol_mat, tol_sph = GEOM_TOL["cornell_spheres"]
    held("deep paths, megakernel_geom_mis", (k_sph, k_alb, k_emi),
         (p_sph, p_alb, p_emi), (tol_sph, tol_mat, tol_mat))

    phase(f"row 12 with mis per shard on cornell_spheres {width}x{height}x4, "
          f"max_bounces {GEOM_SHARD_BOUNCES} (mesh {SHARD_MESH}, one process)")
    cfg = cfg_of(EST_CASES["mis"], width, height, 4, 3,
                 max_bounces=GEOM_SHARD_BOUNCES)
    name = mgeo.geom_kernel_name(cfg)
    g = g_of(height, width, 3)
    n_pix = width * height
    shard = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    tot_img, tot_grads, tot_counts = None, None, None
    for c in ((i, j) for i in range(SHARD_MESH[0])
              for j in range(SHARD_MESH[1])):
        m = Mesh.single(SHARD_MESH, c)
        lay = megakernel.shard_of(cfg, m, what="spp")
        g_c = g.reshape(n_pix, 3)[lay.pix0:lay.pix0 + lay.n_pix_loc]
        before = megakernel.LAUNCHES[name]
        out_i, s_i = timed(lambda: mgeo.geom_run_shard(sph, cam, cfg, m, 3))
        out_k, s_k = timed(lambda: mgeo.geom_run_shard(sph, cam, cfg, m, 3,
                                                       g_c))
        out_p, s_p = timed(lambda: mgeo.geom_run_shard_plain(sph, cam, cfg,
                                                             m, 3, g_c))
        if megakernel.LAUNCHES[name] != before + 2:
            raise AssertionError(f"row 12 mis {c}: {name} did not count 2 "
                                 "launches")
        if not (torch.equal(out_i[0], out_p[0])
                and torch.equal(out_k[0], out_p[0])
                and torch.equal(out_i[4][:2], out_p[4])):
            raise AssertionError(f"row 12 mis {c}: the shard's image or "
                                 "traces differ from its plain version")
        shard["err"] = max(shard["err"], held(
            f"row 12 {name} shard {c}", out_k[1:4], out_p[1:4],
            (tol_sph, tol_mat, tol_mat)))
        shard["ms"] += (s_i + s_k) * 1e3
        shard["plain_ms"] += s_p * 1e3
        tot_grads = (list(out_k[1:4]) if tot_grads is None
                     else [a + b for a, b in zip(tot_grads, out_k[1:4])])
        tot_counts = (out_k[4] if tot_counts is None
                      else tot_counts + out_k[4])
    whole = mgeo.geom_run(sph, cam, cfg, 3, g)[1:4]
    d_g = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(tot_grads, whole))
    log(f"[smoke] row 12 {name} per shard: images and traces equal the "
        f"plain version's; adjoint partials held row by row; the shards' "
        f"sums within {d_g:.3e} of the unsharded adjoint's largest entries "
        f"(limit {STEP_TOL:g}); kernel {shard['ms']:.3f} ms, plain "
        f"{shard['plain_ms']:.3f} ms (sums over the coordinates)")
    if not d_g <= STEP_TOL:
        raise AssertionError("row 12 mis: the shards' sums differ from the "
                             "unsharded adjoint")
    shard["bound"] = geom_bound(tot_counts.tolist(), n_pix * 4, n_pix,
                                sph.rects.k.shape[0],
                                sph.spheres.radius.shape[0],
                                -(-n_pix * megakernel.full_layout(cfg).g
                                  // mgeo.KERNEL_BLOCK), est="mis")

    phase("main path, cli fit --train center,radius --scene cornell_spheres "
          "--estimator mis, 1024x768x512, 5 steps")
    out, err_io = io.StringIO(), io.StringIO()
    megakernel.LAUNCHES.clear()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err_io):
        rc = cli_main(["fit", "--scene", "cornell_spheres", "--width", "1024",
                       "--height", "768", "--spp", "512", "--steps", "5",
                       "--train", "center,radius", "--estimator", "mis"])
    launches = megakernel.LAUNCHES["megakernel_geom_mis"]
    others = {k: v for k, v in megakernel.LAUNCHES.items()
              if k != "megakernel_geom_mis"}
    for line in err_io.getvalue().strip().splitlines():
        log("[smoke] cli fit mis: " + line)
    if rc != 0:
        raise AssertionError(f"cli fit --estimator mis returned {rc}")
    fit = json.loads(out.getvalue().strip().splitlines()[-1])
    log("[smoke] cli fit mis: " + json.dumps(fit))
    steps = [(float(a), float(b)) for a, b in re.findall(
        r"loss (\S+).*?seconds (\S+)", err_io.getvalue())]
    losses = [a for a, _ in steps]
    if launches != 1 + 2 * 5 or others:
        raise AssertionError(f"cli fit mis launched megakernel_geom_mis "
                             f"{launches} times (not 1 + 2 a step), and "
                             f"{others}")
    # The fitter's contract: 5 finite losses, each rejected step restored,
    # so the returned (last) loss is the best. Whether the loss falls is
    # logged, not gated: on this self-test mis's interior gradient points
    # away from the truth (its loss rises along it at every step from 0.05
    # to 1 scene unit, as nee_textbook's; nee's falls), the silhouette
    # terms it leaves out being item 16 (PERF.md §6).
    if not (len(losses) == 5 and all(np.isfinite(losses))
            and losses[-1] == min(losses)):
        raise AssertionError(f"the mis geometry fit's losses {losses}")
    if _build.build_kernels().build_seconds != 0.0:
        raise AssertionError("moving the spheres rebuilt the library")
    step_s = float(np.median([b for _, b in steps]))
    falls = "falls" if min(losses) < losses[0] else "does not fall"
    log(f"[smoke] mis geometry fit: {launches} launches of "
        f"megakernel_geom_mis (1 + 2 a step); loss {losses[0]:.6f} -> best "
        f"{min(losses):.6f} ({falls}); {step_s:.4f} s a step (median of 5) "
        f"on {card}")
    par["megakernel_geom_mis"]["launches"] = launches

    phase("each other instance's path: a 1-step cli fit --train "
          "center,radius of cornell_spheres at 256x192x64")
    for name, r in par.items():
        if name == "megakernel_geom_mis":
            continue
        megakernel.LAUNCHES.clear()
        with (contextlib.redirect_stdout(io.StringIO()),
              contextlib.redirect_stderr(io.StringIO())):
            rc = cli_main(["fit", "--scene", "cornell_spheres", "--width",
                           "256", "--height", "192", "--spp", "64",
                           "--steps", "1", "--train", "center,radius",
                           *est_argv(GEOM_EST_CASES[r["label"]])])
        got = dict(megakernel.LAUNCHES)
        if rc != 0 or got != {name: 3}:
            raise AssertionError(f"cli fit {r['label']}: rc {rc}, launches "
                                 f"{got} (not 1 + 2 of {name})")
        r["launches"] = got[name]
    log(f"[smoke] a 1-step cli fit of each other instance: 3 launches each "
        f"(1 + 2 a step) of {[n for n in par if n != 'megakernel_geom_mis']}")

    phase("each new geometry-adjoint instance at 1024x768x512 on "
          "cornell_spheres, CUDA events")
    cam = camera(1024, 768)
    geometry = megakernel.pack_geometry(sph, cam)
    g512 = torch.full((768, 1024, 3), 1e-7, device="cuda")
    n_pix = 1024 * 768
    for name, r in par.items():
        fields = GEOM_EST_CASES[r["label"]]
        cfg = cfg_of(fields, 1024, 768, 512, 0)
        counts = mgeo.geom_run(sph, cam, cfg, 0, g512, geometry=geometry,
                               with_counts=True)[4].tolist()
        img_ms = event_ms(lambda: mgeo.geom_run(sph, cam, cfg, 0,
                                                geometry=geometry), 1)
        adj_ms = event_ms(lambda: mgeo.geom_run(sph, cam, cfg, 0, g512,
                                                geometry=geometry), 1)
        b512 = geom_bound(counts, n_pix * 512, n_pix, sph.rects.k.shape[0],
                          sph.spheres.radius.shape[0], -(-n_pix // 128),
                          est=fields["estimator"])
        b_alg = geom_bound(counts, n_pix * 512, n_pix, sph.rects.k.shape[0],
                           sph.spheres.radius.shape[0], -(-n_pix // 128),
                           True, est=fields["estimator"])
        log(f"[smoke] {name} cornell_spheres 1024x768x512 seed 0: image-only "
            f"{img_ms:.3f} ms, adjoint {adj_ms:.3f} ms a launch, counts "
            f"{counts} [extend, probe, replayed, VJP, paths longer than the "
            f"tape]; bound {b512[0]:.3f} ms ({b512[1]}; the taped "
            f"algorithm's {b_alg[0]:.3f} ms, {b_alg[1]}) on {card}")

    def entry(name, r, source, replaces):
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": "small_pathtracer_tpu/ops/" + replaces,
                "launches": r["launches"], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None}

    out = []
    for name, r in par.items():
        est = GEOM_EST_CASES[r["label"]]["estimator"]
        source = ("megakernel_geom_direct.cu" if est in mgeo.DIRECT
                  else "megakernel_geom_est.cu")
        out.append(entry(name, r, source, "megakernel_geom.py:1488 "
                         f"(estimator {r['label']})"))
    return out, {"megakernel_geom_mis": shard}


def kernel_parity(label, name, kernel_fn, plain_fn, bound_fn,
                  glos: bool = False) -> dict:
    """kernel, plain, kernel at one launch's shape: the kernel runs
    bit-identical, the plain version's equal bit for bit, two launches
    counted under name. bound_fn(traces) gives the bound; with glos,
    bound_fn(traces, GLOS vertices of one more plain run). Returns the
    numbers of the run's ``kernels`` entry and the GLOS vertices
    (``n_glos``, 0 without glos)."""
    from small_pathtracer_tpu_torch.ops import megakernel

    lbn = megakernel.LAUNCHES
    before = lbn[name]
    outs, med = in_turns({"kernel": kernel_fn, "plain": plain_fn},
                         ("kernel", "plain", "kernel"))
    if lbn[name] != before + 2:
        raise AssertionError(f"{label}: {name} did not count 2 launches")
    (k_img, k_tr), (k2_img, k2_tr) = outs["kernel"]
    p_img, p_tr = outs["plain"][0]
    if not (torch.equal(k_img, k2_img) and torch.equal(k_tr, k2_tr)):
        raise AssertionError(f"{label}: kernel runs differ")
    err_ = float((k_img - p_img).abs().max())
    if glos:
        n_glos = glos_vertices(plain_fn)
        b = bound_fn(k_tr.tolist(), n_glos)
        extra = f"; GLOS vertices {n_glos}"
    else:
        b, extra = bound_fn(k_tr.tolist()), ""
    log(f"[smoke] {label}: {name} {med['kernel'] * 1e3:.3f} ms traces "
        f"{k_tr.tolist()}; plain {med['plain'] * 1e3:.3f} ms traces "
        f"{p_tr.tolist()}; max |diff| {err_:.3e}{extra}; bound "
        f"{b[0]:.3f} ms ({b[1]})")
    if not (torch.equal(k_tr, p_tr) and err_ == 0.0):
        raise AssertionError(f"{label}: kernel and plain version differ")
    return {"err": err_, "ms": med["kernel"] * 1e3,
            "plain_ms": med["plain"] * 1e3, "bound": b,
            "n_glos": n_glos if glos else 0}


def est_argv(fields: dict) -> list[str]:
    """cli render flags of a case's RenderConfig fields."""
    argv = ["--estimator", fields["estimator"]]
    if "mixture_q" in fields:
        argv += ["--mixture-q", str(fields["mixture_q"])]
    if "light_sample_mode" in fields:
        argv += ["--light-sample-mode", fields["light_sample_mode"]]
    return argv


def est_phases(card: str, cli_main) -> list:
    """ROADMAP item 10's forward half (EST_CASES, BUDGET_CASES, guided mis):
    each new instance bit for bit against its plain version (kernel, plain,
    kernel) at 1024x768x4: rows 1 and 2 on ``cornell_box``,
    ``smallpt_original`` (the linear scan) and ``sphere_grid`` (the tree),
    row 3 on ragged spans (75% empty) of the same scenes, rows 4 and 5 with
    mis on ``cornell_alcove_baffled``, ``smallpt_original`` and
    ``sphere_grid`` (sphere_table off), and an all-sentinel table against
    unguided mis; then the paths at 1024x768x512 with the launch counts
    cleared before each and read after: ``cli render --estimator mis`` (the
    main path) and each other case on ``cornell_box`` and ``sphere_grid``,
    ``--adaptive-tol 0.01 --estimator mis`` and ``--adaptive-tol 0
    --adaptive-wave 256`` of each budget case (the uniform render's
    traces; then each kernel's event time with every span x512), mis's
    checkpointed spans and ``--mesh 1x1``, rows 7 and 6 with
    mis on each shard of a 2x2 mesh against the unsharded kernel,
    ``--guided --estimator mis`` (alcove, ``smallpt_original``) and row 5
    through its wrapper; each instance's x512 event time and bound; and
    guiding's clamped-MSE ratio. Returns the ``kernels`` entries."""
    from small_pathtracer_tpu_torch import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu_torch.core import film
    from small_pathtracer_tpu_torch.experiment import path_guiding as pg
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh
    from small_pathtracer_tpu_torch.utils import checkpoint

    lbn = megakernel.LAUNCHES
    width, height = 1024, 768
    n_pix = width * height
    cam = make_camera(aspect=width / height)
    sc_of = {n: get_scene(n) for n in ("cornell_box", "smallpt_original",
                                       "sphere_grid",
                                       "cornell_alcove_baffled")}
    base = ["render", "--width", "1024", "--height", "768", "--spp", "512"]

    def cfg_of(fields, spp, seed, **kw):
        return RenderConfig(width=width, height=height, spp=spp, seed=seed,
                            **fields, **kw)

    def f_bound(sc, tr, n_samples, n_lanes, est, extra_bytes=0):
        return forward_bound(tr, n_samples, n_lanes, sc.rects.k.shape[0],
                             sc.spheres.radius.shape[0], extra_bytes, est,
                             not megakernel.uses_sphere_table(sc))

    parity = kernel_parity
    par = {}  # kernel name -> its reported parity run
    phase("rows 1 and 2 with the item 10 estimators against their plain "
          "version 1024x768x4: cornell_box, smallpt_original (linear), "
          "sphere_grid (tree)")
    for label, fields in EST_CASES.items():
        for nm in ("cornell_box", "smallpt_original", "sphere_grid"):
            sc = sc_of[nm]
            cfg = cfg_of(fields, 4, 21, max_bounces=PARITY_BOUNCES)
            name = megakernel.kernel_name(sc, cfg)
            r = parity(
                f"{label} {nm} 1024x768x4 seed 21", name,
                lambda: megakernel.render_megakernel(sc, cam, cfg, 21),
                lambda: megakernel.render_megakernel_plain(sc, cam, cfg, 21),
                lambda tr: f_bound(sc, tr, n_pix * 4, n_pix,
                                   fields["estimator"]))
            par.setdefault(name, r)

    phase("row 3 with every estimator but nee against its plain version, "
          "1024x768 ragged spans: cornell_box, sphere_grid (tree), "
          "smallpt_original (linear)")
    for label, fields in BUDGET_CASES.items():
        for i, nm in enumerate(("cornell_box", "sphere_grid",
                                "smallpt_original")):
            sc = sc_of[nm]
            cfg = cfg_of(fields, 64, 22 + i, max_bounces=PARITY_BOUNCES)
            a, b_ = ragged_spans(n_pix, 4, 3, 22 + i, empty=0.75)
            name = megakernel.kernel_name(sc, cfg, "_budgets")
            n_samples = int((b_ - a).sum())
            r = parity(
                f"budgets {label} {nm} spans [0,4) + [0,3]", name,
                lambda: megakernel.render_megakernel_budgets(
                    sc, cam, cfg, 22 + i, a, b_),
                lambda: megakernel.render_megakernel_budgets_plain(
                    sc, cam, cfg, 22 + i, a, b_),
                lambda tr: f_bound(sc, tr, n_samples, n_pix,
                                   fields["estimator"], 2 * 4 * n_pix))
            par.setdefault(name, r)

    phase("train_guide at the CLI's pre-pass size on cornell_alcove_baffled, "
          "smallpt_original, sphere_grid")
    tcfg = RenderConfig(width=128, height=96, spp=16, seed=1)
    guides = {nm: pg.guide_lobes(pg.train_guide(sc_of[nm], cam, tcfg, 8, 1))
              for nm in ("cornell_alcove_baffled", "smallpt_original",
                         "sphere_grid")}
    mis = EST_CASES["mis"]

    def guided_fn(primary, plain=False):
        if primary:
            return (megakernel.render_megakernel_guided_primary_plain
                    if plain else megakernel.render_megakernel_guided_primary)
        return (megakernel.render_megakernel_guided_plain if plain
                else megakernel.render_megakernel_guided)

    def guide_bytes(primary):
        return (n_pix if primary else pg.N_VOXELS) * 4

    phase("rows 4 and 5 with mis against their plain version 1024x768x4: "
          "cornell_alcove_baffled, smallpt_original (linear), sphere_grid "
          "(tree); an all-sentinel table against unguided mis")
    empty = (torch.zeros((pg.N_VOXELS, 3), device="cuda"),
             torch.zeros(pg.N_VOXELS, dtype=torch.bool, device="cuda"))
    for nm, g in guides.items():
        sc = sc_of[nm]
        cfg = cfg_of(mis, 4, 23, sphere_table="off")
        for primary in (0, 1):
            name = megakernel.guided_kernel_name(sc, cfg, primary)
            r = parity(
                f"row {4 + primary} mis {nm} 1024x768x4 seed 23", name,
                lambda: guided_fn(primary)(sc, cam, cfg, 23, g, GUIDE_BETA,
                                           GUIDE_K),
                lambda: guided_fn(primary, True)(sc, cam, cfg, 23, g,
                                                 GUIDE_BETA, GUIDE_K),
                lambda tr: f_bound(sc, tr, n_pix * 4, n_pix, "mis",
                                   guide_bytes(primary)))
            par.setdefault(name, r)
            u = megakernel.render_megakernel(sc, cam, cfg, 23)
            e = guided_fn(primary)(sc, cam, cfg, 23, empty, GUIDE_BETA,
                                   GUIDE_K)
            if not (torch.equal(u[0], e[0]) and torch.equal(u[1], e[1])):
                raise AssertionError(f"empty table row {4 + primary} {nm}: "
                                     "guided mis differs from unguided mis")
        log(f"[smoke] empty table {nm} mis: rows 4 and 5 equal the unguided "
            "mis kernel bit for bit")

    main_launch = {}  # kernel name -> launches in its path's run

    def run_path(label, argv, name, n_expect=1):
        """A cli render at 1024x768x512 with the counts cleared before it:
        it must launch name n_expect times and nothing else. Returns
        (traces, seconds, stderr)."""
        lbn.clear()
        with tempfile.TemporaryDirectory() as tmp:
            text = cli_stderr(cli_main, base + argv + [
                "-o", os.path.join(tmp, "out.ppm")])
        counts = dict(lbn)
        if counts != {name: n_expect}:
            raise AssertionError(f"{label} launched {counts}, expected "
                                 f"{name} x{n_expect}")
        main_launch.setdefault(name, n_expect)
        rays, secs = cli_traces(text)
        return rays, secs, text

    def x512(label, name, fn, sc, est, extra_bytes=0):
        """Three launches in a row (CUDA events) after the one that reads the
        traces; logs and returns (ms, traces, bound)."""
        tr = fn()[1].tolist()
        ms = event_ms(fn, 3)
        b = f_bound(sc, tr, n_pix * 512, n_pix, est, extra_bytes)
        log(f"[smoke] {label} 1024x768x512 seed 0: {name} {ms:.3f} ms a "
            f"launch (CUDA events), traces {tr}; bound {b[0]:.3f} ms "
            f"({b[1]}) on {card}")
        return ms, tr, b

    phase("main path, cli render --estimator mis 1024x768x512")
    box = sc_of["cornell_box"]
    cfg_mis = cfg_of(mis, 512, 0)
    rays, secs, _ = run_path("cli render --estimator mis", est_argv(mis),
                             "megakernel_mis")
    ms, tr, _ = x512("mis cornell_box", "megakernel_mis",
                     lambda: megakernel.render_megakernel(box, cam, cfg_mis,
                                                          0), box, "mis")
    if sum(tr) != rays:
        raise AssertionError("cli render's traces differ from the wrapper's")
    log(f"[smoke] main path cli render --estimator mis: 1 launch of "
        f"megakernel_mis, {rays} rays in {secs:.3f} s = "
        f"{rays / secs / 1e6:.1f} Mrays/s wall on {card}; kernel {ms:.3f} ms"
        f" = {rays / ms / 1e3:.1f} Mrays/s")

    phase("rows 1 and 2 at 1024x768x512: cli render of every item 10 case on "
          "cornell_box and sphere_grid, and each one's event time")
    uniform_tr = {}  # (label, scene) -> x512 traces
    for label, fields in BUDGET_CASES.items():
        for nm in ("cornell_box", "sphere_grid"):
            sc = sc_of[nm]
            cfg = cfg_of(fields, 512, 0)
            name = megakernel.kernel_name(sc, cfg)
            fn = (lambda: megakernel.render_megakernel(sc, cam, cfg, 0))
            if label in EST_CASES and not (label == "mis"
                                           and nm == "cornell_box"):
                rays, _, _ = run_path(f"cli render {nm} {label}",
                                      est_argv(fields) + ["--scene", nm],
                                      name)
                ms, tr, _ = x512(f"{label} {nm}", name, fn, sc,
                                 fields["estimator"])
                if sum(tr) != rays:
                    raise AssertionError(f"{label} {nm}: cli traces differ")
            else:
                tr = fn()[1].tolist()
            uniform_tr[(label, nm)] = tr

    phase("row 3 at 1024x768x512: cli render --adaptive-tol 0.01 --estimator "
          "mis, and --adaptive-tol 0 --adaptive-wave 256 of every budget "
          "case on cornell_box and sphere_grid, and each one's event time "
          "with every span x512")
    lbn.clear()
    with tempfile.TemporaryDirectory() as tmp:
        text = cli_stderr(cli_main, base + est_argv(mis) + [
            "--adaptive-tol", "0.01", "-o", os.path.join(tmp, "a.png")])
    counts = dict(lbn)
    m_ = re.search(r"\[adaptive\] (\d+) waves, (\d+) samples \((\d+)% ",
                   text)
    n_waves = int(m_.group(1))
    if counts != {"megakernel_mis_budgets": n_waves}:
        raise AssertionError(f"adaptive mis launched {counts} for {n_waves} "
                             "waves")
    main_launch["megakernel_mis_budgets"] = n_waves
    rays, secs = cli_traces(text)
    log(f"[smoke] adaptive mis cornell_box tol 0.01: {n_waves} waves = "
        f"{n_waves} launches of megakernel_mis_budgets, {m_.group(2)} samples "
        f"= {m_.group(3)}% of uniform, {rays} rays in {secs:.3f} s = "
        f"{rays / secs / 1e6:.1f} Mrays/s")
    for label, fields in BUDGET_CASES.items():
        for nm in ("cornell_box", "sphere_grid"):
            sc = sc_of[nm]
            name = megakernel.kernel_name(sc, cfg_of(fields, 512, 0),
                                          "_budgets")
            rays, _, _ = run_path(
                f"adaptive tol 0 {label} {nm}", est_argv(fields) + [
                    "--scene", nm, "--adaptive-tol", "0", "--adaptive-wave",
                    "256"], name, 2)
            if rays != sum(uniform_tr[(label, nm)]):
                raise AssertionError(f"adaptive tol 0 {label} {nm}: traces "
                                     f"{rays}, uniform "
                                     f"{sum(uniform_tr[(label, nm)])}")
            # The launch alone with every pixel's span all of x512 (the
            # wave function packs the scene once), against the render.
            wave = megakernel.budget_waves(sc, cam, cfg_of(fields, 512, 0))
            a0 = torch.zeros(n_pix, dtype=torch.int32, device="cuda")
            b0 = torch.full((n_pix,), 512, dtype=torch.int32, device="cuda")
            live = torch.arange(n_pix, dtype=torch.int32, device="cuda")
            _, tr, _ = x512(f"budgets {label} {nm}, every span x512", name,
                            lambda: wave(0, a0, b0, live), sc,
                            fields["estimator"], 2 * 4 * n_pix)
            if tr != uniform_tr[(label, nm)]:
                raise AssertionError(f"budgets {label} {nm}: full spans' "
                                     f"traces {tr}, the render's "
                                     f"{uniform_tr[(label, nm)]}")
        log(f"[smoke] adaptive tol 0 {label}: 2 launches of each budget "
            "kernel, the uniform render's traces")

    phase("mis spans and shards at 1024x768x512: --checkpoint "
          "--checkpoint-every 128 --preview, --mesh 1x1 (nccl); rows 7 and 6 "
          "with mis on each shard of a 2x2 mesh at 1024x768x4")
    with tempfile.TemporaryDirectory() as tmp:
        ck, pv = os.path.join(tmp, "r.ckpt"), os.path.join(tmp, "p.png")
        a, b_ = os.path.join(tmp, "a.ppm"), os.path.join(tmp, "b.ppm")
        lbn.clear()
        text = cli_stderr(cli_main, base + est_argv(mis) + [
            "--checkpoint", ck, "--checkpoint-every", "128", "--preview", pv,
            "-o", os.path.join(tmp, "ck.png")])
        n_ck = lbn["megakernel_mis"]
        ck_rays, _ = cli_traces(text)
        img_ck, _ = checkpoint.render_with_checkpoints(box, cam, cfg_mis, "",
                                                       128)
        img_u = film.finalize(megakernel.render_megakernel(
            box, cam, cfg_mis, 0)[0] / torch.tensor(512.0, device="cuda"))
        ck_err = float((img_ck - img_u).abs().max())
        log(f"[smoke] mis checkpoint: {n_ck} span launches of "
            f"megakernel_mis, traces {ck_rays} (one launch "
            f"{sum(uniform_tr[('mis', 'cornell_box')])}), max |span image - "
            f"one-launch image| {ck_err:.3e}")
        if not (n_ck == 4 and ck_rays == sum(uniform_tr[("mis",
                                                         "cornell_box")])
                and ck_err <= 1e-5):
            raise AssertionError("mis's checkpointed render differs")
        lbn.clear()
        cli_stderr(cli_main, base + est_argv(mis) + ["-o", a])
        cli_stderr(cli_main, base + est_argv(mis) + [
            "--mesh", "1x1", "--dist-backend", "nccl", "-o", b_])
        same = Path(a).read_bytes() == Path(b_).read_bytes()
        log(f"[smoke] mis --mesh 1x1 (nccl): launches {dict(lbn)}, output "
            f"bytes equal to cli render's: {same}")
        if not (same and dict(lbn) == {"megakernel_mis": 2}):
            raise AssertionError("mis --mesh 1x1 differs from cli render")
    coords = [(i, j) for i in range(2) for j in range(2)]
    cfg4 = cfg_of(mis, 4, 24, sphere_table="off")
    alc = sc_of["cornell_alcove_baffled"]
    g_alc = guides["cornell_alcove_baffled"]
    for label, name, fn, want in (
            ("row 7 mis cornell_box", "megakernel_mis",
             lambda m: megakernel.render_megakernel_sharded(box, cam, cfg4, m,
                                                            24),
             lambda: megakernel.render_megakernel(box, cam, cfg4, 24)),
            ("row 6 mis cornell_alcove_baffled", "megakernel_guided_mis",
             lambda m: megakernel.render_megakernel_guided_sharded(
                 alc, cam, cfg4, m, 24, g_alc, GUIDE_BETA, GUIDE_K),
             lambda: megakernel.render_megakernel_guided(
                 alc, cam, cfg4, 24, g_alc, GUIDE_BETA, GUIDE_K))):
        lbn.clear()
        parts = {c: fn(Mesh.single((2, 2), c)) for c in coords}
        n_sh = lbn[name]
        img = torch.cat([parts[(i, 0)][0] + parts[(i, 1)][0]
                         for i in range(2)]).reshape(height, width, 3)
        tr = sum(v[1] for v in parts.values())
        w_img, w_tr = want()
        err_ = float((img - w_img).abs().max())
        log(f"[smoke] {label} 2x2 shards: {n_sh} launches of {name}, traces "
            f"{tr.tolist()} (unsharded {w_tr.tolist()}), max |sum - "
            f"unsharded| {err_:.3e}")
        if not (n_sh == 4 and torch.equal(tr, w_tr) and torch.allclose(
                img, w_img, rtol=SHARD_RTOL, atol=SHARD_ATOL)):
            raise AssertionError(f"{label}: the shards' sum differs")

    phase("guided mis at 1024x768x512: cli render --guided --estimator mis "
          "(cornell_alcove_baffled, smallpt_original), row 5 through its "
          "wrapper, event times")
    for nm in ("cornell_alcove_baffled", "smallpt_original"):
        sc = sc_of[nm]
        cfg = cfg_of(mis, 512, 0)
        name = megakernel.guided_kernel_name(sc, cfg)
        rays, secs, text = run_path(f"cli render --guided {nm} mis",
                                    est_argv(mis) + ["--scene", nm,
                                                     "--guided"], name)
        g = guides[nm]
        ms, tr, _ = x512(f"guided mis {nm}", name, lambda: guided_fn(0)(
            sc, cam, cfg, 0, g, GUIDE_BETA, GUIDE_K), sc, "mis",
            guide_bytes(0))
        if sum(tr) != rays:
            raise AssertionError(f"guided mis {nm}: the CLI's table differs "
                                 "from train_guide's")
        log(f"[smoke] cli render --guided {nm} mis: 1 launch of {name}, "
            f"{rays} rays in {secs:.3f} s = {rays / secs / 1e6:.1f} Mrays/s")
        lbn.clear()
        p_name = megakernel.guided_kernel_name(sc, cfg, 1)
        fn = (lambda: guided_fn(1)(sc, cam, cfg, 0, g, GUIDE_BETA, GUIDE_K))
        img, _ = fn()
        if dict(lbn) != {p_name: 1} or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{p_name}: launches {dict(lbn)} or a "
                                 "non-finite image")
        main_launch[p_name] = 1
        x512(f"guided primary mis {nm}", p_name, fn, sc, "mis",
             guide_bytes(1))

    phase(f"guiding's clamped MSE, cornell_alcove_baffled mis 1024x768: "
          f"guided and unguided at {MSE_SPPS} spp, seeds {MSE_SEEDS}, against "
          f"unguided mis at {MSE_REF_SPP} spp")

    def clamped(img, spp):
        return torch.clamp(img / torch.tensor(float(spp), device="cuda"),
                           0.0, 1.0)

    ref = clamped(megakernel.render_megakernel(
        alc, cam, cfg_of(mis, MSE_REF_SPP, MSE_REF_SEED), MSE_REF_SEED)[0],
        MSE_REF_SPP)
    for spp in MSE_SPPS:
        mse = {"guided": [], "unguided": []}
        for seed in MSE_SEEDS:
            cfg = cfg_of(mis, spp, seed)
            for kind, img in (
                    ("guided", megakernel.render_megakernel_guided(
                        alc, cam, cfg, seed, g_alc, GUIDE_BETA, GUIDE_K)[0]),
                    ("unguided", megakernel.render_megakernel(
                        alc, cam, cfg, seed)[0])):
                mse[kind].append(float(
                    ((clamped(img, spp) - ref) ** 2).double().mean()))
        ratio = np.mean(mse["unguided"]) / np.mean(mse["guided"])
        log(f"[smoke] clamped MSE at {spp} spp against {MSE_REF_SPP} spp: "
            f"guided {np.mean(mse['guided']):.6e} {mse['guided']}, unguided "
            f"{np.mean(mse['unguided']):.6e} {mse['unguided']}; unguided / "
            f"guided {ratio:.4f} (the JAX package's TPU-era claim: 1.40)")
    # Equal time: MSE falls as 1 / spp, so the ratio at equal card time is
    # the equal-spp ratio times the unguided kernel's time over the guided
    # one's (x512 event times; the guide's pre-pass left out).
    cfg = cfg_of(mis, 512, 0)
    t_g = event_ms(lambda: megakernel.render_megakernel_guided(
        alc, cam, cfg, 0, g_alc, GUIDE_BETA, GUIDE_K), 3)
    t_u = event_ms(lambda: megakernel.render_megakernel(alc, cam, cfg, 0), 3)
    log(f"[smoke] cornell_alcove_baffled mis 1024x768x512: guided "
        f"{t_g:.3f} ms, unguided {t_u:.3f} ms (CUDA events) on {card}; the "
        f"{MSE_SPPS[-1]}-spp ratio at equal card time "
        f"{ratio * t_u / t_g:.4f}")

    def entry(name, source, replaces):
        r = par[name]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": "small_pathtracer_tpu/ops/" + replaces,
                "launches": main_launch[name], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None}

    out = []
    for label, fields in BUDGET_CASES.items():
        est = fields["estimator"]
        for nm, src, what in (("cornell_box", "megakernel_est.cu", ""),
                              ("sphere_grid", "megakernel_est.cu",
                               "sphere_tab, ")):
            cfg = cfg_of(fields, 4, 0)
            if label in EST_CASES:
                out.append(entry(megakernel.kernel_name(sc_of[nm], cfg), src,
                                 f"megakernel.py:1203 ({what}{label}, call "
                                 ":2670)"))
            out.append(entry(megakernel.kernel_name(sc_of[nm], cfg,
                                                    "_budgets"),
                             "megakernel_budgets.cu",
                             f"megakernel.py:2783 ({what}{label})"))
    for nm, what in (("cornell_alcove_baffled", ""),
                     ("smallpt_original", "sphere scenes, ")):
        for primary, site in ((0, "2972"), (1, "3111")):
            out.append(entry(megakernel.guided_kernel_name(
                sc_of[nm], cfg_mis, primary), "megakernel_guided.cu",
                f"megakernel.py:{site} ({what}mis)"))
    return out


# Item 11's forward half (ext_phases): the scenes of the _ext instances.
# The presets: cornell_tilted_light (16 rects, the light a quad; the
# linear scan of an empty sphere table) and cornell_glossy (a GLOS sphere,
# exponent 60; the linear scan). Their tree instances run on
# cornell_tilted_light with sphere_grid's 64 spheres (ids after the quad),
# sphere 0 GLOS (exponent 20) for the estimators with glossy semantics.
EXT_CASES = {"nee": {"estimator": "nee"}, **BUDGET_CASES}
GLOS_CASES = ("cosine", "nee_textbook", "mis")
EXT_TREE_GLOSS = 20.0


def glos_vertices(run_plain) -> int:
    """The GLOS vertices (live lanes whose hit is GLOS) of a run of the
    plain version, counted by a spy around wavefront._bounce_core that
    shades each bounce's rays once more."""
    from small_pathtracer_tpu_torch.geometry.intersect import (
        shade_info, trace,
    )
    from small_pathtracer_tpu_torch.integrator import wavefront as wf
    from small_pathtracer_tpu_torch.scene.types import GLOS

    n = [0]
    orig = wf._bounce_core

    def spy(scene, cfg, seed, o, d, T, alive, *args, **kw):
        sh = shade_info(scene, o, d, trace(scene, o, d))
        n[0] += int((alive & (sh.refl == GLOS)).sum())
        return orig(scene, cfg, seed, o, d, T, alive, *args, **kw)

    wf._bounce_core = spy
    try:
        run_plain()
    finally:
        wf._bounce_core = orig
    return n[0]


def ext_scenes() -> dict:
    """The scenes of the quad and GLOS phases: cornell_tilted_light
    (linear scan), cornell_glossy, and the tilted light with sphere_grid's
    spheres (the tree), plain (``tree``) and with its sphere 0 GLOS
    EXT_TREE_GLOSS (``tree_g``, for the GLOS estimators)."""
    from small_pathtracer_tpu_torch import get_scene
    from small_pathtracer_tpu_torch.scene.types import GLOS

    tilted, glossy = (get_scene(n) for n in ("cornell_tilted_light",
                                            "cornell_glossy"))
    grid = get_scene("sphere_grid").spheres
    refl = grid.refl.clone()
    refl[0] = GLOS
    return {"cornell_tilted_light": tilted, "cornell_glossy": glossy,
            "tree": tilted._replace(spheres=grid),
            "tree_g": tilted._replace(spheres=grid._replace(
                refl=refl,
                gloss=torch.where(refl == GLOS, EXT_TREE_GLOSS, 0.0)))}


def ext_cases():
    """(label, RenderConfig fields, scene name) of every _ext instance's
    parity runs: each code of EXT_CASES on cornell_tilted_light and on the
    tree scene (tree_g for the GLOS estimators), the GLOS estimators on
    cornell_glossy too."""
    for label, fields in EXT_CASES.items():
        glos = label in GLOS_CASES
        yield label, fields, "cornell_tilted_light"
        if glos:
            yield label, fields, "cornell_glossy"
        yield label, fields, "tree_g" if glos else "tree"


def ext_phases(card: str, cli_main) -> tuple[list, dict, dict]:
    """ROADMAP item 11's forward half: rows 1-7 with general quads and GLOS
    materials (the _ext instances of csrc/megakernel_ext*.cu). Each
    instance bit for bit against its plain version (kernel, plain, kernel)
    at 1024x768x4, paths stopped at PARITY_BOUNCES: rows 1 and 2 of every
    estimator on cornell_tilted_light (linear) and on the tree scene
    (EXT_CASES), the three GLOS estimators also on cornell_glossy; row 3
    on ragged spans (75% empty) of both; rows 4 and 5 (cosine,
    nee_textbook, mis) on both with a table trained on the tilted light.
    Then, with the launch counts cleared before each path and read after,
    at 1024x768x512: the main paths ``cli render --scene
    cornell_tilted_light`` and ``--scene cornell_glossy --estimator mis``,
    the refusal of ``nee`` on the glossy scene, ``cli render`` of every
    other case on the presets, ``--adaptive-tol 0 --adaptive-wave 256`` of
    each (the uniform render's traces) and ``--guided``; rows 7 and 6 with
    mis on each shard of a 2x2 mesh at x4 against the unsharded kernel; and
    each instance's x512 event time and bound (on cornell_glossy with the
    GLOS lobe of the x4 parity run's GLOS vertices times 128, an
    estimate). Returns (the ``kernels`` entries, the rows 1 and 2 parity
    runs {(kernel name, scene name): numbers}, and the GLOS vertices of
    cornell_glossy's x4 parity run {label: count})."""
    from small_pathtracer_tpu_torch import RenderConfig, make_camera
    from small_pathtracer_tpu_torch.experiment import path_guiding as pg
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    lbn = megakernel.LAUNCHES
    width, height = 1024, 768
    n_pix = width * height
    cam = make_camera(aspect=width / height)
    scenes = ext_scenes()
    tilted, glossy = scenes["cornell_tilted_light"], scenes["cornell_glossy"]
    tree, tree_g = scenes["tree"], scenes["tree_g"]
    base = ["render", "--width", "1024", "--height", "768", "--spp", "512"]

    def cfg_of(fields, spp, seed, **kw):
        return RenderConfig(width=width, height=height, spp=spp, seed=seed,
                            **fields, **kw)

    def f_bound(sc, tr, n_samples, n_lanes, est, extra_bytes=0, n_glos=0):
        g = FP_GLOS + (FP_GLOS_NEE if est in GLOS_CASES[1:] else 0) + (
            FP_GLOS_MIS if est == "mis" else 0)
        return forward_bound(tr, n_samples, n_lanes, sc.rects.k.shape[0],
                             sc.spheres.radius.shape[0], extra_bytes, est,
                             False, n_quads=sc.quads.corner.shape[0],
                             extra_fp=n_glos * g)

    parity = kernel_parity
    par = {}  # kernel name -> its reported parity run (the tilted light's)
    runs12 = {}  # (kernel name, scene name) -> its parity run
    glos_x4 = {}  # label -> GLOS vertices of cornell_glossy's parity run
    phase("rows 1 and 2 with quads and GLOS (_ext) against their plain "
          "version 1024x768x4: cornell_tilted_light, cornell_glossy "
          "(linear), the tilted light with sphere_grid's spheres (tree)")
    for label, fields, nm in ext_cases():
        sc = scenes[nm]
        cfg = cfg_of(fields, 4, 31, max_bounces=PARITY_BOUNCES)
        name = megakernel.kernel_name(sc, cfg)
        r = parity(
            f"{label} {nm} 1024x768x4 seed 31", name,
            lambda: megakernel.render_megakernel(sc, cam, cfg, 31),
            lambda: megakernel.render_megakernel_plain(sc, cam, cfg, 31),
            lambda tr, n_g=0: f_bound(sc, tr, n_pix * 4, n_pix,
                                    fields["estimator"], n_glos=n_g),
            nm == "cornell_glossy")
        par.setdefault(name, r)
        runs12[(name, nm)] = r
        if nm == "cornell_glossy":
            glos_x4[label] = r["n_glos"]

    phase("row 3 with quads and GLOS (_ext_budgets) against its plain "
          "version, 1024x768 ragged spans: cornell_tilted_light (linear), "
          "the tree scene")
    for label, fields in EXT_CASES.items():
        glos = label in GLOS_CASES
        for i, (nm, sc) in enumerate((("cornell_tilted_light", tilted),
                                      ("tree", tree_g if glos else tree))):
            cfg = cfg_of(fields, 64, 32 + i, max_bounces=PARITY_BOUNCES)
            a, b_ = ragged_spans(n_pix, 4, 3, 32 + i, empty=0.75)
            name = megakernel.kernel_name(sc, cfg, "_budgets")
            n_samples = int((b_ - a).sum())
            r = parity(
                f"budgets {label} {nm} spans [0,4) + [0,3]", name,
                lambda: megakernel.render_megakernel_budgets(
                    sc, cam, cfg, 32 + i, a, b_),
                lambda: megakernel.render_megakernel_budgets_plain(
                    sc, cam, cfg, 32 + i, a, b_),
                lambda tr, n_g=0: f_bound(sc, tr, n_samples, n_pix,
                                        fields["estimator"], 2 * 4 * n_pix,
                                        n_g))
            par.setdefault(name, r)

    phase("rows 4 and 5 with quads (_ext) against their plain version "
          "1024x768x4: cornell_tilted_light (linear), the tree scene")
    tcfg = RenderConfig(width=128, height=96, spp=16, seed=1)
    g_tl = pg.guide_lobes(pg.train_guide(tilted, cam, tcfg, 8, 1))
    guided = {0: (megakernel.render_megakernel_guided,
                  megakernel.render_megakernel_guided_plain),
              1: (megakernel.render_megakernel_guided_primary,
                  megakernel.render_megakernel_guided_primary_plain)}
    for label in GLOS_CASES:
        fields = EXT_CASES[label]
        for nm, sc in (("cornell_tilted_light", tilted), ("tree", tree)):
            cfg = cfg_of(fields, 4, 33, sphere_table="off",
                         max_bounces=PARITY_BOUNCES)
            for primary, (k_fn, p_fn) in guided.items():
                name = megakernel.guided_kernel_name(sc, cfg, primary)
                r = parity(
                    f"row {4 + primary} {label} {nm} 1024x768x4 seed 33",
                    name,
                    lambda: k_fn(sc, cam, cfg, 33, g_tl, GUIDE_BETA, GUIDE_K),
                    lambda: p_fn(sc, cam, cfg, 33, g_tl, GUIDE_BETA, GUIDE_K),
                    lambda tr, n_g=0: f_bound(
                        sc, tr, n_pix * 4, n_pix, fields["estimator"],
                        (n_pix if primary else pg.N_VOXELS) * 4))
                par.setdefault(name, r)

    main_launch = {}  # kernel name -> launches in its path's run

    def run_path(label, argv, name, n_expect=1):
        lbn.clear()
        with tempfile.TemporaryDirectory() as tmp:
            text = cli_stderr(cli_main, base + argv + [
                "-o", os.path.join(tmp, "out.png")])
        counts = dict(lbn)
        if counts != {name: n_expect}:
            raise AssertionError(f"{label} launched {counts}, expected "
                                 f"{name} x{n_expect}")
        main_launch.setdefault(name, n_expect)
        return cli_traces(text)

    def x512(label, name, fn, sc, est, extra_bytes=0):
        tr = fn()[1].tolist()
        ms = event_ms(fn, 3)
        n_g = 128 * glos_x4.get(est, 0) if sc is glossy else 0
        b = f_bound(sc, tr, n_pix * 512, n_pix, est, extra_bytes, n_g)
        lobe = (f"the GLOS lobe at {n_g} vertices: the x4 parity run's "
                "count x 128, estimated" if n_g else "no GLOS lobe counted")
        log(f"[smoke] {label} 1024x768x512 seed 0: {name} {ms:.3f} ms a "
            f"launch (CUDA events), traces {tr}; bound {b[0]:.3f} ms "
            f"({b[1]}, {lobe}) on {card}")
        return ms, tr

    phase("main paths: cli render --scene cornell_tilted_light, --scene "
          "cornell_glossy --estimator mis 1024x768x512; nee refused on "
          "cornell_glossy")
    uniform_tr = {}
    for nm, sc, label in (("cornell_tilted_light", tilted, "nee"),
                          ("cornell_glossy", glossy, "mis")):
        fields = EXT_CASES[label]
        argv = ["--scene", nm] + (est_argv(fields) if label != "nee" else [])
        cfg = cfg_of(fields, 512, 0)
        name = megakernel.kernel_name(sc, cfg)
        rays, secs = run_path(f"cli render {' '.join(argv)}", argv, name)
        ms, tr = x512(f"{label} {nm}", name,
                      lambda: megakernel.render_megakernel(sc, cam, cfg, 0),
                      sc, label)
        if sum(tr) != rays:
            raise AssertionError(f"{nm}: cli render's traces differ")
        uniform_tr[(label, nm)] = tr
        log(f"[smoke] main path cli render {' '.join(argv)}: 1 launch of "
            f"{name}, {rays} rays in {secs:.3f} s = "
            f"{rays / secs / 1e6:.1f} Mrays/s wall on {card}; kernel "
            f"{ms:.3f} ms = {rays / ms / 1e3:.1f} Mrays/s")
    lbn.clear()
    try:
        cli_stderr(cli_main, base[:1] + ["--scene", "cornell_glossy",
                                         "--width", "64", "--height", "48",
                                         "--spp", "4", "-o", os.devnull])
    except ValueError as exc:
        if "glossy" not in str(exc) or dict(lbn):
            raise
        log(f"[smoke] cli render --scene cornell_glossy (nee) refused: {exc}")
    else:
        raise AssertionError("cli render of cornell_glossy with nee ran")

    phase("rows 1-3 with quads and GLOS at 1024x768x512: cli render of "
          "every other case on the presets, --adaptive-tol 0 "
          "--adaptive-wave 256 of each on cornell_tilted_light, event times")
    for label, fields in EXT_CASES.items():
        for nm, sc in (("cornell_tilted_light", tilted),
                       ("cornell_glossy", glossy)):
            if (nm == "cornell_glossy" and label not in GLOS_CASES) or (
                    (label, nm) in uniform_tr):
                continue
            cfg = cfg_of(fields, 512, 0)
            name = megakernel.kernel_name(sc, cfg)
            rays, _ = run_path(f"cli render {nm} {label}",
                               est_argv(fields) + ["--scene", nm], name)
            _, tr = x512(f"{label} {nm}", name,
                         lambda: megakernel.render_megakernel(sc, cam, cfg,
                                                              0),
                         sc, fields["estimator"])
            if sum(tr) != rays:
                raise AssertionError(f"{label} {nm}: cli traces differ")
            uniform_tr[(label, nm)] = tr
        name = megakernel.kernel_name(tilted, cfg_of(fields, 512, 0),
                                      "_budgets")
        rays, _ = run_path(f"adaptive tol 0 {label} cornell_tilted_light",
                           est_argv(fields) + [
                               "--scene", "cornell_tilted_light",
                               "--adaptive-tol", "0", "--adaptive-wave",
                               "256"], name, 2)
        if rays != sum(uniform_tr[(label, "cornell_tilted_light")]):
            raise AssertionError(f"adaptive tol 0 {label}: traces {rays}")
        wave = megakernel.budget_waves(tilted, cam, cfg_of(fields, 512, 0))
        a0 = torch.zeros(n_pix, dtype=torch.int32, device="cuda")
        b0 = torch.full((n_pix,), 512, dtype=torch.int32, device="cuda")
        live = torch.arange(n_pix, dtype=torch.int32, device="cuda")
        _, tr = x512(f"budgets {label} cornell_tilted_light, every span "
                     "x512", name, lambda: wave(0, a0, b0, live), tilted,
                     fields["estimator"], 2 * 4 * n_pix)
        if tr != uniform_tr[(label, "cornell_tilted_light")]:
            raise AssertionError(f"budgets {label}: full spans' traces {tr}")

    phase("rows 4 and 5 with quads at 1024x768x512: cli render --guided "
          "--scene cornell_tilted_light (cosine, nee_textbook, mis), row 5 "
          "through its wrapper, event times")
    for label in GLOS_CASES:
        fields = EXT_CASES[label]
        cfg = cfg_of(fields, 512, 0)
        name = megakernel.guided_kernel_name(tilted, cfg)
        rays, secs = run_path(f"cli render --guided {label}",
                              est_argv(fields) + [
                                  "--scene", "cornell_tilted_light",
                                  "--guided"], name)
        log(f"[smoke] cli render --guided cornell_tilted_light {label}: 1 "
            f"launch of {name}, {rays} rays in {secs:.3f} s")
        for primary, (k_fn, _) in guided.items():
            name = megakernel.guided_kernel_name(tilted, cfg, primary)
            fn = (lambda: k_fn(tilted, cam, cfg, 0, g_tl, GUIDE_BETA,
                               GUIDE_K))
            if primary:
                lbn.clear()
                img, _ = fn()
                if dict(lbn) != {name: 1} or not bool(
                        torch.isfinite(img).all()):
                    raise AssertionError(f"{name}: launches {dict(lbn)} or a "
                                         "non-finite image")
                main_launch.setdefault(name, 1)
            x512(f"guided {label}", name, fn, tilted, fields["estimator"],
                 (n_pix if primary else pg.N_VOXELS) * 4)

    phase("rows 7 and 6 with quads: mis on each shard of a 2x2 mesh at "
          "1024x768x4 against the unsharded kernel")
    coords = [(i, j) for i in range(2) for j in range(2)]
    cfg4 = cfg_of(EXT_CASES["mis"], 4, 34, sphere_table="off")
    for label, name, fn, want in (
            ("row 7 mis cornell_tilted_light", "megakernel_mis_ext",
             lambda m: megakernel.render_megakernel_sharded(
                 tilted, cam, cfg4, m, 34),
             lambda: megakernel.render_megakernel(tilted, cam, cfg4, 34)),
            ("row 6 mis cornell_tilted_light", "megakernel_guided_mis_ext",
             lambda m: megakernel.render_megakernel_guided_sharded(
                 tilted, cam, cfg4, m, 34, g_tl, GUIDE_BETA, GUIDE_K),
             lambda: megakernel.render_megakernel_guided(
                 tilted, cam, cfg4, 34, g_tl, GUIDE_BETA, GUIDE_K))):
        lbn.clear()
        parts = {c: fn(Mesh.single((2, 2), c)) for c in coords}
        n_sh = lbn[name]
        img = torch.cat([parts[(i, 0)][0] + parts[(i, 1)][0]
                         for i in range(2)]).reshape(height, width, 3)
        tr = sum(v[1] for v in parts.values())
        w_img, w_tr = want()
        err_ = float((img - w_img).abs().max())
        log(f"[smoke] {label} 2x2 shards: {n_sh} launches of {name}, traces "
            f"{tr.tolist()} (unsharded {w_tr.tolist()}), max |sum - "
            f"unsharded| {err_:.3e}")
        if not (n_sh == 4 and torch.equal(tr, w_tr) and torch.allclose(
                img, w_img, rtol=SHARD_RTOL, atol=SHARD_ATOL)):
            raise AssertionError(f"{label}: the shards' sum differs")

    def entry(name, source, replaces):
        r = par[name]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": "small_pathtracer_tpu/ops/" + replaces,
                "launches": main_launch[name], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None}

    out = []
    for label, fields in EXT_CASES.items():
        what = "quads and GLOS" if label in GLOS_CASES else "quads"
        cfg = cfg_of(fields, 4, 0)
        out.append(entry(megakernel.kernel_name(tilted, cfg),
                         "megakernel_ext.cu",
                         f"megakernel.py:1203 ({what}, {label}, call :2670)"))
        out.append(entry(megakernel.kernel_name(tilted, cfg, "_budgets"),
                         "megakernel_ext_budgets.cu",
                         f"megakernel.py:2783 ({what}, {label})"))
    for label in ("cosine", "mis"):
        cfg = cfg_of(EXT_CASES[label], 4, 0)
        for primary, site in ((0, "2972"), (1, "3111")):
            out.append(entry(megakernel.guided_kernel_name(tilted, cfg,
                                                           primary),
                             "megakernel_ext_guided.cu",
                             f"megakernel.py:{site} (quads, {label})"))
    return out, runs12, glos_x4


# Rows 8, 9 and 10 with quads and GLOS (mat_ext_phases). Row 9 is held at
# MAT_EXT_SIZE9 x4 (autograd through the plain version keeps every
# bounce's temporaries); the main path is ``cli fit --scene cornell_glossy
# --estimator mis --train emission --lr MIS_FIT_LR``, then an albedo fit of
# the same scene (ALBEDO_FIT_STEPS at ALBEDO_FIT_LR: mis's light-albedo
# row is knife-edge 1/t^2 noise, so an albedo step diverges at every rate,
# MAT_EST's comment; the path must run and count its launches),
# ``fit_megakernel`` on cornell_tilted_light with nee at TILT_FIT_LR
# against a target rendered at the fit's seed with the light quad's
# emission x1.5 (so the loss is a quadratic in that row: on the CPU at
# 32x24x16 lr 3 moved it 12 -> 15.5 in 5 steps, lr 1 to 13.5), and a
# 1-step ``cli fit --train emission`` of each other code on the tilted
# light.
MAT_EXT_SIZE9 = (128, 96)
ALBEDO_FIT_STEPS, ALBEDO_FIT_LR = 2, "0.01"
TILT_FIT_LR = 2.0


def mat_ext_phases(card: str, cli_main, runs12: dict,
                   glos_x4: dict) -> list:
    """ROADMAP item 11's material half: rows 8, 9 and 10 with general quads
    and GLOS materials. Row 8 on an _ext scene is the _ext forward kernel
    launched with the runtime tables (megakernel_<est>_mat_ext): each
    instance with the scene's own tables bit for bit against the forward
    _ext kernel (image and traces) on the inputs of ext_phases' parity runs
    (``runs12``: the forward there is bit for bit its plain version on the
    same inputs, so the entry's plain_ms and bound are that run's), and
    mis on cornell_glossy with perturbed tables against its plain version.
    Row 9 (megakernel_vjp[_<est>]_ext, csrc/megakernel_grad_ext.cu): each
    instance against autograd through its plain version (one plain run a
    case) and against itself at MAT_EXT_SIZE9 x4, paths stopped at
    PARITY_BOUNCES: every code on cornell_tilted_light and on the tree
    scene, the GLOS codes on cornell_glossy; mis on cornell_glossy and
    cosine on the tilted light on DEEP_BOUNCES-bounce paths. Row 10: mis on
    cornell_glossy on each coordinate of a 2x2 mesh, the shards' sums
    against the unsharded kernels. Then the main paths at 1024x768x512
    (launches counted: MAT_EXT_SIZE9's comment) and each instance's x512
    event time and bound (the GLOS lobe on cornell_glossy from ext_phases'
    x4 GLOS vertices ``glos_x4`` times 128, an estimate). Returns the
    ``kernels`` entries."""
    from small_pathtracer_tpu_torch import RenderConfig, make_camera
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    lbn = megakernel.LAUNCHES
    scenes = ext_scenes()
    tilted, glossy = scenes["cornell_tilted_light"], scenes["cornell_glossy"]
    width, height = 1024, 768
    n_pix = width * height
    cam = make_camera(aspect=width / height)

    def cfg_of(fields, w, h, spp, seed, **kw):
        return RenderConfig(width=w, height=h, spp=spp, seed=seed, **fields,
                            **kw)

    def sizes(sc):
        return (sc.rects.k.shape[0], sc.quads.corner.shape[0],
                sc.spheres.radius.shape[0])

    def glos_fp(est, n_glos):
        return n_glos * (FP_GLOS + (FP_GLOS_NEE if est != "cosine" else 0)
                         + (FP_GLOS_MIS if est == "mis" else 0))

    def f_bound(sc, tr, n_samples, n_lanes, est, n_glos=0):
        R, Q, S = sizes(sc)
        return forward_bound(tr, n_samples, n_lanes, R, S, 0, est, False,
                             n_quads=Q, extra_fp=glos_fp(est, n_glos))

    def v_bound(sc, tr, n_samples, n_pix_, est, n_glos=0):
        R, Q, S = sizes(sc)
        return vjp_bound(tr, n_samples, n_pix_, R + Q + S, False, S, est,
                         False, Q, glos_fp(est, n_glos))

    par8, par9 = {}, {}  # kernel name -> its reported run (tilted light's)
    phase("row 8 with quads and GLOS (_mat_ext): each instance with the "
          "scene's tables bit for bit against the forward _ext kernel, "
          "1024x768x4 seed 31 (ext_phases' parity inputs); mis on "
          "cornell_glossy with perturbed tables against its plain version "
          "256x192x4")
    for label, fields, nm in ext_cases():
        sc = scenes[nm]
        cfg = cfg_of(fields, width, height, 4, 31, max_bounces=PARITY_BOUNCES)
        alb, emi = mg.pack_materials(sc)
        name = mg.mat_kernel_name(sc, cfg)
        fwd = megakernel.kernel_name(sc, cfg)
        before = lbn[name]
        outs, med = in_turns(
            {"mat": lambda: mg.render_megakernel_mat(sc, cam, cfg, alb, emi,
                                                     31),
             "fwd": lambda: megakernel.render_megakernel(sc, cam, cfg, 31)},
            ("mat", "fwd", "mat", "mat"))
        if lbn[name] != before + 3:
            raise AssertionError(f"row 8 {label} {nm}: {name} did not count "
                                 "3 launches")
        (m1, t1), (m2, t2), _ = outs["mat"]
        f_img, f_tr = outs["fwd"][0]
        same = all(torch.equal(a, b_) for a, b_ in (
            (m1, m2), (t1, t2), (m1, f_img), (t1, f_tr)))
        log(f"[smoke] row 8 {label} {nm} 1024x768x4: {name} "
            f"{med['mat'] * 1e3:.3f} ms, {fwd} {med['fwd'] * 1e3:.3f} ms, "
            f"traces {t1.tolist()}; == the forward bit for bit: {same}")
        if not same:
            raise AssertionError(f"row 8 {label} {nm}: {name} and {fwd} "
                                 "differ")
        r = runs12[(fwd, nm)]
        par8.setdefault(name, {"err": r["err"], "ms": med["mat"] * 1e3,
                               "plain_ms": r["plain_ms"],
                               "bound": r["bound"]})
    cfg = cfg_of(EXT_CASES["mis"], 256, 192, 4, 35,
                 max_bounces=PARITY_BOUNCES)
    cam_p = make_camera(aspect=256 / 192)
    alb, emi = mg.pack_materials(glossy)
    gen = torch.Generator(device="cuda").manual_seed(35)
    light = int(glossy.light.light_obj_id)
    alb = (alb * (0.8 + 0.2 * torch.rand(alb.shape, generator=gen,
                                         device="cuda"))).contiguous()
    alb[light] = 0.0  # the light stays black (its underside probes)
    emi = emi.clone()
    emi[light] *= 1.25
    (k_img, k_tr), k_s = timed(lambda: mg.render_megakernel_mat(
        glossy, cam_p, cfg, alb, emi, 35))
    (p_img, p_tr), p_s = timed(lambda: mg.render_megakernel_mat_plain(
        glossy, cam_p, cfg, alb, emi, 35))
    log(f"[smoke] row 8 mis cornell_glossy 256x192x4, perturbed tables: "
        f"kernel {k_s * 1e3:.3f} ms, plain {p_s * 1e3:.3f} ms, traces "
        f"{k_tr.tolist()} / {p_tr.tolist()}, max |diff| "
        f"{float((k_img - p_img).abs().max()):.3e}")
    if not (torch.equal(k_img, p_img) and torch.equal(k_tr, p_tr)):
        raise AssertionError("row 8 mis cornell_glossy, perturbed tables: "
                             "kernel and plain version differ")

    w9, h9 = MAT_EXT_SIZE9
    cam_v = make_camera(aspect=w9 / h9)
    g9 = cotangent_image(h9, w9, 5)
    phase(f"row 9 with quads and GLOS (_ext) against autograd through its "
          f"plain version and against itself, {w9}x{h9}x4 seed 17, "
          "cornell_tilted_light and the tree scene (every code), "
          "cornell_glossy (the GLOS codes)")
    for label, fields, nm in ext_cases():
        sc = scenes[nm]
        cfg = cfg_of(fields, w9, h9, 4, 17, max_bounces=PARITY_BOUNCES)
        alb, emi = mg.pack_materials(sc)
        name = mg.vjp_kernel_name(sc, cfg)
        before = lbn[name]
        torch.cuda.reset_peak_memory_stats()
        outs, med = in_turns(
            {"kernel": lambda: mg.render_megakernel_vjp(sc, cam_v, cfg, alb,
                                                        emi, 17, g9),
             "plain": lambda: mg.render_megakernel_vjp_plain(
                 sc, cam_v, cfg, alb, emi, 17, g9)},
            ("kernel", "plain", "kernel", "kernel"))
        peak = torch.cuda.max_memory_allocated()
        if lbn[name] != before + 3:
            raise AssertionError(f"row 9 {label} {nm}: {name} did not count "
                                 "3 launches")
        (ka, ke), (ka2, ke2), _ = outs["kernel"]
        if not (torch.equal(ka, ka2) and torch.equal(ke, ke2)):
            raise AssertionError(f"row 9 {label} {nm}: kernel runs differ")
        pa, pe = outs["plain"][0]
        lid = int(sc.light.light_obj_id)
        r_a = held_tables(f"row 9 {label} {nm} d/d albedo", ka, pa, lid)
        r_e = held_tables(f"row 9 {label} {nm} d/d emission", ke, pe, lid)
        tr = megakernel.render_megakernel(sc, cam_v, cfg, 17)[1].tolist()
        n_g = (glos_vertices(lambda: megakernel.render_megakernel_plain(
            sc, cam_v, cfg, 17)) if label in GLOS_CASES and nm != "tree"
            else 0)
        b = v_bound(sc, tr, w9 * h9 * 4, w9 * h9, cfg.estimator, n_g)
        err = max(float((ka - pa).abs().max()), float((ke - pe).abs().max()))
        log(f"[smoke] row 9 {label} {nm} {w9}x{h9}x4: {name} "
            f"{med['kernel'] * 1e3:.3f} ms, plain {med['plain'] * 1e3:.3f} ms"
            f" (peak memory {peak / 2**30:.2f} GiB); d/d albedo within "
            f"{r_a:.3e}, d/d emission within {r_e:.3e} of the largest entry "
            f"(limit {VJP_TOL:g}, also without the light's row {lid}); two "
            f"runs bit-identical; traces {tr}, GLOS vertices {n_g}, bound "
            f"{b[0]:.3f} ms ({b[1]})")
        par9.setdefault(name, {"err": err, "ms": med["kernel"] * 1e3,
                               "plain_ms": med["plain"] * 1e3, "bound": b})

    phase(f"row 9 with quads and GLOS on deep paths: mis on cornell_glossy "
          f"and cosine on cornell_tilted_light, rr_start_depth = max_bounces "
          f"= {DEEP_BOUNCES}, every albedo {DEEP_ALBEDO} but the light's "
          "(black), 64x48x4")
    cam_d = make_camera(aspect=64 / 48)
    g_d = cotangent_image(48, 64, 5)
    for nm, label in (("cornell_glossy", "mis"),
                      ("cornell_tilted_light", "cosine")):
        sc = scenes[nm]
        lid = int(sc.light.light_obj_id)
        alb, emi = mg.pack_materials(sc)
        alb = torch.full_like(alb, DEEP_ALBEDO)
        alb[lid] = 0.0
        cfg = cfg_of(EXT_CASES[label], 64, 48, 4, 3,
                     rr_start_depth=DEEP_BOUNCES, max_bounces=DEEP_BOUNCES)
        ka, ke = mg.render_megakernel_vjp(sc, cam_d, cfg, alb, emi, 3, g_d)
        ka2, ke2 = mg.render_megakernel_vjp(sc, cam_d, cfg, alb, emi, 3, g_d)
        pa, pe = mg.render_megakernel_vjp_plain(sc, cam_d, cfg, alb, emi, 3,
                                                g_d)
        if not (torch.equal(ka, ka2) and torch.equal(ke, ke2)):
            raise AssertionError(f"deep row 9 {label} {nm}: kernel runs "
                                 "differ")
        r_a = held_tables(f"deep row 9 {label} {nm} d/d albedo", ka, pa, lid)
        r_e = held_tables(f"deep row 9 {label} {nm} d/d emission", ke, pe,
                          lid)
        tr = mg.render_megakernel_mat(sc, cam_d, cfg, alb, emi, 3)[1].tolist()
        log(f"[smoke] deep row 9 {label} {nm}: traces {tr} "
            f"({tr[0] / (64 * 48 * 4):.1f} bounces a sample); d/d albedo "
            f"within {r_a:.3e}, d/d emission within {r_e:.3e} of autograd's "
            "largest entry; runs bit-identical")

    phase(f"row 10 with GLOS: mis on cornell_glossy on each shard of a 2x2 "
          f"mesh {w9}x{h9}x4, the shards' sums against the unsharded "
          "kernels")
    cfg = cfg_of(EXT_CASES["mis"], w9, h9, 4, 18)
    alb, emi = mg.pack_materials(glossy)
    g_rows = cotangent_image(h9, w9, 6).reshape(-1, 3)
    n_loc = w9 * h9 // 2
    lbn.clear()
    img_rows, tr_sum, ga_sum, ge_sum = [0, 0], 0, 0, 0
    for c in [(i, j) for i in range(2) for j in range(2)]:
        m = Mesh.single((2, 2), c)
        part, tr = mg.render_megakernel_mat_shard(glossy, cam_v, cfg, m, alb,
                                                  emi, 18)
        ga, ge = mg.render_megakernel_vjp_shard(
            glossy, cam_v, cfg, m, alb, emi, 18,
            g_rows[c[0] * n_loc:(c[0] + 1) * n_loc])
        img_rows[c[0]] = img_rows[c[0]] + part
        tr_sum, ga_sum, ge_sum = tr_sum + tr, ga_sum + ga, ge_sum + ge
    counts = dict(lbn)
    w_img, w_tr = mg.render_megakernel_mat(glossy, cam_v, cfg, alb, emi, 18)
    wa, we = mg.render_megakernel_vjp(glossy, cam_v, cfg, alb, emi, 18,
                                      g_rows.reshape(h9, w9, 3))
    img = torch.cat(img_rows).reshape(h9, w9, 3)
    d_img = float((img - w_img).abs().max())
    d_sum = max(float((ga_sum - wa).abs().max()) / float(wa.abs().max()),
                float((ge_sum - we).abs().max()) / float(we.abs().max()))
    log(f"[smoke] row 10 mis cornell_glossy 2x2 shards: launches {counts}; "
        f"traces summed {tr_sum.tolist()} (unsharded {w_tr.tolist()}), max "
        f"|image sum - unsharded| {d_img:.3e}, adjoint partials summed "
        f"within {d_sum:.3e} of the unsharded kernel's largest entry")
    if not (counts == {"megakernel_mis_mat_ext": 4,
                       "megakernel_vjp_mis_ext": 4}
            and torch.equal(tr_sum, w_tr)
            and torch.allclose(img, w_img, rtol=SHARD_RTOL, atol=SHARD_ATOL)
            and d_sum <= SHARD_RTOL):
        raise AssertionError("row 10 with GLOS: the shards' sums differ "
                             "from the unsharded kernels")

    main_launch = {}
    base = ["fit", "--width", "1024", "--height", "768", "--spp", "512"]

    def cli_fit(label, nm, fields, train, steps, lr, main=False):
        sc = scenes[nm]
        cfg = cfg_of(fields, width, height, 512, 0)
        argv = [*base, "--scene", nm, *est_argv(fields), "--steps",
                str(steps), "--train", train, "--lr", lr]
        out, err_io = io.StringIO(), io.StringIO()
        lbn.clear()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
                err_io):
            rc = cli_main(argv)
        counts = dict(lbn)
        text = err_io.getvalue()
        for line in text.strip().splitlines():
            log(f"[smoke] cli fit {label}: {line}")
        if rc != 0:
            raise AssertionError(f"cli fit {label} returned {rc}")
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        losses = [float(x) for x in re.findall(r"loss (\S+)", text)]
        m_name, v_name = mg.mat_kernel_name(sc, cfg), mg.vjp_kernel_name(
            sc, cfg)
        log(f"[smoke] {'main path ' if main else ''}cli fit {label}: "
            f"launches {counts}; losses {losses}; light emission "
            f"{res['light_emission']} on {card}")
        want = {m_name: steps, v_name: steps,
                megakernel.kernel_name(sc, cfg): 1}
        if counts != want:
            raise AssertionError(f"cli fit {label} launched {counts}, "
                                 f"expected {want}")
        if not (len(losses) == steps and np.isfinite(losses[0])):
            raise AssertionError(f"cli fit {label}: losses {losses}")
        if main and not (np.all(np.isfinite(losses))
                         and losses[-1] < losses[0]):
            raise AssertionError(f"the main path's loss did not fall: "
                                 f"{losses}")
        main_launch.setdefault(m_name, steps)
        main_launch.setdefault(v_name, steps)

    phase(f"main path: cli {' '.join(base)} --scene cornell_glossy "
          f"--estimator mis --train emission --lr {MIS_FIT_LR} --steps 5")
    cli_fit("cornell_glossy mis emission", "cornell_glossy",
            EXT_CASES["mis"], "emission", 5, MIS_FIT_LR, main=True)
    phase(f"path: cli fit --scene cornell_glossy --estimator mis --train "
          f"albedo --lr {ALBEDO_FIT_LR}, {ALBEDO_FIT_STEPS} steps")
    cli_fit("cornell_glossy mis albedo", "cornell_glossy", EXT_CASES["mis"],
            "albedo", ALBEDO_FIT_STEPS, ALBEDO_FIT_LR)

    phase(f"path: fit_megakernel on cornell_tilted_light nee 1024x768x512, "
          f"5 steps at lr {TILT_FIT_LR}, the target with the light quad's "
          "emission x1.5 at the fit's seed")
    cfg = cfg_of(EXT_CASES["nee"], width, height, 512, 0)
    lid = int(tilted.light.light_obj_id)
    q = lid - tilted.rects.k.shape[0]
    q_emi = tilted.quads.emission.clone()
    q_emi[q] *= 1.5
    bright = tilted._replace(quads=tilted.quads._replace(emission=q_emi))
    target = megakernel.render_megakernel(bright, cam, cfg, 0)[0] / cfg.spp
    e0 = float(mg.pack_materials(tilted)[1][lid].mean())
    lbn.clear()
    fitted, losses = mg.fit_megakernel(tilted, cam, cfg, target, steps=5,
                                       lr=TILT_FIT_LR,
                                       train_fields=("emission",), seed=0)
    counts = dict(lbn)
    e1 = float(mg.pack_materials(fitted)[1][lid].mean())
    log(f"[smoke] fit_megakernel cornell_tilted_light nee: launches "
        f"{counts}; losses {losses}; the light's emission row (object {lid},"
        f" a quad) {e0:.4f} -> {e1:.4f}, truth {1.5 * e0:.4f}")
    if counts != {"megakernel_nee_mat_ext": 5, "megakernel_vjp_ext": 5}:
        raise AssertionError(f"fit_megakernel on the tilted light launched "
                             f"{counts}")
    if not (losses[-1] < losses[0] and abs(e1 - 1.5 * e0) < 0.5 * e0):
        raise AssertionError("the tilted light's fit did not move its "
                             f"light toward the truth: {losses}, {e1}")
    main_launch.setdefault("megakernel_nee_mat_ext", 5)
    main_launch.setdefault("megakernel_vjp_ext", 5)

    phase("paths: a 1-step cli fit --train emission of each other code on "
          "cornell_tilted_light 1024x768x512")
    for label, fields in EXT_CASES.items():
        if label in ("nee", "mis"):
            continue
        cli_fit(f"cornell_tilted_light {label}", "cornell_tilted_light",
                fields, "emission", 1, "1")

    phase("rows 8 and 9 with quads and GLOS at 1024x768x512 seed 0: CUDA-"
          "event times of each instance on cornell_tilted_light, the GLOS "
          "codes on cornell_glossy too (1 launch each)")
    g = torch.full((height, width, 3), 1e-7, device="cuda")
    for label, fields, nm in ext_cases():
        if nm.startswith("tree"):
            continue
        sc = scenes[nm]
        cfg = cfg_of(fields, width, height, 512, 0)
        alb, emi = mg.pack_materials(sc)
        geom = megakernel.pack_geometry(sc, cam)
        tr = mg.render_megakernel_mat(sc, cam, cfg, alb, emi, 0,
                                      geometry=geom)[1].tolist()
        ms_m = event_ms(lambda: mg.render_megakernel_mat(
            sc, cam, cfg, alb, emi, 0, geometry=geom), 1)
        ms_v = event_ms(lambda: mg.render_megakernel_vjp(
            sc, cam, cfg, alb, emi, 0, g, geometry=geom), 1)
        n_g = 128 * glos_x4[label] if nm == "cornell_glossy" else 0
        b_m = f_bound(sc, tr, n_pix * 512, n_pix, cfg.estimator, n_g)
        b_v = v_bound(sc, tr, n_pix * 512, n_pix, cfg.estimator, n_g)
        lobe = (f"; GLOS lobe at {n_g} vertices, the x4 count x 128, "
                "estimated" if n_g else "")
        log(f"[smoke] {nm} {label} 1024x768x512 seed 0, traces {tr}: "
            f"{mg.mat_kernel_name(sc, cfg)} {ms_m:.3f} ms (bound "
            f"{b_m[0]:.3f} ms, {b_m[1]}), {mg.vjp_kernel_name(sc, cfg)} "
            f"{ms_v:.3f} ms (bound {b_v[0]:.3f} ms, {b_v[1]}) a launch "
            f"(CUDA events){lobe} on {card}")

    out = []
    for label, fields in EXT_CASES.items():
        what = "quads and GLOS" if label in GLOS_CASES else "quads"
        cfg = cfg_of(fields, 4, 4, 1, 0)
        for name, src, site, r in (
                (mg.mat_kernel_name(tilted, cfg), "megakernel_ext.cu", 980,
                 par8),
                (mg.vjp_kernel_name(tilted, cfg), "megakernel_grad_ext.cu",
                 1049, par9)):
            r = r[name]
            out.append({
                "name": name, "route": "cuda", "source": CSRC + src,
                "replaces": "small_pathtracer_tpu/ops/"
                            f"megakernel_grad.py:{site} ({what}, {label})",
                "launches": main_launch[name], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None})
    return out


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
    adjoints = ptxas_report(built.build_output,
                            ("megakernel_vjp", "megakernel_vjp_ext",
                             "megakernel_geom"))
    for name, (regs, stack, st, ld) in adjoints.items():
        log(f"[smoke] ptxas {name}: {regs} registers, {stack} bytes stack "
            f"frame (local memory: the tape and checkpoints), spill stores "
            f"{st} / loads {ld} bytes")

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
    vjp_b_alg = vjp_bound(traces_p, n_samp_p, n_pix_p, k_rects, True)
    log(f"[smoke] adjoint 1024x768x4: kernel {vjp_s * 1e3:.3f} ms, plain "
        f"{vjp_plain_s * 1e3:.3f} ms, peak memory {peak / 2**30:.2f} GiB; "
        f"three kernel runs bit-identical; bound {vjp_b[0]:.3f} ms "
        f"({vjp_b[1]}; this algorithm's {vjp_b_alg[0]:.3f} ms, "
        f"{vjp_b_alg[1]})")

    # Phase 5: the render path, as a user calls it.
    phase("main path, cli render 1024x768x512")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell_1024x768x512.ppm")
        err = io.StringIO()
        megakernel.LAUNCHES.clear()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["render", "--width", "1024", "--height", "768",
                           "--spp", "512", "--estimator", "nee", "-o", out])
        launches = megakernel.LAUNCHES["megakernel_nee"]
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
    megakernel.LAUNCHES.clear()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(fit_argv)
    fit_launches = {k: megakernel.LAUNCHES[k] for k in (
        "megakernel_nee", "megakernel_nee_mat", "megakernel_vjp")}
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
        alg = ""
        if name == "megakernel_vjp":
            b_alg = vjp_bound(tr_f, n_pix_f * 512, n_pix_f, k_rects, True)
            alg = f"; this algorithm's {b_alg[0]:.3f} ms ({b_alg[1]})"
        log(f"[smoke] 1024x768x512 seed 0, traces {tr_f}: {name} {ms:.3f} ms"
            f" a launch{share}; bound {f_bounds[name][0]:.3f} ms "
            f"({f_bounds[name][1]}){alg}")

    # Phase (d): the sphere-table kernel (its spheres through the tree)
    # against its plain version, bit for bit, in turns as in phase 4; and
    # its counting instance, for the tree's bound beside the linear scan's.
    def tab_parity(name, width, height, spp, seed,
                   order=("plain", "kernel", "kernel", "plain", "plain",
                          "kernel")):
        sc = get_scene(name)
        cam = make_camera(aspect=width / height)
        cfg = RenderConfig(width=width, height=height, spp=spp, seed=seed)
        before = megakernel.LAUNCHES["megakernel_nee_tab"]
        outs, med = in_turns(
            {"kernel": lambda: megakernel.render_megakernel(sc, cam, cfg,
                                                            seed),
             "plain": lambda: megakernel.render_megakernel_plain(
                 sc, cam, cfg, seed)},
            order)
        if (megakernel.LAUNCHES["megakernel_nee_tab"]
                != before + order.count("kernel")):
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
        b_lin, b_tree, scan = tab_bounds(sc, cam, cfg, seed, k_img, k_tr)
        log(f"[smoke] {name} {width}x{height}x{spp}: the tree's work "
            f"[node tests, rows tested, rows at the square root] {scan}; "
            f"bound: the linear scan's {b_lin[0]:.3f} ms ({b_lin[1]}), this "
            f"algorithm's {b_tree[0]:.3f} ms ({b_tree[1]})")
        return {"img": k_img / spp, "err": err_, "ms": med["kernel"] * 1e3,
                "plain_ms": med["plain"] * 1e3,
                "bound": min(b_lin, b_tree)}

    def tab_bounds(sc, cam, cfg, seed, k_img, k_tr):
        """The linear scan's bound and the tree's (from the counting
        instance, which must render megakernel_nee_tab's image and traces)
        of one megakernel_nee_tab launch."""
        c_img, counts = megakernel.render_megakernel_counted(sc, cam, cfg,
                                                             seed)
        counts = counts.tolist()
        if not (torch.equal(c_img, k_img) and counts[:2] == k_tr.tolist()):
            raise AssertionError("the counting instance differs from "
                                 "megakernel_nee_tab")
        n_pix = cfg.width * cfg.height
        args = (counts[:2], n_pix * cfg.spp, n_pix, sc.rects.k.shape[0],
                sc.spheres.radius.shape[0])
        return (forward_bound(*args), forward_bound(*args, scan=counts[2:]),
                counts[2:])

    phase("sphere-table kernel against its plain version, sphere_grid "
          "1024x768x4")
    tab = {"sphere_grid": tab_parity("sphere_grid", 1024, 768, 4, 4)}
    phase("sphere-table kernel against its plain version, sphere_grid_256 "
          "1024x768x4")
    tab["sphere_grid_256"] = tab_parity(
        "sphere_grid_256", 1024, 768, 4, 4,
        ("plain", "kernel", "kernel", "plain"))
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
    before = megakernel.LAUNCHES["megakernel_nee_tab"]
    img, tr = megakernel.render_megakernel(scene_s, cam_g, cfg_g, 42)
    if megakernel.LAUNCHES["megakernel_nee_tab"] != before + 1:
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
            megakernel.LAUNCHES.clear()
            with contextlib.redirect_stderr(err_):
                rc = cli_main(["render", "--scene", name, "--width", "1024",
                               "--height", "768", "--spp", spp, "-o", out])
            n_launch = megakernel.LAUNCHES["megakernel_nee_tab"]
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
    img_g, _ = megakernel.render_megakernel(scene_g, cam_f, cfg_f, 0)
    lin_512, tree_512, scan_512 = tab_bounds(scene_g, cam_f, cfg_f, 0, img_g,
                                             tr_g)
    log(f"[smoke] sphere_grid 1024x768x512 seed 0, traces {tr_g.tolist()}: "
        f"megakernel_nee_tab {tab_ms:.3f} ms a launch; the tree's work "
        f"{scan_512}; bound: the linear scan's {lin_512[0]:.3f} ms "
        f"({lin_512[1]}), this algorithm's {tree_512[0]:.3f} ms "
        f"({tree_512[1]})")
    # Phases (g)-(l): per-pixel budgets (row 3) and the rest of cli render.
    from small_pathtracer_tpu_torch.core import imageio
    from small_pathtracer_tpu_torch.utils import adaptive, checkpoint
    from small_pathtracer_tpu_torch.utils.aov import render_aovs
    from small_pathtracer_tpu_torch.utils.denoise import denoise

    def budgets_parity(name, spp, start_hi, len_hi, seed):
        """A budget kernel against its plain version on ragged spans where
        most pixels are empty (the kernel launches the live ones only), bit
        for bit, in turns (plain, kernel, kernel, plain)."""
        sc = get_scene(name)
        cfg = RenderConfig(width=1024, height=768, spp=spp, seed=seed)
        n_pix = cfg.width * cfg.height
        s_start, s_stop = ragged_spans(n_pix, start_hi, len_hi, seed,
                                       empty=0.75)
        counter = ("megakernel_nee_tab_budgets"
                   if megakernel.uses_sphere_table(sc)
                   else "megakernel_nee_budgets")
        before = megakernel.LAUNCHES[counter]
        outs, med = in_turns(
            {"kernel": lambda: megakernel.render_megakernel_budgets(
                sc, cam_f, cfg, seed, s_start, s_stop),
             "plain": lambda: megakernel.render_megakernel_budgets_plain(
                 sc, cam_f, cfg, seed, s_start, s_stop)},
            ("plain", "kernel", "kernel", "plain"))
        if megakernel.LAUNCHES[counter] != before + 2:
            raise AssertionError(f"{name}: the budgets wrapper did not "
                                 f"count 2 launches of {counter}")
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
        megakernel.LAUNCHES.clear()
        text = cli_stderr(cli_main, base + [
            "--adaptive-tol", "0", "--adaptive-wave", "64",
            "-o", os.path.join(tmp, "tol0.png")])
        n_launch = megakernel.LAUNCHES["megakernel_nee_budgets"]
        waves = int(re.search(r"\[adaptive\] (\d+) waves", text).group(1))
        tol0_traces, _ = cli_traces(text)
        log(f"[smoke] adaptive tol 0: {waves} waves, {n_launch} launches of "
            f"megakernel_nee_budgets, traces {tol0_traces} (uniform "
            f"{traces})")
        if not (waves == 8 and n_launch == waves and tol0_traces == traces):
            raise AssertionError("adaptive tol 0 differs from the uniform "
                                 "render")

        # tol 0.01, with each wave's spans, live list and wall time kept,
        # to time its kernel after (CUDA events around the launch alone).
        def adaptive_run(name):
            spans, stamps = [], []
            real = adaptive.budget_waves

            def keep(sc, cam, cfg):
                wave_fn = real(sc, cam, cfg)

                def wave(seed, s_start, s_stop, live):
                    stamps.append(time.perf_counter())
                    spans.append((s_start.clone(), s_stop.clone(),
                                  live.clone()))
                    return wave_fn(seed, s_start, s_stop, live)
                return wave

            megakernel.LAUNCHES.clear()
            adaptive.budget_waves = keep
            try:
                text_ = cli_stderr(cli_main, base + [
                    "--scene", name, "--adaptive-tol", "0.01",
                    "-o", os.path.join(tmp, f"{name}_adaptive.png")])
            finally:
                adaptive.budget_waves = real
            launches_ = {k: megakernel.LAUNCHES[k] for k in (
                "megakernel_nee_budgets", "megakernel_nee_tab_budgets")}
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
            wave_fn = real(sc, cam_f, cfg)
            wave_ms = [event_ms(lambda: wave_fn(0, a, b, lv), 3)
                       for a, b, lv in spans]
            active = [lv.numel() / (1024 * 768) for _, _, lv in spans]
            # A wave's wall time: from its call to the next wave's (its launch,
            # the statistics and the host read); the last one's is left out.
            wall_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(stamps, stamps[1:])]
            wall_ms.append(float("nan"))
            log(f"[smoke] adaptive {name} 1024x768x512 tol 0.01: {n_waves} "
                f"waves ({launches_[kernel]} launches of {kernel}), "
                f"{m_.group(2)} samples = {m_.group(3)}% of uniform, spp "
                f"{m_.group(4)}-{m_.group(5)}, {rays} rays in {secs:.3f} s = "
                f"{rays / secs / 1e6:.1f} Mrays/s on {card}")
            for i, (ms, share, wall) in enumerate(zip(wave_ms, active,
                                                      wall_ms)):
                log(f"[smoke] adaptive {name} wave {i + 1}: active "
                    f"{share:.1%}, card {ms:.3f} ms, wall {wall:.3f} ms, "
                    f"host {wall - ms:.3f} ms")
            return launches_[kernel]

        phase("cli render --adaptive-tol 0.01 cornell_box 1024x768x512")
        adaptive_launches = {"cornell_box": adaptive_run("cornell_box")}
        phase("cli render --adaptive-tol 0.01 sphere_grid 1024x768x512")
        adaptive_launches["sphere_grid"] = adaptive_run("sphere_grid")

        phase("cli render --checkpoint --checkpoint-every 128 --preview "
              "1024x768x512")
        ck, pv = os.path.join(tmp, "r.ckpt"), os.path.join(tmp, "prev.png")
        megakernel.LAUNCHES.clear()
        text = cli_stderr(cli_main, base + [
            "--checkpoint", ck, "--checkpoint-every", "128", "--preview", pv,
            "-o", os.path.join(tmp, "ck.png")])
        ck_launches = megakernel.LAUNCHES["megakernel_nee"]
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

    # Phases (m)-(u): the cosine and nee_textbook estimators (rows 1 and 2
    # grow) and path guiding (rows 4 and 5).
    from small_pathtracer_tpu_torch.core import vecmath as vm
    from small_pathtracer_tpu_torch.experiment import path_guiding as pg

    lbn = megakernel.LAUNCHES
    alcove = get_scene("cornell_alcove_baffled")
    smallpt = get_scene("smallpt_original")
    # sphere_grid's 64 spheres take the table kernels' tree instances
    # (kScanTree), smallpt_original's 9 their linear ones.
    grid = get_scene("sphere_grid")
    est_kernel = {"cosine": "megakernel_cosine",
                  "nee_textbook": "megakernel_textbook"}

    def zero_counts():
        lbn.clear()

    def kernel_name(sc, est, kind):
        tab = "_tab" if megakernel.uses_sphere_table(sc) else ""
        if kind == "unguided":
            return est_kernel[est] + tab
        return ("megakernel_guided" + ("_primary" if kind == "primary"
                                       else "") + tab)

    def render_fn(sc, cfg, seed, kind, guide, plain=False):
        """A call of the wrapper (or its plain version) of one kind:
        unguided, voxel (row 4) or primary (row 5)."""
        if kind == "unguided":
            fn = (megakernel.render_megakernel_plain if plain
                  else megakernel.render_megakernel)
            return lambda: fn(sc, cam_f, cfg, seed)
        if kind == "voxel":
            fn = (megakernel.render_megakernel_guided_plain if plain
                  else megakernel.render_megakernel_guided)
        else:
            fn = (megakernel.render_megakernel_guided_primary_plain if plain
                  else megakernel.render_megakernel_guided_primary)
        return lambda: fn(sc, cam_f, cfg, seed, guide, GUIDE_BETA, GUIDE_K)

    def sc_bound(sc, tr, n_samples, n_lanes, est, guide_bytes):
        return forward_bound(tr, n_samples, n_lanes, sc.rects.k.shape[0],
                             sc.spheres.radius.shape[0], guide_bytes, est,
                             not megakernel.uses_sphere_table(sc))

    def new_parity(label, sc, est, kind, guide, seed):
        """The kernel against its plain version at 1024x768x4, bit for bit:
        kernel, plain, kernel (the plain version takes 1-4 s a run)."""
        width, height = 1024, 768
        # The guided entries refuse the JAX package's sphere_table modes on
        # scenes it would render through its table (sphere_grid); "off" is
        # the same kernel.
        cfg = RenderConfig(width=width, height=height, spp=4, estimator=est,
                           seed=seed, sphere_table="auto" if kind ==
                           "unguided" else "off")
        name = kernel_name(sc, est, kind)
        before = lbn[name]
        outs, med = in_turns(
            {"kernel": render_fn(sc, cfg, seed, kind, guide),
             "plain": render_fn(sc, cfg, seed, kind, guide, plain=True)},
            ("kernel", "plain", "kernel"))
        if lbn[name] != before + 2:
            raise AssertionError(f"{label}: {name} did not count 2 launches")
        (k_img, k_tr), (k_img2, k_tr2) = outs["kernel"]
        p_img, p_tr = outs["plain"][0]
        if not (torch.equal(k_img, k_img2) and torch.equal(k_tr, k_tr2)):
            raise AssertionError(f"{label}: kernel runs differ")
        err_ = float((k_img - p_img).abs().max())
        n_pix = width * height
        b = sc_bound(sc, k_tr.tolist(), n_pix * 4, n_pix, est,
                     guide_bytes(kind, n_pix))
        log(f"[smoke] {label} {width}x{height}x4 seed {seed}: {name} "
            f"{med['kernel'] * 1e3:.3f} ms traces {k_tr.tolist()}; "
            f"plain {med['plain'] * 1e3:.3f} ms "
            f"traces {p_tr.tolist()}; max |img diff| {err_:.3e}; bound "
            f"{b[0]:.3f} ms ({b[1]})")
        if not (torch.equal(k_tr, p_tr) and err_ == 0.0):
            raise AssertionError(f"{label}: kernel and plain version differ")
        return {"name": name, "err": err_, "ms": med["kernel"] * 1e3,
                "plain_ms": med["plain"] * 1e3, "bound": b}

    def guide_bytes(kind, n_pix):
        """The guide the kernel reads: the packed voxel table, or one
        packed lobe a pixel."""
        if kind == "unguided":
            return 0
        return (pg.N_VOXELS if kind == "voxel" else n_pix) * 4

    phase("pow_pos against torch.pow on 1e6 uniforms, u^(1/9)")
    u_np = (np.random.default_rng(11).integers(0, 1 << 24, 1_000_000)
            * 2.0 ** -24).astype(np.float32)
    p9 = np.float32(1.0 / (GUIDE_K + 1.0))
    u_t = torch.from_numpy(u_np).to(device)
    p_t = torch.tensor(p9, device=device)
    ref64 = np.power(u_np.astype(np.float64), np.float64(p9))
    ulp = np.spacing(np.maximum(ref64, 1e-30).astype(np.float32))
    pow_ours = vm.pow_pos(u_t, p_t).cpu().numpy()
    pow_lib = torch.pow(u_t, p_t).cpu().numpy()
    pow_share = float(np.mean(pow_ours != pow_lib))
    log(f"[smoke] pow: pow_pos and torch.pow differ on {pow_share:.4%} of "
        f"1e6 uniforms; max error against float64: pow_pos "
        f"{(np.abs(pow_ours - ref64) / ulp).max():.3f} ulp, torch.pow "
        f"{(np.abs(pow_lib - ref64) / ulp).max():.3f} ulp")

    phase("train_guide at the CLI's pre-pass size (128x96x16, 8 bounces), "
          "twice")
    tcfg = RenderConfig(width=128, height=96, spp=16, seed=1)
    m1, train_s = timed(lambda: pg.train_guide(alcove, cam_f, tcfg, 8, 1))
    m2, _ = timed(lambda: pg.train_guide(alcove, cam_f, tcfg, 8, 1))
    if not torch.equal(m1, m2):
        raise AssertionError("train_guide gave two different tables")
    guides = {"cornell_alcove_baffled": pg.guide_lobes(m1)}
    for nm, sc in (("cornell_box", scene), ("smallpt_original", smallpt),
                   ("sphere_grid", grid)):
        guides[nm] = pg.guide_lobes(pg.train_guide(sc, cam_f, tcfg, 8, 1))
    log(f"[smoke] train_guide: the same bits twice, {train_s:.4f} s; guided "
        "voxels " + ", ".join(f"{k} {int(g[1].sum())}"
                              for k, g in guides.items()))

    phase("row 4 against its plain version 1024x768x4: "
          "cornell_alcove_baffled nee_textbook, cornell_box cosine, "
          "smallpt_original cosine, sphere_grid cosine and nee_textbook")
    par = {}  # kernel name -> its first parity run
    grid_runs = [("sphere_grid", grid, "cosine"),
                 ("sphere_grid", grid, "nee_textbook")]
    for nm, sc, est in [("cornell_alcove_baffled", alcove, "nee_textbook"),
                        ("cornell_box", scene, "cosine"),
                        ("smallpt_original", smallpt, "cosine"),
                        *grid_runs]:
        r = new_parity(f"row 4 {nm} {est}", sc, est, "voxel", guides[nm], 12)
        par.setdefault(r["name"], r)
    phase("row 5 against its plain version 1024x768x4: "
          "cornell_alcove_baffled nee_textbook, smallpt_original cosine, "
          "sphere_grid cosine and nee_textbook")
    for nm, sc, est in [("cornell_alcove_baffled", alcove, "nee_textbook"),
                        ("smallpt_original", smallpt, "cosine"),
                        *grid_runs]:
        r = new_parity(f"row 5 {nm} {est}", sc, est, "primary", guides[nm], 13)
        par.setdefault(r["name"], r)
    phase("unguided cosine and nee_textbook against their plain version "
          "1024x768x4 (smallpt_original and sphere_grid both ways)")
    for nm, sc, est in [("cornell_box", scene, "cosine"),
                        ("cornell_alcove_baffled", alcove, "nee_textbook"),
                        ("smallpt_original", smallpt, "cosine"),
                        ("smallpt_original", smallpt, "nee_textbook"),
                        *grid_runs]:
        r = new_parity(f"unguided {nm} {est}", sc, est, "unguided", None, 14)
        par.setdefault(r["name"], r)

    phase("an all-sentinel table against the unguided kernel, rows 4 and 5, "
          "bit for bit")
    empty = (torch.zeros((pg.N_VOXELS, 3), device=device),
             torch.zeros(pg.N_VOXELS, dtype=torch.bool, device=device))
    for est in ("cosine", "nee_textbook"):
        for nm, sc in (("cornell_alcove_baffled", alcove),
                       ("smallpt_original", smallpt), ("sphere_grid", grid)):
            cfg = RenderConfig(width=1024, height=768, spp=4, estimator=est,
                               seed=15, sphere_table="off")
            u_img, u_tr = render_fn(sc, cfg, 15, "unguided", None)()
            for kind in ("voxel", "primary"):
                g_img, g_tr = render_fn(sc, cfg, 15, kind, empty)()
                if not (torch.equal(g_img, u_img) and torch.equal(g_tr, u_tr)):
                    raise AssertionError(f"empty table {kind} {nm} {est} "
                                         "differs from the unguided kernel")
            log(f"[smoke] empty table {nm} {est}: rows 4 and 5 equal the "
                f"unguided kernel bit for bit, traces {u_tr.tolist()}")

    cfg512 = {est: RenderConfig(width=1024, height=768, spp=512,
                                estimator=est, seed=0)
              for est in ("cosine", "nee_textbook")}
    alc_args = ["--scene", "cornell_alcove_baffled", "--estimator",
                "nee_textbook"]
    main = {}  # kernel name -> (launches, x512 event ms, bound)

    def x512(name, sc, est, kind, guide, tr):
        """Event time of three launches in a row at 1024x768x512 seed 0,
        and the bound from these traces."""
        ms = event_ms(render_fn(sc, cfg512[est], 0, kind, guide), 3)
        n_pix = 1024 * 768
        b = sc_bound(sc, tr, n_pix * 512, n_pix, est, guide_bytes(kind, n_pix))
        log(f"[smoke] {name} 1024x768x512 seed 0: {ms:.3f} ms a launch "
            f"(CUDA events), traces {tr}; bound {b[0]:.3f} ms ({b[1]})")
        return ms, b

    with tempfile.TemporaryDirectory() as tmp:
        phase("main path, cli render --guided --scene cornell_alcove_baffled "
              "--estimator nee_textbook 1024x768x512")
        zero_counts()
        text = cli_stderr(cli_main, base + alc_args + [
            "--guided", "-o", os.path.join(tmp, "guided.png")])
        counts = lbn.copy()
        mg_ = re.search(r"guide table trained: (\d+) guided voxels \(pre-pass "
                        r"([0-9.]+) s\)", text)
        g_rays, g_secs = cli_traces(text)
        if counts["megakernel_guided"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"cli render --guided launched {counts}")
        n_vox, pre_s = int(mg_.group(1)), float(mg_.group(2))
        guide_a = guides["cornell_alcove_baffled"]
        if n_vox != int(guide_a[1].sum()):
            raise AssertionError("the CLI's table differs from train_guide's")
        cfg_tb = cfg512["nee_textbook"]
        img_g, tr_g = megakernel.render_megakernel_guided(
            alcove, cam_f, cfg_tb, 0, guide_a, GUIDE_BETA, GUIDE_K)
        if int(tr_g.sum()) != g_rays:
            raise AssertionError("the CLI's traces differ from the wrapper's")
        ms_g, b_g = x512("megakernel_guided", alcove, "nee_textbook", "voxel",
                         guide_a, tr_g.tolist())
        main["megakernel_guided"] = (1, ms_g, b_g)
        log(f"[smoke] main path cli render --guided: pre-pass {pre_s:.4f} s, "
            f"{n_vox} guided voxels, 1 launch of megakernel_guided "
            f"{ms_g:.3f} ms (CUDA events), {g_rays} rays in {g_secs:.3f} s "
            f"wall = {g_rays / g_secs / 1e6:.1f} Mrays/s on {card}")

        zero_counts()
        text = cli_stderr(cli_main, base + alc_args + [
            "-o", os.path.join(tmp, "unguided.png")])
        n_tb = lbn["megakernel_textbook"]
        u_rays, u_secs = cli_traces(text)
        if n_tb != 1:
            raise AssertionError("cli render --estimator nee_textbook did "
                                 "not launch megakernel_textbook once")
        img_u, tr_u = megakernel.render_megakernel(alcove, cam_f, cfg_tb, 0)
        ms_u, b_u = x512("megakernel_textbook", alcove, "nee_textbook",
                         "unguided", None, tr_u.tolist())
        main["megakernel_textbook"] = (1, ms_u, b_u)
        spp_t = torch.tensor(512.0, device=device)
        mean_g = (img_g / spp_t).reshape(-1, 3).double().mean(0)
        mean_u = (img_u / spp_t).reshape(-1, 3).double().mean(0)
        rel = ((mean_g - mean_u).abs() / mean_u).cpu().numpy()
        log(f"[smoke] unguided cli render: {u_rays} rays in {u_secs:.3f} s "
            f"wall = {u_rays / u_secs / 1e6:.1f} Mrays/s, megakernel_textbook "
            f"{ms_u:.3f} ms; linear means guided "
            f"{mean_g.cpu().numpy().round(5).tolist()} unguided "
            f"{mean_u.cpu().numpy().round(5).tolist()} (relative gap "
            f"{rel.round(5).tolist()}, limit {GUIDE_MEAN_TOL})")
        if np.any(rel > GUIDE_MEAN_TOL):
            raise AssertionError("the guided and unguided means disagree")

        phase("variance: cornell_alcove_baffled 1024x768x64, seeds 0 and 1, "
              "guided and unguided")
        var = {}
        for kind in ("voxel", "unguided"):
            imgs = []
            for seed in (0, 1):
                cfg = RenderConfig(width=1024, height=768, spp=64,
                                   estimator="nee_textbook", seed=seed)
                img, _ = render_fn(alcove, cfg, seed, kind, guide_a)()
                imgs.append(img / torch.tensor(64.0, device=device))
            var[kind] = float(((imgs[0] - imgs[1]) ** 2).double().mean())
        log(f"[smoke] mean squared difference of seeds 0 and 1 at x64 "
            f"(twice the pixel variance): guided {var['voxel']:.6e}, "
            f"unguided {var['unguided']:.6e}, ratio "
            f"{var['unguided'] / var['voxel']:.3f}")

        phase("cli render --guided --guide-online 4 1024x768x512")
        zero_counts()
        text = cli_stderr(cli_main, base + alc_args + [
            "--guided", "--guide-online", "4",
            "-o", os.path.join(tmp, "online.png")])
        n_on = lbn["megakernel_guided"]
        on_rays, on_secs = cli_traces(text)
        log(f"[smoke] online: {n_on} launches of megakernel_guided, "
            f"{on_rays} rays in {on_secs:.3f} s = "
            f"{on_rays / on_secs / 1e6:.1f} Mrays/s")
        if n_on != 4:
            raise AssertionError("--guide-online 4 did not launch 4 times")

        phase("cli render --guided --checkpoint --checkpoint-every 128 "
              "--preview 1024x768x512")
        ck, pv = os.path.join(tmp, "g.ckpt"), os.path.join(tmp, "g.png")
        zero_counts()
        text = cli_stderr(cli_main, base + alc_args + [
            "--guided", "--checkpoint", ck, "--checkpoint-every", "128",
            "--preview", pv, "-o", os.path.join(tmp, "gck.png")])
        n_ck = lbn["megakernel_guided"]
        ck_rays, _ = cli_traces(text)
        img_ck, _ = checkpoint.render_with_checkpoints(
            alcove, cam_f, cfg_tb, "", 128, guide=guide_a,
            guide_beta=GUIDE_BETA, guide_k=GUIDE_K)
        ck_err = float((img_ck - film.finalize(img_g / spp_t)).abs().max())
        log(f"[smoke] guided checkpoint: {n_ck} span launches, traces "
            f"{ck_rays} (one launch {g_rays}), preview "
            f"{imageio.read_image(pv).shape}, max |span image - one-launch "
            f"image| {ck_err:.3e}")
        if not (n_ck == 4 and ck_rays == g_rays and ck_err <= 1e-5):
            raise AssertionError("the guided checkpointed render differs")

        phase("the other new kernels' main paths at 1024x768x512: cli render "
              "cosine (cornell_box), smallpt_original cosine guided, cosine "
              "and nee_textbook; row 5 through its wrapper")
        for name, args_, sc, est, kind in (
                ("megakernel_cosine", ["--estimator", "cosine"], scene,
                 "cosine", "unguided"),
                ("megakernel_guided_tab",
                 ["--scene", "smallpt_original", "--estimator", "cosine",
                  "--guided"], smallpt, "cosine", "voxel"),
                ("megakernel_cosine_tab",
                 ["--scene", "smallpt_original", "--estimator", "cosine"],
                 smallpt, "cosine", "unguided"),
                ("megakernel_textbook_tab",
                 ["--scene", "smallpt_original", "--estimator",
                  "nee_textbook"], smallpt, "nee_textbook", "unguided")):
            zero_counts()
            text = cli_stderr(cli_main, base + args_ + [
                "-o", os.path.join(tmp, f"{name}.png")])
            n_l = lbn[name]
            rays, secs = cli_traces(text)
            if n_l != 1:
                raise AssertionError(f"{name}: {n_l} launches")
            nm = "cornell_box" if sc is scene else "smallpt_original"
            _, tr = render_fn(sc, cfg512[est], 0, kind, guides[nm])()
            ms, b = x512(name, sc, est, kind, guides[nm], tr.tolist())
            main[name] = (n_l, ms, b)
            log(f"[smoke] main path {name}: 1 launch, {rays} rays in "
                f"{secs:.3f} s = {rays / secs / 1e6:.1f} Mrays/s")
        for name, sc, est, nm in (
                ("megakernel_guided_primary", alcove, "nee_textbook",
                 "cornell_alcove_baffled"),
                ("megakernel_guided_primary_tab", smallpt, "cosine",
                 "smallpt_original")):
            zero_counts()
            img, tr = render_fn(sc, cfg512[est], 0, "primary", guides[nm])()
            n_l = lbn[name]
            if n_l != 1 or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: {n_l} launches or a non-finite "
                                     "image")
            ms, b = x512(name, sc, est, "primary", guides[nm], tr.tolist())
            main[name] = (n_l, ms, b)

    grazing_phase()
    tie_phase(guides["cornell_box"])
    geo = geom_phases(card, cli_main)
    deep_phase()
    mat_entries, mat_shard = mat_phases(card, cli_main, MAT_GROWN)
    est_entries = est_phases(card, cli_main)
    ext_entries, ext_runs, glos_x4 = ext_phases(card, cli_main)
    est_mat_entries, est_shard = mat_phases(card, cli_main, MAT_EST)
    mat_ext_entries = mat_ext_phases(card, cli_main, ext_runs, glos_x4)
    geo_entries, geo_shard = geom_est_phases(card, cli_main)
    shard = shard_phases(card, cli_main, guides["cornell_alcove_baffled"],
                         {**mat_shard, **est_shard}, geo_shard)

    PHASES.append(("end", time.perf_counter()))
    for (name, t0), (_, t1) in zip(PHASES, PHASES[1:]):
        log(f"[smoke] {t1 - t0:8.3f} s  {name}")

    # No single PyTorch call computes any of these functions: library_ms is
    # null for each. The new kernels' ms, plain_ms and bound_ms are their
    # parity runs' at 1024x768x4; their x512 event times and bounds are in
    # the log.
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
        entry("megakernel_nee_budgets", "megakernel_budgets.cu",
              "megakernel.py:2783",
              adaptive_launches["cornell_box"], bud["cornell_box"]["err"],
              bud["cornell_box"]["ms"], bud["cornell_box"]["plain_ms"],
              bud["cornell_box"]["bound"]),
        entry("megakernel_nee_tab_budgets", "megakernel_budgets.cu",
              "megakernel.py:2783", adaptive_launches["sphere_grid"],
              bud["sphere_grid"]["err"], bud["sphere_grid"]["ms"],
              bud["sphere_grid"]["plain_ms"], bud["sphere_grid"]["bound"]),
        *(entry(name, source, replaces, main[name][0], par[name]["err"],
                par[name]["ms"], par[name]["plain_ms"], par[name]["bound"])
          for name, source, replaces in NEW_KERNELS),
        entry("megakernel_geom", "megakernel_geom.cu", "megakernel_geom.py:1488",
              geo["launches"], geo["err"], geo["ms"], geo["plain_ms"],
              geo["bound"]),
        *(entry(name, source, replaces, launch, r["err"], r["ms"],
                r["plain_ms"], r["bound"])
          for name, source, replaces, launch, r in shard),
        *mat_entries,
        *est_entries,
        *ext_entries,
        *est_mat_entries,
        *mat_ext_entries,
        *geo_entries,
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
