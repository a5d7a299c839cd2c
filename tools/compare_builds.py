"""Compares the kernels of this checkout with another checkout's on one
NVIDIA GPU.

    python3 tools/compare_builds.py OTHER [--cases NAME,NAME]

OTHER is the root of another checkout of the repository, for example a
parent commit unpacked into a git-ignored directory:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent

Each checkout builds its own kernels into its own build/, in a process of
its own, in the order OTHER, this, this, OTHER. The cases (``CASES``; rows
of PERF.md §6):

- the forwards (rows 1-8): the image and traces at 1024x768x4 seed 3 and
  the traces at 1024x768x512 seed 0, and a launch's CUDA-event time at x512
  (three launches after one warm-up; it holds the wrapper's host work
  between launches), for rows 1 and 2 also the kernel's own device time
  from torch.profiler; row 2 on ``sphere_grid`` with 2, 9,
  16, 32, 64, 256 and 1024 spheres (``sphere_grid_N`` that is no preset:
  the preset's grid cut to N) and its ``cosine`` / ``nee_textbook`` twins on
  ``smallpt_original``;
- row 3 on one wave with 74% of the pixels active (seeded; samples
  [64, 128) of spp 512): its sums and traces and a launch's event time
  (this checkout: the launch alone, through ``budget_waves``; the other:
  ``render_megakernel_budgets`` three times in a row, whose host work
  overlaps the previous launch); and ``adaptive``: ``adaptive_render`` at
  ``--adaptive-tol 0.01`` (1024x768x512) of ``cornell_box`` and
  ``sphere_grid``, its image, spp map and traces, the wall time of two
  renders after a warm-up, and each wave's active share and event time;
- the adjoints: ``megakernel_vjp`` on ``cornell_box`` (``nee``,
  ``cosine``, ``nee_textbook``, ``mis``; its ``_tab`` instances on
  ``smallpt_original``, the linear scan, and ``sphere_grid``, the tree)
  and the adjoint launch of ``megakernel_geom`` on ``cornell_spheres``
  (and on ``smallpt_original``; each estimator's instance,
  ``megakernel_geom_<est>``, on ``cornell_spheres``, ``mis`` also on
  ``smallpt_original``: one launch timed, a checkout without it shows no
  time and no output), their gradient
  tables at 1024x768x4 (seed 3, cotangent seeds 5 and 3, as chip_smoke.py)
  and a launch's event time at 1024x768x512 seed 0 (cotangent 1e-7; two
  launches after one warm-up; for ``megakernel_geom`` also the kernel's
  own device time from torch.profiler, without the wrapper's host work); ``megakernel_geom deep``, its tables on
  ``cornell_spheres`` 64x48x4 with rr_start_depth = max_bounces = 200 and
  every albedo 0.98; ``geom fit`` (``geom fit mis``: with ``--estimator
  mis``), ``cli fit --train center,radius`` of ``cornell_spheres`` at
  1024x768x512 (5 steps, the main path: host work and syncs included),
  each step's printed seconds and the stdout line's sphere 0 and losses;
- ``guided 4 ranks`` (row 6 end to end): ``cli render --guided --mesh 2x2``
  of the alcove at 1024x768x512 as chip_smoke.py's main path runs it, four
  gloo ranks on the one card (the checkout's ``launcher.spawn``): one
  warm-up ``cli render --mesh 2x2`` of the box, then the guided render
  three times; rank 0's ``seconds=`` of each and its output bytes.

Prints the card's name and power limit; then per case each run's time, and
for every output the largest gap of each run to this checkout's first run
("equal" where the bits are the same). It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
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

ROOT = Path(__file__).resolve().parent.parent
GUIDE_BETA, GUIDE_K = 0.6, 8.0  # as chip_smoke.py
MESH_RENDERS = 3

# Each case: (row of PERF.md §6, scene, estimator, kind). Forward kinds: the
# unguided wrapper, row 4's voxel guide, row 5's pixel lobes, rows 6 and
# 7's four coordinates of a 2x2 mesh (one process), row 8's runtime
# materials, row 3's per-pixel spans (all of spp).
CASES = {
    "megakernel_nee": ("1", "cornell_box", "nee", "unguided"),
    "megakernel_cosine": ("1", "cornell_box", "cosine", "unguided"),
    "megakernel_textbook": ("1", "cornell_alcove_baffled", "nee_textbook",
                            "unguided"),
    "megakernel_guided": ("4", "cornell_alcove_baffled", "nee_textbook",
                          "voxel"),
    "megakernel_guided_primary": ("5", "cornell_alcove_baffled",
                                  "nee_textbook", "primary"),
    "megakernel_guided_tab": ("4", "smallpt_original", "cosine", "voxel"),
    "megakernel_guided_primary_tab": ("5", "smallpt_original", "cosine",
                                      "primary"),
    "megakernel_guided_tab grid": ("4", "sphere_grid", "cosine", "voxel"),
    "megakernel_guided_primary_tab grid": ("5", "sphere_grid", "cosine",
                                           "primary"),
    "megakernel_nee_tab 2x2": ("7", "sphere_grid", "nee", "sharded"),
    "megakernel_guided 2x2": ("6", "cornell_alcove_baffled",
                              "nee_textbook", "voxel sharded"),
    "megakernel_nee 2x2": ("7", "cornell_box", "nee", "sharded"),
    "megakernel_nee_mat": ("8", "cornell_box", "nee", "mat"),
    "megakernel_cosine_mat": ("8", "cornell_box", "cosine", "mat"),
    "megakernel_textbook_mat": ("8", "cornell_box", "nee_textbook", "mat"),
    "megakernel_mis_mat": ("8", "cornell_box", "mis", "mat"),
    "megakernel_nee_budgets": ("3", "cornell_box", "nee", "budgets"),
    "megakernel_nee_tab": ("2", "sphere_grid", "nee", "unguided"),
    "megakernel_nee_tab 2": ("2", "sphere_grid_2", "nee", "unguided"),
    "megakernel_nee_tab 9": ("2", "sphere_grid_9", "nee", "unguided"),
    "megakernel_nee_tab 16": ("2", "sphere_grid_16", "nee", "unguided"),
    "megakernel_nee_tab 32": ("2", "sphere_grid_32", "nee", "unguided"),
    "megakernel_nee_tab 256": ("2", "sphere_grid_256", "nee", "unguided"),
    "megakernel_nee_tab 1024": ("2", "sphere_grid_1024", "nee", "unguided"),
    "megakernel_cosine_tab": ("2", "smallpt_original", "cosine",
                              "unguided"),
    "megakernel_textbook_tab": ("2", "smallpt_original", "nee_textbook",
                                "unguided"),
    "megakernel_cosine_tab grid": ("2", "sphere_grid", "cosine", "unguided"),
    "megakernel_textbook_tab grid": ("2", "sphere_grid", "nee_textbook",
                                     "unguided"),
    "budgets 74%": ("3", "cornell_box", "nee", "budgets74"),
    "budgets 74% spheres": ("3", "sphere_grid", "nee", "budgets74"),
    "adaptive cornell_box": ("3", "cornell_box", "nee", "adaptive"),
    "adaptive sphere_grid": ("3", "sphere_grid", "nee", "adaptive"),
    "megakernel_vjp": ("9", "cornell_box", "nee", "vjp"),
    "megakernel_vjp_cosine": ("9", "cornell_box", "cosine", "vjp"),
    "megakernel_vjp_textbook": ("9", "cornell_box", "nee_textbook", "vjp"),
    "megakernel_vjp_tab": ("9", "smallpt_original", "nee", "vjp"),
    "megakernel_vjp_cosine_tab": ("9", "smallpt_original", "cosine", "vjp"),
    "megakernel_vjp_textbook_tab": ("9", "smallpt_original", "nee_textbook",
                                    "vjp"),
    "megakernel_vjp_textbook_tab grid": ("9", "sphere_grid", "nee_textbook",
                                         "vjp"),
    "megakernel_vjp_mis": ("9", "cornell_box", "mis", "vjp"),
    "megakernel_geom": ("11", "cornell_spheres", "nee", "geom"),
    "megakernel_geom smallpt": ("11", "smallpt_original", "nee", "geom"),
    "megakernel_geom deep": ("11", "cornell_spheres", "nee", "geom deep"),
    "geom fit": ("11", "cornell_spheres", "nee", "fit"),
    **{f"megakernel_geom_{name}": ("11", "cornell_spheres", est, "geom")
       for name, est in (("cosine", "cosine"), ("textbook", "nee_textbook"),
                         ("uniform", "uniform"),
                         ("uniform_corrected", "uniform_corrected"),
                         ("mixture", "mixture"), ("mis", "mis"),
                         ("nee_glibc", "nee+glibc"),
                         ("mixture_glibc", "mixture+glibc"))},
    "megakernel_geom_mis smallpt": ("11", "smallpt_original", "mis", "geom"),
    "geom fit mis": ("11", "cornell_spheres", "mis", "fit"),
    "guided 4 ranks": ("6", "cornell_alcove_baffled", "nee_textbook",
                       "mesh"),
}


def _fields(est: str) -> dict:
    """RenderConfig fields of a case's estimator: ``e+glibc`` is e with
    light_sample_mode='glibc_overflow'."""
    e, _, glibc = est.partition("+")
    return {"estimator": e,
            **({"light_sample_mode": "glibc_overflow"} if glibc else {})}


def event_ms(fn, n: int) -> float:
    """CUDA-event time of one call of fn, averaged over n after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n: int, kernel: str) -> float:
    """The device time of the kernels whose name holds ``kernel`` in one
    call of fn (torch.profiler, n calls after a warm-up): the launch alone,
    without the host work that the event time holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or
                getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if kernel in e.key)
    return total / 1e3 / n


def _cotangent(seed: int, height: int, width: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (height, width, 3)).astype(np.float32)).to("cuda")


def cli_rank(argvs: list) -> list:
    """One rank of the mesh case (run by ``launcher.spawn``): the CLI on
    each argv; (exit code, stderr) of each."""
    from small_pathtracer_tpu_torch.cli import main as cli_main

    out = []
    for argv in argvs:
        err = io.StringIO()
        with (contextlib.redirect_stdout(io.StringIO()),
              contextlib.redirect_stderr(err)):
            rc = cli_main(argv)
        out.append((rc, err.getvalue()))
    return out


def mesh_case(root: str) -> dict:
    """The ``guided 4 ranks`` case in the checkout at ``root``."""
    from small_pathtracer_tpu_torch.parallel import launcher

    base = ["render", "--width", "1024", "--height", "768", "--spp", "512",
            "--mesh", "2x2", "--dist-backend", "gloo"]
    alc = ["--scene", "cornell_alcove_baffled", "--estimator",
           "nee_textbook", "--guided"]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"g{i}.ppm") for i in range(MESH_RENDERS)]
        argvs = [[*base, "-o", os.path.join(tmp, "box.ppm")]]
        argvs += [[*base, *alc, "-o", out] for out in outs]
        ranks = launcher.spawn(cli_rank, 4, "gloo", "cuda", 600.0,
                               args=(argvs,))
        if any(rc != 0 for r in ranks for rc, _ in r):
            raise SystemExit(f"{root}: a rank's cli render failed")
        seconds = [float(re.search(r"seconds=([0-9.]+)", err)[1])
                   for _, err in ranks[0][1:]]
        images = [torch.frombuffer(bytearray(Path(o).read_bytes()),
                                   dtype=torch.uint8) for o in outs]
    return {"out": images, "ms": [1e3 * s for s in seconds]}


def waves_case(sc, cam, name: str) -> dict:
    """The ``adaptive`` case: (image, spp map, traces), two walls after a
    warm-up, and each wave's (active share, event ms)."""
    from small_pathtracer_tpu_torch import RenderConfig
    from small_pathtracer_tpu_torch.ops import megakernel as mk
    from small_pathtracer_tpu_torch.utils import adaptive

    cfg = RenderConfig(width=1024, height=768, spp=512, seed=0)
    spans = []
    new = hasattr(adaptive, "budget_waves")
    real = adaptive.budget_waves if new else adaptive.render_megakernel_budgets

    def keep_new(sc_, cam_, cfg_):
        fn = real(sc_, cam_, cfg_)

        def wave(seed, a, b, live):
            spans.append((a.clone(), b.clone()))
            return fn(seed, a, b, live)
        return wave

    def keep_old(sc_, cam_, cfg_, seed, a, b):
        spans.append((a.clone(), b.clone()))
        return real(sc_, cam_, cfg_, seed, a, b)

    setattr(adaptive, "budget_waves" if new else "render_megakernel_budgets",
            keep_new if new else keep_old)
    try:
        res = adaptive.adaptive_render(sc, cam, cfg, tol=0.01)
    finally:
        setattr(adaptive, "budget_waves" if new
                else "render_megakernel_budgets", real)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adaptive.adaptive_render(sc, cam, cfg, tol=0.01)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    waves = []
    wave_fn = adaptive.budget_waves(sc, cam, cfg) if new else None
    for a, b in spans:
        live = torch.nonzero(b > a).flatten().to(torch.int32)
        fn = ((lambda: wave_fn(0, a, b, live)) if new else
              (lambda: mk.render_megakernel_budgets(sc, cam, cfg, 0, a, b)))
        waves.append((live.numel() / (1024 * 768), event_ms(fn, 3)))
    return {"out": [res.image, res.spp_map,
                    torch.tensor(res.traces, dtype=torch.int64)],
            "ms": walls, "waves": waves}


def fit_case(est: str) -> dict:
    """The ``geom fit`` cases: the CLI's geometry fit with estimator
    ``est`` in this process; the losses and sphere 0 (from stderr and the
    stdout line) and each step's seconds."""
    from small_pathtracer_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(["fit", "--scene", "cornell_spheres", "--width", "1024",
                       "--height", "768", "--spp", "512", "--steps", "5",
                       "--train", "center,radius", "--estimator", est])
    if rc != 0:
        raise SystemExit(f"cli fit returned {rc}")
    steps = re.findall(r"loss (\S+).*?seconds (\S+)", err.getvalue())
    fit = json.loads(out.getvalue().strip().splitlines()[-1])
    return {"out": [torch.tensor([float(a) for a, _ in steps],
                                 dtype=torch.float64),
                    torch.tensor([*fit["center"], fit["radius"]],
                                 dtype=torch.float64)],
            "ms": [1e3 * float(b) for _, b in steps]}


def worker(root: str, out: str, cases: list[str]) -> None:
    """In the checkout at ``root``: every case's outputs and times, saved to
    ``out``."""
    sys.path.insert(0, root)
    from small_pathtracer_tpu_torch import (
        RenderConfig, get_scene, make_camera,
    )
    from small_pathtracer_tpu_torch.experiment import path_guiding as pg
    from small_pathtracer_tpu_torch.ops import megakernel as mk
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
    from small_pathtracer_tpu_torch.parallel.mesh import Mesh

    cam = make_camera(aspect=1024 / 768)
    scenes, guides = {}, {}
    coords = [(i, j) for i in range(2) for j in range(2)]
    g512 = torch.full((768, 1024, 3), 1e-7, device="cuda")

    def scene(name):
        if name not in scenes:
            from small_pathtracer_tpu_torch.scene import presets
            if name in presets.PRESETS:
                scenes[name] = get_scene(name)
            else:  # sphere_grid_N: the preset's grid cut to N spheres
                scenes[name] = presets.sphere_grid(int(name.split("_")[-1]))
        return scenes[name]

    def call(case, cfg, seed):
        _, name, est, kind = CASES[case]
        scene(name)
        sc = scenes[name]
        if kind.startswith(("voxel", "primary")) and name not in guides:
            guides[name] = pg.guide_lobes(pg.train_guide(
                sc, cam, RenderConfig(width=128, height=96, spp=16, seed=1),
                8, 1))
        g = guides.get(name)
        if kind == "unguided":
            return lambda: mk.render_megakernel(sc, cam, cfg, seed)
        if kind == "voxel":
            return lambda: mk.render_megakernel_guided(
                sc, cam, cfg, seed, g, GUIDE_BETA, GUIDE_K)
        if kind == "primary":
            return lambda: mk.render_megakernel_guided_primary(
                sc, cam, cfg, seed, g, GUIDE_BETA, GUIDE_K)
        if kind in ("sharded", "voxel sharded"):
            meshes = [Mesh.single((2, 2), c) for c in coords]

            def shards():
                parts = [mk.render_megakernel_sharded(sc, cam, cfg, m, seed)
                         if kind == "sharded" else
                         mk.render_megakernel_guided_sharded(
                             sc, cam, cfg, m, seed, g, GUIDE_BETA, GUIDE_K)
                         for m in meshes]
                return (torch.cat([p[0] for p in parts]),
                        sum(p[1] for p in parts))
            return shards
        if kind == "mat":
            alb, emi = mg.pack_materials(sc)
            return lambda: mg.render_megakernel_mat(sc, cam, cfg, alb, emi,
                                                    seed)
        n_pix = cfg.width * cfg.height
        s_start = torch.zeros(n_pix, dtype=torch.int32, device="cuda")
        s_stop = torch.full((n_pix,), cfg.spp, dtype=torch.int32,
                            device="cuda")
        if kind == "budgets74":
            act = torch.from_numpy(
                np.random.default_rng(74).random(n_pix) < 0.74).cuda()
            s_start = torch.full_like(s_start, 64)
            s_stop = torch.where(act, 128, 64).to(torch.int32)
            if hasattr(mk, "budget_waves"):
                wave_fn = mk.budget_waves(sc, cam, cfg)
                live = torch.nonzero(act).flatten().to(torch.int32)
                return lambda: wave_fn(seed, s_start, s_stop, live)
        return lambda: mk.render_megakernel_budgets(sc, cam, cfg, seed,
                                                    s_start, s_stop)

    res = {}
    for case in cases:
        _, name, est, kind = CASES[case]
        # The guided kernels refuse the JAX sphere_table modes; "off" is
        # the same kernel.
        table = "off" if kind.startswith(("voxel", "primary")) else "auto"
        cfg4 = RenderConfig(width=1024, height=768, spp=4, **_fields(est),
                            seed=3, sphere_table=table)
        cfg512 = RenderConfig(width=1024, height=768, spp=512,
                              **_fields(est), seed=0, sphere_table=table)
        if kind in ("geom", "fit") and est != "nee" and not hasattr(
                mgeo, "geom_kernel_name"):
            # A checkout without the other estimators' geometry adjoint.
            res[case] = {"out": []}
            continue
        if kind == "mesh":
            res[case] = mesh_case(root)
        elif kind == "adaptive":
            res[case] = waves_case(scene(name), cam, name)
        elif kind == "fit":
            res[case] = fit_case(est)
        elif kind == "vjp":
            sc = get_scene(name)
            alb, emi = mg.pack_materials(sc)
            geom = mk.pack_geometry(sc, cam)
            res[case] = {
                "out": list(mg.render_megakernel_vjp(
                    sc, cam, cfg4, alb, emi, 3, _cotangent(5, 768, 1024))),
                "ms": event_ms(lambda: mg.render_megakernel_vjp(
                    sc, cam, cfg512, alb, emi, 0, g512, geometry=geom), 2)}
        elif kind == "geom":
            sc = scene(name)
            geom = mk.pack_geometry(sc, cam)
            run = (lambda: mgeo.geom_run(sc, cam, cfg512, 0, g512,
                                         geometry=geom))
            res[case] = {
                "out": list(mgeo.geom_vjp(sc, cam, cfg4, 3,
                                          _cotangent(3, 768, 1024))),
                "ms": event_ms(run, 2 if est == "nee" else 1),
                "device_ms": device_ms(run, 2 if est == "nee" else 1,
                                       "megakernel_geom")}
        elif kind == "geom deep":
            sc = get_scene(name)
            t_sph, t_alb, t_emi = mgeo.pack_tables(sc)
            deep = mgeo.scene_with_tables(sc, t_sph,
                                          torch.full_like(t_alb, 0.98), t_emi)
            cfg = RenderConfig(width=64, height=48, spp=4, seed=3,
                               rr_start_depth=200, max_bounces=200)
            res[case] = {"out": list(mgeo.geom_vjp(
                deep, make_camera(aspect=64 / 48), cfg, 3,
                _cotangent(5, 48, 64)))}
        else:
            img4, tr4 = call(case, cfg4, 3)()
            fn = call(case, cfg512, 0)
            _, tr512 = fn()
            res[case] = {"out": [img4, tr4, tr512], "ms": event_ms(fn, 3)}
            if kind == "unguided":
                res[case]["device_ms"] = device_ms(fn, 3, case.split()[0])
        res[case]["out"] = [t.cpu() for t in res[case]["out"]]
    torch.save(res, out)


def gap(a: torch.Tensor, ref: torch.Tensor) -> str:
    if torch.equal(a, ref):
        return "equal"
    d = float((a.double() - ref.double()).abs().max())
    return f"{d:.3e} ({d / float(ref.double().abs().max()):.3e} of its max)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    cases = args.cases.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    roots = {"other": str(Path(args.other).resolve()), "this": str(ROOT)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--worker",
                            roots[name], out, ",".join(cases)], check=True)
            runs.append((name, torch.load(out)))
    ref = runs[1][1]
    for case in cases:
        row, scene, est, _ = CASES[case]
        times = []
        for name, res in runs:
            ms = res[case].get("ms")
            if ms is not None:
                ms = ms if isinstance(ms, list) else [ms]
                times.append(f"{name} " + "/".join(f"{m:.3f}" for m in ms))
        dev = [f"{name} {res[case]['device_ms']:.3f}" for name, res in runs
               if "device_ms" in res[case]]
        if dev:
            times.append("kernel alone (profiler) " + ", ".join(dev))
        outs = "; ".join(
            f"{name} [" + ", ".join(gap(a, b) for a, b in zip(
                res[case]["out"], ref[case]["out"])) + "]"
            for name, res in runs)
        print(f"row {row} {case} ({scene}, {est}): ms "
              + (", ".join(times) or "not timed")
              + f"; outputs against this checkout's first run: {outs}",
              flush=True)
        for name, res in runs:
            if "waves" in res[case]:
                print(f"  {name} waves [active share, event ms]: "
                      + ", ".join(f"[{a:.3f}, {m:.3f}]"
                                  for a, m in res[case]["waves"]),
                      flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
        sys.exit(0)
    sys.exit(main())
