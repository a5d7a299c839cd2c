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
  (three launches after one warm-up);
- the adjoints: ``megakernel_vjp`` on ``cornell_box`` and the adjoint
  launch of ``megakernel_geom`` on ``cornell_spheres``, their gradient
  tables at 1024x768x4 (seed 3, cotangent seeds 5 and 3, as chip_smoke.py)
  and a launch's event time at 1024x768x512 seed 0 (cotangent 1e-7; two
  launches after one warm-up); ``megakernel_geom deep``, its tables on
  ``cornell_spheres`` 64x48x4 with rr_start_depth = max_bounces = 200 and
  every albedo 0.98;
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
import os
import re
import subprocess
import sys
import tempfile
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
    "megakernel_guided 2x2": ("6", "cornell_alcove_baffled",
                              "nee_textbook", "voxel sharded"),
    "megakernel_nee 2x2": ("7", "cornell_box", "nee", "sharded"),
    "megakernel_nee_mat": ("8", "cornell_box", "nee", "mat"),
    "megakernel_nee_budgets": ("3", "cornell_box", "nee", "budgets"),
    "megakernel_nee_tab": ("2", "sphere_grid", "nee", "unguided"),
    "megakernel_vjp": ("9", "cornell_box", "nee", "vjp"),
    "megakernel_geom": ("11", "cornell_spheres", "nee", "geom"),
    "megakernel_geom deep": ("11", "cornell_spheres", "nee", "geom deep"),
    "guided 4 ranks": ("6", "cornell_alcove_baffled", "nee_textbook",
                       "mesh"),
}


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

    def call(case, cfg, seed):
        _, name, est, kind = CASES[case]
        if name not in scenes:
            scenes[name] = get_scene(name)
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
        return lambda: mk.render_megakernel_budgets(sc, cam, cfg, seed,
                                                    s_start, s_stop)

    res = {}
    for case in cases:
        _, name, est, kind = CASES[case]
        cfg4 = RenderConfig(width=1024, height=768, spp=4, estimator=est,
                            seed=3)
        cfg512 = RenderConfig(width=1024, height=768, spp=512,
                              estimator=est, seed=0)
        if kind == "mesh":
            res[case] = mesh_case(root)
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
            sc = get_scene(name)
            geom = mk.pack_geometry(sc, cam)
            res[case] = {
                "out": list(mgeo.geom_vjp(sc, cam, cfg4, 3,
                                          _cotangent(3, 768, 1024))),
                "ms": event_ms(lambda: mgeo.geom_run(
                    sc, cam, cfg512, 0, g512, geometry=geom), 2)}
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
        outs = "; ".join(
            f"{name} [" + ", ".join(gap(a, b) for a, b in zip(
                res[case]["out"], ref[case]["out"])) + "]"
            for name, res in runs)
        print(f"row {row} {case} ({scene}, {est}): ms "
              + (", ".join(times) or "not timed")
              + f"; outputs against this checkout's first run: {outs}",
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
        sys.exit(0)
    sys.exit(main())
