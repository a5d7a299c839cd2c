"""Compares the two adjoint kernels of this checkout with another
checkout's on one NVIDIA GPU.

    python3 tools/adjoint_builds.py OTHER

OTHER is the root of another checkout of the repository, for example a
parent commit unpacked into a git-ignored directory:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent

Each checkout builds its own kernels into its own build/, in a process of
its own, in the order OTHER, this, this, OTHER. Prints the card's name and
power limit; then, for ``megakernel_vjp`` on ``cornell_box`` and the
adjoint launch of ``megakernel_geom`` on ``cornell_spheres``, the largest
gap of each gradient table between the two checkouts at 1024x768x4 (seed 3,
cotangent seeds 5 and 3, as chip_smoke.py), absolute and over the table's
largest entry, and each run's CUDA-event time of a launch at 1024x768x512
seed 0 (cotangent 1e-7, as chip_smoke.py); and the same gaps for
``megakernel_geom`` on deep paths: ``cornell_spheres`` 64x48x4 with
rr_start_depth = max_bounces = 200 and every albedo 0.98, so that every
path runs 200 bounces. It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TABLES = {"megakernel_vjp": ("albedo", "emission"),
          "megakernel_geom": ("sphere rows", "albedo", "emission"),
          "megakernel_geom deep": ("sphere rows", "albedo", "emission")}


def event_ms(fn, n: int = 2) -> float:
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


def worker(root: str, out: str) -> None:
    """In the checkout at ``root``: the gradients at x4 and the x512 times,
    saved to ``out``."""
    sys.path.insert(0, root)
    from small_pathtracer_tpu_torch import (
        RenderConfig, get_scene, make_camera,
    )
    from small_pathtracer_tpu_torch.ops import megakernel
    from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu_torch.ops import megakernel_grad as mg

    box, sph = get_scene("cornell_box"), get_scene("cornell_spheres")
    cam = make_camera(aspect=1024 / 768)
    alb, emi = mg.pack_materials(box)
    cfg4 = RenderConfig(width=1024, height=768, spp=4, seed=3)
    cfg512 = RenderConfig(width=1024, height=768, spp=512, seed=0)

    def cot(seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (768, 1024, 3)).astype(np.float32)).to("cuda")

    cfg_deep = RenderConfig(width=64, height=48, spp=4, seed=3,
                            rr_start_depth=200, max_bounces=200)
    t_sph, t_alb, t_emi = mgeo.pack_tables(sph)
    sph_deep = mgeo.scene_with_tables(sph, t_sph, torch.full_like(t_alb, 0.98),
                                      t_emi)
    g_deep = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (48, 64, 3)).astype(np.float32)).to("cuda")
    g512 = torch.full((768, 1024, 3), 1e-7, device="cuda")
    geom_box = megakernel.pack_geometry(box, cam)
    geom_sph = megakernel.pack_geometry(sph, cam)
    grads = {
        "megakernel_vjp": mg.render_megakernel_vjp(box, cam, cfg4, alb, emi,
                                                   3, cot(5)),
        "megakernel_geom": mgeo.geom_vjp(sph, cam, cfg4, 3, cot(3)),
        "megakernel_geom deep": mgeo.geom_vjp(
            sph_deep, make_camera(aspect=64 / 48), cfg_deep, 3, g_deep),
    }
    ms = {
        "megakernel_vjp": event_ms(lambda: mg.render_megakernel_vjp(
            box, cam, cfg512, alb, emi, 0, g512, geometry=geom_box)),
        "megakernel_geom": event_ms(lambda: mgeo.geom_run(
            sph, cam, cfg512, 0, g512, geometry=geom_sph)),
    }
    torch.save({"grads": {k: [t.cpu() for t in v] for k, v in grads.items()},
                "ms": ms}, out)


def main(other: str) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    roots = {"other": str(Path(other).resolve()), "this": str(ROOT)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--worker",
                            roots[name], out], check=True)
            runs.append((name, torch.load(out)))
    first = {name: res for name, res in reversed(runs)}
    for kname, labels in TABLES.items():
        gaps = []
        for label, a, ref in zip(labels, first["other"]["grads"][kname],
                                 first["this"]["grads"][kname]):
            gap = float((a - ref).abs().max())
            gaps.append(f"{label} {gap:.3e} ({gap / float(ref.abs().max()):.3e}"
                        " of its largest entry)")
        print(f"{kname}, other against this: " + "; ".join(gaps))
        if kname not in runs[0][1]["ms"]:
            continue
        print(f"{kname} 1024x768x512 seed 0, ms a launch (CUDA events, two "
              "launches a run): " + ", ".join(
                  f"{name} {res['ms'][kname]:.3f}" for name, res in runs))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:4])
        sys.exit(0)
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
