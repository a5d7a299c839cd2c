"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` into an object, all at once in
parallel, and links them into one shared library with a plain C interface,
``build/kernels/libspt_kernels.so`` at the repository root, on first use;
``ctypes`` loads it. A hash of the sources and the flags sits beside the
library, and a change of either rebuilds it. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
LIB_NAME = "libspt_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No FMA contraction, IEEE division and sqrt (nvcc's defaults without
    # --use_fast_math): the kernel rounds like the eager torch ops.
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)


class KernelLib(NamedTuple):
    lib: ctypes.CDLL
    build_seconds: float  # 0.0 when the library was already built
    build_output: str     # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH, nor in $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc, *NVCC_FLAGS)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {res.returncode}):\n{res.stdout}{res.stderr}"
        )
    return res.stdout + res.stderr


def _compile_all(nvcc: str, tag: str) -> tuple[list[Path], str]:
    """One nvcc per source, all started together; waits for every one and
    raises if any failed. Returns (objects, the compilers' output)."""
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, obj, proc))
    outputs, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        outputs.append(f"{src.name}:\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode})")
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "".join(outputs))
    return [obj for _, obj, _ in jobs], "".join(outputs)


def build_kernels() -> KernelLib:
    """Compile (if the sources changed) and load the kernel library."""
    nvcc = find_nvcc()
    digest = _digest(nvcc)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    seconds, output = 0.0, ""
    if not (lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        t0 = time.perf_counter()
        objs, output = _compile_all(nvcc, tag)
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        output += _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink()
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    lib = ctypes.CDLL(str(lib_path))
    _bind(lib)
    return KernelLib(lib, seconds, output)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    # Geometry, light and camera (host), then the launch settings: the
    # leading arguments of every entry point.
    scene = [
        p,  # rect_geom: (R, 5) f32 host [k, lo0, lo1, hi0, hi1]
        p,  # rect_axis: (R,) i32 host
    ]
    head = [
        p,  # light_f: 13 f32 host
        i,  # light_id
        p,  # cam_f: 12 f32 host
        u,  # seed
        i, i, i,  # width, height, spp
    ]
    depth = [i, i]  # rr_start_depth, max_bounces
    launch = [*head, i, i, u, *depth]  # g, per, s0 between
    # The budget kernels (row 3) take one lane a pixel: no g, per or s0.
    budget_launch = [*head, *depth]
    lib.spt_megakernel_nee.restype = ctypes.c_int
    lib.spt_megakernel_nee.argtypes = [
        *scene,
        p, p,  # rect_alb, rect_emi: (R, 3) f32 host
        i,  # n_rects
        *launch,
        i,  # fold
        p,  # out_l: (n_pix * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_nee_mat.restype = ctypes.c_int
    lib.spt_megakernel_nee_mat.argtypes = [
        *scene,
        i,  # n_rects
        *launch,
        p, p,  # albedo, emission: (R, 3) f32 device
        p,  # out_l: (n_pix * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_nee_tab.restype = ctypes.c_int
    lib.spt_megakernel_nee_tab.argtypes = [
        *scene,
        i,  # n_rects
        *launch,
        p,  # sph: (S, 4) f32 device [cx, cy, cz, r]
        i,  # n_spheres
        p, p,  # albedo, emission: (R + S, 3) f32 device
        p,  # refl: (R + S,) i32 device
        p,  # out_l: (n_pix * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_nee_budgets.restype = ctypes.c_int
    lib.spt_megakernel_nee_budgets.argtypes = [
        *scene,
        p, p,  # rect_alb, rect_emi: (R, 3) f32 host
        i,  # n_rects
        *budget_launch,
        i,  # fold
        p, p,  # s_start, s_stop: (n_pix,) i32 device
        p,  # out_l: (n_pix, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_nee_tab_budgets.restype = ctypes.c_int
    lib.spt_megakernel_nee_tab_budgets.argtypes = [
        *scene,
        i,  # n_rects
        *budget_launch,
        p,  # sph: (S, 4) f32 device [cx, cy, cz, r]
        i,  # n_spheres
        p, p,  # albedo, emission: (R + S, 3) f32 device
        p,  # refl: (R + S,) i32 device
        p, p,  # s_start, s_stop: (n_pix,) i32 device
        p,  # out_l: (n_pix, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_vjp.restype = ctypes.c_int
    lib.spt_megakernel_vjp.argtypes = [
        *scene,
        i,  # n_rects
        *launch,
        p, p,  # albedo, emission: (R, 3) f32 device
        p,  # g_img: (h, w, 3) f32 device
        p,  # partials: f32 device scratch
        ctypes.c_longlong,  # its length in floats
        p,  # out: (2, R, 3) f32 device
        p,  # cudaStream_t
    ]
