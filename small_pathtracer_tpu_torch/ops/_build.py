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
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
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
    # g, per, s0 between, then the shard's first pixel and pixel count
    # (0 and width * height unsharded).
    launch = [*head, i, i, u, i, i, *depth]
    # The budget kernels (row 3) take one lane a live pixel: no g, per or
    # s0.
    budget_launch = [*head, *depth]
    # A sphere table: its rows and its tree (spt_sphere_bvh's buffer and
    # root link), then the material tables.
    spheres = [
        p,  # sph: (S, 4) f32 device [cx, cy, cz, r]
        i,  # n_spheres
        p,  # bvh: f32 device, spt_sphere_bvh's buffer
        i,  # its root link
        p, p,  # albedo, emission: (R + S, 3) f32 device
        p,  # refl: (R + S,) i32 device
    ]
    live = [
        p,  # live: (n_live,) i32 device, the pixels with a non-empty span
        i,  # n_live
        p, p,  # s_start, s_stop: (n_pix,) i32 device
    ]
    lib.spt_sphere_bvh.restype = ctypes.c_int
    lib.spt_sphere_bvh.argtypes = [
        p,  # sph: (S, 4) f32 host
        i,  # n_spheres
        p,  # out: f32 host, zeroed
        ctypes.c_longlong,  # its length in floats
    ]
    lib.spt_megakernel.restype = ctypes.c_int
    lib.spt_megakernel.argtypes = [
        i,  # estimator: 0 nee, 1 cosine, 2 nee_textbook
        *scene,
        p, p,  # rect_alb, rect_emi: (R, 3) f32 host
        i,  # n_rects
        *launch,
        i,  # fold
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    # csrc/megakernel_est.cu: rows 1 and 2 with the other estimators.
    est = [
        i,  # estimator: 3 uniform, 4 uniform_corrected, 5 mixture, 6 mis,
        #     + 8 glibc_overflow (0 nee, 5 mixture)
        f,  # mixture_q
    ]
    lib.spt_megakernel_est.restype = ctypes.c_int
    lib.spt_megakernel_est.argtypes = [
        *est, *lib.spt_megakernel.argtypes[1:]]
    lib.spt_megakernel_mat.restype = ctypes.c_int
    lib.spt_megakernel_mat.argtypes = [
        i,  # estimator: 0 nee, 1 cosine, 2 nee_textbook
        *scene,
        i,  # n_rects
        *launch,
        p, p,  # albedo, emission: (R, 3) f32 device
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_est_mat.restype = ctypes.c_int
    lib.spt_megakernel_est_mat.argtypes = [
        *est, *lib.spt_megakernel_mat.argtypes[1:]]
    lib.spt_megakernel_tab.restype = ctypes.c_int
    lib.spt_megakernel_tab.argtypes = [
        i,  # estimator
        i,  # count: the counting instance (nee), traces of 5
        *scene,
        i,  # n_rects
        *launch,
        *spheres,
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_est_tab.restype = ctypes.c_int
    lib.spt_megakernel_est_tab.argtypes = [
        *est, *lib.spt_megakernel_tab.argtypes[2:]]
    # csrc/megakernel_budgets.cu: row 3 with every estimator (est as
    # above, and 0 nee, 1 cosine, 2 nee_textbook).
    lib.spt_megakernel_budgets.restype = ctypes.c_int
    lib.spt_megakernel_budgets.argtypes = [
        *est,
        *scene,
        p, p,  # rect_alb, rect_emi: (R, 3) f32 host
        i,  # n_rects
        *budget_launch,
        i,  # fold
        *live,
        p,  # out_l: (n_pix, 3) f32 device, zeroed
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_tab_budgets.restype = ctypes.c_int
    lib.spt_megakernel_tab_budgets.argtypes = [
        *est,
        *scene,
        i,  # n_rects
        *budget_launch,
        *spheres,
        *live,
        p,  # out_l: (n_pix, 3) f32 device, zeroed
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    # The guided kernels (rows 4 and 5) take the guide first.
    guide = [
        i,  # estimator: 1 cosine, 2 nee_textbook, 6 mis
        i,  # primary: 0 voxel table (row 4), 1 pixel lobes (row 5)
        p,  # table: (V,) or (n_pix,) i32 device, packed lobes
        i,  # its length
        f, f, f, f,  # beta, k, (k + 1) / (2 pi), 1 / (k + 1)
        i,  # k as an int in [1, 64], else 0
    ]
    lib.spt_megakernel_guided.restype = ctypes.c_int
    lib.spt_megakernel_guided.argtypes = [
        *guide,
        *scene,
        p, p,  # rect_alb, rect_emi: (R, 3) f32 host
        i,  # n_rects
        *launch,
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_guided_tab.restype = ctypes.c_int
    lib.spt_megakernel_guided_tab.argtypes = [
        *guide,
        *scene,
        i,  # n_rects
        *launch,
        *spheres,
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    # csrc/megakernel_ext*.cu: rows 1-7 on scenes with quads or GLOS
    # objects (every estimator code; GLOS with 1, 2 and 6 only).
    ext_scene = [
        *scene,
        i,  # n_rects
        p,  # quad_f: (Q, 19) f32 host, geometry/intersect.quad_consts
        i,  # n_quads
    ]
    gloss = p  # (R + Q + S,) f32 device, the Phong exponents
    lib.spt_megakernel_ext.restype = ctypes.c_int
    lib.spt_megakernel_ext.argtypes = [
        *est,
        *ext_scene,
        *launch,
        *spheres,
        gloss,
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_ext_budgets.restype = ctypes.c_int
    lib.spt_megakernel_ext_budgets.argtypes = [
        *est,
        *ext_scene,
        *budget_launch,
        *spheres,
        gloss,
        *live,
        p,  # out_l: (n_pix, 3) f32 device, zeroed
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_ext_guided.restype = ctypes.c_int
    lib.spt_megakernel_ext_guided.argtypes = [
        *guide,
        *ext_scene,
        *launch,
        *spheres,
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
    # Row 9: spt_megakernel_vjp takes estimators 0 nee, 1 cosine and 2
    # nee_textbook (csrc/megakernel_grad.cu), spt_megakernel_vjp_est the
    # others (csrc/megakernel_grad_est.cu: the codes of `est` above).
    vjp = [
        *scene,
        i,  # n_rects
        *launch,
        p, p,  # albedo, emission: (K, 3) f32 device, K = R + Q + S
        p,  # g_img: (n_pix_loc, 3) f32 device
        p,  # partials: f32 device scratch
        ctypes.c_longlong,  # its length in floats
        p,  # out: (2, K, 3) f32 device
        *est,
        i,  # tab: 0 a rect-only DIFF scene, 1 the sphere table
        *spheres[:4],  # sph, n_spheres, bvh, root (unused with tab 0)
        p,  # refl: (K,) i32 device (unused with tab 0)
        p,  # cudaStream_t
    ]
    for entry in (lib.spt_megakernel_vjp, lib.spt_megakernel_vjp_est):
        entry.restype = ctypes.c_int
        entry.argtypes = vjp
    # Row 9 on scenes with quads or GLOS objects (csrc/megakernel_grad_ext.cu:
    # every code of `est`; GLOS with 1, 2 and 6 only): the quads after the
    # rects as the _ext forwards take them, no `tab` (always the sphere
    # table), and the Phong exponents last.
    lib.spt_megakernel_vjp_ext.restype = ctypes.c_int
    lib.spt_megakernel_vjp_ext.argtypes = [
        *ext_scene,
        *launch,
        p, p,  # albedo, emission: (K, 3) f32 device, K = R + Q + S
        p,  # g_img: (n_pix_loc, 3) f32 device
        p,  # partials: f32 device scratch
        ctypes.c_longlong,  # its length in floats
        p,  # out: (2, K, 3) f32 device
        *est,
        *spheres[:4],  # sph, n_spheres, bvh, root
        p,  # refl: (K,) i32 device
        gloss,
        p,  # cudaStream_t
    ]
    lib.spt_megakernel_geom.restype = ctypes.c_int
    lib.spt_megakernel_geom.argtypes = [
        *scene,
        i,  # n_rects
        *launch,
        *spheres,
        i,  # bk: 0 the image-only launch, 1 the adjoint
        p,  # g_img: (n_pix_loc, 3) f32 device, or null
        p,  # partials: f32 device scratch
        ctypes.c_longlong,  # its length in floats
        p,  # out: 6 (R + S) + 4 S f32 device
        p,  # out_l: (n_pix_loc * g, 3) f32 device
        p,  # counts: (5,) u64 device
        p,  # cudaStream_t
    ]
    # Rows 11 and 12 with the other estimators: spt_megakernel_geom_est
    # (csrc/megakernel_geom_est.cu: 1 cosine, 3 uniform, 4
    # uniform_corrected, 5 mixture, 8 and 13 glibc_overflow) and
    # spt_megakernel_geom_direct (csrc/megakernel_geom_direct.cu: 2
    # nee_textbook, 6 mis) take `est` first.
    for entry in (lib.spt_megakernel_geom_est,
                  lib.spt_megakernel_geom_direct):
        entry.restype = ctypes.c_int
        entry.argtypes = [*est, *lib.spt_megakernel_geom.argtypes]
    lib.spt_sphere_queries.restype = ctypes.c_int
    lib.spt_sphere_queries.argtypes = [
        *scene,
        i,  # n_rects
        p,  # light_f: 13 f32 host
        i,  # light_id
        *spheres[:4],
        p, p,  # o, d: (N, 3) f32 device
        i,  # N
        p, p, p, p,  # t, id, ok, t_light: (N,) f32, i32, i32, f32 device
        p,  # cudaStream_t
    ]
