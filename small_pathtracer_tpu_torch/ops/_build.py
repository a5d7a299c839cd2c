"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface, ``build/kernels/libspt_kernels.so`` at the repository root, on
first use; ``ctypes`` loads it. A hash of the sources and the flags sits
beside the library, and a change of either rebuilds it. There is no
fallback: a missing ``nvcc`` or a failed build raises.
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
    "-shared", "-Xcompiler", "-fPIC",
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
        tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in sorted(CSRC.glob("*.cu")))]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds, output = time.perf_counter() - t0, res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    lib = ctypes.CDLL(str(lib_path))
    _bind(lib)
    return KernelLib(lib, seconds, output)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.spt_megakernel_nee.restype = ctypes.c_int
    lib.spt_megakernel_nee.argtypes = [
        p,  # rect_f: (R, 11) f32 host
        p,  # rect_axis: (R,) i32 host
        i,  # n_rects
        p,  # light_f: 13 f32 host
        i,  # light_id
        p,  # cam_f: 12 f32 host
        u,  # seed
        i, i, i,  # width, height, spp
        i, i, u,  # g, per, s0
        i, i, i,  # rr_start_depth, max_bounces, fold
        p,  # out_l: (n_pix * g, 3) f32 device
        p,  # traces: (2,) u64 device
        p,  # cudaStream_t
    ]
