"""Host builds of the port's CUDA headers for the CPU tests.

``csrc/megakernel_common.cuh`` and ``csrc/megakernel_bvh.cuh`` hold host
functions (``fill_params``, ``build_sphere_bvh``) and device functions
written as plain C++ (the scans). The tests compile them with the host C++
compiler against ``CUDA_STAND_IN``, a small stand-in for ``cuda_runtime.h``,
with FMA contraction off as the library's ``--fmad=false``, and load the
result with ctypes."""

import ctypes
import shutil
import subprocess
from pathlib import Path

from small_pathtracer_tpu_torch.ops import megakernel

CSRC = Path(megakernel.__file__).resolve().parent.parent / "csrc"

# What the headers need of the CUDA runtime to compile for the host.
CUDA_STAND_IN = r"""
#pragma once
#include <math.h>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static
#define __restrict__
struct Idx { int x; };
static Idx threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
struct float4 { float x, y, z, w; };
template <class T> T __ldg(const T* p) { return *p; }
"""


def build_host_lib(directory: Path, name: str, source: str) -> ctypes.CDLL:
    """Compiles ``source`` (C++ including the csrc headers) into a shared
    library in ``directory`` and loads it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build the csrc headers"
    (directory / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    (directory / f"{name}.cpp").write_text(source)
    lib_path = directory / f"{name}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{directory}", f"-I{CSRC}", "-o",
                    str(lib_path), str(directory / f"{name}.cpp")],
                   check=True)
    return ctypes.CDLL(str(lib_path))
