// Row 11, the geometry and material adjoint (megakernel_geom.cuh), with the
// estimators that add no direct term: `cosine`, `uniform`,
// `uniform_corrected`, `mixture`, and `nee` and `mixture` with
// light_sample_mode='glibc_overflow' (SPT_GEOM_EST_CODES).
// megakernel_geom<kScan, kEst> and megakernel_geom_image<kScan, kEst> under
// each scan replace the Pallas TPU kernel of
// small_pathtracer_tpu/ops/megakernel_geom.py `build_geom_grad_kernel`
// (:133; `_build_geom_run`, call :1488; row 12 on a shard's lanes, call
// :1686) with those estimators: the hemisphere sample and the uniform one
// (:428-438), glibc's light point (:532-537), mixture's coin (:646-654) and
// uniform_corrected's weight (:666-671, :1027-1030). Each is the
// forward's own branch of `bounce_scatter`; the pullback adds the uniform
// sample's constants, uniform_corrected's 2 max(d'·n, 0) through n and d',
// and mixture's NEE branch where its coin took NEE. The instances live in
// their own translation unit so that the library's sources build in
// parallel (ops/_build.py).

#include "megakernel_geom.cuh"

// The codes of this file (megakernel_lane.cuh), as X(code).
#define SPT_GEOM_EST_CODES(X) \
  X(kCosine)                  \
  X(kUniform)                 \
  X(kUniformCorrected)        \
  X(kMixture)                 \
  X(kNee | kGlibc)            \
  X(kMixture | kGlibc)

namespace {

GeomKernels est_geom_kernels(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e) \
  case (e):         \
    return geom_of_scan<(e)>(tree);
    SPT_GEOM_EST_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return GeomKernels{nullptr, nullptr};
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): est a
// code of SPT_GEOM_EST_CODES (1 cosine, 3 uniform, 4 uniform_corrected,
// 5 mixture, 8 nee + glibc_overflow, 13 mixture + glibc_overflow),
// mixture_q the mixture's NEE probability, then the arguments of
// SPT_GEOM_PARAMS (megakernel_geom.cuh).
extern "C" int spt_megakernel_geom_est(int est, float mixture_q,
                                       SPT_GEOM_PARAMS) {
  return launch_geom(est_geom_kernels, est, mixture_q, SPT_GEOM_ARGS);
}
