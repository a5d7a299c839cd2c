// Row 11, the geometry and material adjoint (megakernel_geom.cuh), `nee`:
// megakernel_geom<kScan, kNee> and megakernel_geom_image<kScan, kNee> under
// each scan replace the Pallas TPU kernel of
// small_pathtracer_tpu/ops/megakernel_geom.py `build_geom_grad_kernel`
// (:133; `_build_geom_run`, call :1488) with estimator nee, and row 12
// (`geom_train_step_sharded`, call :1686) on a shard's lanes. The other
// estimators' instances are in megakernel_geom_est.cu and
// megakernel_geom_direct.cu, so that the library's sources build in
// parallel (ops/_build.py).

#include "megakernel_geom.cuh"

namespace {

GeomKernels nee_geom_kernels(int est, bool tree) {
  return est == kNee ? geom_of_scan<kNee>(tree)
                     : GeomKernels{nullptr, nullptr};
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// arguments of SPT_GEOM_PARAMS (megakernel_geom.cuh), estimator nee.
extern "C" int spt_megakernel_geom(SPT_GEOM_PARAMS) {
  return launch_geom(nee_geom_kernels, kNee, 0.0f, SPT_GEOM_ARGS);
}
