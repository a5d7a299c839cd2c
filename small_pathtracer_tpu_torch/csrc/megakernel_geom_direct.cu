// Row 11, the geometry and material adjoint (megakernel_geom.cuh), with the
// estimators that add a direct term at each diffuse vertex: `nee_textbook`
// and `mis`. megakernel_geom<kScan, kEst> and megakernel_geom_image<kScan,
// kEst> under each scan replace the Pallas TPU kernel of
// small_pathtracer_tpu/ops/megakernel_geom.py `build_geom_grad_kernel`
// (:133; `_build_geom_run`, call :1488; row 12 on a shard's lanes, call
// :1686) with those estimators: the direct term and its weight w_tb through
// x and n (:615-633, :775-789, :1011-1015), nee_textbook's suppressed
// pickup after a counted probe (:351-354), and mis's balance weights, the
// light strategy's at the probe direction (:594-614, :994-1010) and the
// pickup's w_b(t, d, mpdf) on a BSDF-sampled hit of the light (:355-387,
// :790-800, :1094-1112), with the pdf carry's cotangent routed one bounce
// back (λ_mpdf, :801-804, :1113-1127, :1333-1355). `mis` ignores
// light_sample_mode='glibc_overflow', as the JAX package's config.py:43-50
// says (the JAX kernel's :532 applies it: a defect of the reference,
// ROADMAP.md). The tape entry and state are each one's own (GeomTape):
// nee_textbook's suppression flag and mis's carry in 64 bytes.

#include "megakernel_geom.cuh"

namespace {

GeomKernels direct_geom_kernels(int est, bool tree) {
  switch (est) {
    case kTextbook:
      return geom_of_scan<kTextbook>(tree);
    case kMis:
      return geom_of_scan<kMis>(tree);
    default:
      return GeomKernels{nullptr, nullptr};
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): est 2
// nee_textbook or 6 mis, mixture_q (unused), then the arguments of
// SPT_GEOM_PARAMS (megakernel_geom.cuh).
extern "C" int spt_megakernel_geom_direct(int est, float mixture_q,
                                          SPT_GEOM_PARAMS) {
  return launch_geom(direct_geom_kernels, est, mixture_q, SPT_GEOM_ARGS);
}
