// Row 9, the material adjoint (megakernel_vjp.cuh), with the `nee`,
// `cosine` and `nee_textbook` estimators: megakernel_vjp<kTab, kEst> under
// each scan (rects only, the sphere table's linear scan and its tree), and
// the host entry point spt_megakernel_vjp. The other estimators' instances
// are in megakernel_grad_est.cu, so that the library's sources build in
// parallel (ops/_build.py).

#include "megakernel_vjp.cuh"

namespace {

VjpKernel own_vjp_kernel(int est, int scan) {
  switch (est) {
    case kNee:
      return vjp_of_scan<kNee>(scan);
    case kCosine:
      return vjp_of_scan<kCosine>(scan);
    case kTextbook:
      return vjp_of_scan<kTextbook>(scan);
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// arguments of SPT_VJP_PARAMS (megakernel_vjp.cuh), est 0 nee, 1 cosine or
// 2 nee_textbook.
extern "C" int spt_megakernel_vjp(SPT_VJP_PARAMS) {
  return launch_vjp(own_vjp_kernel, SPT_VJP_ARGS);
}
