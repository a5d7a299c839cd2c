// Row 9, the material adjoint (megakernel_vjp.cuh), with the other
// estimators (SPT_EST_CODES, megakernel_lane.cuh): `uniform`,
// `uniform_corrected`, `mixture` and `mis`, and `nee` and `mixture` with
// light_sample_mode='glibc_overflow'. megakernel_vjp<kTab, kEst> under each
// scan replaces the Pallas TPU kernel of
// small_pathtracer_tpu/ops/megakernel_grad.py `build_grad_kernel` (:129;
// `_build_vjp`, call :1049) with those estimators: its uniform direction
// (:376-381), glibc light point (:481-486), mixture coin and
// uniform_corrected weight (:599-615), and mis's pickup weight (:265-333),
// balance-weighted direct term (:544-562, :731-777) and pdf carry
// (:832-855). Each is the forward's own branch of `bounce_scatter` and
// `render_lane`; the tape holds mis's pickup weight and direct-term weight
// as numbers and its carry in the checkpointed state.
//
// What bounds them: as megakernel_grad.cu's instances, operations (one
// trace, the sweep's arithmetic), and the tape's local memory beyond the
// function's. The instances live in their own translation unit so that
// the library's sources build in parallel (ops/_build.py).

#include "megakernel_vjp.cuh"

namespace {

VjpKernel est_vjp_kernel(int est, int scan) {
  switch (est) {
#define SPT_CASE(e) \
  case (e):         \
    return vjp_of_scan<(e)>(scan);
    SPT_EST_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// arguments of SPT_VJP_PARAMS (megakernel_vjp.cuh), est a code of
// SPT_EST_CODES: 3 uniform, 4 uniform_corrected, 5 mixture, 6 mis, 8 nee +
// glibc_overflow, 13 mixture + glibc_overflow.
extern "C" int spt_megakernel_vjp_est(SPT_VJP_PARAMS) {
  return launch_vjp(est_vjp_kernel, SPT_VJP_ARGS);
}
