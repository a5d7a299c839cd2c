// Row 3 of the kernel table, per-pixel sample budgets, with every
// estimator: `nee`, `cosine`, `nee_textbook`, `uniform`,
// `uniform_corrected`, `mixture`, `mis`, and `nee` and `mixture` with
// light_sample_mode='glibc_overflow'.
//
// megakernel_est_budgets<kEst> (baked rect scenes) and
// megakernel_est_tab_budgets<kEst, kScan> (the sphere table) replace the
// Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel.py:
// `_build_render_budgets` (:2756, its `pallas_call` at :2783) as
// `render_pallas_budgets` builds it for the adaptive waves of
// utils/adaptive.py: rows 1 and 2 (megakernel.cu, megakernel_est.cu) with
// per-pixel sample budgets. The wrapper lists the pixels with a non-empty
// span (an int32 device array) and launches one lane for each: lane i
// renders pixel live[i]'s span [s_start, s_stop), read from two int32
// device arrays (lane_range_budgets), and writes that pixel's row. The TPU
// kernel's padded px, py and pid_base planes are derived from the pixel
// instead. So a late wave, where most pixels have stopped, launches only
// its live pixels' lanes; each pixel is still summed by one lane in sample
// order. What bounds them, and the estimators' branches: megakernel.cu and
// megakernel_est.cu.

#include "megakernel_lane.cuh"

namespace {

// The estimators this file instantiates, as X(code).
#define SPT_BUDGET_CODES(X) \
  X(kNee)                   \
  X(kCosine)                \
  X(kTextbook)              \
  X(kUniform)               \
  X(kUniformCorrected)      \
  X(kMixture)               \
  X(kMis)                   \
  X(kNee | kGlibc)          \
  X(kMixture | kGlibc)

template <int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_est_budgets(const __grid_constant__ Params p,
                           const int* __restrict__ live,
                           const int* __restrict__ s_start,
                           const int* __restrict__ s_stop,
                           float* __restrict__ out_l,
                           unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone, kEst, NoGuide, true>(
      p, lane_range_budgets(p, live, s_start, s_stop), BakedMaterials{p},
      SphereTab{}, p.fold != 0, out_l, traces);
}

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_est_tab_budgets(const __grid_constant__ Params p,
                               const float4* __restrict__ sph, int n_sph,
                               const float4* __restrict__ bvh, int root,
                               const float* __restrict__ alb,
                               const float* __restrict__ emi,
                               const int* __restrict__ refl,
                               const int* __restrict__ live,
                               const int* __restrict__ s_start,
                               const int* __restrict__ s_stop,
                               float* __restrict__ out_l,
                               unsigned long long* __restrict__ traces) {
  const TableMaterials mats{alb, emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, kScan, kEst, NoGuide, true>(
      p, lane_range_budgets(p, live, s_start, s_stop), mats,
      sphere_tab(sph, n_sph, refl, bvh, root),
      nee_cont(kEst) && fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f, out_l, traces);
}

using Row3 = decltype(&megakernel_est_budgets<kCosine>);
using Row3Tab = decltype(&megakernel_est_tab_budgets<kCosine, kScanLinear>);

Row3 row3_kernel(int est) {
  switch (est) {
#define SPT_CASE(e) \
  case (e):         \
    return megakernel_est_budgets<(e)>;
    SPT_BUDGET_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

Row3Tab row3_tab_kernel(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                          \
  case (e):                                                  \
    return tree ? megakernel_est_tab_budgets<(e), kScanTree> \
                : megakernel_est_tab_budgets<(e), kScanLinear>;
    SPT_BUDGET_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes), as in
// megakernel.cu. est: one of SPT_BUDGET_CODES (others are refused:
// cudaErrorInvalidValue); mixture_q: the mixture's NEE probability. One
// lane a live pixel, n_live lanes (1 to width * height), lane i rendering
// samples [s_start[j], s_stop[j]) of pixel j = live[i]; live (n_live,),
// s_start and s_stop (width * height,) int32 device arrays. out_l is
// (width * height, 3), zeroed: the kernel writes the live pixels' rows.

// Row 3 on rect-only DIFF scenes, baked materials as spt_megakernel (fold:
// the NEE fold, kNee and kMixture only).
extern "C" int spt_megakernel_budgets(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    const float* rect_alb, const float* rect_emi, int n_rects,
    const float* light_f, int light_id, const float* cam_f, unsigned seed,
    int width, int height, int spp, int rr_start_depth, int max_bounces,
    int fold, const int* live, int n_live, const int* s_start,
    const int* s_stop, float* out_l, unsigned long long* traces,
    void* stream) {
  Params p;
  const Row3 kernel = row3_kernel(est);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, 1, 0, 0u, 0, n_live,
                   rr_start_depth, max_bounces) ||
      kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bake_materials(&p, rect_alb, rect_emi, n_rects, nee_cont(est) ? fold : 0);
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, live, s_start, s_stop, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 3 with the sphere table: the tables as spt_megakernel_tab.
extern "C" int spt_megakernel_tab_budgets(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* light_f, int light_id, const float* cam_f,
    unsigned seed, int width, int height, int spp, int rr_start_depth,
    int max_bounces, const float* sph, int n_spheres, const float* bvh,
    int root, const float* alb, const float* emi, const int* refl,
    const int* live, int n_live, const int* s_start, const int* s_stop,
    float* out_l, unsigned long long* traces, void* stream) {
  Params p;
  const Row3Tab kernel = row3_tab_kernel(est, root >= 0);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, 1, 0, 0u, 0, n_live,
                   rr_start_depth, max_bounces) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, live,
      s_start, s_stop, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
