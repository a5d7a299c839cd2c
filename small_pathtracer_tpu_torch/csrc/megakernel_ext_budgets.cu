// Row 3 of the kernel table, per-pixel sample budgets, on scenes with
// general quads or GLOS objects, every estimator: megakernel_ext
// (megakernel_ext.cu) with the lanes of megakernel_budgets.cu, one lane a
// live pixel (lane_range_budgets).
//
// megakernel_ext_budgets<kEst, kScan> replaces the Pallas TPU kernel of
// small_pathtracer_tpu/ops/megakernel.py: `_build_render_budgets` (:2756,
// its `pallas_call` at :2783) for `render_pallas_budgets` on those scenes.
// What bounds it and its branches: megakernel_ext.cu.

#include "megakernel_lane.cuh"

namespace {

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_ext_budgets(const __grid_constant__ Params p,
                           const __grid_constant__ QuadTab qt,
                           const float4* __restrict__ sph, int n_sph,
                           const float4* __restrict__ bvh, int root,
                           const float* __restrict__ alb,
                           const float* __restrict__ emi,
                           const int* __restrict__ refl,
                           const float* __restrict__ gloss,
                           const int* __restrict__ live,
                           const int* __restrict__ s_start,
                           const int* __restrict__ s_stop,
                           float* __restrict__ out_l,
                           unsigned long long* __restrict__ traces) {
  const TableMaterials mats{alb, emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, kScan, kEst, NoGuide, true>(
      p, lane_range_budgets(p, live, s_start, s_stop), mats,
      sphere_tab(sph, n_sph, refl, bvh, root, gloss, &qt),
      nee_cont(kEst) && fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f, out_l, traces);
}

using RowExt3 = decltype(&megakernel_ext_budgets<kNee, kScanLinear>);

RowExt3 ext_budgets_kernel(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                                      \
  case (e):                                                              \
    return tree ? megakernel_ext_budgets<ext_code(e), kScanTree>         \
                : megakernel_ext_budgets<ext_code(e), kScanLinear>;
    SPT_EXT_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// arguments of spt_megakernel_ext (megakernel_ext.cu) with the lanes of
// spt_megakernel_tab_budgets (megakernel_budgets.cu): no g, per, s0 or
// shard; live (n_live,), s_start and s_stop (width * height,) int32 device
// arrays; out_l (width * height, 3), zeroed.
extern "C" int spt_megakernel_ext_budgets(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* quad_f, int n_quads, const float* light_f,
    int light_id, const float* cam_f, unsigned seed, int width, int height,
    int spp, int rr_start_depth, int max_bounces, const float* sph,
    int n_spheres, const float* bvh, int root, const float* alb,
    const float* emi, const int* refl, const float* gloss, const int* live,
    int n_live, const int* s_start, const int* s_stop, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  const RowExt3 kernel = ext_budgets_kernel(est, root >= 0);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, 1, 0, 0u, 0, n_live,
                   rr_start_depth, max_bounces, n_quads) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, fill_quads(p, quad_f, n_quads), reinterpret_cast<const float4*>(sph),
      n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, gloss,
      live, s_start, s_stop, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
