// Rows 1, 2 and 8 of the kernel table with the estimators of ROADMAP item
// 10 (the loop body of megakernel.cu, `render_lane` in megakernel_lane.cuh,
// with another estimator argument): `uniform`, `uniform_corrected`,
// `mixture` and `mis`, and `nee` and `mixture` with
// light_sample_mode='glibc_overflow' (SPT_EST_CODES).
//
// - megakernel_est<kEst> replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel` (:1203) with
//   estimator uniform, uniform_corrected, mixture or mis (`pallas_call` at
//   :2670), baked rect scenes. megakernel_est_tab<kEst, kScan> replaces the
//   same call with `sphere_tab=True`: the sphere table through its tree or
//   its linear scan, SPEC and REFR (as megakernel_nee_tab in megakernel.cu).
// - megakernel_est_mat<kEst> is row 8 on rect-only DIFF scenes with these
//   estimators: small_pathtracer_tpu/ops/megakernel_grad.py `_build_fwd_mat`
//   (:980) for `render_pallas_mat`, the runtime (K, 3) tables copied into
//   shared memory once a block (`mat_body`, as megakernel_nee_mat). On
//   sphere or SPEC/REFR scenes row 8 is megakernel_est_tab with the
//   runtime tables. Equal tables give rows 1 and 2's image and traces bit
//   for bit.
// - uniform and uniform_corrected sample the uniform hemisphere (cos theta
//   = 1 - u2) from the cosine sample's draws, with the reference's weight 1
//   or 2 max(cos, 0) (the TPU kernel's :1738-1743, :2186-2190); no probe.
// - mixture draws its coin (P_MIX_COIN) first and probes the light only
//   where the coin falls below mixture_q (the TPU kernel probes every
//   diffuse lane and discards the result where the coin says no: every
//   draw is keyed by its counter, so skipping the probe changes no bit);
//   the probe counts where it is taken and the lane survives RR
//   (:2172-2181). The NEE fold applies where the coin took NEE (:1375-1384,
//   :2295-2296).
// - mis: textbook NEE's probe and direct term, the direct term weighted by
//   p_light / (p_light + p_bsdf) at the light sample (:2077-2120), and a
//   pickup of the light by p_bsdf / (p_bsdf + p_light) with the previous
//   diffuse vertex's p_bsdf, a float the lane carries across the bounce
//   loop and zeroes on a respawn (:1536-1551, :1589-1592, :1684-1690,
//   :2362-2393). p_light = t^2 / (A max(|cos_l|, 1e-6)), with the hit's t
//   at the pickup and t_safe at the probe.
// - kGlibc (nee, mixture): the light point is the corner plus glibc's
//   wrapped offsets along the unit edges (:1448-1451, :1963-1966): an
//   unsigned product, a reinterpret and __int2float_rn.
//
// What bounds them: as rows 1 and 2 (megakernel.cu), arithmetic and
// divergence, not bytes. mis adds two balance weights (~12 fp32
// operations each) and one float of loop-live state; the uniform sample
// costs what the cosine one does. Every new branch and the mis carry sit
// behind `if constexpr`, so megakernel.cu's instances compile as before;
// the new instances live in this translation unit so that the library's
// sources build in parallel (ops/_build.py).

#include "megakernel_lane.cuh"

namespace {

template <int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_est(const __grid_constant__ Params p, float* __restrict__ out_l,
                   unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone, kEst>(
      p, lane_range(p), BakedMaterials{p}, SphereTab{}, p.fold != 0, out_l,
      traces);
}

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_est_tab(const __grid_constant__ Params p,
                       const float4* __restrict__ sph, int n_sph,
                       const float4* __restrict__ bvh, int root,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const int* __restrict__ refl, float* __restrict__ out_l,
                       unsigned long long* __restrict__ traces) {
  tab_body<kEst, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,
                        traces);
}

template <int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_est_mat(const __grid_constant__ Params p,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       float* __restrict__ out_l,
                       unsigned long long* __restrict__ traces) {
  mat_body<kEst>(p, alb, emi, out_l, traces);
}

using Row1 = decltype(&megakernel_est<kUniform>);
using Row2 = decltype(&megakernel_est_tab<kUniform, kScanLinear>);

Row1 row1_kernel(int est) {
  switch (est) {
#define SPT_CASE(e) \
  case (e):         \
    return megakernel_est<(e)>;
    SPT_EST_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

using Row8 = decltype(&megakernel_est_mat<kUniform>);

Row8 row8_kernel(int est) {
  switch (est) {
#define SPT_CASE(e) \
  case (e):         \
    return megakernel_est_mat<(e)>;
    SPT_EST_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

Row2 row2_kernel(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                       \
  case (e):                                               \
    return tree ? megakernel_est_tab<(e), kScanTree>      \
                : megakernel_est_tab<(e), kScanLinear>;
    SPT_EST_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes), as in
// megakernel.cu. est: kUniform, kUniformCorrected, kMixture, kMis, or
// kNee | kGlibc, kMixture | kGlibc (others are refused:
// cudaErrorInvalidValue); mixture_q: the mixture's NEE probability.

// Row 1, baked materials: the arguments of spt_megakernel after est (fold:
// the NEE fold, kNee and kMixture only).
extern "C" int spt_megakernel_est(int est, float mixture_q,
                                  const float* rect_geom,
                                  const int* rect_axis, const float* rect_alb,
                                  const float* rect_emi, int n_rects,
                                  const float* light_f, int light_id,
                                  const float* cam_f, unsigned seed,
                                  int width, int height, int spp, int g,
                                  int per, unsigned s0, int pix0,
                                  int n_pix_loc, int rr_start_depth,
                                  int max_bounces, int fold, float* out_l,
                                  unsigned long long* traces, void* stream) {
  Params p;
  const Row1 kernel = row1_kernel(est);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bake_materials(&p, rect_alb, rect_emi, n_rects, nee_cont(est) ? fold : 0);
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 2, the sphere table: the arguments of spt_megakernel_tab after its
// count flag (the linear or the tree instance by the root link).
extern "C" int spt_megakernel_est_tab(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* light_f, int light_id, const float* cam_f,
    unsigned seed, int width, int height, int spp, int g, int per,
    unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,
    int max_bounces, const float* sph, int n_spheres, const float* bvh,
    int root, const float* alb, const float* emi, const int* refl,
    float* out_l, unsigned long long* traces, void* stream) {
  Params p;
  const Row2 kernel = row2_kernel(est, root >= 0);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, out_l,
      traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 8 on rect-only DIFF scenes: the arguments of spt_megakernel_mat after
// est (alb, emi (n_rects, 3) float32 device tables; the NEE fold decided in
// the kernel). On sphere or SPEC/REFR scenes row 8 is spt_megakernel_est_tab
// with the runtime tables.
extern "C" int spt_megakernel_est_mat(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* light_f, int light_id, const float* cam_f,
    unsigned seed, int width, int height, int spp, int g, int per,
    unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,
    int max_bounces, const float* alb, const float* emi, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  const Row8 kernel = row8_kernel(est);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, alb, emi, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
