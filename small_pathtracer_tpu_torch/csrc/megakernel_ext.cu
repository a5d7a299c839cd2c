// Rows 1, 2 and 7 of the kernel table on scenes with general quads or GLOS
// (modified-Phong) objects, every estimator: row 2's table kernel
// (`tab_body`, megakernel_lane.cuh) with the estimator code's scene flags
// kWithQuads and, for cosine, nee_textbook and mis, kWithGlos.
//
// - megakernel_ext<kEst, kScan> replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel` (:1203, its
//   `pallas_call` at :2670) on scenes with quads or GLOS objects, which the
//   TPU kernel renders unrolled (a sphere table refuses GLOS spheres
//   there). The port renders them through its table kernel: the rects and
//   the quads sit in kernel parameters (the quads in a QuadTab beside
//   Params, so the other kernels' parameters stay as they were), the
//   spheres in the table (its
//   linear or tree scan), the materials, codes and Phong exponents in
//   device memory. Row 7 runs it on a shard's lanes.
// - Quads (`_iter_hits` :322-370): the plane hit through the unnormalized
//   normal and the 2x2 Gram solve with 1 / det, all constants from the
//   host (quad_hit, megakernel_common.cuh). They are scanned after the
//   three axis groups in id order with a strict <, so the nearest hit is
//   the in-order scan's; the light may be a quad (probe_light_quads: the
//   rects and the quads before it block at t <= t_l, the ones after it at
//   t < t_l, the spheres at t < t_l).
// - GLOS (:783-790, :1750-1790, :2055, :2121, :2248, :2375): the winner's
//   flag and exponent (read from the (K,) exponents at the winner, so the
//   sphere table's rows stay four floats), the Phong lobe around the
//   mirror of d about the oriented normal from the cosine sample's draws
//   (cos = u2^(1/(n+1)) by pow_pos), its weight (n+2)/(n+1) max(cos, 0)
//   and the absorption of a sample below the surface; the direct term of
//   nee_textbook and mis with the lobe's BRDF in place of cos/pi, and mis's
//   competing pdf and continuation pdf, the lobe's.
//
// What bounds them: as rows 1 and 2 (megakernel.cu), arithmetic and
// divergence. A quad test is ~30 fp32 operations and a divide; a GLOS
// vertex adds the lobe frame, a real power from ~30 operations and, with
// a probe, two more powers. Every branch sits behind the scene flags, so
// the instances of megakernel.cu, megakernel_est.cu and
// megakernel_budgets.cu compile as before.

#include "megakernel_lane.cuh"

namespace {

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_ext(const __grid_constant__ Params p,
                   const __grid_constant__ QuadTab qt,
                   const float4* __restrict__ sph, int n_sph,
                   const float4* __restrict__ bvh, int root,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const int* __restrict__ refl,
                   const float* __restrict__ gloss, float* __restrict__ out_l,
                   unsigned long long* __restrict__ traces) {
  tab_body<kEst, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,
                        traces, gloss, &qt);
}

using RowExt = decltype(&megakernel_ext<kNee, kScanLinear>);

RowExt ext_kernel(int est, bool tree) {
  switch (est) {
#define SPT_CASE(e)                                                      \
  case (e):                                                              \
    return tree ? megakernel_ext<ext_code(e), kScanTree>                 \
                : megakernel_ext<ext_code(e), kScanLinear>;
    SPT_EXT_CODES(SPT_CASE)
#undef SPT_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes), as in
// megakernel.cu. est: any estimator code of SPT_EXT_CODES (kNee ... kMis,
// kNee | kGlibc, kMixture | kGlibc; others are refused:
// cudaErrorInvalidValue); mixture_q: the mixture's NEE probability. The
// rects as spt_megakernel takes them; quad_f: (n_quads, 19) float32 host
// rows (geometry/intersect.quad_consts); the light may be a rect or a quad
// (light_id < n_rects + n_quads). The sphere table and the (K,) tables as
// spt_megakernel_tab, with K = n_rects + n_quads + n_spheres, refl's GLOS
// code 3, and gloss: the (K,) float32 Phong exponents in device memory.
extern "C" int spt_megakernel_ext(
    int est, float mixture_q, const float* rect_geom, const int* rect_axis,
    int n_rects, const float* quad_f, int n_quads, const float* light_f,
    int light_id, const float* cam_f, unsigned seed, int width, int height,
    int spp, int g, int per, unsigned s0, int pix0, int n_pix_loc,
    int rr_start_depth, int max_bounces, const float* sph, int n_spheres,
    const float* bvh, int root, const float* alb, const float* emi,
    const int* refl, const float* gloss, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  const RowExt kernel = ext_kernel(est, root >= 0);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces, n_quads) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, fill_quads(p, quad_f, n_quads), reinterpret_cast<const float4*>(sph),
      n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, gloss,
      out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
