// Rows 4, 5 and 6 of the kernel table on scenes with general quads: the
// guided kernels of megakernel_guided.cu (their table instances) with the
// scene flag kWithQuads. The guide refuses GLOS objects, as the TPU
// kernel does (`build_kernel` :1266-1270: the mixture reweights against
// the cosine pdf), so these instances take no GLOS lobe.
//
// - megakernel_ext_guided<kEst, kScan> replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `_build_render_guided` (:2934,
//   its `pallas_call` at :2972) on scenes with quads; row 6
//   (`_build_render_guided_sharded`, :3241) runs it on a shard's lanes.
// - megakernel_ext_guided_primary<kEst, kScan> replaces
//   `_build_render_guided_primary` (:3074, `pallas_call` at :3111).
//
// What bounds them: megakernel_guided.cu, and a quad test a query.

#include "megakernel_lane.cuh"

namespace {

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_ext_guided(const __grid_constant__ Params p,
                          const __grid_constant__ QuadTab qt,
                          const int* __restrict__ table, GuideParams g,
                          const float4* __restrict__ sph, int n_sph,
                          const float4* __restrict__ bvh, int root,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const int* __restrict__ refl,
                          float* __restrict__ out_l,
                          unsigned long long* __restrict__ traces) {
  __shared__ int s_tab[kNVoxels];
  for (int i = threadIdx.x; i < kNVoxels; i += kBlock) s_tab[i] = table[i];
  __syncthreads();
  render_lane<TableMaterials, kScan, kEst | kWithQuads>(
      p, lane_range(p), TableMaterials{alb, emi},
      sphere_tab(sph, n_sph, refl, bvh, root, nullptr, &qt), false, out_l,
      traces,
      VoxelGuide{s_tab, g});
}

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_ext_guided_primary(const __grid_constant__ Params p,
                                  const __grid_constant__ QuadTab qt,
                                  const int* __restrict__ lobes,
                                  GuideParams g,
                                  const float4* __restrict__ sph, int n_sph,
                                  const float4* __restrict__ bvh, int root,
                                  const float* __restrict__ alb,
                                  const float* __restrict__ emi,
                                  const int* __restrict__ refl,
                                  float* __restrict__ out_l,
                                  unsigned long long* __restrict__ traces) {
  render_lane<TableMaterials, kScan, kEst | kWithQuads>(
      p, lane_range(p), TableMaterials{alb, emi},
      sphere_tab(sph, n_sph, refl, bvh, root, nullptr, &qt), false, out_l,
      traces,
      LaneGuide{lobes, g});
}

using RowExtGuided = decltype(&megakernel_ext_guided<kCosine, kScanLinear>);

template <int kEst>
RowExtGuided ext_guided_kernel(int primary, bool tree) {
  if (primary) {
    return tree ? megakernel_ext_guided_primary<kEst, kScanTree>
                : megakernel_ext_guided_primary<kEst, kScanLinear>;
  }
  return tree ? megakernel_ext_guided<kEst, kScanTree>
              : megakernel_ext_guided<kEst, kScanLinear>;
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes): the
// guide arguments of spt_megakernel_guided_tab (est kCosine, kTextbook or
// kMis; primary 0 the (kNVoxels,) voxel table, 1 the (width * height,)
// pixel lobes; beta, k, (k + 1) / (2 pi), 1 / (k + 1), k_int), then the
// scene of spt_megakernel_ext without the Phong exponents, and the lanes
// of spt_megakernel_guided_tab.
extern "C" int spt_megakernel_ext_guided(
    int est, int primary, const int* table, int table_len, float beta,
    float k, float norm_k, float inv_k1, int k_int, const float* rect_geom,
    const int* rect_axis, int n_rects, const float* quad_f, int n_quads,
    const float* light_f, int light_id, const float* cam_f, unsigned seed,
    int width, int height, int spp, int g_lanes, int per, unsigned s0,
    int pix0, int n_pix_loc, int rr_start_depth, int max_bounces,
    const float* sph, int n_spheres, const float* bvh, int root,
    const float* alb, const float* emi, const int* refl, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g_lanes, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces, n_quads) ||
      (est != kCosine && est != kTextbook && est != kMis) ||
      (primary != 0 && primary != 1) ||
      table_len != (primary ? width * height : kNVoxels) || k_int < 0 ||
      k_int > 64 || n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GuideParams g{beta, k, norm_k, inv_k1, k_int};
  const bool tree = root >= 0;
  const RowExtGuided kernel =
      est == kCosine     ? ext_guided_kernel<kCosine>(primary, tree)
      : est == kTextbook ? ext_guided_kernel<kTextbook>(primary, tree)
                         : ext_guided_kernel<kMis>(primary, tree);
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, fill_quads(p, quad_f, n_quads), table, g,
      reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, out_l,
      traces);
  return static_cast<int>(cudaGetLastError());
}
