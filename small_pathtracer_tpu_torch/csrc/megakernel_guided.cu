// Path guiding in the fused path tracer: rows 4 and 5 of the port's kernel
// table, the loop body of megakernel.cu (`render_lane`,
// megakernel_lane.cuh) with a guide source, for the `cosine`,
// `nee_textbook` and `mis` estimators (a template parameter each kernel
// takes). Under `mis` both balance weights take the guided mixture's pdf
// as the BSDF strategy's density: at the shadow direction, and for the
// continuation the lane carries (the TPU kernel's :2106-2119, :2369-2375);
// at an unguided vertex the mixture's pdf is the cosine pdf bit for bit,
// so an all-sentinel table renders the unguided `mis` kernel's image.
//
// - megakernel_guided<kEst> (baked rect scenes) and megakernel_guided_tab
//   (the sphere table, SPEC/REFR) replace the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel(guide_cfg=...)`
//   as `_build_render_guided` builds it for `render_pallas_guided` (its
//   `pallas_call` at :2972). The 1620 packed lobes (6.5 KB) are copied into
//   shared memory once a block; a diffuse hit reads one entry at its voxel
//   (the TPU kernel's chunked broadcast-and-select gather works around
//   Mosaic's lane-axis-only gather and is not carried over). A guided
//   vertex decodes the entry, samples the power-cosine lobe from the
//   cosine sample's u1 and u2, draws the coin, and weighs by
//   pdf_cos / pdf_mix with the decoded lobe, so the quantization is part
//   of the estimator and the image equals the JAX kernel's for one table.
//   A lobe sample below the surface ends the path (weight 0) and the lane
//   respawns. SPEC/REFR vertices scatter unguided.
// - megakernel_guided_primary<kEst> and megakernel_guided_primary_tab
//   replace `build_kernel(guide_primary=True)` as
//   `_build_render_guided_primary` builds it (`pallas_call` at :3111): the
//   lane reads its pixel's packed lobe from an (n_pix,) int32 device array
//   at depth 1 and guides that vertex only (the JAX wrapper repeats the
//   lobes per lane; the lane indexes by pixel instead).
// - Row 6 (`_build_render_guided_sharded`, megakernel.py:3188, its
//   `pallas_call` at :3241) runs megakernel_guided / _tab on one rank's
//   shard lanes (`lane_range` with pix0, megakernel_common.cuh), the table
//   copied to every rank; the image and trace sums over the mesh are
//   torch.distributed all-reduces around the launch (ops/megakernel.py).
//
// What bounds them: as rows 1 and 2 (megakernel.cu), arithmetic and
// divergence, not bytes. A guided vertex adds the lobe frame, a real power
// from ~30 float operations (pow_pos, so kernel and plain version agree),
// the k = 8 squaring chain, two dots and a divide; a table read is one
// shared-memory load. Guided paths end at different depths than unguided
// ones, which widens the divergence the per-lane loop already has. Left
// for later: sorting lanes against divergence and a cheaper lobe sample.

#include "megakernel_lane.cuh"

namespace {

// Copies the (kNVoxels,) voxel table into shared memory (every thread of
// the block calls it: it ends in a barrier).
__device__ __forceinline__ const int* load_guide(const int* __restrict__ table,
                                                 int* s_tab) {
  for (int i = threadIdx.x; i < kNVoxels; i += kBlock) s_tab[i] = table[i];
  __syncthreads();
  return s_tab;
}

template <int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_guided(const __grid_constant__ Params p,
                      const int* __restrict__ table, GuideParams g,
                      float* __restrict__ out_l,
                      unsigned long long* __restrict__ traces) {
  __shared__ int s_tab[kNVoxels];
  render_lane<BakedMaterials, kTabNone, kEst>(
      p, lane_range(p), BakedMaterials{p}, SphereTab{}, false, out_l, traces,
      VoxelGuide{load_guide(table, s_tab), g});
}

template <int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_guided_primary(const __grid_constant__ Params p,
                              const int* __restrict__ lobes, GuideParams g,
                              float* __restrict__ out_l,
                              unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone, kEst>(
      p, lane_range(p), BakedMaterials{p}, SphereTab{}, false, out_l, traces,
      LaneGuide{lobes, g});
}

// The table variants: the sphere rows, their tree and the material tables
// in device memory, as megakernel_nee_tab (and like it in a linear and a
// tree instance).
template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_guided_tab(const __grid_constant__ Params p,
                          const int* __restrict__ table, GuideParams g,
                          const float4* __restrict__ sph, int n_sph,
                          const float4* __restrict__ bvh, int root,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const int* __restrict__ refl,
                          float* __restrict__ out_l,
                          unsigned long long* __restrict__ traces) {
  __shared__ int s_tab[kNVoxels];
  const int* tab_g = load_guide(table, s_tab);
  render_lane<TableMaterials, kScan, kEst>(
      p, lane_range(p), TableMaterials{alb, emi},
      sphere_tab(sph, n_sph, refl, bvh, root), false, out_l, traces,
      VoxelGuide{tab_g, g});
}

template <int kEst, int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_guided_primary_tab(const __grid_constant__ Params p,
                                  const int* __restrict__ lobes,
                                  GuideParams g,
                                  const float4* __restrict__ sph, int n_sph,
                                  const float4* __restrict__ bvh, int root,
                                  const float* __restrict__ alb,
                                  const float* __restrict__ emi,
                                  const int* __restrict__ refl,
                                  float* __restrict__ out_l,
                                  unsigned long long* __restrict__ traces) {
  render_lane<TableMaterials, kScan, kEst>(
      p, lane_range(p), TableMaterials{alb, emi},
      sphere_tab(sph, n_sph, refl, bvh, root), false, out_l, traces,
      LaneGuide{lobes, g});
}

// The checks every guided entry point shares: the estimator, the table's
// length (kNVoxels entries, or one a pixel for primary), the guide
// constants. Fills *g.
bool guide_args(int est, int primary, int table_len, const Params& p,
                float beta, float k, float norm_k, float inv_k1, int k_int,
                GuideParams* g) {
  if ((est != kCosine && est != kTextbook && est != kMis) ||
      (primary != 0 && primary != 1) ||
      table_len != (primary ? p.width * p.height : kNVoxels) || k_int < 0 ||
      k_int > 64) {
    return false;
  }
  *g = GuideParams{beta, k, norm_k, inv_k1, k_int};
  return true;
}

// The kernels of estimator kEst, by guide source (primary) and scan.
template <int kEst>
decltype(&megakernel_guided<kCosine>) guided_kernel(int primary) {
  return primary ? megakernel_guided_primary<kEst> : megakernel_guided<kEst>;
}

template <int kEst>
decltype(&megakernel_guided_tab<kCosine, kScanLinear>) guided_tab_kernel(
    int primary, bool tree) {
  if (primary) {
    return tree ? megakernel_guided_primary_tab<kEst, kScanTree>
                : megakernel_guided_primary_tab<kEst, kScanLinear>;
  }
  return tree ? megakernel_guided_tab<kEst, kScanTree>
              : megakernel_guided_tab<kEst, kScanLinear>;
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes), as in
// megakernel.cu. est: kCosine, kTextbook or kMis. primary 0: table is the
// (kNVoxels,) int32 voxel table (row 4); primary 1: the (width * height,)
// int32 packed lobes of the pixels (row 5); both in device memory, entries
// packed as ops/megakernel.pack_guide_entries packs them. beta, k, norm_k =
// (k + 1) / (2 pi), inv_k1 = 1 / (k + 1) as float32, k_int = k when it is
// an integer in [1, 64], else 0.

// Rows 4 and 5 on rect-only DIFF scenes, baked materials as
// spt_megakernel (no fold).
extern "C" int spt_megakernel_guided(
    int est, int primary, const int* table, int table_len, float beta,
    float k, float norm_k, float inv_k1, int k_int, const float* rect_geom,
    const int* rect_axis, const float* rect_alb, const float* rect_emi,
    int n_rects, const float* light_f, int light_id, const float* cam_f,
    unsigned seed, int width, int height, int spp, int g_lanes, int per,
    unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,
    int max_bounces, float* out_l, unsigned long long* traces,
    void* stream) {
  Params p;
  GuideParams g;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g_lanes, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      !guide_args(est, primary, table_len, p, beta, k, norm_k, inv_k1, k_int,
                  &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bake_materials(&p, rect_alb, rect_emi, n_rects, 0);
  const auto kernel = est == kCosine     ? guided_kernel<kCosine>(primary)
                      : est == kTextbook ? guided_kernel<kTextbook>(primary)
                                         : guided_kernel<kMis>(primary);
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, table, g, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Rows 4 and 5 with the sphere table: the tables as spt_megakernel_tab.
extern "C" int spt_megakernel_guided_tab(
    int est, int primary, const int* table, int table_len, float beta,
    float k, float norm_k, float inv_k1, int k_int, const float* rect_geom,
    const int* rect_axis, int n_rects, const float* light_f, int light_id,
    const float* cam_f, unsigned seed, int width, int height, int spp,
    int g_lanes, int per, unsigned s0, int pix0, int n_pix_loc,
    int rr_start_depth, int max_bounces,
    const float* sph, int n_spheres, const float* bvh, int root,
    const float* alb, const float* emi, const int* refl, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  GuideParams g;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g_lanes, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      !guide_args(est, primary, table_len, p, beta, k, norm_k, inv_k1, k_int,
                  &g) ||
      n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tree = root >= 0;
  const auto kernel =
      est == kCosine     ? guided_tab_kernel<kCosine>(primary, tree)
      : est == kTextbook ? guided_tab_kernel<kTextbook>(primary, tree)
                         : guided_tab_kernel<kMis>(primary, tree);
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, table, g, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, out_l,
      traces);
  return static_cast<int>(cudaGetLastError());
}
