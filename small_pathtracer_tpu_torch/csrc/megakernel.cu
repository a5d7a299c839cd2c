// Fused regenerating path tracer, axis-aligned rects and spheres with one
// parallelogram light, box filter, pinhole camera. The kernels share one
// loop body (`render_lane` in megakernel_lane.cuh, a template on where the
// materials come from, whether the scene has a sphere table, the estimator
// and the guide source, fed a LaneRange by the kernel's lane source); the
// guided kernels (rows 4 and 5) are in megakernel_guided.cu:
//
// - megakernel_nee replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel`, as
//   `_build_render` builds it for `render_pallas` / `render_pallas_span`
//   (baked scene, no material refs, NEE fold on). Materials sit in the
//   kernel parameters beside the geometry. Rects and DIFF only.
// - megakernel_nee_mat, megakernel_cosine_mat and megakernel_textbook_mat
//   replace `build_kernel(mat_refs=True)` as
//   small_pathtracer_tpu/ops/megakernel_grad.py: `_build_fwd_mat` builds it
//   for `render_pallas_mat` on rect-only DIFF scenes: the albedo and
//   emission (K, 3) tables are runtime inputs in device memory, copied into
//   shared memory once per block, so a training step changes them without
//   a host copy. The NEE fold is decided in the kernel from the light's row
//   of the table. Equal tables give a bit-identical image and trace counts.
//   On scenes with spheres or SPEC/REFR objects, `render_pallas_mat` is
//   row 2's table kernel with the runtime tables (below), which reads its
//   tables from device memory already.
// - megakernel_nee_tab replaces `build_kernel(mat_refs=True,
//   sphere_tab=True)` as `_build_render(use_tab=True)` builds it (the same
//   `pallas_call`, megakernel.py:2670): spheres from a runtime table after
//   every rect, and the SPEC mirror and REFR glass branches. The spheres
//   are scanned through a bounding-volume hierarchy that the host builds
//   at each launch (megakernel_bvh.cuh; up to kMaxSpheres rows, a table of
//   at most kBvhLinearMax rows scanned in id order); each lane walks it
//   alone, nearer child first, and gets the linear scan's (t, id) bit for
//   bit. The tree, the sphere rows, the (K, 3) material tables and the
//   (K,) material codes stay in device memory: a lane reads its winner's
//   row once a bounce, after the scan. The shadow probe stops at the first
//   occluder. SPEC/REFR lanes skip the NEE probe (the TPU kernel computes
//   and discards it: every draw is keyed by its counter, so skipping
//   changes no bit), count no probe and are never folded. The TPU kernel's
//   cluster pruning and lane swizzle work around lockstep TPU lanes (a
//   per-lane gather costs a TPU a scan of the table) and change no pixel;
//   they are not carried over.
// - Row 3, the per-pixel budget kernels of every estimator, is in
//   megakernel_budgets.cu.
// - megakernel_cosine / megakernel_textbook and megakernel_cosine_tab /
//   megakernel_textbook_tab are rows 1 and 2 (`build_kernel` with
//   estimator "cosine" or "nee_textbook") with the same loop body: the
//   cosine continuation alone, or with textbook NEE (a probe at each live
//   diffuse vertex before RR, its direct term with the throughput before
//   the update, the next pickup of the light suppressed; no fold).
// - Row 7 (`_build_render_sharded`, megakernel.py:3321, its `pallas_call`
//   at :3370, under `render_pallas_sharded`) runs these same kernels on one
//   rank's shard: the pixels [pix0, pix0 + n_pix_loc) and one sample range
//   of the span (`lane_range` adds pix0; the path ids use the global
//   pixel, so each sample is the unsharded sample bit for bit). The TPU
//   kernel's `psum` inside `shard_map` becomes torch.distributed
//   all-reduces around the launch (ops/megakernel.py).
//
// What bounds them: arithmetic and divergence, not bytes. A lane reads
// nothing but its index, the scene (a few hundred bytes of kernel
// parameters, read by every lane alike, plus the sphere and material
// tables) and writes 12 bytes of radiance plus a share of two counters:
// about 20 bytes of I/O against thousands of operations per sample (a rect
// test costs ~12 operations, a sphere test ~26 at least, two queries per
// bounce, five murmur3 hashes per bounce on the integer pipes). Counted
// that way, the integer operations bound rows 1 and 8 on the Cornell box
// (3.8 ms at 1024x768x512 on an H100 SXM, 700 W, against ~69 ms measured)
// and the sphere tests bound row 2 on sphere scenes (PERF.md). What costs
// time is the per-lane while loop: lanes of one warp die and respawn at
// different bounces, and a diverged warp runs both paths.
//
// Design: one thread per lane, blocks of 128, the ragged last block masked.
// A lane derives its pixel and sample range [s_start, s_stop) from its index
// (no input planes; the budget kernels read the span) and keeps the whole
// path state in registers across the
// bounce loop; a lane whose path dies respawns at once with its next sample,
// so a warp stays busy until its slowest lane runs out of samples. Trace
// counts are 32-bit per thread, summed per warp, and added to two 64-bit
// totals with one atomic per warp. Left for later: sorting or compacting
// lanes against divergence.
//
// Numerics: see megakernel_common.cuh; the kernels match the eager plain
// version exactly on the card. The NEE fold: a successful probe from a
// diffuse hit proves the next extend ray hits the light, and when the
// light's max albedo is <= 0 that bounce's pickup, its extend count and the
// path's certain RR death are resolved one iteration early. Per-lane sums
// and counters stay exactly those of the unfolded loop.

#include "megakernel_lane.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
    megakernel_nee(const __grid_constant__ Params p, float* __restrict__ out_l,
                   unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone>(p, lane_range(p), BakedMaterials{p},
                                     SphereTab{}, p.fold != 0, out_l, traces);
}

// Row 1 with the cosine and nee_textbook estimators (no fold).
__global__ void __launch_bounds__(kBlock)
    megakernel_cosine(const __grid_constant__ Params p,
                      float* __restrict__ out_l,
                      unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone, kCosine>(
      p, lane_range(p), BakedMaterials{p}, SphereTab{}, false, out_l, traces);
}

__global__ void __launch_bounds__(kBlock)
    megakernel_textbook(const __grid_constant__ Params p,
                        float* __restrict__ out_l,
                        unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, kTabNone, kTextbook>(
      p, lane_range(p), BakedMaterials{p}, SphereTab{}, false, out_l, traces);
}

// Row 8 on rect-only DIFF scenes (mat_body in megakernel_lane.cuh).
#define SPT_MAT_KERNEL(name, est)                                          \
  __global__ void __launch_bounds__(kBlock)                                \
      name(const __grid_constant__ Params p, const float* __restrict__ alb, \
           const float* __restrict__ emi, float* __restrict__ out_l,       \
           unsigned long long* __restrict__ traces) {                      \
    mat_body<est>(p, alb, emi, out_l, traces);                             \
  }

SPT_MAT_KERNEL(megakernel_nee_mat, kNee)
SPT_MAT_KERNEL(megakernel_cosine_mat, kCosine)
SPT_MAT_KERNEL(megakernel_textbook_mat, kTextbook)
#undef SPT_MAT_KERNEL

// Each table kernel in two instances, the linear scan (kScanLinear: a
// table that is one root leaf) and the tree (kScanTree); the entry point
// picks by the root link. megakernel_nee_tab<kScanCount> is row 2's
// counting instance: megakernel_nee_tab's image and traces, and the scans'
// node tests, rows tested and rows at the square root (traces[2..4]) for
// this algorithm's bound. No timed path launches it.
#define SPT_TAB_KERNEL(name, est)                                          \
  template <int kScan>                                                     \
  __global__ void __launch_bounds__(kBlock)                                \
      name(const __grid_constant__ Params p, const float4* __restrict__ sph, \
           int n_sph, const float4* __restrict__ bvh, int root,            \
           const float* __restrict__ alb, const float* __restrict__ emi,   \
           const int* __restrict__ refl, float* __restrict__ out_l,        \
           unsigned long long* __restrict__ traces) {                      \
    tab_body<est, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,  \
                         traces);                                          \
  }

SPT_TAB_KERNEL(megakernel_nee_tab, kNee)
SPT_TAB_KERNEL(megakernel_cosine_tab, kCosine)
SPT_TAB_KERNEL(megakernel_textbook_tab, kTextbook)
#undef SPT_TAB_KERNEL

// The sphere table's two scans on given rays, for the smoke run's checks
// against the plain version (rays of its choosing: grazing, on faces,
// ties): ray i's nearest hit (t, id) and its probe toward the light
// (success, t_light).
__global__ void __launch_bounds__(kBlock)
    sphere_queries(const __grid_constant__ Params p,
                   const float4* __restrict__ sph, int n_sph,
                   const float4* __restrict__ bvh, int root,
                   const float* __restrict__ o, const float* __restrict__ d,
                   int n_rays, float* __restrict__ out_t,
                   int* __restrict__ out_id, int* __restrict__ out_ok,
                   float* __restrict__ out_tl) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const SphereTab tab = sphere_tab(sph, n_sph, nullptr, bvh, root);
  const V3 oi = ld3(o + 3 * i), di = ld3(d + 3 * i);
  int id;
  float t_l;
  if (root < 0) {
    out_t[i] = nearest_tab<kScanLinear>(p, tab, oi, di, &id);
    out_ok[i] = probe_light_tab<kScanLinear>(p, tab, oi, di, &t_l) ? 1 : 0;
  } else {
    out_t[i] = nearest_tab<kScanTree>(p, tab, oi, di, &id);
    out_ok[i] = probe_light_tab<kScanTree>(p, tab, oi, di, &t_l) ? 1 : 0;
  }
  out_id[i] = id;
  out_tl[i] = t_l;
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes). rect_geom,
// rect_axis, light_f and cam_f as fill_params (megakernel_common.cuh) reads
// them, in host memory. out_l: (n_pix * g, 3) float32 and traces: 2 uint64,
// zeroed, on the device. Each launches on `stream` and returns the launch's
// cudaError_t.

// Row 1, baked materials, estimator est (kNee, kCosine, kTextbook):
// rect_alb, rect_emi are (n_rects, 3) float32 host arrays copied into the
// kernel parameters; fold turns the NEE fold on (kNee only).
extern "C" int spt_megakernel(int est, const float* rect_geom,
                              const int* rect_axis, const float* rect_alb,
                              const float* rect_emi, int n_rects,
                              const float* light_f, int light_id,
                              const float* cam_f, unsigned seed, int width,
                              int height, int spp, int g, int per,
                              unsigned s0, int pix0, int n_pix_loc,
                              int rr_start_depth, int max_bounces, int fold,
                              float* out_l,
                              unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      est < kNee || est > kTextbook) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bake_materials(&p, rect_alb, rect_emi, n_rects, est == kNee ? fold : 0);
  const auto kernel = est == kNee ? megakernel_nee
                      : est == kCosine ? megakernel_cosine
                                       : megakernel_textbook;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 8 on rect-only DIFF scenes, runtime materials, estimator est (kNee,
// kCosine, kTextbook): alb, emi are (n_rects, 3) float32 tables in device
// memory, read by the kernel (no host copy). On scenes with spheres or
// SPEC/REFR objects row 8 is row 2's kernel (spt_megakernel_tab) with the
// runtime tables.
extern "C" int spt_megakernel_mat(int est, const float* rect_geom,
                                  const int* rect_axis, int n_rects,
                                  const float* light_f, int light_id,
                                  const float* cam_f, unsigned seed,
                                  int width, int height, int spp, int g,
                                  int per, unsigned s0, int pix0,
                                  int n_pix_loc, int rr_start_depth,
                                  int max_bounces, const float* alb,
                                  const float* emi, float* out_l,
                                  unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      est < kNee || est > kTextbook) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = est == kNee      ? megakernel_nee_mat
                      : est == kCosine ? megakernel_cosine_mat
                                       : megakernel_textbook_mat;
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, alb, emi, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// The tree of a sphere table (megakernel_bvh.cuh), built on the host: sph
// (n_spheres, 4) float32 [cx, cy, cz, r] in host memory; out n_out floats
// of host memory, zeroed, at least bvh_floats(n_spheres) (8 n + 16 (n - 1)),
// which the caller copies to the device for the table kernels' bvh. Returns
// the root link (the table kernels' root), or kBvhError (int32 min) for a
// table the kernels do not take or a short out.
extern "C" int spt_sphere_bvh(const float* sph, int n_spheres, float* out,
                              long long n_out) {
  if (n_spheres < 0 || n_spheres > kMaxSpheres ||
      n_out < static_cast<long long>(bvh_floats(n_spheres))) {
    return kBvhError;
  }
  return build_sphere_bvh(sph, n_spheres, out);
}

// Row 2, the sphere table, estimator est (count: the counting instance of
// kNee, traces of 5): sph is (n_spheres, 4) float32 [cx, cy, cz, r], bvh
// the tree spt_sphere_bvh built for it (root its root link), alb, emi
// (n_rects + n_spheres, 3) float32 and refl (n_rects + n_spheres,) int32
// (DIFF 0, SPEC 1, REFR 2), all in device memory, rects first. More than
// kMaxSpheres spheres are refused (cudaErrorInvalidValue).
extern "C" int spt_megakernel_tab(int est, int count, const float* rect_geom,
                                  const int* rect_axis, int n_rects,
                                  const float* light_f, int light_id,
                                  const float* cam_f, unsigned seed,
                                  int width, int height, int spp, int g,
                                  int per, unsigned s0, int pix0,
                                  int n_pix_loc, int rr_start_depth,
                                  int max_bounces, const float* sph,
                                  int n_spheres, const float* bvh, int root,
                                  const float* alb, const float* emi,
                                  const int* refl, float* out_l,
                                  unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || est < kNee ||
      est > kTextbook || (count && est != kNee)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tree = root >= 0;
  const auto kernel =
      count            ? megakernel_nee_tab<kScanCount>
      : est == kNee    ? (tree ? megakernel_nee_tab<kScanTree>
                               : megakernel_nee_tab<kScanLinear>)
      : est == kCosine ? (tree ? megakernel_cosine_tab<kScanTree>
                               : megakernel_cosine_tab<kScanLinear>)
                       : (tree ? megakernel_textbook_tab<kScanTree>
                               : megakernel_textbook_tab<kScanLinear>);
  kernel<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, out_l,
      traces);
  return static_cast<int>(cudaGetLastError());
}

// The smoke run's query kernel: the nearest hit and the probe of n_rays
// rays o, d ((n_rays, 3) float32 device arrays) in the scene (rects as
// fill_params reads them, the sphere table as spt_megakernel_tab); out_t,
// out_tl (n_rays,) float32 and out_id, out_ok (n_rays,) int32 device
// arrays.
extern "C" int spt_sphere_queries(const float* rect_geom,
                                  const int* rect_axis, int n_rects,
                                  const float* light_f, int light_id,
                                  const float* sph, int n_spheres,
                                  const float* bvh, int root, const float* o,
                                  const float* d, int n_rays, float* out_t,
                                  int* out_id, int* out_ok, float* out_tl,
                                  void* stream) {
  const float cam_f[12] = {};
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, 0u, 1, 1, 1, 1, 1, 0u, 0, 1, 5, 5) ||
      n_spheres < 0 || n_spheres > kMaxSpheres || n_rays < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sphere_queries<<<(n_rays + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, o, d, n_rays, out_t, out_id,
      out_ok, out_tl);
  return static_cast<int>(cudaGetLastError());
}
