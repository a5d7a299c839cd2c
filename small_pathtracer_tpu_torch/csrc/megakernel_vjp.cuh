// Material adjoint of the runtime-material megakernels (row 9): the kernel
// template megakernel_vjp<kTab, kEst> (its body in megakernel_vjp_body.cuh,
// shared with megakernel_vjp_ext) and the body of its two host entry
// points, spt_megakernel_vjp (megakernel_grad.cu: nee, cosine,
// nee_textbook) and spt_megakernel_vjp_est (megakernel_grad_est.cu: the
// codes of SPT_EST_CODES). Axis-aligned rects and spheres (the runtime
// sphere table; rects and spheres at most kMaxGradObjects) with DIFF, SPEC
// and REFR materials and one parallelogram light. Its _ext instances
// (megakernel_grad_ext.cu) take general quads (the light may be one) and
// GLOS materials too.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel_grad.py:
// `build_grad_kernel`, as `_build_vjp` builds it for `render_pallas_vjp`.
// Given the per-pixel cotangent g of the radiance sum I (the forward's
// image), it returns d(sum g·I)/d albedo and d(sum g·I)/d emission, both
// (K, 3) in global object order (rects, quads, then spheres), pathwise
// (the same scope as autograd through the plain forward). Row 10
// (`material_train_step_sharded`, megakernel_grad.py:1083, its two
// `pallas_call`s at :1156 and :1195) runs the forward and this kernel on
// one rank's shard lanes (`lane_range` with pix0): g_img holds the shard's
// pixel rows only, indexed by the lane's row in the shard. The sums over
// the mesh are torch.distributed all-reduces in ops/megakernel_grad.py.
//
// Algorithm: every (pixel, sample) path is traced once, each bounce by
// `bounce_hit` / `bounce_scatter` of megakernel_lane.cuh, the forward's own
// (row 8 is render_lane on rect scenes and row 2's table kernels on sphere
// scenes; the library is built with --fmad=false, so the paths are the
// forward's bit for bit). Each bounce tapes, in the lane's local memory
// (megakernel_tape.cuh), what the gradient formulas read: the hit object,
// the emission partial sum A_{j+1} (this bounce's pickup and, for
// nee_textbook and mis, its direct term included), the prefix throughput
// T_j, inv_p, the weight w_j, the direct term's weight `gate` (the NEE
// weight where the probe reached the light, else 0; mis's includes its
// balance weight), and flags: RR's scaling, the channels tied at p_max,
// and whether the pickup counted (nee_textbook drops the light's pickup
// after a diffuse bounce whose probe already counted it). mis tapes its
// pickup's weight instead of inv_p (its balance weight on a BSDF-sampled
// hit of the light, else 1). When the path ends its radiance
// L is known, and the sweep recovers the suffix factor as
// T_j·S_{j+1} = (L − A_{j+1}) / (f_j·w_j), f_j = albedo·inv_p, 0 where that
// is 0. Per bounce on the hit object:
//   d/d albedo_c += g_c·TS_c·inv_p·w, plus the RR 1/p term
//                   −inv_p²·w·Σ_c g_c·TS_c·albedo_c split evenly over the
//                   channels equal to p_max (autograd's amax rule), plus
//                   the direct term g_c·gate·T_c·e_light,c;
//   d/d emission_c += g_c·T_c·(the pickup's weight);
// and the direct term adds g_c·gate·T_c·albedo_c to the light's emission
// row. Every weight is a function of the geometry and the draws only, so
// the tape holds it as a number. SPEC and REFR bounces enter through w (1,
// or REFR's Fresnel weight re/P or (1 − re)/(1 − P) by its coin, 1 on total
// internal reflection) and fire no probe. The other estimators need
// nothing more: w is 1 at a diffuse bounce for `cosine` and `uniform`,
// 2 max(cos, 0) for `uniform_corrected` (where it is 0 the guarded divide
// gives TS = 0, the JAX kernel's rule), and for `nee` and `mixture` the NEE
// weight where the probe (mixture: where its coin took NEE) reached the
// light, else 1; glibc_overflow moves only the light point. The TPU kernel
// traces each path twice instead (pass A for L, pass B for the terms) and
// keeps a column of accumulators a thread.
//
// Design: one thread per lane on the forward's lane layout (blocks of 128);
// a lane reads its pixel's cotangent g_img[pix] directly. On rect scenes
// (kTab = kTabNone) the tables are copied into shared memory once per
// block; on sphere scenes they stay in device memory, as in row 2, and a
// linear table's rows are staged in shared memory as row 11 stages them.
// A lane traces one segment of a path while it sweeps the one before (two
// tape buffers of kSeg bounces); paths longer than kSeg replay their
// earlier segments from checkpoints, bit for bit (mis's pdf carry is part
// of the checkpointed state). The warp loops while any
// lane is active and meets once an iteration at `warp_accumulate`, which
// adds the sweep's contributions by object into the warp's row of 6·K
// slots in shared memory in a fixed order. The direct terms' light-emission
// terms go to one object for every lane: each lane sums them in its own
// registers, and the warp adds the 32 sums by a fixed xor tree once, after
// its loop. The block sums its four rows in a fixed order into one row of
// per-block partials, and `reduce_partials` sums the rows in a fixed order.
// The result is bit-identical from run to run, without atomics; dynamic
// shared memory is the staged tables or rows and kWarps·6·K floats, which
// caps the object count at kMaxGradObjects (~100 KB a block there).
//
// What bounds it: operations, about one forward's (one trace, no NEE fold),
// plus the sweep's gradient arithmetic and the warp sums. Bytes are small:
// the cotangent image (12 bytes a pixel), the tables, the per-block
// partials, and the tape (48 bytes a bounce, written and read once).
// Left for later: the NEE fold in the trace.

#pragma once

#include "megakernel_lane.cuh"
#include "megakernel_tape.cuh"

namespace {

// Objects (rects, quads and spheres) a launch takes: the warps' rows of
// 6·K slots fill ~100 KB of a block's shared memory there (kMaxRects rects
// and 1024 spheres).
constexpr int kMaxGradObjects = kMaxRects + 1024;

// `code` of a tape entry: the hit object (low 16 bits), RR's scaling, the
// channels tied at p_max, and whether the bounce's pickup counted.
constexpr int kIdMask = 0xFFFF;
constexpr int kRrBit = 1 << 16, kTieX = 1 << 17, kTieY = 1 << 18,
              kTieZ = 1 << 19, kEmitBit = 1 << 20;

// A tape entry: 40 bytes of fields, 48 with the alignment (one more
// 4-byte field cost nee_textbook's adjoint 16-18% at 1024x768x512:
// PERF.md §6). mis (kMisEntry) tapes its pickup's weight in place
// of inv_p, which its sweep recomputes from the hit's albedo and the RR
// bit as pass A computed it.
template <bool kMisEntry>
struct __align__(16) VjpEntry {
  int code;
  V3 A_new, T;
  float inv_p, w, gate;
};
template <>
struct __align__(16) VjpEntry<true> {
  int code;
  V3 A_new, T;
  float w_pick, w, gate;
};

// The path state before a bounce: nee_textbook's flag (the bounce before it
// was diffuse, so its probe counted the light) and, for mis only (kCarry),
// its carry: the p_bsdf of this ray from the diffuse vertex before it (0:
// the pickup is whole).
template <bool kCarry>
struct VjpState {
  V3 o, d, T, A;
  bool suppress;
};
template <>
struct VjpState<true> {
  V3 o, d, T, A;
  bool suppress;
  float mis_pdf;
};

template <int kTab, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_vjp(const __grid_constant__ Params p,
                   const float4* __restrict__ sph, int n_sph,
                   const float4* __restrict__ bvh, int root,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const int* __restrict__ refl,
                   const float* __restrict__ g_img,
                   float* __restrict__ partials) {
  constexpr const float* gloss = nullptr;
  constexpr const QuadTab* quads = nullptr;
#include "megakernel_vjp_body.cuh"
}

// Every instance's type (spelled out: a decltype of one instance would make
// it an instance of each translation unit that includes this header).
using VjpKernel = void (*)(Params, const float4*, int, const float4*, int,
                           const float*, const float*, const int*,
                           const float*, float*);

// Estimator kEst's instance for the scene's scan: rects only (kTabNone),
// the sphere table's linear scan or its tree.
template <int kEst>
VjpKernel vjp_of_scan(int scan) {
  return scan == kTabNone      ? megakernel_vjp<kTabNone, kEst>
         : scan == kScanLinear ? megakernel_vjp<kScanLinear, kEst>
                               : megakernel_vjp<kScanTree, kEst>;
}

// A row 9 launch's Params and shape: its blocks, its 6·K gradient slots
// (K = rects + quads + spheres) and its dynamic shared memory.
struct VjpLaunch {
  Params p;
  int n_blocks, n_slots;
  size_t smem;
};

// Host: checks a row 9 launch's arguments (n_quads: the _ext entry's
// quads, the light may be one of them; the scan: tab 0 rects only, else
// the sphere table's linear scan (root < 0) or its tree) and fills *l.
// Returns false on an argument the kernels do not take.
inline bool vjp_launch(VjpLaunch* l, const float* rect_geom,
                       const int* rect_axis, int n_rects, int n_quads,
                       const float* light_f, int light_id,
                       const float* cam_f, unsigned seed, int width,
                       int height, int spp, int g, int per, unsigned s0,
                       int pix0, int n_pix_loc, int rr_start_depth,
                       int max_bounces, long long n_partials,
                       float mixture_q, int tab, int n_spheres, int root) {
  if (!fill_params(&l->p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces, n_quads) ||
      n_spheres < 0 || n_rects + n_quads + n_spheres > kMaxGradObjects ||
      (!tab && n_quads + n_spheres != 0)) {
    return false;
  }
  l->p.mixture_q = mixture_q;
  l->n_blocks = grid_of(l->p);
  l->n_slots = 6 * (n_rects + n_quads + n_spheres);
  if (n_partials < static_cast<long long>(l->n_blocks) * l->n_slots) {
    return false;
  }
  const int n_head =
      !tab ? (6 * n_rects + 3) / 4 : (root >= 0 ? 0 : 2 * n_spheres);
  l->smem = sizeof(float4) * n_head + sizeof(float) * kWarps * l->n_slots;
  return true;
}

// Launches kernel(l.p, args..., partials) and reduce_partials on `stream`;
// returns the first launch error.
template <class Kernel, class... Args>
inline int launch_vjp_kernel(Kernel kernel, const VjpLaunch& l,
                             float* partials, float* out, void* stream,
                             Args... args) {
  cudaError_t err = cudaSuccess;
  if (l.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<l.n_blocks, kBlock, l.smem, st>>>(l.p, args..., partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<l.n_slots, kReduceThreads, 0, st>>>(partials, l.n_blocks,
                                                        l.n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

// The body of spt_megakernel_vjp and spt_megakernel_vjp_est (their
// arguments, kernel_of the entry's instance of an estimator code and scan,
// nullptr for a code it has no instance of): checks, launches the kernel
// and reduce_partials on `stream`, and returns the first launch error.
inline int launch_vjp(VjpKernel (*kernel_of)(int est, int scan),
                      const float* rect_geom, const int* rect_axis,
                      int n_rects, const float* light_f, int light_id,
                      const float* cam_f, unsigned seed, int width,
                      int height, int spp, int g, int per, unsigned s0,
                      int pix0, int n_pix_loc, int rr_start_depth,
                      int max_bounces, const float* alb, const float* emi,
                      const float* g_img, float* partials,
                      long long n_partials, float* out, int est,
                      float mixture_q, int tab, const float* sph,
                      int n_spheres, const float* bvh, int root,
                      const int* refl, void* stream) {
  VjpLaunch l;
  const VjpKernel kernel =
      kernel_of(est, !tab ? kTabNone : root >= 0 ? kScanTree : kScanLinear);
  if (kernel == nullptr ||
      !vjp_launch(&l, rect_geom, rect_axis, n_rects, 0, light_f, light_id,
                  cam_f, seed, width, height, spp, g, per, s0, pix0,
                  n_pix_loc, rr_start_depth, max_bounces, n_partials,
                  mixture_q, tab, n_spheres, root)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_vjp_kernel(kernel, l, partials, out, stream,
                           reinterpret_cast<const float4*>(sph), n_spheres,
                           reinterpret_cast<const float4*>(bvh), root, alb,
                           emi, refl, g_img);
}

}  // namespace

// The arguments of both entry points. Geometry, light and camera as
// fill_params (megakernel_common.cuh) reads them, in host memory. On the
// device: alb, emi (K, 3) float32, K = n_rects + n_spheres, rects first;
// g_img (n_pix_loc, 3) float32, the cotangents of the shard's pixels
// [pix0, pix0 + n_pix_loc) (unsharded: (height, width, 3)); partials:
// scratch of n_partials floats, at least ceil(n_pix_loc·g / 128) · 6·K;
// out: 6·K floats, d/d albedo (K, 3) then d/d emission (K, 3). Then the
// estimator code est (megakernel_lane.cuh) and mixture_q, the mixture's NEE
// probability, and the scene's kind: tab 0 for rect-only DIFF scenes (row
// 1's and row 8's scan; sph, bvh and refl unused, n_spheres 0), else the
// sphere table as spt_megakernel_tab takes it: sph (n_spheres, 4) float32
// [cx, cy, cz, r], its tree bvh with root link root, and refl (K,) int32,
// K at most kMaxGradObjects. Each launches both kernels on `stream` and
// returns the first launch error (cudaError_t); a code the entry has no
// instance of is refused (cudaErrorInvalidValue).
#define SPT_VJP_PARAMS                                                      \
  const float *rect_geom, const int *rect_axis, int n_rects,                \
      const float *light_f, int light_id, const float *cam_f,               \
      unsigned seed, int width, int height, int spp, int g, int per,        \
      unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,             \
      int max_bounces, const float *alb, const float *emi,                  \
      const float *g_img, float *partials, long long n_partials, float *out, \
      int est, float mixture_q, int tab, const float *sph, int n_spheres,   \
      const float *bvh, int root, const int *refl, void *stream
#define SPT_VJP_ARGS                                                        \
  rect_geom, rect_axis, n_rects, light_f, light_id, cam_f, seed, width,     \
      height, spp, g, per, s0, pix0, n_pix_loc, rr_start_depth,             \
      max_bounces, alb, emi, g_img, partials, n_partials, out, est,         \
      mixture_q, tab, sph, n_spheres, bvh, root, refl, stream
