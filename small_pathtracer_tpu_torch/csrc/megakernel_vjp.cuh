// Material adjoint of the runtime-material megakernels (row 9): the kernel
// template megakernel_vjp<kTab, kEst> and the body of its two host entry
// points, spt_megakernel_vjp (megakernel_grad.cu: nee, cosine,
// nee_textbook) and spt_megakernel_vjp_est (megakernel_grad_est.cu: the
// codes of SPT_EST_CODES). Axis-aligned rects and spheres (the runtime
// sphere table, at most kMaxGradSpheres rows) with DIFF, SPEC and REFR
// materials and one parallelogram light.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel_grad.py:
// `build_grad_kernel`, as `_build_vjp` builds it for `render_pallas_vjp`.
// Given the per-pixel cotangent g of the radiance sum I (the forward's
// image), it returns d(sum g·I)/d albedo and d(sum g·I)/d emission, both
// (K, 3) in global object order (rects, then spheres), pathwise (the same
// scope as autograd through the plain forward). Row 10
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
// caps the sphere count at kMaxGradSpheres (~100 KB a block there).
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

constexpr int kMaxGradSpheres = 1024;

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
  // Dynamic shared memory: the rect scene's tables or a linear sphere
  // table's rows (two float4 a row), then a row of 6K gradient slots a
  // warp (albedo, then emission).
  extern __shared__ float4 smem4[];
  const int k_obj = p.n_rects + n_sph;
  const int n_slots = 6 * k_obj;
  SphereTab tab = sphere_tab(sph, n_sph, refl, bvh, root);
  int n_head = 0;
  float* s_tab = reinterpret_cast<float*>(smem4);
  if constexpr (kTab == kTabNone) {
    n_head = (6 * p.n_rects + 3) / 4;
    for (int i = threadIdx.x; i < 3 * p.n_rects; i += kBlock) {
      s_tab[i] = alb[i];
      s_tab[3 * p.n_rects + i] = emi[i];
    }
  } else if constexpr (kTab == kScanLinear) {
    n_head = 2 * ((-1 - root) >> 16);
    for (int i = threadIdx.x; i < n_head; i += kBlock) smem4[i] = tab.rows[i];
    tab.rows = smem4;
  }
  float* rows = reinterpret_cast<float*>(smem4 + n_head);
  for (int i = threadIdx.x; i < kWarps * n_slots; i += kBlock) rows[i] = 0.0f;
  __syncthreads();
  float* my_row = rows + (threadIdx.x >> 5) * n_slots;
  const TableMaterials mats =
      kTab == kTabNone ? TableMaterials{s_tab, s_tab + 3 * p.n_rects}
                       : TableMaterials{alb, emi};

  const LaneRange lr = lane_range(p);
  const LightFrame lf = light_frame(p);
  const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
  const V3 gc = lr.in_range ? ld3(g_img + 3 * lr.pix) : zero;
  const V3 cam_o = ld3(p.cam_o);
  const V3 e_light = mats.emission(p.light_id);
  V3 g_le = zero;  // the direct terms' light-emission terms of this lane

  using State = VjpState<kEst == kMis>;
  VjpEntry<kEst == kMis> tape[2][kSeg];
  State ck[kCkpt];
  TapeCtl c;
  tape_start(&c, lr.s, lr.in_range && lr.s < lr.s_stop);
  State st;  // the producer's state before its next bounce
  const auto spawn = [&] {
    st = State{cam_o, spawn_dir(p, lr.px, lr.py, lr.pid_base + c.s), one,
               zero, false};  // (mis: a carry of 0)
  };
  if (c.tracing) spawn();

  while (__any_sync(kFull, tape_active(c))) {
    Contrib ct;
    ct.key = -1;
    if (c.tracing) {  // pass A, or a segment replay
      const int depth = c.depth + 1;
      const V3 T = st.T;
      Bounce b;
      bounce_hit<TableMaterials, kTab>(p, tab, mats, st.o, st.d, &b);
      // render_lane's pickup, direct term and sum, in its order.
      V3 pick = v3(T.x * b.emi.x, T.y * b.emi.y, T.z * b.emi.z);
      bool counted = true;
      float w_pick = 1.0f;  // mis: the pickup's balance weight
      if constexpr (kEst == kTextbook) {
        if (st.suppress && b.hit && b.id == p.light_id) {
          pick = zero;
          counted = false;
        }
      } else if constexpr (kEst == kMis) {
        if (mis_pickup(p, lf, st.d, b, st.mis_pdf, &w_pick)) {
          pick = mul(pick, w_pick);
        }
      }
      bounce_scatter<kTab, kEst>(p, tab, lf, st.o, st.d, lr.pid_base + c.s,
                                 depth, lr.pix, NoGuide{}, &b);
      V3 A_new;
      float gate = 0.0f;
      if constexpr (direct_term(kEst)) {
        V3 direct = zero;
        if (b.success) {
          gate = b.w_nee;
          direct = v3(((b.w_nee * T.x) * b.alb.x) * e_light.x,
                      ((b.w_nee * T.y) * b.alb.y) * e_light.y,
                      ((b.w_nee * T.z) * b.alb.z) * e_light.z);
        }
        A_new = add(st.A, add(pick, direct));
      } else {
        A_new = add(st.A, pick);
      }
      const float p_max = fmaxf(b.alb.x, fmaxf(b.alb.y, b.alb.z));

      auto& e = tape[c.pbuf][tape_slot(depth)];
      e.code = b.id | (b.rr_scaled ? kRrBit : 0) |
               (b.alb.x == p_max ? kTieX : 0) |
               (b.alb.y == p_max ? kTieY : 0) |
               (b.alb.z == p_max ? kTieZ : 0) | (counted ? kEmitBit : 0);
      e.A_new = A_new;
      e.T = T;
      if constexpr (kEst == kMis) {
        e.w_pick = w_pick;
      } else {
        e.inv_p = b.inv_p;
      }
      e.w = b.w;
      e.gate = gate;

      // A path that goes on was alive after this bounce, so the next
      // pickup is suppressed exactly when this bounce was diffuse, and
      // mis's carry is this diffuse bounce's continuation pdf.
      State next{b.x, b.new_dir,
                 mul(v3(T.x * b.f.x, T.y * b.f.y, T.z * b.f.z), b.w), A_new,
                 kEst == kTextbook && b.diffuse};
      if constexpr (kEst == kMis) next.mis_pdf = b.diffuse ? b.pdf_cont : 0.0f;
      c.depth = depth;
      if (c.d_stop == 0) {  // pass A
        tape_checkpoint(ck, depth, st);
        if (b.survive && depth < p.max_bounces) {
          st = next;
        } else {
          tape_end_pass_a(&c, A_new);
        }
      } else if (depth == c.d_stop) {
        tape_end_replay(&c);
      } else {
        st = next;
      }
    }
    if (c.sweeping) {  // bounce j's terms
      const auto e = tape[c.sbuf][tape_slot(c.j)];
      const int id = e.code & kIdMask;
      const V3 alb_h = mats.albedo(id);
      const V3 LA = c.LA_sw, A_new = e.A_new, T = e.T;
      const float w = e.w;
      float inv_p, emit_f;  // bounce_scatter's inv_p; the pickup's weight
      if constexpr (kEst == kMis) {
        const float p_max = fmaxf(alb_h.x, fmaxf(alb_h.y, alb_h.z));
        inv_p = (e.code & kRrBit) ? 1.0f / (p_max > 0.0f ? p_max : 1.0f)
                                  : 1.0f;
        emit_f = e.w_pick;
      } else {
        inv_p = e.inv_p;
        emit_f = (e.code & kEmitBit) ? 1.0f : 0.0f;
      }
      const V3 fw = mul(mul(alb_h, inv_p), w);
      // T_j·S_{j+1} per channel by the guarded tail divide.
      const V3 TS = v3(fw.x != 0.0f ? (LA.x - A_new.x) / fw.x : 0.0f,
                       fw.y != 0.0f ? (LA.y - A_new.y) / fw.y : 0.0f,
                       fw.z != 0.0f ? (LA.z - A_new.z) / fw.z : 0.0f);
      const float f_scale = inv_p * w;
      const float s_am =
          (e.code & kRrBit)
              ? (gc.x * TS.x * alb_h.x + gc.y * TS.y * alb_h.y +
                 gc.z * TS.z * alb_h.z) *
                    w * (-(inv_p * inv_p))
              : 0.0f;
      const float eq_x = (e.code & kTieX) ? 1.0f : 0.0f;
      const float eq_y = (e.code & kTieY) ? 1.0f : 0.0f;
      const float eq_z = (e.code & kTieZ) ? 1.0f : 0.0f;
      const float n_eq = eq_x + eq_y + eq_z;
      const float am = s_am / (n_eq > 0.0f ? n_eq : 1.0f);
      ct.key = id;
      ct.v[0] = gc.x * TS.x * f_scale + eq_x * am;
      ct.v[1] = gc.y * TS.y * f_scale + eq_y * am;
      ct.v[2] = gc.z * TS.z * f_scale + eq_z * am;
      ct.v[3] = gc.x * T.x * emit_f;
      ct.v[4] = gc.y * T.y * emit_f;
      ct.v[5] = gc.z * T.z * emit_f;
      if constexpr (direct_term(kEst)) {
        const float gate = e.gate;
        ct.v[0] += gc.x * gate * T.x * e_light.x;
        ct.v[1] += gc.y * gate * T.y * e_light.y;
        ct.v[2] += gc.z * gate * T.z * e_light.z;
        g_le = add(g_le, v3(gc.x * gate * T.x * alb_h.x,
                            gc.y * gate * T.y * alb_h.y,
                            gc.z * gate * T.z * alb_h.z));
      }
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    // No key is a sphere's geometry row here: the threshold is K.
    warp_accumulate(ct, my_row, k_obj, k_obj);
  }
  if constexpr (direct_term(kEst)) {
    float s3[3] = {g_le.x, g_le.y, g_le.z};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s3[i] += __shfl_xor_sync(kFull, s3[i], off);
      }
    }
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < 3; ++i) my_row[3 * k_obj + 3 * p.light_id + i] += s3[i];
    }
    __syncwarp();
  }
  block_partials(rows, n_slots, partials);
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

// The host entry points' body (their arguments, kernel_of the entry's
// instance of an estimator code and scan, nullptr for a code it has no
// instance of): checks, fills Params, launches the kernel and
// reduce_partials on `stream`, and returns the first launch error.
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
  Params p;
  const bool tree = root >= 0;
  const VjpKernel kernel =
      kernel_of(est, !tab ? kTabNone : tree ? kScanTree : kScanLinear);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      kernel == nullptr || n_spheres < 0 || n_spheres > kMaxGradSpheres ||
      (!tab && n_spheres != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  const int n_blocks = grid_of(p);
  const int n_slots = 6 * (n_rects + n_spheres);
  if (n_partials < static_cast<long long>(n_blocks) * n_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_head = !tab ? (6 * n_rects + 3) / 4 : (tree ? 0 : 2 * n_spheres);
  const size_t smem =
      sizeof(float4) * n_head + sizeof(float) * kWarps * n_slots;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<n_blocks, kBlock, smem, st>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl, g_img,
      partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
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
// 0 to kMaxGradSpheres spheres. Each launches both kernels on `stream` and
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
