// Material adjoint of the runtime-material megakernel, `nee` estimator,
// axis-aligned rects with one parallelogram light.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel_grad.py:
// `build_grad_kernel`, as `_build_vjp` builds it for `render_pallas_vjp`.
// Given the per-pixel cotangent g of the radiance sum I (the forward's
// image), it returns d(sum g·I)/d albedo and d(sum g·I)/d emission, both
// (K, 3), pathwise (the same scope as autograd through the plain forward).
// Row 10 (`material_train_step_sharded`, megakernel_grad.py:1083, its two
// `pallas_call`s at :1156 and :1195) runs megakernel_nee_mat and this
// kernel on one rank's shard lanes (`lane_range` with pix0): g_img holds
// the shard's pixel rows only, indexed by the lane's row in the shard. The
// sums over the mesh are torch.distributed all-reduces in
// ops/megakernel_grad.py.
//
// Algorithm: every (pixel, sample) path is traced once. Each bounce tapes,
// in the lane's local memory (megakernel_tape.cuh), what the gradient
// formulas read: the hit object, the emission partial sum A_{j+1} (this
// bounce's pickup included), the prefix throughput T_j, f_j·w_j (f_j =
// albedo·inv_p is the bounce's throughput factor, w_j its NEE weight),
// inv_p, w_j, and the RR flags. When the path ends its radiance L is known,
// and the sweep recovers the suffix factor as T_j·S_{j+1} = (L − A_{j+1}) /
// (f_j·w_j), 0 where that is 0. Per bounce on the hit object:
//   d/d albedo_c += g_c·TS_c·inv_p·w, plus the RR 1/p term
//                   −inv_p²·w·Σ_c g_c·TS_c·albedo_c split evenly over the
//                   channels equal to p_max (autograd's amax rule);
//   d/d emission_c += g_c·T_c.
// The TPU kernel traces each path twice instead (pass A for L, pass B for
// the terms) and keeps a column of accumulators a thread.
//
// Design: one thread per lane on the forward's lane layout (blocks of 128);
// a lane reads its pixel's cotangent g_img[pix] directly. The tables are
// copied into shared memory once per block. A lane traces one segment of a
// path while it sweeps the one before (two tape buffers of kSeg bounces);
// paths longer than kSeg replay their earlier segments from checkpoints,
// bit for bit (one bounce body, the library's --fmad=false build). The
// warp loops while any lane is active and meets once an iteration at
// `warp_accumulate`, which adds the sweep's contributions by object into
// the warp's row of 6·K slots in shared memory in a fixed order; the block
// sums its four rows in a fixed order into one row of per-block partials,
// and `reduce_partials` sums the rows in a fixed order. The result is
// bit-identical from run to run, without atomics; shared memory is the
// tables and kWarps·6·K floats.
//
// What bounds it: operations, about one forward's (one trace, no NEE fold),
// plus the sweep's gradient arithmetic and the warp sums. Bytes are small:
// the cotangent image (12 bytes a pixel), the tables, the per-block
// partials, and the tape (48 bytes a bounce, written and read once).
// Left for later: the NEE fold in the trace.

#include "megakernel_common.cuh"
#include "megakernel_tape.cuh"

namespace {

// A tape entry: what the sweep reads of bounce j. `code` holds the hit
// object (low 8 bits), RR's scaling (bit 8) and the channels tied at p_max
// (bits 9-11).
struct __align__(16) VjpEntry {
  int code;
  V3 A_new, T, fw;
  float inv_p, w;
};

__global__ void __launch_bounds__(kBlock)
    megakernel_vjp(const __grid_constant__ Params p,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ g_img,
                   float* __restrict__ partials) {
  // Dynamic shared memory: the tables, then a row of 6K gradient slots a
  // warp (albedo, then emission).
  extern __shared__ float smem[];
  float* s_alb = smem;
  float* s_emi = smem + 3 * kMaxRects;
  float* rows = smem + 6 * kMaxRects;
  const int n_slots = 6 * p.n_rects;
  for (int i = threadIdx.x; i < kWarps * n_slots; i += kBlock) rows[i] = 0.0f;
  load_tables(p, alb, emi, s_alb, s_emi);
  float* my_row = rows + (threadIdx.x >> 5) * n_slots;
  const TableMaterials mats{s_alb, s_emi};

  const LaneRange lr = lane_range(p);
  const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
  const V3 gc = lr.in_range ? ld3(g_img + 3 * lr.pix) : zero;
  const V3 cam_o = ld3(p.cam_o);
  const V3 lc = ld3(p.lc), leu = ld3(p.leu), lev = ld3(p.lev), ln = ld3(p.ln);

  VjpEntry tape[2][kSeg];
  PathState ck[kCkpt];
  TapeCtl c;
  tape_start(&c, lr.s, lr.in_range && lr.s < lr.s_stop);
  PathState st;  // the producer's state before its next bounce
  const auto spawn = [&] {
    st = PathState{cam_o, spawn_dir(p, lr.px, lr.py, lr.pid_base + c.s), one,
                   zero};
  };
  if (c.tracing) spawn();

  while (__any_sync(kFull, tape_active(c))) {
    Contrib ct;
    ct.key = -1;
    if (c.tracing) {  // pass A, or a segment replay
      const int depth = c.depth + 1;
      const uint32_t pid = lr.pid_base + c.s;
      const V3 o = st.o, d = st.d, T = st.T;
      int id;
      const float t_hit = nearest(p, o, d, &id);
      const bool hit = t_hit < kMissT;
      const int axis = p.rects[id].axis;
      const V3 alb_h = mats.albedo(id);
      const V3 emi_h = mats.emission(id);
      const V3 A_new =
          add(st.A, v3(T.x * emi_h.x, T.y * emi_h.y, T.z * emi_h.z));
      const V3 x = hit ? add(o, mul(d, t_hit)) : v3(0.0f, 0.0f, 0.0f);
      const V3 ng = v3(axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
                       axis == 2 ? 1.0f : 0.0f);
      const V3 n = dot(ng, d) < 0.0f ? ng : neg(ng);

      const uint32_t ctr = static_cast<uint32_t>(depth) * kDrawsPerBounce;
      const float u_rr = uniform(p.seed, pid, ctr + kRR);

      const float p_max = fmaxf(alb_h.x, fmaxf(alb_h.y, alb_h.z));
      const bool rr_active = depth > p.rr_start_depth || p_max <= 0.0f;
      const bool survive = rr_active ? u_rr < p_max : true;
      const bool rr_scaled = rr_active && p_max > 0.0f;
      const float inv_p =
          rr_scaled ? 1.0f / (p_max > 0.0f ? p_max : 1.0f) : 1.0f;
      const V3 f = mul(alb_h, inv_p);

      const float u1 = uniform(p.seed, pid, ctr + kScatterU);
      const float u2 = uniform(p.seed, pid, ctr + kScatterV);
      float sr1, cr1;
      sincos_2pi(u1, &sr1, &cr1);
      const float r2s = sqrtf(u2);
      const V3 a =
          fabsf(n.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
      const V3 fu = norm(cross(a, n));
      const V3 fv = cross(n, fu);
      const V3 cos_dir = norm(add(add(mul(fu, cr1 * r2s), mul(fv, sr1 * r2s)),
                                  mul(n, sqrtf(1.0f - u2))));

      const float lu = uniform(p.seed, pid, ctr + kLightU);
      const float lv = uniform(p.seed, pid, ctr + kLightV);
      const V3 lp = add(add(lc, mul(leu, lu)), mul(lev, lv));
      const V3 d_l = norm(sub(lp, x));
      float t_l;
      const bool success = probe_light(p, x, d_l, &t_l);
      const float t_safe = success ? t_l : 1.0f;
      const float w_nee = (fabsf(p.area * dot(d_l, ln)) / (t_safe * t_safe)) *
                          (fabsf(dot(d_l, n)) * kInvPi);
      const V3 new_dir = success ? d_l : cos_dir;
      const float w = success ? w_nee : 1.0f;

      VjpEntry& e = tape[c.pbuf][tape_slot(depth)];
      e.code = id | (rr_scaled ? 1 << 8 : 0) |
               (alb_h.x == p_max ? 1 << 9 : 0) |
               (alb_h.y == p_max ? 1 << 10 : 0) |
               (alb_h.z == p_max ? 1 << 11 : 0);
      e.A_new = A_new;
      e.T = T;
      e.fw = mul(f, w);
      e.inv_p = inv_p;
      e.w = w;

      const PathState next{x, new_dir,
                           mul(v3(T.x * f.x, T.y * f.y, T.z * f.z), w),
                           A_new};
      c.depth = depth;
      if (c.d_stop == 0) {  // pass A
        tape_checkpoint(ck, depth, st);
        if (survive && depth < p.max_bounces) {
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
      const VjpEntry e = tape[c.sbuf][tape_slot(c.j)];
      const int id = e.code & 0xFF;
      const V3 alb_h = mats.albedo(id);
      const V3 LA = c.LA_sw, A_new = e.A_new, T = e.T, fw = e.fw;
      const float inv_p = e.inv_p, w = e.w;
      // T_j·S_{j+1} per channel by the guarded tail divide.
      const V3 TS = v3(fw.x != 0.0f ? (LA.x - A_new.x) / fw.x : 0.0f,
                       fw.y != 0.0f ? (LA.y - A_new.y) / fw.y : 0.0f,
                       fw.z != 0.0f ? (LA.z - A_new.z) / fw.z : 0.0f);
      const float f_scale = inv_p * w;
      const float s_am =
          (e.code & (1 << 8))
              ? (gc.x * TS.x * alb_h.x + gc.y * TS.y * alb_h.y +
                 gc.z * TS.z * alb_h.z) *
                    w * (-(inv_p * inv_p))
              : 0.0f;
      const float eq_x = (e.code & (1 << 9)) ? 1.0f : 0.0f;
      const float eq_y = (e.code & (1 << 10)) ? 1.0f : 0.0f;
      const float eq_z = (e.code & (1 << 11)) ? 1.0f : 0.0f;
      const float n_eq = eq_x + eq_y + eq_z;
      const float am = s_am / (n_eq > 0.0f ? n_eq : 1.0f);
      ct.key = id;
      ct.v[0] = gc.x * TS.x * f_scale + eq_x * am;
      ct.v[1] = gc.y * TS.y * f_scale + eq_y * am;
      ct.v[2] = gc.z * TS.z * f_scale + eq_z * am;
      ct.v[3] = gc.x * T.x;
      ct.v[4] = gc.y * T.y;
      ct.v[5] = gc.z * T.z;
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    warp_accumulate(ct, my_row, p.n_rects, p.n_rects);
  }
  block_partials(rows, n_slots, partials);
}

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes). Geometry,
// light and camera as fill_params (megakernel_common.cuh) reads them, in
// host memory. On the device: alb, emi (n_rects, 3) float32; g_img
// (n_pix_loc, 3) float32, the cotangents of the shard's pixels [pix0,
// pix0 + n_pix_loc) (unsharded: (height, width, 3)); partials: scratch of
// n_partials floats, at least ceil(n_pix_loc·g / 128) · 6·n_rects; out:
// 6·n_rects floats,
// d/d albedo (n_rects, 3) then d/d emission (n_rects, 3). Launches both
// kernels on `stream` and returns the first launch error (cudaError_t).
extern "C" int spt_megakernel_vjp(const float* rect_geom, const int* rect_axis,
                                  int n_rects, const float* light_f,
                                  int light_id, const float* cam_f,
                                  unsigned seed, int width, int height,
                                  int spp, int g, int per, unsigned s0,
                                  int pix0, int n_pix_loc,
                                  int rr_start_depth, int max_bounces,
                                  const float* alb, const float* emi,
                                  const float* g_img, float* partials,
                                  long long n_partials, float* out,
                                  void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = grid_of(p);
  const int n_slots = 6 * n_rects;
  if (n_partials < static_cast<long long>(n_blocks) * n_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (6 * kMaxRects + kWarps * n_slots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  megakernel_vjp<<<n_blocks, kBlock, smem, st>>>(p, alb, emi, g_img, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
}
