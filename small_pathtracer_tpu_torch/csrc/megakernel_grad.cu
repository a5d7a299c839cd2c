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
// Algorithm (the TPU kernel's): every (pixel, sample) path is replayed twice
// from the counter RNG. Pass A recomputes the sample's radiance L; pass B
// replays it keeping the prefix throughput T_j and the emission partial sum
// A_{j+1} (this bounce's pickup included), and recovers the suffix factor
// without a stored tape as T_j·S_{j+1} = (L − A_{j+1}) / f_j, 0 where
// f_j == 0 (f_j = albedo·inv_p·w is the bounce's throughput factor). Per
// bounce on the hit object:
//   d/d albedo_c += g_c·TS_c·inv_p·w, plus the RR 1/p term
//                   −inv_p²·w·Σ_c g_c·TS_c·albedo_c split evenly over the
//                   channels equal to p_max (autograd's amax rule);
//   d/d emission_c += g_c·T_c.
//
// Design: one thread per lane on the forward's lane layout (blocks of 128);
// a lane reads its pixel's cotangent g_img[pix] directly. Both passes run in
// one loop body with one spawn site, so pass B retraces pass A bit for bit
// (with the library's --fmad=false IEEE build, see megakernel_common.cuh).
// The tables are copied into shared memory once per block. Each thread owns
// a column of 2·K·3 float accumulators in shared memory (no atomics); the
// block sums its columns in a fixed order into one row of per-block
// partials, and `reduce_partials` sums the rows in a fixed order. The
// result is bit-identical from run to run.
//
// What bounds it: operations, as for the forward, about twice over (two
// replays, no NEE fold), plus the pass-B gradient arithmetic and six
// shared-memory updates a bounce: counted, fp32 bounds it at 12.4 ms at
// 1024x768x512 on an H100 SXM (700 W) against ~261 ms measured (PERF.md).
// Bytes are small: the cotangent image (12 bytes a pixel), the tables, and
// the per-block partials. The shared accumulators (52 KB a block at
// K = 17) cap occupancy at 4 blocks an SM.
// Left for later: the NEE fold in the replays, warp-level accumulation in
// registers to free shared memory, and a tape that skips pass A.

#include "megakernel_common.cuh"

namespace {

__global__ void __launch_bounds__(kBlock)
    megakernel_vjp(const __grid_constant__ Params p,
                   const float* __restrict__ alb,
                   const float* __restrict__ emi,
                   const float* __restrict__ g_img,
                   float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* s_alb = smem;
  float* s_emi = smem + 3 * kMaxRects;
  float* acc = smem + 6 * kMaxRects;  // [slot][kBlock], slot < n_slots
  const int k3 = 3 * p.n_rects;
  const int n_slots = 2 * k3;  // albedo slots, then emission slots
  for (int sl = 0; sl < n_slots; ++sl) acc[sl * kBlock + threadIdx.x] = 0.0f;
  load_tables(p, alb, emi, s_alb, s_emi);
  const TableMaterials mats{s_alb, s_emi};
  float* my = acc + threadIdx.x;

  const LaneRange lr = lane_range(p);
  const V3 gc = lr.in_range ? ld3(g_img + 3 * lr.pix) : v3(0.0f, 0.0f, 0.0f);
  const V3 cam_o = ld3(p.cam_o);
  const V3 lc = ld3(p.lc), leu = ld3(p.leu), lev = ld3(p.lev), ln = ld3(p.ln);

  uint32_t s = lr.s;
  uint32_t pid = 0;
  V3 o = cam_o, d = v3(0.0f, 0.0f, 0.0f);
  V3 T = v3(1.0f, 1.0f, 1.0f);
  V3 A = v3(0.0f, 0.0f, 0.0f);   // emission partial sum (pass A: L)
  V3 LA = v3(0.0f, 0.0f, 0.0f);  // pass A's radiance of the sample
  int depth = 0;
  bool alive = lr.in_range && s < lr.s_stop;
  bool spawn = true, pass_b = false;

  while (alive) {
    if (spawn) {  // the one spawn site of both passes
      pid = lr.pid_base + s;
      o = cam_o;
      d = spawn_dir(p, lr.px, lr.py, pid);
      T = v3(1.0f, 1.0f, 1.0f);
      A = v3(0.0f, 0.0f, 0.0f);
      depth = 0;
      spawn = false;
    }
    depth += 1;
    int id;
    const float t_hit = nearest(p, o, d, &id);
    const bool hit = t_hit < kMissT;
    const int axis = p.rects[id].axis;
    const V3 alb_h = mats.albedo(id);
    const V3 emi_h = mats.emission(id);
    const V3 A_new = add(A, v3(T.x * emi_h.x, T.y * emi_h.y, T.z * emi_h.z));
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
    const float inv_p = rr_scaled ? 1.0f / (p_max > 0.0f ? p_max : 1.0f) : 1.0f;
    const V3 f = mul(alb_h, inv_p);

    const float u1 = uniform(p.seed, pid, ctr + kScatterU);
    const float u2 = uniform(p.seed, pid, ctr + kScatterV);
    float sr1, cr1;
    sincos_2pi(u1, &sr1, &cr1);
    const float r2s = sqrtf(u2);
    const V3 a = fabsf(n.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
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
    const V3 T_new = mul(v3(T.x * f.x, T.y * f.y, T.z * f.z), w);

    if (pass_b) {
      // T_j·S_{j+1} per channel by the guarded tail divide.
      const V3 fw = mul(f, w);
      const V3 TS = v3(fw.x != 0.0f ? (LA.x - A_new.x) / fw.x : 0.0f,
                       fw.y != 0.0f ? (LA.y - A_new.y) / fw.y : 0.0f,
                       fw.z != 0.0f ? (LA.z - A_new.z) / fw.z : 0.0f);
      const float f_scale = inv_p * w;
      const float s_am =
          rr_scaled ? (gc.x * TS.x * alb_h.x + gc.y * TS.y * alb_h.y +
                       gc.z * TS.z * alb_h.z) *
                          w * (-(inv_p * inv_p))
                    : 0.0f;
      const float eq_x = alb_h.x == p_max ? 1.0f : 0.0f;
      const float eq_y = alb_h.y == p_max ? 1.0f : 0.0f;
      const float eq_z = alb_h.z == p_max ? 1.0f : 0.0f;
      const float n_eq = eq_x + eq_y + eq_z;
      const float am = s_am / (n_eq > 0.0f ? n_eq : 1.0f);
      float* ga = my + (3 * id) * kBlock;
      float* ge = my + (k3 + 3 * id) * kBlock;
      ga[0] += gc.x * TS.x * f_scale + eq_x * am;
      ga[kBlock] += gc.y * TS.y * f_scale + eq_y * am;
      ga[2 * kBlock] += gc.z * TS.z * f_scale + eq_z * am;
      ge[0] += gc.x * T.x;
      ge[kBlock] += gc.y * T.y;
      ge[2 * kBlock] += gc.z * T.z;
    }

    const bool alive_next = survive && depth < p.max_bounces;
    if (alive_next) {
      o = x;
      d = new_dir;
      T = T_new;
      A = A_new;
    } else if (!pass_b) {
      LA = A_new;  // pass A done: replay the same sample as pass B
      pass_b = true;
      spawn = true;
    } else {
      pass_b = false;
      s += 1;
      if (s < lr.s_stop) {
        spawn = true;
      } else {
        alive = false;
      }
    }
  }

  // This block's sums, one warp per slot, in a fixed order: each lane adds
  // its four columns in turn, then a shuffle tree.
  __syncthreads();
  const int warp = threadIdx.x >> 5, ln32 = threadIdx.x & 31;
  for (int sl = warp; sl < n_slots; sl += kBlock / 32) {
    const float* row = acc + sl * kBlock;
    float v = row[ln32];
#pragma unroll
    for (int q = 1; q < kBlock / 32; ++q) v += row[ln32 + 32 * q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    }
    if (ln32 == 0) partials[blockIdx.x * n_slots + sl] = v;
  }
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
  const size_t smem =
      sizeof(float) * (6 * kMaxRects + static_cast<size_t>(n_slots) * kBlock);
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_vjp, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  megakernel_vjp<<<n_blocks, kBlock, smem, st>>>(p, alb, emi, g_img, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
}
