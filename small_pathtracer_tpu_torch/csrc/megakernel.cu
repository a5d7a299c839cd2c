// Fused regenerating path tracer, `nee` estimator, axis-aligned rects with
// one parallelogram light, box filter, pinhole camera. Two kernels share one
// loop body (`render_lane`, a template on where the materials come from):
//
// - megakernel_nee replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel`, as
//   `_build_render` builds it for `render_pallas` / `render_pallas_span`
//   (baked scene, no material refs, NEE fold on). Materials sit in the
//   kernel parameters beside the geometry.
// - megakernel_nee_mat replaces `build_kernel(mat_refs=True)` as
//   small_pathtracer_tpu/ops/megakernel_grad.py: `_build_fwd_mat` builds it
//   for `render_pallas_mat`: the albedo and emission (K, 3) tables are
//   runtime inputs in device memory, copied into shared memory once per
//   block, so a training step changes them without a host copy. The NEE
//   fold is decided in the kernel from the light's row of the table.
//   Equal tables give a bit-identical image and trace counts.
//
// What bounds them: arithmetic and divergence, not bytes. A lane reads
// nothing but its index, the scene (a few hundred bytes of kernel
// parameters, read by every lane alike) and, for the table kernel, 2·K·3
// floats per block, and writes 12 bytes of radiance plus a share of two
// counters: about 20 bytes of I/O against thousands of operations per
// sample (17 rect tests per nearest-hit query, two queries per bounce, five
// murmur3 hashes per bounce on the integer pipes). Counted that way, the
// integer operations bound both kernels: 3.8 ms at 1024x768x512 on an H100
// SXM (700 W) against ~69 ms measured (PERF.md). What costs time is the
// per-lane while loop: lanes of one warp die and respawn at different
// bounces, and a diverged warp runs both paths.
//
// Design: one thread per lane, blocks of 128, the ragged last block masked.
// A lane derives its pixel and sample range [s_start, s_stop) from its index
// (no input planes) and keeps the whole path state in registers across the
// bounce loop; a lane whose path dies respawns at once with its next sample,
// so a warp stays busy until its slowest lane runs out of samples. Trace
// counts are 32-bit per thread, summed per warp, and added to two 64-bit
// totals with one atomic per warp. Left for later: sorting or compacting
// lanes against divergence, and a scene test cheaper than the linear scan.
//
// Numerics: see megakernel_common.cuh; the kernels match the eager plain
// version exactly on the card. The NEE fold: a successful probe proves the
// next extend ray hits the light, and when the light's max albedo is <= 0
// that bounce's pickup, its extend count and the path's certain RR death are
// resolved one iteration early. Per-lane sums and counters stay exactly
// those of the unfolded loop.

#include "megakernel_common.cuh"

namespace {

template <class Mats>
__device__ __forceinline__ void render_lane(const Params& p, const Mats& mats,
                                            bool fold,
                                            float* __restrict__ out_l,
                                            unsigned long long* __restrict__ traces) {
  const LaneRange lr = lane_range(p);
  const V3 cam_o = ld3(p.cam_o);
  const V3 lc = ld3(p.lc), leu = ld3(p.leu), lev = ld3(p.lev), ln = ld3(p.ln);
  const V3 e_light = mats.emission(p.light_id);

  uint32_t s = lr.s;
  uint32_t pid = lr.pid_base + s;
  V3 o = cam_o;
  V3 d = spawn_dir(p, lr.px, lr.py, pid);
  V3 T = v3(1.0f, 1.0f, 1.0f);
  V3 L = v3(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool alive = lr.in_range && s < lr.s_stop;
  uint32_t n_extend = 0, n_probe = 0;

  while (alive) {
    depth += 1;
    int id;
    const float t_hit = nearest(p, o, d, &id);
    const bool hit = t_hit < kMissT;
    const int axis = p.rects[id].axis;
    const V3 alb = mats.albedo(id);
    const V3 emi = mats.emission(id);
    // Emission pickup: throughput * emission.
    L = add(L, v3(T.x * emi.x, T.y * emi.y, T.z * emi.z));
    const V3 x = hit ? add(o, mul(d, t_hit)) : v3(0.0f, 0.0f, 0.0f);
    const V3 ng = v3(axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
                     axis == 2 ? 1.0f : 0.0f);
    const V3 n = dot(ng, d) < 0.0f ? ng : neg(ng);

    const uint32_t ctr = static_cast<uint32_t>(depth) * kDrawsPerBounce;
    const float u_rr = uniform(p.seed, pid, ctr + kRR);

    // Russian roulette.
    const float p_max = fmaxf(alb.x, fmaxf(alb.y, alb.z));
    const bool rr_active = depth > p.rr_start_depth || p_max <= 0.0f;
    const bool survive = rr_active ? u_rr < p_max : true;
    const float inv_p =
        (rr_active && p_max > 0.0f) ? 1.0f / (p_max > 0.0f ? p_max : 1.0f) : 1.0f;
    const V3 f = mul(alb, inv_p);

    // Cosine-weighted hemisphere sample around n.
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

    // NEE as continuation: probe a uniform point of the light parallelogram.
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

    bool alive_next = survive;
    n_extend += 1;
    n_probe += alive_next ? 1u : 0u;
    alive_next = alive_next && depth < p.max_bounces;

    if (fold && alive_next && success) {
      // The next bounce hits the light at t_l, picks up T_new * e_light and
      // dies in RR (max albedo <= 0): resolve it now.
      L = add(L, v3(T_new.x * e_light.x, T_new.y * e_light.y,
                    T_new.z * e_light.z));
      n_extend += 1;
      alive_next = false;
    }

    if (alive_next) {
      o = x;
      d = new_dir;
      T = T_new;
    } else {
      s += 1;
      if (s < lr.s_stop) {
        pid = lr.pid_base + s;
        o = cam_o;
        d = spawn_dir(p, lr.px, lr.py, pid);
        T = v3(1.0f, 1.0f, 1.0f);
        depth = 0;
      } else {
        alive = false;
      }
    }
  }

  if (lr.in_range) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    out_l[3 * lane + 0] = L.x;
    out_l[3 * lane + 1] = L.y;
    out_l[3 * lane + 2] = L.z;
  }
  unsigned long long ext = n_extend, prb = n_probe;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ext += __shfl_down_sync(0xFFFFFFFFu, ext, off);
    prb += __shfl_down_sync(0xFFFFFFFFu, prb, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&traces[0], ext);
    atomicAdd(&traces[1], prb);
  }
}

__global__ void __launch_bounds__(kBlock)
    megakernel_nee(const __grid_constant__ Params p, float* __restrict__ out_l,
                   unsigned long long* __restrict__ traces) {
  render_lane(p, BakedMaterials{p}, p.fold != 0, out_l, traces);
}

__global__ void __launch_bounds__(kBlock)
    megakernel_nee_mat(const __grid_constant__ Params p,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       float* __restrict__ out_l,
                       unsigned long long* __restrict__ traces) {
  __shared__ float s_alb[3 * kMaxRects];
  __shared__ float s_emi[3 * kMaxRects];
  load_tables(p, alb, emi, s_alb, s_emi);
  const TableMaterials mats{s_alb, s_emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane(p, mats, fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f, out_l, traces);
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes). rect_geom,
// rect_axis, light_f and cam_f as fill_params (megakernel_common.cuh) reads
// them, in host memory. out_l: (n_pix * g, 3) float32 and traces: 2 uint64,
// zeroed, on the device. Each launches on `stream` and returns the launch's
// cudaError_t.

// Row 1, baked materials: rect_alb, rect_emi are (n_rects, 3) float32 host
// arrays copied into the kernel parameters; fold turns the NEE fold on.
extern "C" int spt_megakernel_nee(const float* rect_geom, const int* rect_axis,
                                  const float* rect_alb, const float* rect_emi,
                                  int n_rects, const float* light_f,
                                  int light_id, const float* cam_f,
                                  unsigned seed, int width, int height,
                                  int spp, int g, int per, unsigned s0,
                                  int rr_start_depth, int max_bounces,
                                  int fold, float* out_l,
                                  unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0,
                   rr_start_depth, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n_rects; ++i) {
    for (int c = 0; c < 3; ++c) {
      p.rects[i].alb[c] = rect_alb[3 * i + c];
      p.rects[i].emi[c] = rect_emi[3 * i + c];
    }
  }
  p.fold = fold;
  megakernel_nee<<<grid_of(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 8, runtime materials: alb, emi are (n_rects, 3) float32 tables in
// device memory, read by the kernel (no host copy).
extern "C" int spt_megakernel_nee_mat(const float* rect_geom,
                                      const int* rect_axis, int n_rects,
                                      const float* light_f, int light_id,
                                      const float* cam_f, unsigned seed,
                                      int width, int height, int spp, int g,
                                      int per, unsigned s0,
                                      int rr_start_depth, int max_bounces,
                                      const float* alb, const float* emi,
                                      float* out_l,
                                      unsigned long long* traces,
                                      void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0,
                   rr_start_depth, max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  megakernel_nee_mat<<<grid_of(p), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, alb, emi, out_l,
                                                            traces);
  return static_cast<int>(cudaGetLastError());
}
