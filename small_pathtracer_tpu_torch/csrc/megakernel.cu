// Fused regenerating path tracer, `nee` estimator, axis-aligned rects with
// one parallelogram light, box filter, pinhole camera.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel.py:
// `build_kernel`, as `_build_render` builds it for `render_pallas` /
// `render_pallas_span` (baked scene, no material refs, NEE fold on).
//
// What bounds it: arithmetic and divergence, not bytes. A lane reads nothing
// but its index and the scene (a few hundred bytes of kernel parameters,
// read by every lane alike) and writes 12 bytes of radiance plus a share of
// two counters: about 20 bytes of I/O against thousands of flops per sample
// (17 rect tests per nearest-hit query, two queries per bounce, the hash per
// draw). What costs time is the per-lane while loop: lanes of one warp die
// and respawn at different bounces, and a diverged warp runs both paths.
//
// Design: one thread per lane, blocks of 128, the ragged last block masked.
// A lane derives its pixel and sample range [s_start, s_stop) from its index
// (no input planes) and keeps the whole path state in registers across the
// bounce loop; a lane whose path dies respawns at once with its next sample,
// so a warp stays busy until its slowest lane runs out of samples. Trace
// counts are 32-bit per thread, summed per warp, and added to two 64-bit
// totals with one atomic per warp.
//
// Numerics: compiled with --fmad=false and IEEE division and sqrt, with
// rsqrt written as 1/sqrtf, so each operation rounds as the eager torch ops
// of integrator/wavefront.py do (the plain version, which the kernel matches
// exactly on the card). The kernel folds the NEE continuation: a successful
// probe proves the next extend ray hits the zero-albedo light, so that
// bounce's pickup, its extend count and the path's certain RR death are
// resolved one iteration early. Per-lane sums and counters stay exactly those
// of the unfolded loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRects = 32;
constexpr int kBlock = 128;
constexpr float kMissT = 1e20f;
constexpr float kSelfHitEps = 1e-3f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr uint32_t kDrawsPerBounce = 8;
constexpr uint32_t kRR = 0, kLightU = 1, kLightV = 2, kScatterU = 3,
                   kScatterV = 4;

struct Rect {
  int axis;
  float k, lo0, lo1, hi0, hi1;
  float alb[3];
  float emi[3];
};

struct Params {
  Rect rects[kMaxRects];
  int n_rects;
  int light_id;
  float lc[3], leu[3], lev[3];  // light corner and edges
  float ln[3];                  // light unit normal
  float area;                   // light area
  float cam_o[3], cam_ll[3], cam_h[3], cam_v[3];
  uint32_t seed;
  int width, height, spp;
  int g, per;
  uint32_t s0;
  int n_lanes;
  int rr_start_depth, max_bounces, fold;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float rsqrt_ieee(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ V3 norm(V3 a) { return mul(a, rsqrt_ieee(dot(a, a))); }
__device__ __forceinline__ float comp(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// murmur3_x86_32 over the two words (path_id, ctr); core/rng.hash_u32.
__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t path_id,
                                             uint32_t ctr) {
  uint32_t h = seed;
  const uint32_t blocks[2] = {path_id, ctr};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t k = blocks[i] * 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= 8u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float uniform(uint32_t seed, uint32_t pid,
                                         uint32_t ctr) {
  return static_cast<float>(hash_u32(seed, pid, ctr) >> 8) * kInv2p24;
}

// core/vecmath.sincos_2pi: quarter-wave polynomial.
__device__ __forceinline__ float qsin(float t) {
  const float t2 = t * t;
  return t * (1.5707962973f +
              t2 * (-0.6459634395f +
                    t2 * (0.0796887379f +
                          t2 * (-0.0046725480f + t2 * 0.0001509561f))));
}

__device__ __forceinline__ void sincos_2pi(float u, float* s, float* c) {
  const float x4 = u * 4.0f;
  const float qd = floorf(x4);
  const float f = x4 - qd;
  const float s0 = qsin(f);
  const float c0 = qsin(1.0f - f);
  const int qi = static_cast<int>(qd) & 3;
  const bool swap = (qi & 1) == 1;
  const float sb = swap ? c0 : s0;
  const float cb = swap ? s0 : c0;
  *s = qi < 2 ? sb : -sb;
  *c = (qi == 0 || qi == 3) ? cb : -cb;
}

// Hit distance of rect r, or kMissT (geometry/intersect.intersect_rects).
__device__ __forceinline__ float rect_t(const Rect& r, V3 o, V3 d, V3 inv,
                                        bool ok_x, bool ok_y, bool ok_z) {
  const int a = r.axis;
  const int b = a == 0 ? 1 : 0;
  const int c = a == 2 ? 1 : 2;
  const float t = (r.k - comp(o, a)) * comp(inv, a);
  const float p0 = comp(o, b) + t * comp(d, b);
  const float p1 = comp(o, c) + t * comp(d, c);
  const bool ok = a == 0 ? ok_x : (a == 1 ? ok_y : ok_z);
  const bool valid = p0 >= r.lo0 && p0 <= r.hi0 && p1 >= r.lo1 &&
                     p1 <= r.hi1 && t > kSelfHitEps && ok;
  return valid ? t : kMissT;
}

struct RayPrep {
  V3 inv;
  bool ok_x, ok_y, ok_z;
};

__device__ __forceinline__ RayPrep prep(V3 d) {
  RayPrep r;
  r.ok_x = d.x != 0.0f;
  r.ok_y = d.y != 0.0f;
  r.ok_z = d.z != 0.0f;
  r.inv = v3(1.0f / (r.ok_x ? d.x : 1.0f), 1.0f / (r.ok_y ? d.y : 1.0f),
             1.0f / (r.ok_z ? d.z : 1.0f));
  return r;
}

// Nearest hit: strict < scan in object order; a miss keeps id 0.
__device__ __forceinline__ float nearest(const Params& p, V3 o, V3 d,
                                         int* id) {
  const RayPrep rp = prep(d);
  float t_best = kMissT;
  int best = 0;
  for (int i = 0; i < p.n_rects; ++i) {
    const float t = rect_t(p.rects[i], o, d, rp.inv, rp.ok_x, rp.ok_y, rp.ok_z);
    if (t < t_best) {
      t_best = t;
      best = i;
    }
  }
  *id = best;
  return t_best;
}

// Shadow probe toward the light: true iff the nearest hit is the light.
// Unwinds the nearest-hit scan: the light wins iff it is hit, no earlier
// object has t <= t_light and no later object has t < t_light.
__device__ __forceinline__ bool probe_light(const Params& p, V3 o, V3 d,
                                            float* t_light) {
  const RayPrep rp = prep(d);
  const float t_l =
      rect_t(p.rects[p.light_id], o, d, rp.inv, rp.ok_x, rp.ok_y, rp.ok_z);
  *t_light = t_l;
  if (!(t_l < kMissT)) return false;
  for (int i = 0; i < p.n_rects; ++i) {
    if (i == p.light_id) continue;
    const float t = rect_t(p.rects[i], o, d, rp.inv, rp.ok_x, rp.ok_y, rp.ok_z);
    if (i < p.light_id ? t <= t_l : t < t_l) return false;
  }
  return true;
}

// camera/pinhole.primary_rays_cfg: box-filter jitter at counters 0 and 1.
__device__ __forceinline__ V3 spawn_dir(const Params& p, float px, float py,
                                        uint32_t pid) {
  const float ju = uniform(p.seed, pid, 0u);
  const float jv = uniform(p.seed, pid, 1u);
  const float s = (px - 0.5f + ju) / static_cast<float>(p.width);
  const float t =
      ((static_cast<float>(p.height) - py - 1.0f) - 0.5f + jv) /
      static_cast<float>(p.height);
  const V3 d = sub(add(add(ld3(p.cam_ll), mul(ld3(p.cam_h), s)),
                       mul(ld3(p.cam_v), t)),
                   ld3(p.cam_o));
  return norm(d);
}

__global__ void __launch_bounds__(kBlock)
    megakernel_nee(const __grid_constant__ Params p, float* __restrict__ out_l,
                   unsigned long long* __restrict__ traces) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = lane < p.n_lanes;
  const int safe_lane = in_range ? lane : 0;
  const int pix = safe_lane / p.g;
  const uint32_t grp = static_cast<uint32_t>(safe_lane % p.g);
  const float px = static_cast<float>(pix % p.width);
  const float py = static_cast<float>(pix / p.width);
  const uint32_t pid_base = static_cast<uint32_t>(pix) * static_cast<uint32_t>(p.spp);
  uint32_t s = p.s0 + grp * static_cast<uint32_t>(p.per);
  const uint32_t s_stop = s + static_cast<uint32_t>(p.per);

  const V3 cam_o = ld3(p.cam_o);
  const V3 lc = ld3(p.lc), leu = ld3(p.leu), lev = ld3(p.lev), ln = ld3(p.ln);
  const V3 e_light = ld3(p.rects[p.light_id].emi);

  uint32_t pid = pid_base + s;
  V3 o = cam_o;
  V3 d = spawn_dir(p, px, py, pid);
  V3 T = v3(1.0f, 1.0f, 1.0f);
  V3 L = v3(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool alive = in_range && s < s_stop;
  uint32_t n_extend = 0, n_probe = 0;

  while (alive) {
    depth += 1;
    int id;
    const float t_hit = nearest(p, o, d, &id);
    const bool hit = t_hit < kMissT;
    const Rect& r = p.rects[id];
    const V3 alb = ld3(r.alb);
    // Emission pickup: throughput * emission.
    L = add(L, v3(T.x * r.emi[0], T.y * r.emi[1], T.z * r.emi[2]));
    const V3 x = hit ? add(o, mul(d, t_hit)) : v3(0.0f, 0.0f, 0.0f);
    const V3 ng = v3(r.axis == 0 ? 1.0f : 0.0f, r.axis == 1 ? 1.0f : 0.0f,
                     r.axis == 2 ? 1.0f : 0.0f);
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

    if (p.fold && alive_next && success) {
      // The next bounce hits the light at t_l, picks up T_new * e_light and
      // dies in RR (zero albedo): resolve it now.
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
      if (s < s_stop) {
        pid = pid_base + s;
        o = cam_o;
        d = spawn_dir(p, px, py, pid);
        T = v3(1.0f, 1.0f, 1.0f);
        depth = 0;
      } else {
        alive = false;
      }
    }
  }

  if (in_range) {
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

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes).
// rect_f: n_rects rows of [k, lo0, lo1, hi0, hi1, albedo rgb, emission rgb];
// light_f: [corner 3, edge_u 3, edge_v 3, unit normal 3, area];
// cam_f: [origin 3, lower_left 3, horizontal 3, vertical 3] (all host
// memory). out_l: (n_pix * g, 3) float32 and traces: 2 uint64, zeroed, on the
// device. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int spt_megakernel_nee(const float* rect_f, const int* rect_axis,
                                  int n_rects, const float* light_f,
                                  int light_id, const float* cam_f,
                                  unsigned seed, int width, int height,
                                  int spp, int g, int per, unsigned s0,
                                  int rr_start_depth, int max_bounces,
                                  int fold, float* out_l,
                                  unsigned long long* traces, void* stream) {
  if (n_rects < 1 || n_rects > kMaxRects || light_id < 0 ||
      light_id >= n_rects || width < 1 || height < 1 || g < 1 || per < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  for (int i = 0; i < n_rects; ++i) {
    const float* row = rect_f + 11 * i;
    Rect& r = p.rects[i];
    r.axis = rect_axis[i];
    if (r.axis < 0 || r.axis > 2) return static_cast<int>(cudaErrorInvalidValue);
    r.k = row[0];
    r.lo0 = row[1];
    r.lo1 = row[2];
    r.hi0 = row[3];
    r.hi1 = row[4];
    for (int c = 0; c < 3; ++c) {
      r.alb[c] = row[5 + c];
      r.emi[c] = row[8 + c];
    }
  }
  p.n_rects = n_rects;
  p.light_id = light_id;
  for (int c = 0; c < 3; ++c) {
    p.lc[c] = light_f[c];
    p.leu[c] = light_f[3 + c];
    p.lev[c] = light_f[6 + c];
    p.ln[c] = light_f[9 + c];
    p.cam_o[c] = cam_f[c];
    p.cam_ll[c] = cam_f[3 + c];
    p.cam_h[c] = cam_f[6 + c];
    p.cam_v[c] = cam_f[9 + c];
  }
  p.area = light_f[12];
  p.seed = seed;
  p.width = width;
  p.height = height;
  p.spp = spp;
  p.g = g;
  p.per = per;
  p.s0 = s0;
  p.n_lanes = width * height * g;
  p.rr_start_depth = rr_start_depth;
  p.max_bounces = max_bounces;
  p.fold = fold;
  const int grid = (p.n_lanes + kBlock - 1) / kBlock;
  megakernel_nee<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
