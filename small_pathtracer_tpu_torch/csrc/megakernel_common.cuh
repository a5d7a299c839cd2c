// Device functions shared by the forward megakernels (megakernel.cu) and
// the material adjoint (megakernel_grad.cu): the scene parameters, the
// murmur3 counter RNG, the polynomial sincos, the rect and sphere tests, the
// nearest-hit scans, the shadow probes and the primary-ray spawn. The
// adjoint uses the rect-only scans (nearest, probe_light).
//
// Numerics: the library is compiled with --fmad=false and IEEE division and
// sqrt, with rsqrt written as 1/sqrtf, so each operation rounds as the eager
// torch ops of integrator/wavefront.py do (the plain version).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRects = 32;
constexpr int kMaxSpheres = 4096;  // 64 KB of shared memory a block
constexpr int kBlock = 128;
constexpr float kMissT = 1e20f;
constexpr float kSelfHitEps = 1e-3f;
constexpr float kSphereEps = 1e-4f, kSphereEpsRel = 4e-6f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr uint32_t kDrawsPerBounce = 8;
constexpr uint32_t kRR = 0, kLightU = 1, kLightV = 2, kScatterU = 3,
                   kScatterV = 4, kRefrCoin = 6;

struct Rect {
  int axis;
  float k, lo0, lo1, hi0, hi1;
  float alb[3];  // baked materials (row 1); unused by the table kernels
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

// Where a lane reads its materials: the kernel parameters (baked scene,
// row 1) or (K, 3) tables, which rows 8 and 9 copy into shared memory and
// the sphere-table kernel (row 2) reads from device memory.
struct BakedMaterials {
  const Params& p;
  __device__ __forceinline__ V3 albedo(int id) const { return ld3(p.rects[id].alb); }
  __device__ __forceinline__ V3 emission(int id) const { return ld3(p.rects[id].emi); }
};

struct TableMaterials {
  const float* alb;
  const float* emi;
  __device__ __forceinline__ V3 albedo(int id) const { return ld3(alb + 3 * id); }
  __device__ __forceinline__ V3 emission(int id) const { return ld3(emi + 3 * id); }
};

// Copies the (K, 3) device tables into the block's shared arrays. Every
// thread of the block must call it (it ends in a barrier).
__device__ __forceinline__ void load_tables(const Params& p,
                                            const float* __restrict__ alb,
                                            const float* __restrict__ emi,
                                            float* s_alb, float* s_emi) {
  for (int i = threadIdx.x; i < 3 * p.n_rects; i += blockDim.x) {
    s_alb[i] = alb[i];
    s_emi[i] = emi[i];
  }
  __syncthreads();
}

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

// Hit distance of sphere s = [cx, cy, cz, r], or kMissT
// (geometry/intersect.intersect_spheres: the recentered quadratic, the near
// root when it clears eps, else the far one).
__device__ __forceinline__ float sphere_t(float4 s, V3 o, V3 d) {
  const float opx = s.x - o.x, opy = s.y - o.y, opz = s.z - o.z;
  const float b = opx * d.x + opy * d.y + opz * d.z;
  const float mx = b * d.x - opx, my = b * d.y - opy, mz = b * d.z - opz;
  const float m2 = mx * mx + my * my + mz * mz;
  const float mlen = m2 > 0.0f ? sqrtf(m2) : 0.0f;
  const float det = (s.w - mlen) * (s.w + mlen);
  if (!(det > 0.0f)) return kMissT;
  const float sdet = sqrtf(det);
  const float t_near = b - sdet;
  const float eps = fmaxf(kSphereEps, kSphereEpsRel * s.w);
  const float t = t_near > eps ? t_near : b + sdet;
  return t > eps ? t : kMissT;
}

// The sphere table of megakernel_nee_tab: geometry rows in shared memory
// and the material code of every object (rects, then spheres) in device
// memory.
struct SphereTab {
  const float4* sph;  // (n,) [cx, cy, cz, r]
  int n;
  const int* refl;  // (n_rects + n,)
};

// Nearest hit over the rects, then the spheres (global id n_rects + i),
// one strict < scan.
__device__ __forceinline__ float nearest_tab(const Params& p,
                                             const SphereTab& tab, V3 o,
                                             V3 d, int* id) {
  float t_best = nearest(p, o, d, id);
  for (int i = 0; i < tab.n; ++i) {
    const float t = sphere_t(tab.sph[i], o, d);
    if (t < t_best) {
      t_best = t;
      *id = p.n_rects + i;
    }
  }
  return t_best;
}

// probe_light with the spheres: they come after the light in the scan, so
// one blocks it iff its t < t_light. Stops at the first occluder.
__device__ __forceinline__ bool probe_light_tab(const Params& p,
                                                const SphereTab& tab, V3 o,
                                                V3 d, float* t_light) {
  if (!probe_light(p, o, d, t_light)) return false;
  for (int i = 0; i < tab.n; ++i) {
    if (sphere_t(tab.sph[i], o, d) < *t_light) return false;
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

// The lane's pixel and sample range [s, s_stop) on the wrapper's layout:
// lane i renders pixel i / g, samples s0 + (i % g) * per + [0, per).
struct LaneRange {
  bool in_range;
  int pix;
  float px, py;
  uint32_t pid_base, s, s_stop;
};

__device__ __forceinline__ LaneRange lane_range(const Params& p) {
  LaneRange r;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  r.in_range = lane < p.n_lanes;
  const int safe_lane = r.in_range ? lane : 0;
  r.pix = safe_lane / p.g;
  const uint32_t grp = static_cast<uint32_t>(safe_lane % p.g);
  r.px = static_cast<float>(r.pix % p.width);
  r.py = static_cast<float>(r.pix / p.width);
  r.pid_base = static_cast<uint32_t>(r.pix) * static_cast<uint32_t>(p.spp);
  r.s = p.s0 + grp * static_cast<uint32_t>(p.per);
  r.s_stop = r.s + static_cast<uint32_t>(p.per);
  return r;
}

// Per-pixel budgets (the adaptive waves): lane i renders pixel i, samples
// [s_start[i], s_stop[i]) read from two (n_pix,) int32 device arrays. The
// wrapper launches n_lanes = n_pix (g = 1); a lane with an empty span is
// born dead and counts nothing.
__device__ __forceinline__ LaneRange lane_range_budgets(
    const Params& p, const int* __restrict__ s_start,
    const int* __restrict__ s_stop) {
  LaneRange r;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  r.in_range = lane < p.n_lanes;
  r.pix = r.in_range ? lane : 0;
  r.px = static_cast<float>(r.pix % p.width);
  r.py = static_cast<float>(r.pix / p.width);
  r.pid_base = static_cast<uint32_t>(r.pix) * static_cast<uint32_t>(p.spp);
  r.s = r.in_range ? static_cast<uint32_t>(s_start[r.pix]) : 0u;
  r.s_stop = r.in_range ? static_cast<uint32_t>(s_stop[r.pix]) : 0u;
  return r;
}

// Host: fills the geometry, light, camera and launch settings of p from
// rect_geom (n_rects rows of [k, lo0, lo1, hi0, hi1]), rect_axis,
// light_f ([corner 3, edge_u 3, edge_v 3, unit normal 3, area]) and cam_f
// ([origin 3, lower_left 3, horizontal 3, vertical 3]), all host memory.
// Materials stay zero. Returns false on an argument the kernels do not take.
inline bool fill_params(Params* p, const float* rect_geom,
                        const int* rect_axis, int n_rects,
                        const float* light_f, int light_id,
                        const float* cam_f, unsigned seed, int width,
                        int height, int spp, int g, int per, unsigned s0,
                        int rr_start_depth, int max_bounces) {
  if (n_rects < 1 || n_rects > kMaxRects || light_id < 0 ||
      light_id >= n_rects || width < 1 || height < 1 || g < 1 || per < 0) {
    return false;
  }
  *p = Params{};
  for (int i = 0; i < n_rects; ++i) {
    const float* row = rect_geom + 5 * i;
    Rect& r = p->rects[i];
    r.axis = rect_axis[i];
    if (r.axis < 0 || r.axis > 2) return false;
    r.k = row[0];
    r.lo0 = row[1];
    r.lo1 = row[2];
    r.hi0 = row[3];
    r.hi1 = row[4];
  }
  p->n_rects = n_rects;
  p->light_id = light_id;
  for (int c = 0; c < 3; ++c) {
    p->lc[c] = light_f[c];
    p->leu[c] = light_f[3 + c];
    p->lev[c] = light_f[6 + c];
    p->ln[c] = light_f[9 + c];
    p->cam_o[c] = cam_f[c];
    p->cam_ll[c] = cam_f[3 + c];
    p->cam_h[c] = cam_f[6 + c];
    p->cam_v[c] = cam_f[9 + c];
  }
  p->area = light_f[12];
  p->seed = seed;
  p->width = width;
  p->height = height;
  p->spp = spp;
  p->g = g;
  p->per = per;
  p->s0 = s0;
  p->n_lanes = width * height * g;
  p->rr_start_depth = rr_start_depth;
  p->max_bounces = max_bounces;
  return true;
}

inline int grid_of(const Params& p) { return (p.n_lanes + kBlock - 1) / kBlock; }

}  // namespace
