// Device functions shared by the forward megakernels (megakernel.cu) and
// the adjoints (megakernel_vjp.cuh, megakernel_geom.cu): the scene
// parameters, the murmur3 counter RNG, the polynomial sincos, the rect and
// sphere tests, the rect scans (nearest, probe_light), the primary-ray
// spawn, the lanes' pixel and sample ranges, and the adjoints' fixed-order
// `reduce_partials`. The sphere table's scans are in megakernel_bvh.cuh.
//
// The rect scans run over the rects grouped by axis (`AxisRect`, laid out
// by fill_params): one loop a group, each an
// instance of a template on the axis, so a rect test reads five floats
// and does the TPU kernel's unrolled arithmetic (`_trace_unrolled`,
// `_probe_unrolled`) instead of picking the ray's components by a runtime
// axis. Each test keeps rect_t's expressions in rect_t's order, so every
// t and hit point rounds as before; the winner is the smallest (t, id),
// which is the in-order strict-< scan's (geometry/intersect.py).
//
// Numerics: the library is compiled with --fmad=false and IEEE division and
// sqrt, with rsqrt written as 1/sqrtf, so each operation rounds as the eager
// torch ops of integrator/wavefront.py do (the plain version).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRects = 32;
constexpr int kMaxSpheres = 4096;  // the sphere table's rows at most
constexpr int kBlock = 128;
constexpr float kMissT = 1e20f;
constexpr float kSelfHitEps = 1e-3f;
constexpr float kSphereEps = 1e-4f, kSphereEpsRel = 4e-6f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr uint32_t kDrawsPerBounce = 8;
constexpr uint32_t kRR = 0, kLightU = 1, kLightV = 2, kScatterU = 3,
                   kScatterV = 4, kMixCoin = 5, kRefrCoin = 6;

// A rect by object id: its axis and plane (the normal, the light's
// distance), its baked materials (row 1; unused by the table kernels).
struct Rect {
  int axis;
  float k;
  float alb[3];
  float emi[3];
};

// A rect in the scan order: its plane and bounds on its group's axis, and
// its object id.
struct AxisRect {
  float k, lo0, lo1, hi0, hi1;
  int id;
};

// The scan rows [begin, end) of one axis's rects, in id order; the rows
// from split on have ids >= the light's (the light's own row is split).
struct AxisGroup {
  int begin, split, end;
};

struct Params {
  Rect rects[kMaxRects];  // by object id
  AxisRect scan[kMaxRects];  // grouped by axis
  AxisGroup groups[3];
  int n_rects;
  int light_id;
  int light_axis;  // the light's group; its row is groups[light_axis].split
  float lc[3], leu[3], lev[3];  // light corner and edges
  float ln[3];                  // light unit normal
  float area;                   // light area
  float cam_o[3], cam_ll[3], cam_h[3], cam_v[3];
  uint32_t seed;
  int width, height, spp;
  int g, per;
  uint32_t s0;
  int pix0;     // the shard's first pixel (0 unsharded)
  int n_lanes;  // n_pix_loc * g: the shard's pixels times the lane groups
  int rr_start_depth, max_bounces, fold;
  // The estimators of rows 1-5 (megakernel_lane.cuh): the mixture's NEE
  // probability (the entry points set it), and the light's unit edge
  // directions, along which glibc's wrapped offsets move (fill_params).
  float mixture_q;
  float leu_hat[3], lev_hat[3];
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
// row 1) or (K, 3) tables, which rows 8 and 9 copy into shared memory on
// rect-only scenes and the sphere-table kernels (row 2, and rows 8 and 9 on
// sphere scenes) read from device memory.
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

template <int A>
__device__ __forceinline__ float axis_comp(V3 v) {
  if constexpr (A == 0) {
    return v.x;
  } else if constexpr (A == 1) {
    return v.y;
  } else {
    return v.z;
  }
}

// The ray's components that a test of a rect on axis A reads: o and 1/d
// on A, o and d on the two others (b < c), and whether d is off A's plane.
struct AxisRay {
  float oa, ia, ob, db, oc, dc;
  bool ok;
};

template <int A>
__device__ __forceinline__ AxisRay axis_ray(V3 o, V3 d, const RayPrep& rp) {
  constexpr int B = A == 0 ? 1 : 0;
  constexpr int C = A == 2 ? 1 : 2;
  const bool ok = A == 0 ? rp.ok_x : (A == 1 ? rp.ok_y : rp.ok_z);
  return AxisRay{axis_comp<A>(o), axis_comp<A>(rp.inv), axis_comp<B>(o),
                 axis_comp<B>(d), axis_comp<C>(o), axis_comp<C>(d), ok};
}

// geometry/intersect.intersect_rects for one rect of the ray's axis: its
// distance *t, and whether the ray hits it (d off the plane is the
// caller's test).
__device__ __forceinline__ bool axis_hit(const AxisRect& r, const AxisRay& a,
                                         float* t_out) {
  const float t = (r.k - a.oa) * a.ia;
  const float p0 = a.ob + t * a.db;
  const float p1 = a.oc + t * a.dc;
  *t_out = t;
  return (p0 >= r.lo0) & (p0 <= r.hi0) & (p1 >= r.lo1) & (p1 <= r.hi1) &
         (t > kSelfHitEps);
}

// The nearest hit among group A's rects, merged into (*t_best, *best) as
// the smaller (t, id).
template <int A>
__device__ __forceinline__ void nearest_axis(const Params& p, V3 o, V3 d,
                                             const RayPrep& rp, float* t_best,
                                             int* best) {
  const AxisRay ray = axis_ray<A>(o, d, rp);
  if (!ray.ok) return;
  float t_g = kMissT;
  int i_g = -1;
  for (int i = p.groups[A].begin; i < p.groups[A].end; ++i) {
    float t;
    if (axis_hit(p.scan[i], ray, &t) & (t < t_g)) {
      t_g = t;
      i_g = i;
    }
  }
  if (i_g >= 0) {
    const int id = p.scan[i_g].id;
    if (t_g < *t_best || (t_g == *t_best && id < *best)) {
      *t_best = t_g;
      *best = id;
    }
  }
}

// Nearest hit: the in-order strict < scan's winner; a miss keeps id 0.
__device__ __forceinline__ float nearest(const Params& p, V3 o, V3 d,
                                         const RayPrep& rp, int* id) {
  float t_best = kMissT;
  int best = 0;
  nearest_axis<0>(p, o, d, rp, &t_best, &best);
  nearest_axis<1>(p, o, d, rp, &t_best, &best);
  nearest_axis<2>(p, o, d, rp, &t_best, &best);
  *id = best;
  return t_best;
}

__device__ __forceinline__ float nearest(const Params& p, V3 o, V3 d,
                                         int* id) {
  return nearest(p, o, d, prep(d), id);
}

// Whether a row of [begin, end) is hit nearer than thr.
__device__ __forceinline__ bool any_below(const Params& p, int begin, int end,
                                          const AxisRay& ray, float thr) {
  for (int i = begin; i < end; ++i) {
    float t;
    if (axis_hit(p.scan[i], ray, &t) & (t < thr)) return true;
  }
  return false;
}

// Whether a rect of group A blocks the light at t_l: one with a smaller id
// at t <= t_l (t < t_up, the next float above t_l), one with a larger id
// at t < t_l. The light's own row (t == t_l) does not.
template <int A>
__device__ __forceinline__ bool blocked_axis(const Params& p, V3 o, V3 d,
                                             const RayPrep& rp, float t_l,
                                             float t_up) {
  const AxisRay ray = axis_ray<A>(o, d, rp);
  if (!ray.ok) return false;
  const AxisGroup g = p.groups[A];
  return any_below(p, g.begin, g.split, ray, t_up) ||
         any_below(p, g.split, g.end, ray, t_l);
}

template <int A>
__device__ __forceinline__ float light_t(const Params& p, V3 o, V3 d,
                                         const RayPrep& rp) {
  const AxisRay ray = axis_ray<A>(o, d, rp);
  float t;
  const bool hit = axis_hit(p.scan[p.groups[A].split], ray, &t);
  return hit && ray.ok ? t : kMissT;
}

// Shadow probe toward the light: true iff the nearest hit is the light,
// i.e. the light is hit and no other rect has a smaller (t, id). Stops at
// the first occluder.
__device__ __forceinline__ bool probe_light(const Params& p, V3 o, V3 d,
                                            const RayPrep& rp,
                                            float* t_light) {
  const float t_l = p.light_axis == 0   ? light_t<0>(p, o, d, rp)
                    : p.light_axis == 1 ? light_t<1>(p, o, d, rp)
                                        : light_t<2>(p, o, d, rp);
  *t_light = t_l;
  if (!(t_l < kMissT)) return false;
  const float t_up = __int_as_float(__float_as_int(t_l) + 1);
  return !blocked_axis<0>(p, o, d, rp, t_l, t_up) &&
         !blocked_axis<1>(p, o, d, rp, t_l, t_up) &&
         !blocked_axis<2>(p, o, d, rp, t_l, t_up);
}

__device__ __forceinline__ bool probe_light(const Params& p, V3 o, V3 d,
                                            float* t_light) {
  return probe_light(p, o, d, prep(d), t_light);
}

// Hit distance of sphere s = [cx, cy, cz, r], or kMissT
// (geometry/intersect.intersect_spheres: the recentered quadratic, the near
// root when it clears eps, else the far one), in two parts: `sphere_pre`
// (b = op·d and m2 = |b d − op|², no square root), which the scans'
// rejects read, and `sphere_root`.
struct SpherePre {
  float b, m2;
};

__device__ __forceinline__ SpherePre sphere_pre(float4 s, V3 o, V3 d) {
  const float opx = s.x - o.x, opy = s.y - o.y, opz = s.z - o.z;
  const float b = opx * d.x + opy * d.y + opz * d.z;
  const float mx = b * d.x - opx, my = b * d.y - opy, mz = b * d.z - opz;
  return SpherePre{b, mx * mx + my * my + mz * mz};
}

__device__ __forceinline__ float sphere_root(float4 s, SpherePre q) {
  const float mlen = q.m2 > 0.0f ? sqrtf(q.m2) : 0.0f;
  const float det = (s.w - mlen) * (s.w + mlen);
  if (!(det > 0.0f)) return kMissT;
  const float sdet = sqrtf(det);
  const float t_near = q.b - sdet;
  const float eps = fmaxf(kSphereEps, kSphereEpsRel * s.w);
  const float t = t_near > eps ? t_near : q.b + sdet;
  return t > eps ? t : kMissT;
}

__device__ __forceinline__ float sphere_t(float4 s, V3 o, V3 d) {
  return sphere_root(s, sphere_pre(s, o, d));
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
// lane i renders the shard's pixel row i / g, samples s0 + (i % g) * per +
// [0, per). `pix` is that row, which indexes the shard's per-pixel arrays
// (cotangents, pixel lobes); px, py and the path ids use the global pixel
// pix0 + pix, so a sample's radiance does not depend on the shard.
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
  const int gpix = p.pix0 + r.pix;
  const uint32_t grp = static_cast<uint32_t>(safe_lane % p.g);
  r.px = static_cast<float>(gpix % p.width);
  r.py = static_cast<float>(gpix / p.width);
  r.pid_base = static_cast<uint32_t>(gpix) * static_cast<uint32_t>(p.spp);
  r.s = p.s0 + grp * static_cast<uint32_t>(p.per);
  r.s_stop = r.s + static_cast<uint32_t>(p.per);
  return r;
}

// Per-pixel budgets (the adaptive waves): lane i renders pixel live[i],
// samples [s_start[pix], s_stop[pix]) of the two (n_pix,) int32 device
// arrays; render_lane (kPixRow) writes that pixel's row of out_l. The wrapper lists the
// pixels with a non-empty span in `live` and launches n_lanes = its length
// (g = 1), so no lane is born dead; the other rows of out_l stay as the
// wrapper zeroed them.
__device__ __forceinline__ LaneRange lane_range_budgets(
    const Params& p, const int* __restrict__ live,
    const int* __restrict__ s_start, const int* __restrict__ s_stop) {
  LaneRange r;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  r.in_range = lane < p.n_lanes;
  r.pix = r.in_range ? live[lane] : 0;
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
// The lanes cover the shard's pixels [pix0, pix0 + n_pix_loc) (unsharded:
// 0 and width * height), g lanes a pixel. Materials stay zero. Returns
// false on an argument the kernels do not take.
inline bool fill_params(Params* p, const float* rect_geom,
                        const int* rect_axis, int n_rects,
                        const float* light_f, int light_id,
                        const float* cam_f, unsigned seed, int width,
                        int height, int spp, int g, int per, unsigned s0,
                        int pix0, int n_pix_loc, int rr_start_depth,
                        int max_bounces) {
  if (n_rects < 1 || n_rects > kMaxRects || light_id < 0 ||
      light_id >= n_rects || width < 1 || height < 1 || g < 1 || per < 0 ||
      pix0 < 0 || n_pix_loc < 1 ||
      static_cast<long long>(pix0) + n_pix_loc >
          static_cast<long long>(width) * height) {
    return false;
  }
  *p = Params{};
  for (int i = 0; i < n_rects; ++i) {
    const float* row = rect_geom + 5 * i;
    Rect& r = p->rects[i];
    r.axis = rect_axis[i];
    if (r.axis < 0 || r.axis > 2) return false;
    r.k = row[0];
  }
  p->n_rects = n_rects;
  p->light_id = light_id;
  p->light_axis = p->rects[light_id].axis;
  // The scan order: the ids grouped by axis, each group in id order and
  // split at its first id >= the light's (the light's own row in its
  // group).
  int n = 0;
  for (int a = 0; a < 3; ++a) {
    AxisGroup& g = p->groups[a];
    g.begin = n;
    g.split = -1;
    for (int id = 0; id < n_rects; ++id) {
      if (p->rects[id].axis != a) continue;
      if (g.split < 0 && id >= light_id) g.split = n;
      const float* row = rect_geom + 5 * id;
      p->scan[n++] = AxisRect{row[0], row[1], row[2], row[3], row[4], id};
    }
    g.end = n;
    if (g.split < 0) g.split = n;
  }
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
  // integrator/sampling.glibc_edge_dirs: each edge over its magnitude.
  const float mu = sqrtf(p->leu[0] * p->leu[0] + p->leu[1] * p->leu[1] +
                         p->leu[2] * p->leu[2]);
  const float mv = sqrtf(p->lev[0] * p->lev[0] + p->lev[1] * p->lev[1] +
                         p->lev[2] * p->lev[2]);
  for (int c = 0; c < 3; ++c) {
    p->leu_hat[c] = p->leu[c] / mu;
    p->lev_hat[c] = p->lev[c] / mv;
  }
  p->seed = seed;
  p->width = width;
  p->height = height;
  p->spp = spp;
  p->g = g;
  p->per = per;
  p->s0 = s0;
  p->pix0 = pix0;
  p->n_lanes = n_pix_loc * g;
  p->rr_start_depth = rr_start_depth;
  p->max_bounces = max_bounces;
  return true;
}

inline int grid_of(const Params& p) { return (p.n_lanes + kBlock - 1) / kBlock; }

constexpr int kReduceThreads = 256;

// out[slot] = sum over blocks b of partials[b, slot], in a fixed order: a
// strided sum per thread, then a tree in shared memory. One block a slot.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const float* __restrict__ partials, int n_blocks,
                    int n_slots, float* __restrict__ out) {
  __shared__ float buf[kReduceThreads];
  const int sl = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads) {
    v += partials[b * n_slots + sl];
  }
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[sl] = buf[0];
}

}  // namespace
