// Fused regenerating path tracer, `nee` estimator, axis-aligned rects with
// one parallelogram light, box filter, pinhole camera. Five kernels share
// one loop body (`render_lane`, a template on where the materials come from
// and on whether the scene has a sphere table, fed a LaneRange by the
// kernel's lane source):
//
// - megakernel_nee replaces the Pallas TPU kernel of
//   small_pathtracer_tpu/ops/megakernel.py: `build_kernel`, as
//   `_build_render` builds it for `render_pallas` / `render_pallas_span`
//   (baked scene, no material refs, NEE fold on). Materials sit in the
//   kernel parameters beside the geometry. Rects and DIFF only.
// - megakernel_nee_mat replaces `build_kernel(mat_refs=True)` as
//   small_pathtracer_tpu/ops/megakernel_grad.py: `_build_fwd_mat` builds it
//   for `render_pallas_mat`: the albedo and emission (K, 3) tables are
//   runtime inputs in device memory, copied into shared memory once per
//   block, so a training step changes them without a host copy. The NEE
//   fold is decided in the kernel from the light's row of the table.
//   Equal tables give a bit-identical image and trace counts.
// - megakernel_nee_tab replaces `build_kernel(mat_refs=True,
//   sphere_tab=True)` as `_build_render(use_tab=True)` builds it (the same
//   `pallas_call`, megakernel.py:2670): spheres scanned from a runtime
//   table after every rect, and the SPEC mirror and REFR glass branches.
//   The sphere rows [cx, cy, cz, r] are copied once per block into shared
//   memory (16 bytes a sphere, up to kMaxSpheres); in the scan every lane
//   of a warp reads the same row, one broadcast. The (K, 3) material tables
//   and the (K,) material codes stay in device memory: a lane reads its
//   winner's row once a bounce, after the scan. The shadow probe stops at
//   the first occluder. SPEC/REFR lanes skip the NEE probe (the TPU kernel
//   computes and discards it: every draw is keyed by its counter, so
//   skipping changes no bit), count no probe and are never folded. The
//   TPU kernel's cluster pruning and lane swizzle work around lockstep TPU
//   lanes and change no pixel; they are not carried over.
// - megakernel_nee_budgets and megakernel_nee_tab_budgets replace
//   `_build_render_budgets` (megakernel.py:2756, its `pallas_call` at
//   :2783) as `render_pallas_budgets` builds it for the adaptive waves of
//   utils/adaptive.py: rows 1 and 2 with per-pixel sample budgets. One lane
//   renders one pixel's span [s_start, s_stop), read from two int32
//   device arrays (lane_range_budgets); the TPU kernel's padded px, py and
//   pid_base planes are derived from the lane index instead. Empty spans
//   are born dead. In a late wave most lanes are dead and a warp with one
//   live lane still runs the whole path: compacting the live pixels is
//   left for a later change (ROADMAP queue 2, row 3).
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
// (no input planes; the budget kernels read the span) and keeps the whole path state in registers across the
// bounce loop; a lane whose path dies respawns at once with its next sample,
// so a warp stays busy until its slowest lane runs out of samples. Trace
// counts are 32-bit per thread, summed per warp, and added to two 64-bit
// totals with one atomic per warp. Left for later: sorting or compacting
// lanes against divergence, and a scene test cheaper than the linear scan
// (a BVH over the spheres, ROADMAP item 21).
//
// Numerics: see megakernel_common.cuh; the kernels match the eager plain
// version exactly on the card. The NEE fold: a successful probe from a
// diffuse hit proves the next extend ray hits the light, and when the
// light's max albedo is <= 0 that bounce's pickup, its extend count and the
// path's certain RR death are resolved one iteration early. Per-lane sums
// and counters stay exactly those of the unfolded loop.

#include "megakernel_common.cuh"

namespace {

constexpr int kDiff = 0, kSpec = 1;
// integrator/wavefront._refr_scatter: air 1, glass 1.5, Schlick's R0.
constexpr float kNntInto = 1.0f / 1.5f, kNntOut = 1.5f;
constexpr float kR0 = 0.04f, kOneMinusR0 = 0.96f;

// core/vecmath.reflect.
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return sub(d, mul(n, 2.0f * dot(n, d)));
}

// integrator/wavefront._refr_scatter, its expressions in its order: ng the
// geometric normal, n the one oriented against d.
__device__ __forceinline__ void refr_scatter(V3 d, V3 ng, V3 n, float u_coin,
                                             V3* dir, float* w) {
  const bool into = dot(ng, n) > 0.0f;
  const float nnt = into ? kNntInto : kNntOut;
  const float ddn = dot(d, n);
  const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
  const bool tir = cos2t < 0.0f;
  const float sq = cos2t > 0.0f ? sqrtf(cos2t) : 0.0f;
  const float sign = into ? 1.0f : -1.0f;
  const V3 tdir = norm(sub(mul(d, nnt), mul(ng, sign * (ddn * nnt + sq))));
  const float c = 1.0f - (into ? -ddn : dot(tdir, ng));
  const float re = kR0 + kOneMinusR0 * c * c * c * c * c;
  const float tr = 1.0f - re;
  const float pr = 0.25f + 0.5f * re;
  const bool pick_refl = u_coin < pr || tir;
  *w = tir ? 1.0f : (pick_refl ? re / pr : tr / (1.0f - pr));
  *dir = pick_refl ? reflect(d, ng) : tdir;
}

// One lane's samples [lr.s, lr.s_stop) of pixel lr.pix; lr comes from the
// kernel's lane source (lane_range or lane_range_budgets).
template <class Mats, bool kTab>
__device__ __forceinline__ void render_lane(const Params& p,
                                            const LaneRange& lr,
                                            const Mats& mats,
                                            const SphereTab& tab, bool fold,
                                            float* __restrict__ out_l,
                                            unsigned long long* __restrict__ traces) {
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
    float t_hit;
    if constexpr (kTab) {
      t_hit = nearest_tab(p, tab, o, d, &id);
    } else {
      t_hit = nearest(p, o, d, &id);
    }
    const bool hit = t_hit < kMissT;
    // The winner's rect axis, -1 for a sphere. Rows 1 and 8 read it here,
    // as before the sphere table existed, so their code is unchanged.
    const int axis = (kTab && id >= p.n_rects) ? -1 : p.rects[id].axis;
    const V3 alb = mats.albedo(id);
    const V3 emi = mats.emission(id);
    // Emission pickup: throughput * emission.
    L = add(L, v3(T.x * emi.x, T.y * emi.y, T.z * emi.z));
    const V3 x = hit ? add(o, mul(d, t_hit)) : v3(0.0f, 0.0f, 0.0f);
    V3 ng = v3(axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
               axis == 2 ? 1.0f : 0.0f);
    int refl = kDiff;
    if constexpr (kTab) {
      refl = tab.refl[id];
      if (axis < 0) {
        const float4 c = tab.sph[id - p.n_rects];
        ng = norm(sub(x, v3(c.x, c.y, c.z)));
      }
    }
    const V3 n = dot(ng, d) < 0.0f ? ng : neg(ng);
    const bool diffuse = refl == kDiff;

    const uint32_t ctr = static_cast<uint32_t>(depth) * kDrawsPerBounce;
    const float u_rr = uniform(p.seed, pid, ctr + kRR);

    // Russian roulette.
    const float p_max = fmaxf(alb.x, fmaxf(alb.y, alb.z));
    const bool rr_active = depth > p.rr_start_depth || p_max <= 0.0f;
    const bool survive = rr_active ? u_rr < p_max : true;
    const float inv_p =
        (rr_active && p_max > 0.0f) ? 1.0f / (p_max > 0.0f ? p_max : 1.0f) : 1.0f;
    const V3 f = mul(alb, inv_p);

    V3 new_dir;
    float w;
    bool success = false;
    if (diffuse) {
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

      // NEE as continuation: probe a uniform point of the light
      // parallelogram.
      const float lu = uniform(p.seed, pid, ctr + kLightU);
      const float lv = uniform(p.seed, pid, ctr + kLightV);
      const V3 lp = add(add(lc, mul(leu, lu)), mul(lev, lv));
      const V3 d_l = norm(sub(lp, x));
      float t_l;
      if constexpr (kTab) {
        success = probe_light_tab(p, tab, x, d_l, &t_l);
      } else {
        success = probe_light(p, x, d_l, &t_l);
      }
      const float t_safe = success ? t_l : 1.0f;
      const float w_nee = (fabsf(p.area * dot(d_l, ln)) / (t_safe * t_safe)) *
                          (fabsf(dot(d_l, n)) * kInvPi);
      new_dir = success ? d_l : cos_dir;
      w = success ? w_nee : 1.0f;
    } else if (refl == kSpec) {
      new_dir = reflect(d, ng);
      w = 1.0f;
    } else {
      refr_scatter(d, ng, n, uniform(p.seed, pid, ctr + kRefrCoin), &new_dir,
                   &w);
    }
    const V3 T_new = mul(v3(T.x * f.x, T.y * f.y, T.z * f.z), w);

    bool alive_next = survive;
    n_extend += 1;
    n_probe += (alive_next && diffuse) ? 1u : 0u;
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
  render_lane<BakedMaterials, false>(p, lane_range(p), BakedMaterials{p},
                                     SphereTab{}, p.fold != 0, out_l, traces);
}

// Row 3 on rect-only DIFF scenes: row 1 with one lane a pixel and its
// span read from s_start / s_stop.
__global__ void __launch_bounds__(kBlock)
    megakernel_nee_budgets(const __grid_constant__ Params p,
                           const int* __restrict__ s_start,
                           const int* __restrict__ s_stop,
                           float* __restrict__ out_l,
                           unsigned long long* __restrict__ traces) {
  render_lane<BakedMaterials, false>(
      p, lane_range_budgets(p, s_start, s_stop), BakedMaterials{p},
      SphereTab{}, p.fold != 0, out_l, traces);
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
  render_lane<TableMaterials, false>(p, lane_range(p), mats, SphereTab{},
                                     fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f,
                                     out_l, traces);
}

// Dynamic shared memory: n_sph rows of float4.
__global__ void __launch_bounds__(kBlock)
    megakernel_nee_tab(const __grid_constant__ Params p,
                       const float4* __restrict__ sph, int n_sph,
                       const float* __restrict__ alb,
                       const float* __restrict__ emi,
                       const int* __restrict__ refl,
                       float* __restrict__ out_l,
                       unsigned long long* __restrict__ traces) {
  extern __shared__ float4 s_sph[];
  for (int i = threadIdx.x; i < n_sph; i += kBlock) s_sph[i] = sph[i];
  __syncthreads();
  const TableMaterials mats{alb, emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, true>(p, lane_range(p), mats,
                                    SphereTab{s_sph, n_sph, refl},
                                    fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f,
                                    out_l, traces);
}

// Row 3 on scenes with spheres or SPEC/REFR objects: row 2 with one lane a
// pixel and its span read from s_start / s_stop.
__global__ void __launch_bounds__(kBlock)
    megakernel_nee_tab_budgets(const __grid_constant__ Params p,
                               const float4* __restrict__ sph, int n_sph,
                               const float* __restrict__ alb,
                               const float* __restrict__ emi,
                               const int* __restrict__ refl,
                               const int* __restrict__ s_start,
                               const int* __restrict__ s_stop,
                               float* __restrict__ out_l,
                               unsigned long long* __restrict__ traces) {
  extern __shared__ float4 s_sph[];
  for (int i = threadIdx.x; i < n_sph; i += kBlock) s_sph[i] = sph[i];
  __syncthreads();
  const TableMaterials mats{alb, emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, true>(p, lane_range_budgets(p, s_start, s_stop),
                                    mats, SphereTab{s_sph, n_sph, refl},
                                    fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f,
                                    out_l, traces);
}

}  // namespace

// Host entry points with a plain C interface (loaded with ctypes). rect_geom,
// rect_axis, light_f and cam_f as fill_params (megakernel_common.cuh) reads
// them, in host memory. out_l: (n_pix * g, 3) float32 and traces: 2 uint64,
// zeroed, on the device. Each launches on `stream` and returns the launch's
// cudaError_t.

namespace {

// Copies the (n_rects, 3) host materials into the kernel parameters.
void bake_materials(Params* p, const float* rect_alb, const float* rect_emi,
                    int n_rects, int fold) {
  for (int i = 0; i < n_rects; ++i) {
    for (int c = 0; c < 3; ++c) {
      p->rects[i].alb[c] = rect_alb[3 * i + c];
      p->rects[i].emi[c] = rect_emi[3 * i + c];
    }
  }
  p->fold = fold;
}

// Dynamic shared memory of n_spheres rows for a sphere-table kernel: raises
// the kernel's limit above 48 KB. Returns the bytes, or -1 (and the error
// in *err) when the attribute cannot be set.
template <class Kernel>
int sphere_smem(Kernel kernel, int n_spheres, cudaError_t* err) {
  const int smem = n_spheres * static_cast<int>(sizeof(float4));
  *err = cudaSuccess;
  if (smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return -1;
  }
  return smem;
}

}  // namespace

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
  bake_materials(&p, rect_alb, rect_emi, n_rects, fold);
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

// Row 2, the sphere table: sph is (n_spheres, 4) float32 [cx, cy, cz, r]
// and alb, emi (n_rects + n_spheres, 3) float32 and refl
// (n_rects + n_spheres,) int32 (DIFF 0, SPEC 1, REFR 2) are tables in
// device memory, rects first. More than kMaxSpheres spheres are refused
// (cudaErrorInvalidValue); above 48 KB of rows the kernel's dynamic shared
// memory limit is raised first.
extern "C" int spt_megakernel_nee_tab(const float* rect_geom,
                                      const int* rect_axis, int n_rects,
                                      const float* light_f, int light_id,
                                      const float* cam_f, unsigned seed,
                                      int width, int height, int spp, int g,
                                      int per, unsigned s0,
                                      int rr_start_depth, int max_bounces,
                                      const float* sph, int n_spheres,
                                      const float* alb, const float* emi,
                                      const int* refl, float* out_l,
                                      unsigned long long* traces,
                                      void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0,
                   rr_start_depth, max_bounces) ||
      n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const int smem = sphere_smem(megakernel_nee_tab, n_spheres, &err);
  if (smem < 0) return static_cast<int>(err);
  megakernel_nee_tab<<<grid_of(p), kBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres, alb, emi, refl,
      out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 3, per-pixel budgets: one lane a pixel (n_lanes = width * height),
// rendering samples [s_start[i], s_stop[i]) of pixel i, from two
// (width * height,) int32 device arrays; out_l is (width * height, 3).
// Baked materials and the NEE fold as row 1.
extern "C" int spt_megakernel_nee_budgets(
    const float* rect_geom, const int* rect_axis, const float* rect_alb,
    const float* rect_emi, int n_rects, const float* light_f, int light_id,
    const float* cam_f, unsigned seed, int width, int height, int spp,
    int rr_start_depth, int max_bounces, int fold, const int* s_start,
    const int* s_stop, float* out_l, unsigned long long* traces,
    void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, 1, 0, 0u, rr_start_depth,
                   max_bounces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bake_materials(&p, rect_alb, rect_emi, n_rects, fold);
  megakernel_nee_budgets<<<grid_of(p), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, s_start, s_stop, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}

// Row 3 with the sphere table: the tables as row 2, the lanes as
// spt_megakernel_nee_budgets.
extern "C" int spt_megakernel_nee_tab_budgets(
    const float* rect_geom, const int* rect_axis, int n_rects,
    const float* light_f, int light_id, const float* cam_f, unsigned seed,
    int width, int height, int spp, int rr_start_depth, int max_bounces,
    const float* sph, int n_spheres, const float* alb, const float* emi,
    const int* refl, const int* s_start, const int* s_stop, float* out_l,
    unsigned long long* traces, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, 1, 0, 0u, rr_start_depth,
                   max_bounces) ||
      n_spheres < 0 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const int smem = sphere_smem(megakernel_nee_tab_budgets, n_spheres, &err);
  if (smem < 0) return static_cast<int>(err);
  megakernel_nee_tab_budgets<<<grid_of(p), kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      p, reinterpret_cast<const float4*>(sph), n_spheres, alb, emi, refl,
      s_start, s_stop, out_l, traces);
  return static_cast<int>(cudaGetLastError());
}
