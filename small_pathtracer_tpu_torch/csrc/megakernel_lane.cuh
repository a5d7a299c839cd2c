// The loop body of the forward kernels (megakernel.cu, megakernel_guided.cu):
// `render_lane`, one lane's samples, a template on where the materials
// come from, whether the scene has a sphere table, the estimator and the
// guide source; `bounce`, its one bounce, which the geometry adjoint
// (megakernel_geom.cu) traces too, so both compute every bounce with the
// same expressions (the adjoint's sweep takes the bounce's two queries
// from its tape instead of tracing them again); `tab_body`, row 2's kernel
// body (and its counting instance), and `mat_body`, row 8's on rect
// scenes; `mis_pickup`, the weight of a BSDF-sampled pickup of the light
// under mis; the SPEC/REFR scatter; the GLOS lobe; path guiding's device
// functions (the voxel
// lookup, the octahedral decode, the real power, the defensive mixture);
// and the host helpers the entry points share.
//
// Numerics: see megakernel_common.cuh. Every expression below is the one
// integrator/wavefront.py (the plain version) computes, in its order.

#pragma once

#include "megakernel_bvh.cuh"

namespace {

constexpr int kDiff = 0, kSpec = 1, kGlos = 3;
constexpr float kInv2Pi = 0.159154943091895335768883763372514362f;
// integrator/wavefront._refr_scatter: air 1, glass 1.5, Schlick's R0.
constexpr float kNntInto = 1.0f / 1.5f, kNntOut = 1.5f;
constexpr float kR0 = 0.04f, kOneMinusR0 = 0.96f;

// Estimators (ops/megakernel.py EST_CODE): NEE as continuation, the cosine
// continuation alone, textbook NEE (a shadow probe's direct term, the
// cosine continuation, the next pickup of the light suppressed), the
// uniform hemisphere sample with the reference's weight 1 or with
// 2 max(cos, 0), NEE as continuation where a coin falls below mixture_q,
// and mis (textbook NEE's two strategies under the balance heuristic).
// kGlibc added to kNee or kMixture draws the light point from glibc's
// wrapped offsets (the reference's Linux build, C13a); the others take no
// light sample or ignore the mode. Every estimator is a template argument,
// so each instance compiles only its own branches.
constexpr int kNee = 0, kCosine = 1, kTextbook = 2, kUniform = 3,
              kUniformCorrected = 4, kMixture = 5, kMis = 6;
constexpr int kGlibc = 8;
// Scene flags an estimator code of the _ext kernels (megakernel_ext*.cu)
// carries beside it: kWithQuads, the quads scanned after the rects (with
// the sphere table's kernels only), and kWithGlos, the GLOS lobe (cosine,
// nee_textbook and mis only). Without them every branch of theirs
// compiles away, so the other instances are as before.
constexpr int kWithQuads = 16, kWithGlos = 32;

__host__ __device__ constexpr int est_base(int est) { return est & 7; }
__host__ __device__ constexpr bool with_quads(int est) {
  return (est & kWithQuads) != 0;
}
__host__ __device__ constexpr bool with_glos(int est) {
  return (est & kWithGlos) != 0;
}

// NEE as continuation (nee, mixture): a successful probe becomes the
// bounce, and the NEE fold applies.
__host__ __device__ constexpr bool nee_cont(int est) {
  return est_base(est) == kNee || est_base(est) == kMixture;
}

// A direct term at each live diffuse vertex (nee_textbook, mis).
__host__ __device__ constexpr bool direct_term(int est) {
  return est_base(est) == kTextbook || est_base(est) == kMis;
}

__host__ __device__ constexpr bool uniform_sample(int est) {
  return est_base(est) == kUniform || est_base(est) == kUniformCorrected;
}

// The estimator codes beside nee, cosine and nee_textbook, as
// X(code): the instances of megakernel_est.cu (rows 1, 2, 8) and
// megakernel_grad_est.cu (row 9).
#define SPT_EST_CODES(X) \
  X(kUniform)            \
  X(kUniformCorrected)   \
  X(kMixture)            \
  X(kMis)                \
  X(kNee | kGlibc)       \
  X(kMixture | kGlibc)

// The estimator codes of the _ext kernels (megakernel_ext*.cu), as X(code),
// and each code's instance: the quads, and the GLOS lobe where the
// estimator has glossy semantics (integrator/wavefront.GLOS_ESTIMATORS).
#define SPT_EXT_CODES(X) \
  X(kNee)                \
  X(kCosine)             \
  X(kTextbook)           \
  SPT_EST_CODES(X)

__host__ __device__ constexpr bool glos_estimator(int est) {
  return est == kCosine || est == kTextbook || est == kMis;
}

__host__ __device__ constexpr int ext_code(int est) {
  return est | kWithQuads | (glos_estimator(est) ? kWithGlos : 0);
}

// float32(1 / RAND_MAX) for glibc's RAND_MAX = 2^31 - 1: it rounds to 2^-31.
constexpr float kInvRandMax = 4.656612873077393e-10f;

// integrator/sampling.glibc_overflow_offset: rand() * 36 / RAND_MAX with
// glibc's int product wrapping. u * 2^31 is an exact integer below 2^31 (u
// has 24 random bits); the unsigned product wraps modulo 2^32 and is read
// as int32.
__device__ __forceinline__ float glibc_offset(float u) {
  const uint32_t r = static_cast<uint32_t>(u * 2147483648.0f);
  const int wrapped = static_cast<int>(r * 36u);
  return __int2float_rn(wrapped) * kInvRandMax;
}

// The kTab template argument of the loop body: no sphere table (rows 1, 8),
// or the sphere table scanned as kScanLinear, kScanTree or kScanCount
// (megakernel_bvh.cuh).
constexpr int kTabNone = 0;

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

// ---- Path guiding (experiment/path_guiding.py, ops/megakernel.py) ----

// The reference's voxel grid: x in [0, 100), y in [-1, 85), z in [-1, 171),
// 10-unit voxels, ids clamped into the grid.
constexpr int kNVox0 = 10, kNVox1 = 9, kNVox2 = 18;
constexpr int kNVoxels = kNVox0 * kNVox1 * kNVox2;  // 1620
constexpr int kGuideSentinel = -2147483647 - 1;  // int32 min
constexpr float kOctQ = 3.05185094e-05f;  // float32(1 / 32767)

__device__ __forceinline__ int voxel_axis(float c, float lo, int n) {
  const int q = static_cast<int>(floorf((c - lo) / 10.0f));
  return q < 0 ? 0 : (q > n - 1 ? n - 1 : q);
}

// path_guiding.voxel_id.
__device__ __forceinline__ int voxel_id(V3 x) {
  return (voxel_axis(x.x, 0.0f, kNVox0) * kNVox1 +
          voxel_axis(x.y, -1.0f, kNVox1)) * kNVox2 +
         voxel_axis(x.z, -1.0f, kNVox2);
}

// ops/megakernel.oct_decode: the low 16 bits (u) and the high 16 (v) as
// int16, each over 32767, the octahedral chart's lower half unfolded.
__device__ __forceinline__ V3 oct_decode(int packed) {
  const int iu = static_cast<int16_t>(packed & 0xFFFF);
  const int iv = packed >> 16;  // arithmetic shift
  const float u = static_cast<float>(iu) * kOctQ;
  const float v = static_cast<float>(iv) * kOctQ;
  const float az = 1.0f - fabsf(u) - fabsf(v);
  const bool fold = az < 0.0f;
  const float su = u >= 0.0f ? 1.0f : -1.0f;
  const float sv = v >= 0.0f ? 1.0f : -1.0f;
  const float uf = fold ? (1.0f - fabsf(v)) * su : u;
  const float vf = fold ? (1.0f - fabsf(u)) * sv : v;
  const float inv = rsqrt_ieee(uf * uf + vf * vf + az * az);
  return v3(uf * inv, vf * inv, az * inv);
}

// core/vecmath.pow_pos: x^p for x >= 0 as exp2(p * log2(x)) from +, -, *, /
// and bit operations (a library powf may round unlike the plain version's
// pow); 0 below the smallest normal float.
__device__ __forceinline__ float pow_pos(float x, float p) {
  bool ok = x >= 1.17549435e-38f;
  const int bits = __float_as_int(ok ? x : 1.0f);
  int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);
  const bool big = m > 1.41421354f;
  m = big ? m * 0.5f : m;
  e = big ? e + 1 : e;
  const float s = (m - 1.0f) / (m + 1.0f);
  const float s2 = s * s;
  float poly = 0.3205989f;
  poly = poly * s2 + 0.412198573f;
  poly = poly * s2 + 0.577078044f;
  poly = poly * s2 + 0.961796701f;
  poly = poly * s2 + 2.88539004f;
  const float t = (static_cast<float>(e) + s * poly) * p;
  const float n = floorf(t + 0.5f);
  const float f = t - n;
  float q = 1.52527336e-05f;
  q = q * f + 0.000154035297f;
  q = q * f + 0.00133335579f;
  q = q * f + 0.00961812865f;
  q = q * f + 0.0555041097f;
  q = q * f + 0.240226507f;
  q = q * f + 0.693147182f;
  q = q * f + 1.0f;
  ok = ok && n >= -126.0f && n <= 127.0f;
  const int n_i = ok ? static_cast<int>(n) : 0;
  return ok ? q * __int_as_float((n_i + 127) << 23) : 0.0f;
}

// integrator/sampling._pow_safe: max(x, 0)^n.
__device__ __forceinline__ float pow_safe(float x, float n) {
  return x > 0.0f ? pow_pos(x, n) : 0.0f;
}

// The mixture's constants (ops/megakernel._guide_consts): the lobe
// probability, its power k, (k + 1) / (2 pi), 1 / (k + 1), and k as an
// integer in [1, 64] (else 0).
struct GuideParams {
  float beta, k, norm_k, inv_k1;
  int k_int;
};

// core/vecmath.pow_const: an integer power as its squaring chain.
__device__ __forceinline__ float pow_k(const GuideParams& g, float x) {
  if (g.k_int > 0) {
    int n = g.k_int;
    float result = 0.0f, base = x;
    bool have = false;
    while (n) {
      if (n & 1) {
        result = have ? result * base : base;
        have = true;
      }
      n >>= 1;
      if (n) base = base * base;
    }
    return result;
  }
  return pow_pos(x, g.k);
}

// integrator/wavefront.guided_mixture on a guided vertex (beta_eff = beta):
// the power-cosine lobe around mu from the cosine sample's u2 and angle,
// the coin, the weight pdf_cos / pdf_mix, and pdf_mix (mis's carry).
// Returns ok (false: the lane ends, with weight 0).
__device__ __forceinline__ bool guided_mixture(const GuideParams& g, V3 n,
                                               V3 mu, V3 cos_dir, float sr1,
                                               float cr1, float u2,
                                               float u_coin, V3* dir,
                                               float* w, float* pdf) {
  const V3 a = fabsf(mu.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 mu_u = norm(cross(a, mu));
  const V3 mu_v = cross(mu, mu_u);
  const float wz = pow_pos(u2, g.inv_k1);
  const float sin_t = sqrtf(fmaxf(1.0f - wz * wz, 0.0f));
  const V3 d_lobe = norm(add(add(mul(mu_u, cr1 * sin_t), mul(mu_v, sr1 * sin_t)),
                             mul(mu, wz)));
  const V3 d = u_coin < g.beta ? d_lobe : cos_dir;
  const float cos_n = dot(d, n);
  const float cos_mu = dot(d, mu);
  const float pdf_lobe = g.norm_k * pow_k(g, fmaxf(cos_mu, 0.0f));
  const float pdf_cos = fmaxf(cos_n, 0.0f) * kInvPi;
  const float pdf_mix = g.beta * pdf_lobe + (1.0f - g.beta) * pdf_cos;
  const bool ok = pdf_mix > 1e-9f && cos_n > 0.0f;
  *w = ok ? pdf_cos / pdf_mix : 0.0f;
  *dir = d;
  *pdf = pdf_mix;
  return ok;
}

// Guide sources of render_lane: none (rows 1, 2, 3, 8); row 4's voxel
// table of packed lobes (kNVoxels entries, in shared memory), read at each
// diffuse hit's voxel; row 5's packed lobe of each pixel (device memory),
// the lane's pixel's, at depth 1 only.
struct NoGuide {
  static constexpr int kKind = 0;
};
struct VoxelGuide {
  static constexpr int kKind = 1;
  const int* tab;
  GuideParams g;
};
struct LaneGuide {
  static constexpr int kKind = 2;
  const int* lobes;
  GuideParams g;
};

// The light parallelogram's corner, edges and normal, read once a lane.
struct LightFrame {
  V3 lc, leu, lev, ln;
};

__device__ __forceinline__ LightFrame light_frame(const Params& p) {
  return LightFrame{ld3(p.lc), ld3(p.leu), ld3(p.lev), ld3(p.ln)};
}

// One bounce: what render_lane and the geometry adjoint (megakernel_geom.cu)
// read of it. Fields a caller does not read cost it nothing (inlined).
struct Bounce {
  int id;        // the winner
  float t;       // its distance, kMissT on a miss
  bool hit;
  int axis;      // the winner's rect axis, -1 for a sphere
  int refl;
  bool diffuse;
  bool glos;     // a GLOS hit (kWithGlos): it samples the light too
  V3 x, ng, n;   // hit point, geometric normal, the normal against d
  V3 alb, emi;
  bool survive;    // Russian roulette
  bool rr_scaled;  // RR active with p_max > 0: f = albedo / p_max
  float inv_p;
  V3 f;
  V3 new_dir;
  float w;
  bool success;  // the NEE probe reached the light
  float t_safe;  // its distance to the light where it did, else 1
  float w_nee;   // its weight (nee_textbook's direct term)
  bool ok_g;     // guided: the mixture sample carries
  float alpha, beta, wz;  // the cosine sample: fu·alpha + fv·beta + n·wz
  V3 lp;                  // the light sample
  float coin;             // REFR's coin
  bool take;              // mixture: its coin took NEE
  float pdf_cont;         // mis: the continuation's p_bsdf (diffuse)
};

// What a bounce's two queries found, as an earlier trace of the same
// bounce taped them: the nearest hit, and the NEE probe's success and
// t_safe.
struct Queries {
  int id;
  float t;
  bool success;
  float t_safe;
};

// A bounce from (o, d) in two parts, in render_lane's order: the nearest
// hit and its materials (`bounce_hit`), then, after the caller's emission
// pickup, the hit point and normals, Russian roulette and the scatter of
// the estimator kEst (and the guide on a diffuse hit; pix is the lane's
// pixel, for row 5's lobes) for bounce `depth` of sample pid
// (`bounce_scatter`). `bounce` runs both. With kTaped, the nearest hit and
// the probe's result come from *taped instead of being traced. kQuads: the
// quads are scanned after the rects (the table kernels only).
template <class Mats, int kTab, bool kTaped = false, bool kQuads = false>
__device__ __forceinline__ void bounce_hit(const Params& p, const SphereTab& tab,
                                           const Mats& mats, V3 o, V3 d,
                                           Bounce* b,
                                           const Queries* taped = nullptr) {
  static_assert(!kQuads || kTab != kTabNone, "quads need a table kernel");
  if constexpr (kTaped) {
    b->id = taped->id;
    b->t = taped->t;
  } else if constexpr (kTab) {
    b->t = nearest_tab<kTab, kQuads>(p, tab, o, d, &b->id);
  } else {
    b->t = nearest(p, o, d, &b->id);
  }
  b->hit = b->t < kMissT;
  // The winner's rect axis, -1 for a sphere. Rows 1 and 8 read it here,
  // as before the sphere table existed, so their code is unchanged.
  b->axis = (kTab && b->id >= p.n_rects) ? -1 : p.rects[b->id].axis;
  b->alb = mats.albedo(b->id);
  b->emi = mats.emission(b->id);
}

// The NEE probe of bounce_scatter from the hit point b->x with normal n:
// the light sample (a uniform point of the parallelogram, or glibc's
// wrapped one), whether the probe reaches the light, its t_safe and the
// NEE weight, into *b. Returns the direction toward the light sample.
template <int kTab, int kEst, bool kTaped>
__device__ __forceinline__ V3 nee_probe(const Params& p, const SphereTab& tab,
                                        const LightFrame& lf, V3 n,
                                        uint32_t pid, uint32_t ctr, Bounce* bp,
                                        const Queries* taped) {
  Bounce& b = *bp;
  const float lu = uniform(p.seed, pid, ctr + kLightU);
  const float lv = uniform(p.seed, pid, ctr + kLightV);
  if constexpr ((kEst & kGlibc) != 0) {
    b.lp = add(add(lf.lc, mul(ld3(p.leu_hat), glibc_offset(lu))),
               mul(ld3(p.lev_hat), glibc_offset(lv)));
  } else {
    b.lp = add(add(lf.lc, mul(lf.leu, lu)), mul(lf.lev, lv));
  }
  const V3 d_l = norm(sub(b.lp, b.x));
  float t_l;
  if constexpr (kTaped) {
    b.success = taped->success;
    t_l = taped->t_safe;
  } else if constexpr (kTab) {
    b.success = probe_light_tab<kTab, with_quads(kEst)>(p, tab, b.x, d_l, &t_l);
  } else {
    b.success = probe_light(p, b.x, d_l, &t_l);
  }
  const float t_safe = b.success ? t_l : 1.0f;
  b.t_safe = t_safe;
  b.w_nee = (fabsf(p.area * dot(d_l, lf.ln)) / (t_safe * t_safe)) *
            (fabsf(dot(d_l, n)) * kInvPi);
  return d_l;
}

// mis: whether bounce b, reached along d, picks up the light by a BSDF
// sample from a diffuse vertex (mis_pdf, that vertex's p_bsdf of d, > 0),
// and then its balance weight mis_pdf / (mis_pdf + p_light) into *w, with
// p_light = t^2 / (A max(|cos_l|, 1e-6)) at the hit's t. render_lane and
// the material adjoint weigh the pickup by it.
__device__ __forceinline__ bool mis_pickup(const Params& p,
                                          const LightFrame& lf, V3 d,
                                          const Bounce& b, float mis_pdf,
                                          float* w) {
  if (!(b.hit && b.id == p.light_id && mis_pdf > 0.0f)) return false;
  const float cos_l = fabsf(dot(d, lf.ln));
  const float p_light = (b.t * b.t) / (p.area * fmaxf(cos_l, 1e-6f));
  *w = mis_pdf / (mis_pdf + p_light);
  return true;
}

template <int kTab, int kEst, class Guide, bool kTaped = false>
__device__ __forceinline__ void bounce_scatter(const Params& p,
                                               const SphereTab& tab,
                                               const LightFrame& lf, V3 o,
                                               V3 d, uint32_t pid, int depth,
                                               int pix, const Guide& guide,
                                               Bounce* bp,
                                               const Queries* taped = nullptr) {
  Bounce& b = *bp;
  const int axis = b.axis;
  b.x = b.hit ? add(o, mul(d, b.t)) : v3(0.0f, 0.0f, 0.0f);
  V3 ng = v3(axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
             axis == 2 ? 1.0f : 0.0f);
  b.refl = kDiff;
  if constexpr (kTab) {
    b.refl = tab.refl[b.id];
    if (axis < 0) {
      int row = b.id - p.n_rects;
      bool quad = false;
      if constexpr (with_quads(kEst)) {
        // A quad's unit normal, or a sphere's row after the quads.
        quad = row < tab.quads->n;
        if (quad) {
          ng = ld3(tab.quads->q[row].ng);
        } else {
          row -= tab.quads->n;
        }
      }
      if (!quad) {
        const float4 c = sphere_row<kTab>(tab, row);
        ng = norm(sub(b.x, v3(c.x, c.y, c.z)));
      }
    }
  }
  b.ng = ng;
  const V3 n = dot(ng, d) < 0.0f ? ng : neg(ng);
  b.n = n;
  b.diffuse = b.refl == kDiff;
  b.glos = false;
  float gl = 0.0f;  // the GLOS hit's Phong exponent
  if constexpr (with_glos(kEst)) {
    static_assert(kTab != kTabNone, "GLOS needs a table kernel");
    b.glos = b.refl == kGlos;
    if (b.glos) gl = tab.gloss[b.id];
  }

  const uint32_t ctr = static_cast<uint32_t>(depth) * kDrawsPerBounce;
  const float u_rr = uniform(p.seed, pid, ctr + kRR);

  // Russian roulette.
  const float p_max = fmaxf(b.alb.x, fmaxf(b.alb.y, b.alb.z));
  const bool rr_active = depth > p.rr_start_depth || p_max <= 0.0f;
  b.survive = rr_active ? u_rr < p_max : true;
  b.rr_scaled = rr_active && p_max > 0.0f;
  b.inv_p = b.rr_scaled ? 1.0f / (p_max > 0.0f ? p_max : 1.0f) : 1.0f;
  b.f = mul(b.alb, b.inv_p);

  b.success = false;
  b.t_safe = 1.0f;
  b.w_nee = 0.0f;
  b.ok_g = true;
  b.alpha = b.beta = b.wz = b.coin = 0.0f;
  b.lp = v3(0.0f, 0.0f, 0.0f);
  // A diffuse or GLOS hit: the hemisphere sample, the NEE probe of the
  // estimator, and (GLOS) the lobe, which then replaces the continuation.
  if (b.diffuse || b.glos) {
    // Cosine-weighted (or the uniform estimators' uniform) hemisphere
    // sample around n.
    const float u1 = uniform(p.seed, pid, ctr + kScatterU);
    const float u2 = uniform(p.seed, pid, ctr + kScatterV);
    float sr1, cr1;
    sincos_2pi(u1, &sr1, &cr1);
    if constexpr (uniform_sample(kEst)) {
      const float sin_t = sqrtf(u2 * (2.0f - u2));
      b.alpha = cr1 * sin_t;
      b.beta = sr1 * sin_t;
      b.wz = 1.0f - u2;
    } else {
      const float r2s = sqrtf(u2);
      b.alpha = cr1 * r2s;
      b.beta = sr1 * r2s;
      b.wz = sqrtf(1.0f - u2);
    }
    const V3 a = fabsf(n.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    const V3 fu = norm(cross(a, n));
    const V3 fv = cross(n, fu);
    const V3 cos_dir =
        norm(add(add(mul(fu, b.alpha), mul(fv, b.beta)), mul(n, b.wz)));
    // GLOS (integrator/wavefront._glos_scatter): the modified-Phong lobe
    // around gm, the mirror of d about n, from the same u1 and u2: cos =
    // u2^(1/(n+1)) (pow_pos), in gm's frame; weight (n+2)/(n+1) max(cos,
    // 0) against n.
    V3 gm = v3(0.0f, 0.0f, 0.0f), g_dir = v3(0.0f, 0.0f, 0.0f);
    float g_w = 0.0f;
    if constexpr (with_glos(kEst)) {
      if (b.glos) {
        gm = reflect(d, n);
        const V3 ga = fabsf(gm.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f)
                                         : v3(1.0f, 0.0f, 0.0f);
        const V3 gu = norm(cross(ga, gm));
        const V3 gv = cross(gm, gu);
        const float wz = pow_pos(u2, 1.0f / (gl + 1.0f));
        const float sin_t = sqrtf(fmaxf(1.0f - wz * wz, 0.0f));
        g_dir = norm(add(add(mul(gu, cr1 * sin_t), mul(gv, sr1 * sin_t)),
                         mul(gm, wz)));
        g_w = ((gl + 2.0f) / (gl + 1.0f)) * fmaxf(dot(g_dir, n), 0.0f);
      }
    }

    V3 d_l = v3(0.0f, 0.0f, 0.0f);  // mis: the light sample's direction
    if constexpr (est_base(kEst) == kCosine || est_base(kEst) == kUniform) {
      b.new_dir = cos_dir;
      b.w = 1.0f;
    } else if constexpr (est_base(kEst) == kUniformCorrected) {
      b.new_dir = cos_dir;
      b.w = 2.0f * fmaxf(dot(cos_dir, n), 0.0f);
    } else if constexpr (est_base(kEst) == kMixture) {
      // The coin first: a lane it sends to the cosine sample traces no
      // probe (every draw is keyed by its counter, so skipping one
      // changes no bit).
      b.take = uniform(p.seed, pid, ctr + kMixCoin) < p.mixture_q;
      b.new_dir = cos_dir;
      b.w = 1.0f;
      if (b.take) {
        d_l = nee_probe<kTab, kEst, kTaped>(p, tab, lf, n, pid, ctr, &b,
                                             taped);
        b.new_dir = b.success ? d_l : cos_dir;
        b.w = b.success ? b.w_nee : 1.0f;
      }
    } else {
      // Probe a uniform point of the light parallelogram.
      d_l = nee_probe<kTab, kEst, kTaped>(p, tab, lf, n, pid, ctr, &b, taped);
      if constexpr (est_base(kEst) == kNee) {
        // NEE as continuation.
        b.new_dir = b.success ? d_l : cos_dir;
        b.w = b.success ? b.w_nee : 1.0f;
      } else {
        // Textbook and mis: the cosine continuation (render_lane adds the
        // direct term).
        b.new_dir = cos_dir;
        b.w = 1.0f;
        if constexpr (with_glos(kEst)) {
          if (b.glos) {
            // The direct term's weight: the light's |A cos_l| / t^2 times
            // the lobe's BRDF over albedo and max(cos, 0).
            const float w_geo =
                fabsf(p.area * dot(d_l, lf.ln)) / (b.t_safe * b.t_safe);
            b.w_nee = (w_geo * ((gl + 2.0f) * kInv2Pi *
                                pow_safe(dot(d_l, gm), gl))) *
                      fmaxf(dot(d_l, n), 0.0f);
          }
        }
      }
    }
    if constexpr (with_glos(kEst)) {
      if (b.glos) {
        // A lobe sample below the surface is absorbed.
        b.new_dir = g_dir;
        b.w = g_w;
        b.survive = b.survive && !(g_w <= 0.0f);
      }
    }
    bool guided = false;  // mis: the vertex took the mixture
    V3 mu = v3(0.0f, 0.0f, 1.0f);
    float pdf_mix = 0.0f;
    if constexpr (Guide::kKind != NoGuide::kKind) {
      // The defensive mixture where the vertex has a lobe; elsewhere the
      // cosine sample with weight 1 is what the mixture gives exactly.
      int entry = kGuideSentinel;
      if constexpr (Guide::kKind == VoxelGuide::kKind) {
        entry = guide.tab[voxel_id(b.x)];
      } else {
        if (depth == 1) entry = guide.lobes[pix];
      }
      if (entry != kGuideSentinel) {
        guided = true;
        mu = oct_decode(entry);
        b.ok_g = guided_mixture(guide.g, n, mu, cos_dir, sr1, cr1, u2,
                                uniform(p.seed, pid, ctr + kMixCoin),
                                &b.new_dir, &b.w, &pdf_mix);
      }
    }
    if constexpr (est_base(kEst) == kMis) {
      // The balance heuristic at the light sample, w_nee * p_light /
      // (p_light + p_bsdf), p_bsdf the continuation's pdf there (the
      // mixture's at a guided vertex; at an unguided one the mixture's is
      // the cosine pdf bit for bit); and the continuation's own p_bsdf,
      // which the next pickup of the light weighs against.
      float p_bsdf = fmaxf(dot(d_l, n), 0.0f) * kInvPi;
      if constexpr (Guide::kKind != NoGuide::kKind) {
        if (guided) {
          const float p_lobe =
              guide.g.norm_k * pow_k(guide.g, fmaxf(dot(d_l, mu), 0.0f));
          p_bsdf = guide.g.beta * p_lobe + (1.0f - guide.g.beta) * p_bsdf;
        }
      }
      if constexpr (with_glos(kEst)) {
        // GLOS: the lobe's pdf (n+1)/(2 pi) max(d . gm, 0)^n.
        if (b.glos) {
          p_bsdf = (gl + 1.0f) * kInv2Pi * pow_safe(dot(d_l, gm), gl);
        }
      }
      const float cos_l = fabsf(dot(d_l, lf.ln));
      const float p_light =
          (b.t_safe * b.t_safe) / (p.area * fmaxf(cos_l, 1e-6f));
      b.w_nee = b.w_nee * (p_light / (p_light + p_bsdf));
      b.pdf_cont = guided ? pdf_mix : fmaxf(dot(b.new_dir, n), 0.0f) * kInvPi;
      if constexpr (with_glos(kEst)) {
        if (b.glos) {
          b.pdf_cont =
              (gl + 1.0f) * kInv2Pi * pow_safe(dot(b.new_dir, gm), gl);
        }
      }
    }
  } else if (b.refl == kSpec) {
    b.new_dir = reflect(d, ng);
    b.w = 1.0f;
  } else {
    b.coin = uniform(p.seed, pid, ctr + kRefrCoin);
    refr_scatter(d, ng, n, b.coin, &b.new_dir, &b.w);
  }
}

template <class Mats, int kTab, int kEst, class Guide, bool kTaped = false>
__device__ __forceinline__ Bounce bounce(const Params& p, const SphereTab& tab,
                                         const Mats& mats, const LightFrame& lf,
                                         V3 o, V3 d, uint32_t pid, int depth,
                                         int pix, const Guide& guide,
                                         const Queries* taped = nullptr) {
  Bounce b;
  bounce_hit<Mats, kTab, kTaped>(p, tab, mats, o, d, &b, taped);
  bounce_scatter<kTab, kEst, Guide, kTaped>(p, tab, lf, o, d, pid, depth, pix,
                                            guide, &b, taped);
  return b;
}

// One lane's samples [lr.s, lr.s_stop) of pixel lr.pix; lr comes from the
// kernel's lane source (lane_range or lane_range_budgets). The lane writes
// row lr.pix of out_l with kPixRow (the budget kernels), else the row of
// its index. traces: [extend, probe], and with kTab == kScanCount also the
// scans' [node tests, rows tested, rows at the square root].
template <class Mats, int kTab, int kEst = kNee, class Guide = NoGuide,
          bool kPixRow = false>
__device__ __forceinline__ void render_lane(const Params& p,
                                            const LaneRange& lr,
                                            const Mats& mats,
                                            const SphereTab& tab_in, bool fold,
                                            float* __restrict__ out_l,
                                            unsigned long long* __restrict__ traces,
                                            const Guide& guide = Guide{}) {
  ScanCounts cnt{0u, 0u, 0u};
  SphereTab tab = staged_tab<kTab>(tab_in);
  if constexpr (kTab == kScanCount) tab.cnt = &cnt;
  const V3 cam_o = ld3(p.cam_o);
  const LightFrame lf = light_frame(p);
  const V3 e_light = mats.emission(p.light_id);

  uint32_t s = lr.s;
  uint32_t pid = lr.pid_base + s;
  V3 o = cam_o;
  V3 d = spawn_dir(p, lr.px, lr.py, pid);
  V3 T = v3(1.0f, 1.0f, 1.0f);
  V3 L = v3(0.0f, 0.0f, 0.0f);
  int depth = 0;
  bool alive = lr.in_range && s < lr.s_stop;
  // nee_textbook: the previous bounce's probe already counted the light.
  bool suppress = false;
  // mis: the previous diffuse vertex's p_bsdf of this ray (0: the pickup
  // is whole).
  float mis_pdf = 0.0f;
  uint32_t n_extend = 0, n_probe = 0;

  while (alive) {
    depth += 1;
    Bounce b;
    bounce_hit<Mats, kTab, false, with_quads(kEst)>(p, tab, mats, o, d, &b);
    // Emission pickup: throughput * emission (nee_textbook adds it with
    // the direct term below, or drops it when the light was just probed;
    // mis adds it with the direct term, a pickup of the light weighted by
    // the balance heuristic against the light sampler's density there).
    V3 pick = v3(T.x * b.emi.x, T.y * b.emi.y, T.z * b.emi.z);
    if constexpr (est_base(kEst) == kTextbook) {
      if (suppress && b.hit && b.id == p.light_id) pick = v3(0.0f, 0.0f, 0.0f);
    } else if constexpr (est_base(kEst) == kMis) {
      float w_b;
      if (mis_pickup(p, lf, d, b, mis_pdf, &w_b)) pick = mul(pick, w_b);
    } else {
      L = add(L, pick);
    }
    bounce_scatter<kTab, kEst>(p, tab, lf, o, d, pid, depth, lr.pix, guide,
                               &b);
    // The direct term of nee_textbook and mis, with the throughput before
    // the update.
    V3 direct = v3(0.0f, 0.0f, 0.0f);
    if constexpr (direct_term(kEst)) {
      if (b.success) {
        direct = v3(((b.w_nee * T.x) * b.alb.x) * e_light.x,
                    ((b.w_nee * T.y) * b.alb.y) * e_light.y,
                    ((b.w_nee * T.z) * b.alb.z) * e_light.z);
      }
    }
    const V3 T_new = mul(v3(T.x * b.f.x, T.y * b.f.y, T.z * b.f.z), b.w);

    bool alive_next = b.survive;
    n_extend += 1;
    if constexpr (est_base(kEst) == kNee) {
      n_probe += (alive_next && b.diffuse) ? 1u : 0u;
    } else if constexpr (est_base(kEst) == kMixture) {
      n_probe += (alive_next && b.diffuse && b.take) ? 1u : 0u;
    } else if constexpr (direct_term(kEst)) {
      n_probe += (b.diffuse || b.glos) ? 1u : 0u;  // before RR
    }
    alive_next = alive_next && depth < p.max_bounces;
    if constexpr (Guide::kKind != NoGuide::kKind) {
      alive_next = alive_next && b.ok_g;
    }

    if constexpr (nee_cont(kEst)) {
      // (mixture: success only where its coin took NEE.)
      if (fold && alive_next && b.success) {
        // The next bounce hits the light at t_l, picks up T_new * e_light
        // and dies in RR (max albedo <= 0): resolve it now.
        L = add(L, v3(T_new.x * e_light.x, T_new.y * e_light.y,
                      T_new.z * e_light.z));
        n_extend += 1;
        alive_next = false;
      }
    }
    if constexpr (est_base(kEst) == kTextbook) {
      L = add(L, add(pick, direct));
      suppress = alive_next && (b.diffuse || b.glos);
    } else if constexpr (est_base(kEst) == kMis) {
      L = add(L, add(pick, direct));
      mis_pdf = (b.diffuse || b.glos) ? b.pdf_cont : 0.0f;
    }

    if (alive_next) {
      o = b.x;
      d = b.new_dir;
      T = T_new;
    } else {
      s += 1;
      if (s < lr.s_stop) {
        pid = lr.pid_base + s;
        o = cam_o;
        d = spawn_dir(p, lr.px, lr.py, pid);
        T = v3(1.0f, 1.0f, 1.0f);
        depth = 0;
        if constexpr (est_base(kEst) == kMis) mis_pdf = 0.0f;
      } else {
        alive = false;
      }
    }
  }

  if (lr.in_range) {
    const int row = kPixRow ? lr.pix : blockIdx.x * kBlock + threadIdx.x;
    out_l[3 * row + 0] = L.x;
    out_l[3 * row + 1] = L.y;
    out_l[3 * row + 2] = L.z;
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
  if constexpr (kTab == kScanCount) {
    unsigned long long c3[3] = {cnt.nodes, cnt.rows, cnt.roots};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        c3[i] += __shfl_down_sync(0xFFFFFFFFu, c3[i], off);
      }
      if ((threadIdx.x & 31) == 0) atomicAdd(&traces[2 + i], c3[i]);
    }
  }
}

// Row 2 (megakernel.cu) with estimator kEst and scan kScan (its counting
// instance: kScanCount, traces of 5), its _ext instances (megakernel_ext.cu,
// with the (K,) Phong exponents gloss and the quads), and the image-only
// launch of the geometry adjoint (megakernel_geom.cu): the sphere rows,
// the tree (bvh, root) and the material tables in device memory.
template <int kEst, int kScan>
__device__ __forceinline__ void tab_body(const Params& p,
                                         const float4* __restrict__ sph,
                                         int n_sph,
                                         const float4* __restrict__ bvh,
                                         int root,
                                         const float* __restrict__ alb,
                                         const float* __restrict__ emi,
                                         const int* __restrict__ refl,
                                         float* __restrict__ out_l,
                                         unsigned long long* __restrict__ traces,
                                         const float* __restrict__ gloss = nullptr,
                                         const QuadTab* quads = nullptr) {
  const TableMaterials mats{alb, emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, kScan, kEst>(
      p, lane_range(p), mats,
      sphere_tab(sph, n_sph, refl, bvh, root, gloss, quads),
      nee_cont(kEst) && fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f, out_l, traces);
}

// Row 8 on rect-only DIFF scenes (megakernel.cu, megakernel_est.cu),
// estimator kEst: the runtime (K, 3) tables copied into shared memory once
// a block; the NEE fold (nee and mixture) decided from the light's row.
template <int kEst>
__device__ __forceinline__ void mat_body(const Params& p,
                                         const float* __restrict__ alb,
                                         const float* __restrict__ emi,
                                         float* __restrict__ out_l,
                                         unsigned long long* __restrict__ traces) {
  __shared__ float s_alb[3 * kMaxRects];
  __shared__ float s_emi[3 * kMaxRects];
  load_tables(p, alb, emi, s_alb, s_emi);
  const TableMaterials mats{s_alb, s_emi};
  const V3 a = mats.albedo(p.light_id);
  render_lane<TableMaterials, kTabNone, kEst>(
      p, lane_range(p), mats, SphereTab{},
      nee_cont(kEst) && fmaxf(a.x, fmaxf(a.y, a.z)) <= 0.0f, out_l, traces);
}

// ---- Host helpers of the entry points ----

// Copies the (n_rects, 3) host materials into the kernel parameters.
inline void bake_materials(Params* p, const float* rect_alb,
                           const float* rect_emi, int n_rects, int fold) {
  for (int i = 0; i < n_rects; ++i) {
    for (int c = 0; c < 3; ++c) {
      p->rects[i].alb[c] = rect_alb[3 * i + c];
      p->rects[i].emi[c] = rect_emi[3 * i + c];
    }
  }
  p->fold = fold;
}

}  // namespace
