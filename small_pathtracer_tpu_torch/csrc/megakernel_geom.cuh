// Geometry and material adjoint of the sphere-table megakernel: the kernel
// templates megakernel_geom<kScan, kEst> and megakernel_geom_image<kScan,
// kEst> and the body of their three host entry points, spt_megakernel_geom
// (megakernel_geom.cu: nee), spt_megakernel_geom_est (megakernel_geom_est.cu:
// cosine, uniform, uniform_corrected, mixture, and nee and mixture with
// light_sample_mode='glibc_overflow') and spt_megakernel_geom_direct
// (megakernel_geom_direct.cu: the direct-term estimators nee_textbook and
// mis). Axis-aligned rects (unrolled) and spheres (the runtime table) with
// DIFF, SPEC and REFR materials and one parallelogram light.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel_geom.py:
// `build_geom_grad_kernel` (:133), as `_build_geom_run` builds it for
// `geom_run` / `geom_vjp` (its `pallas_call` at :1488), with every estimator
// of SUPPORTED_ESTIMATORS (:127). Given the per-pixel cotangent g of the
// radiance sum I, it returns the pathwise interior cotangents of sum(g·I)
// with respect to every sphere's (center, radius) and every object's
// (albedo, emission). With bk == 0 it only renders I (the image-only launch
// of a fit step): the TPU kernel's pass A alone, which is row 2's loop body
// (`tab_body<kEst>` of megakernel_lane.cuh, the NEE fold on for nee and
// mixture), so it is megakernel_<est>_tab's image, counts and time. Row 12
// (`geom_train_step_sharded`, megakernel_geom.py:1636, its `pallas_call` at
// :1686) runs both launches on one rank's shard lanes (`lane_range` with
// pix0), the same lanes and seed for the two, so the loss and the gradient
// share their paths; g_img holds the shard's pixel rows only. The sums over
// the mesh are torch.distributed all-reduces in ops/megakernel_geom.py.
//
// Algorithm: per sample, pass A traces the path once, latches its radiance
// L and its depth D, and tapes the state (o, d, T, A) before each bounce in
// the lane's local memory (megakernel_tape.cuh: a segment of kSeg bounces a
// buffer, checkpoints and segment replays for longer paths). Then the
// sweep runs bounce j = D..1 once each from the tape as a VJP bounce,
// carrying λ = (dL/do, dL/dd) of the state after bounce j (mis also dL/d
// of its pdf carry, λ_mpdf). A VJP bounce re-evaluates bounce j on the
// taped (o, d) and adds
//   - the material terms of the material adjoint (megakernel_vjp.cuh):
//     d/d albedo with the RR 1/p term split over the channels tied at p_max,
//     and d/d emission (times the pickup's weight: 0 where nee_textbook
//     suppresses it, mis's balance weight), from T_j·S_{j+1} =
//     (L − A_{j+1}) / (f_j·w_j); nee_textbook and mis add their direct
//     term's albedo and light-emission terms;
//   - the pullback of the bounce's continuous map (o, d, c, r, mpdf) ->
//     (x, d', w_cont, w_tb, w_pick, pdf_cont) under (λ_x, λ_d, σ_w, σ_tb,
//     σ_pk, λ_mpdf), σ_w = dL/dw_j = Σ_c g_c·T_j S_{j+1}·albedo_c·inv_p,
//     σ_tb = Σ_c g_c·T_c·albedo_c·e_light,c (the direct term's weight),
//     σ_pk = Σ_c g_c·T_c·e_c (mis's pickup weight) (`bounce_vjp` below):
//     the winner sphere's (c, r) cotangent, the new λ for bounce j-1, and
//     mis's λ_mpdf, which lands one bounce back on that bounce's
//     continuation pdf. The TPU kernel pulls back with jax.vjp inside the
//     kernel (:840-850, :1140-1157); here the pullback is derived by hand,
//     the same formulas in the same order as ops/megakernel_geom.py
//     `bounce_vjp`, which the tests hold against torch.autograd branch by
//     branch.
// The TPU kernel has no lane-private memory, so it replays bounces 1..j-1
// before each VJP bounce j: D(D+1)/2 bounces a sample. Here a sample costs
// D traced bounces, D VJP bounces and, for D > kSeg only, about D replayed
// bounces (counters: [extend, probe] of pass A, replayed, VJP, and the
// paths longer than the tape).
//
// The VJP bounce takes what its two queries (the nearest hit and the NEE
// probe) found from the tape (64 bytes an entry instead of 48) and shades
// the bounce again without them: pass A's bounce bit for bit, and faster on
// cornell_spheres than tracing the queries again on the taped (o, d)
// (PERF.md). The entry and the checkpointed state are the estimator's
// (GeomTape): nee and the codes without carry keep PathState and the
// 64-byte GeomEntry; nee_textbook's state adds its suppression flag, mis's
// its pdf carry, and both fit the flag or the carry into the same 64 bytes
// (the probe's success as the sign of its taped distance), since each
// 4 bytes more of a tape entry cost the material adjoint 16-18% (PERF.md
// §6).
//
// Design: one thread per lane on the forward's lane layout (blocks of 128).
// Every bounce, of pass A, a replay or a VJP bounce, is `bounce` of
// megakernel_lane.cuh, render_lane's own, and the library is built with
// --fmad=false, so pass A's image and [extend, probe] counts are
// megakernel_<est>_tab's (pass A leaves the NEE fold out: it changes
// neither), and a replay or a VJP bounce retraces pass A. A lane traces one
// segment while it sweeps the one before (two tape buffers). A warp loops
// while any of its lanes is active, so all 32 lanes meet once an iteration
// at `warp_accumulate`, which sums the VJP bounces' contributions by winner
// object into the warp's row of gradient slots in shared memory in a fixed
// order. The direct terms' light-emission terms go to one object for every
// lane: each lane sums them in its registers, and the warp adds the 32 sums
// by a fixed xor tree once, after its loop. The block sums its four rows in
// a fixed order into one row of per-block partials and `reduce_partials`
// sums those rows in a fixed order: the gradient has the same bits from run
// to run, without per-thread columns and without atomics.
//
// What bounds it: operations. The gradient needs pass A's bounces (a
// nearest-hit query and the shading each), its shadow probes, and one
// pullback of a few hundred operations a bounce; the algorithm adds each
// VJP bounce's shading and the segment replays. Bytes are the cotangent
// image, the tables, the partials and the tape (64 bytes a bounce, written
// once and read once).

#pragma once

#include "megakernel_lane.cuh"
#include "megakernel_tape.cuh"

namespace {

constexpr int kMaxGeomSpheres = 1024;
// mis: the floor of the light density's |cos| (mis_pickup, bounce_scatter).
constexpr float kCosMin = 1e-6f;

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ void add_comp(V3* v, int i, float s) {
  if (i == 0) {
    v->x += s;
  } else if (i == 1) {
    v->y += s;
  } else {
    v->z += s;
  }
}

// u = v·rs, rs = 1/|v|: the cotangent of v under g_u.
__device__ __forceinline__ V3 norm_vjp(V3 u, float rs, V3 g_u) {
  return mul(sub(g_u, mul(u, dot(u, g_u))), rs);
}

// r = d − ng·(2 ng·d): the cotangents of d and ng under lam.
__device__ __forceinline__ void reflect_vjp(V3 d, V3 ng, V3 lam, V3* g_d,
                                            V3* g_ng) {
  const float k2 = 2.0f * dot(ng, d);
  const float gk = -dot(ng, lam);
  *g_d = add(lam, mul(ng, 2.0f * gk));
  *g_ng = add(mul(lam, -k2), mul(d, 2.0f * gk));
}

struct Pullback {
  V3 g_o, g_d, g_c;
  float g_r;
  float g_mp;  // mis: the cotangent of the carry (the previous pdf_cont)
};

// The cotangents of the bounce's outputs beside (x, d', w): the direct
// term's weight (sig_tb), mis's pickup weight (sig_pk) and its
// continuation pdf (lam_mp); and mis's carry mp and whether the pickup is
// balance-weighted (pick).
struct EstCot {
  float sig_tb, sig_pk, lam_mp, mp;
  bool pick;
};

// The NEE weight w = |A·(dl·ln)| / tl² · |dl·n| / π of a probe that
// reached the light (kBalance: times mis's p_l / (p_l + p_b), p_l =
// tl² / (A max(|dl·ln|, 1e-6)), p_b = max(dl·n, 0) / π) and, for NEE as
// the continuation, its direction dl = norm(lp − x), pulled back under
// (sig, lam_dl): adds the cotangent of x to *g_x and returns that of n.
template <bool kBalance>
__device__ __forceinline__ V3 nee_vjp(const Params& p, const Bounce& b,
                                      float sig, V3 lam_dl, V3* g_x) {
  const V3 ln = ld3(p.ln);
  const int a_l = p.rects[p.light_id].axis;
  const V3 vl = sub(b.lp, b.x);
  const float rs_l = rsqrt_ieee(dot(vl, vl));
  const V3 dl = mul(vl, rs_l);
  const float dla = comp(dl, a_l);
  const float inv_l = 1.0f / (dla != 0.0f ? dla : 1.0f);
  const float tl = (p.rects[p.light_id].k - comp(b.x, a_l)) * inv_l;
  const float a1 = p.area * dot(dl, ln);
  const float q = fabsf(a1) / (tl * tl);
  const float cs = dot(dl, b.n);
  const float bb = fabsf(cs) * kInvPi;
  float gcs_b = 0.0f, gtl_b = 0.0f, gcl_b = 0.0f;
  if constexpr (kBalance) {
    const float cl = dot(dl, ln);
    const float cm = fmaxf(fabsf(cl), kCosMin);
    const float p_l = (tl * tl) / (p.area * cm);
    const float p_b = fmaxf(cs, 0.0f) * kInvPi;
    const float den = p_l + p_b;
    const float g_bal = sig * (q * bb);
    sig = sig * (p_l / den);
    const float g_pl = g_bal * p_b / (den * den);
    const float g_pb = -g_bal * p_l / (den * den);
    gtl_b = g_pl * 2.0f * tl / (p.area * cm);
    gcl_b = fabsf(cl) >= kCosMin ? -g_pl * p_l / cm * sgnf(cl) : 0.0f;
    gcs_b = cs >= 0.0f ? g_pb * kInvPi : 0.0f;
  }
  const float gq = sig * bb;
  const float gb = sig * q;
  float gcs = gb * kInvPi * sgnf(cs);
  const float ga1 = gq / (tl * tl) * sgnf(a1);
  float gtl = -2.0f * gq * q / tl;
  V3 gdl;
  if constexpr (kBalance) {
    gcs = gcs + gcs_b;
    gtl = gtl + gtl_b;
    gdl = add(add(lam_dl, mul(ln, ga1 * p.area + gcl_b)), mul(b.n, gcs));
  } else {
    gdl = add(add(lam_dl, mul(ln, ga1 * p.area)), mul(b.n, gcs));
  }
  const V3 g_n = mul(dl, gcs);
  add_comp(g_x, a_l, -(gtl * inv_l));
  add_comp(&gdl, a_l, -(gtl * tl * inv_l));
  *g_x = sub(*g_x, norm_vjp(dl, rs_l, gdl));
  return g_n;
}

// The pullback of the bounce's continuous map (o, d, c, r, mp) -> (x, d',
// w, w_tb, w_pick, pdf_cont) of estimator kEst, every discrete choice fixed
// by the primal b, under (lam_x, lam_d, sig_w) and ec: ops/megakernel_geom.py
// `bounce_vjp`, per lane.
template <int kScan, int kEst>
__device__ __forceinline__ Pullback bounce_vjp(const Params& p,
                                            const SphereTab& tab,
                                            const Bounce& b, V3 o, V3 d,
                                            V3 lam_x, V3 lam_d, float sig_w,
                                            const EstCot& ec) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 g_x = zero, g_n = zero, g_ng = zero, g_d = zero;
  if (nee_cont(kEst) && b.diffuse && b.success) {
    // d' = dl = norm(lp − x), w = |A·(dl·ln)| / tl² · |dl·n| / π (mixture:
    // b.success only where its coin took NEE).
    g_n = nee_vjp<false>(p, b, sig_w, lam_d, &g_x);
  } else if (b.diffuse) {
    // d' = the hemisphere sample in the frame of n, w = 1 (uniform_corrected:
    // 2 max(d'·n, 0); mis: also pdf_cont = max(d'·n, 0) / π).
    const V3 a = fabsf(b.n.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    const V3 cr = cross(a, b.n);
    const float rs_u = rsqrt_ieee(dot(cr, cr));
    const V3 fu = mul(cr, rs_u);
    const V3 fv = cross(b.n, fu);
    const V3 sv = add(add(mul(fu, b.alpha), mul(fv, b.beta)), mul(b.n, b.wz));
    const float rs_s = rsqrt_ieee(dot(sv, sv));
    constexpr bool kCosOut = kEst == kUniformCorrected || kEst == kMis;
    V3 lam_s = lam_d, gn_cd = zero;
    if constexpr (kCosOut) {
      // The cotangent of d'·n.
      const V3 dn = mul(sv, rs_s);
      float g_cd = 0.0f;
      if (dot(dn, b.n) >= 0.0f) {
        g_cd = kEst == kMis ? ec.lam_mp * kInvPi : 2.0f * sig_w;
      }
      lam_s = add(lam_d, mul(b.n, g_cd));
      gn_cd = mul(dn, g_cd);
    }
    const V3 gsv = norm_vjp(mul(sv, rs_s), rs_s, lam_s);
    V3 gfu = mul(gsv, b.alpha);
    const V3 gfv = mul(gsv, b.beta);
    g_n = add(mul(gsv, b.wz), cross(fu, gfv));
    gfu = add(gfu, cross(gfv, b.n));
    const V3 gcr = norm_vjp(fu, rs_u, gfu);
    g_n = add(g_n, cross(gcr, a));
    if constexpr (kCosOut) g_n = add(g_n, gn_cd);
    if constexpr (direct_term(kEst)) {
      // The direct term's weight where the probe reached the light.
      if (b.success) {
        g_n = add(g_n, nee_vjp<kEst == kMis>(p, b, ec.sig_tb, zero, &g_x));
      }
    }
  } else if (b.refl == kSpec) {
    reflect_vjp(d, b.ng, lam_d, &g_d, &g_ng);
  } else {
    // REFR (refr_scatter's expressions; its decisions recomputed).
    const bool into = dot(b.ng, b.n) > 0.0f;
    const float nnt = into ? kNntInto : kNntOut;
    const float ddn = dot(d, b.n);
    const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
    const bool tir = cos2t < 0.0f;
    const float sq = cos2t > 0.0f ? sqrtf(cos2t) : 0.0f;
    const float sgn = into ? 1.0f : -1.0f;
    const float h = sgn * (ddn * nnt + sq);
    const V3 tv = sub(mul(d, nnt), mul(b.ng, h));
    const float rs_t = rsqrt_ieee(dot(tv, tv));
    const V3 td = mul(tv, rs_t);
    const float c = 1.0f - (into ? -ddn : dot(td, b.ng));
    const float re = kR0 + kOneMinusR0 * c * c * c * c * c;
    const float tr = 1.0f - re;
    const float pr = 0.25f + 0.5f * re;
    const bool pick_refl = b.coin < pr || tir;
    float gddn = 0.0f;
    V3 gtd = zero;
    if (!tir) {
      float gre, gpr;
      if (pick_refl) {
        gre = sig_w / pr;
        gpr = -sig_w * re / (pr * pr);
      } else {
        gre = -(sig_w / (1.0f - pr));
        gpr = sig_w * tr / ((1.0f - pr) * (1.0f - pr));
      }
      gre = gre + 0.5f * gpr;
      const float gcc = gre * kOneMinusR0 * 5.0f * (c * c * c * c);
      if (into) {
        gddn = gcc;
      } else {
        gtd = mul(b.ng, -gcc);
        g_ng = mul(td, -gcc);
      }
    }
    if (pick_refl) {
      V3 gd_r, gng_r;
      reflect_vjp(d, b.ng, lam_d, &gd_r, &gng_r);
      g_d = gd_r;
      g_ng = add(g_ng, gng_r);
    } else {
      gtd = add(gtd, lam_d);
    }
    const V3 gtv = norm_vjp(td, rs_t, gtd);
    g_d = add(g_d, mul(gtv, nnt));
    g_ng = sub(g_ng, mul(gtv, h));
    const float gh = -dot(b.ng, gtv);
    gddn = gddn + sgn * nnt * gh;
    const float gsq = sgn * gh;
    const float gcos2t = cos2t > 0.0f ? gsq * 0.5f / sq : 0.0f;
    gddn = gddn + gcos2t * nnt * nnt * 2.0f * ddn;
    g_d = add(g_d, mul(b.n, gddn));
    g_n = mul(d, gddn);
  }

  // n = sign·ng; ng = norm(x − c) on a sphere winner.
  const float sign = dot(b.ng, d) < 0.0f ? 1.0f : -1.0f;
  g_ng = add(g_ng, mul(g_n, sign));
  Pullback out{zero, g_d, zero, 0.0f, 0.0f};
  float4 c4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (b.axis < 0) {
    c4 = sphere_row<kScan>(tab, b.id - p.n_rects);
    const V3 v = sub(b.x, v3(c4.x, c4.y, c4.z));
    const V3 gv = norm_vjp(b.ng, rsqrt_ieee(dot(v, v)), g_ng);
    g_x = add(g_x, gv);
    out.g_c = neg(gv);
  }
  if (!b.hit) return out;
  // x = o + d·t.
  g_x = add(g_x, lam_x);
  out.g_o = g_x;
  out.g_d = add(out.g_d, mul(g_x, b.t));
  float g_t = dot(g_x, d);
  if constexpr (kEst == kMis) {
    // The pickup's weight mp / (mp + p_h), p_h = t² / (A max(|d·ln|,
    // 1e-6)), on a BSDF-sampled hit of the light (a rect).
    if (ec.pick) {
      const V3 ln = ld3(p.ln);
      const float cos_h = dot(d, ln);
      const float cm = fmaxf(fabsf(cos_h), kCosMin);
      const float p_h = (b.t * b.t) / (p.area * cm);
      const float den = ec.mp + p_h;
      out.g_mp = ec.sig_pk * p_h / (den * den);
      const float g_ph = -ec.sig_pk * ec.mp / (den * den);
      g_t = g_t + g_ph * 2.0f * b.t / (p.area * cm);
      if (fabsf(cos_h) >= kCosMin) {
        out.g_d = add(out.g_d, mul(ln, -g_ph * p_h / cm * sgnf(cos_h)));
      }
    }
  }
  if (b.axis >= 0) {
    // t = (k − o[a]) / d[a].
    const int a = b.axis;
    const float da = comp(d, a);
    const float inv = 1.0f / (da != 0.0f ? da : 1.0f);
    add_comp(&out.g_o, a, -(g_t * inv));
    add_comp(&out.g_d, a, -(g_t * b.t * inv));
    return out;
  }
  // t = b ∓ sqrt((r − |m|)(r + |m|)), m = b·d − op, op = c − o, b = op·d
  // (sphere_t's expressions; the root recomputed).
  const V3 op = sub(v3(c4.x, c4.y, c4.z), o);
  const float bq = dot(op, d);
  const V3 m = sub(mul(d, bq), op);
  const float m2 = dot(m, m);
  const float mlen = m2 > 0.0f ? sqrtf(m2) : 0.0f;
  const float r = c4.w;
  const float sdet = sqrtf((r - mlen) * (r + mlen));
  const float eps = fmaxf(kSphereEps, kSphereEpsRel * r);
  const bool near = bq - sdet > eps;
  const float g_sd = near ? -g_t : g_t;
  const float g_det = g_sd * 0.5f / sdet;
  out.g_r = g_det * 2.0f * r;
  const float g_m2 = m2 > 0.0f ? -g_det : 0.0f;
  const V3 g_m = mul(m, 2.0f * g_m2);
  const float g_b = g_t + dot(g_m, d);
  const V3 g_dd = add(mul(g_m, bq), mul(op, g_b));
  const V3 g_op = add(neg(g_m), mul(d, g_b));
  out.g_o = sub(out.g_o, g_op);
  out.g_d = add(out.g_d, g_dd);
  out.g_c = add(out.g_c, g_op);
  return out;
}

// The image-only launch (bk == 0): row 2's kernel body. This kernel and the
// adjoint come in a linear and a tree instance, as row 2's.
template <int kScan, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_geom_image(const __grid_constant__ Params p,
                          const float4* __restrict__ sph, int n_sph,
                          const float4* __restrict__ bvh, int root,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const int* __restrict__ refl,
                          float* __restrict__ out_l,
                          unsigned long long* __restrict__ counts) {
  tab_body<kEst, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,
                        counts);
}

// A tape entry of nee and the codes without carry: the state before bounce
// j, and what its queries found.
struct __align__(16) GeomEntry {
  PathState st;
  Queries q;
};

// nee_textbook's state: the bounce before was diffuse, so its probe counted
// the light (the pickup of the light is suppressed). Its entry keeps the
// flag where GeomEntry's Queries pads its success flag, and the success
// as the sign of the probe's distance (a reached light is at t_safe > 0).
struct TbState {
  V3 o, d, T, A;
  bool suppress;
};
struct __align__(16) TbEntry {
  V3 o, d, T, A;
  int id;
  float t, t_l;  // the nearest hit; the probe's t_safe, or -1 (failed)
  bool suppress;
};

// mis's state: its carry, the p_bsdf of this ray from the diffuse vertex
// before it (0: the pickup is whole). Its entry holds the carry in place of
// the success flag.
struct MisState {
  V3 o, d, T, A;
  float mis_pdf;
};
struct __align__(16) MisEntry {
  V3 o, d, T, A;
  int id;
  float t, t_l, mis_pdf;
};

// The producer's state, its tape entry and their conversions, by estimator.
template <int kEst>
struct GeomTape {
  using State = PathState;
  using Entry = GeomEntry;
  __device__ static Entry entry(const State& st, const Bounce& b) {
    return Entry{st, Queries{b.id, b.t, b.success, b.t_safe}};
  }
  __device__ static State state(const Entry& e) { return e.st; }
  __device__ static Queries queries(const Entry& e) { return e.q; }
  __device__ static State next(const Bounce& b, V3 T, V3 A) {
    return State{b.x, b.new_dir, T, A};
  }
};

template <>
struct GeomTape<kTextbook> {
  using State = TbState;
  using Entry = TbEntry;
  __device__ static Entry entry(const State& st, const Bounce& b) {
    return Entry{st.o, st.d, st.T, st.A, b.id, b.t,
                 b.success ? b.t_safe : -1.0f, st.suppress};
  }
  __device__ static State state(const Entry& e) {
    return State{e.o, e.d, e.T, e.A, e.suppress};
  }
  __device__ static Queries queries(const Entry& e) {
    const bool ok = e.t_l > 0.0f;
    return Queries{e.id, e.t, ok, ok ? e.t_l : 1.0f};
  }
  // A path that goes on was alive after this bounce, so the next pickup is
  // suppressed exactly when this bounce was diffuse.
  __device__ static State next(const Bounce& b, V3 T, V3 A) {
    return State{b.x, b.new_dir, T, A, b.diffuse};
  }
};

template <>
struct GeomTape<kMis> {
  using State = MisState;
  using Entry = MisEntry;
  __device__ static Entry entry(const State& st, const Bounce& b) {
    return Entry{st.o, st.d, st.T, st.A, b.id, b.t,
                 b.success ? b.t_safe : -1.0f, st.mis_pdf};
  }
  __device__ static State state(const Entry& e) {
    return State{e.o, e.d, e.T, e.A, e.mis_pdf};
  }
  __device__ static Queries queries(const Entry& e) {
    const bool ok = e.t_l > 0.0f;
    return Queries{e.id, e.t, ok, ok ? e.t_l : 1.0f};
  }
  // The carry of the next bounce: this diffuse bounce's continuation pdf.
  __device__ static State next(const Bounce& b, V3 T, V3 A) {
    return State{b.x, b.new_dir, T, A, b.diffuse ? b.pdf_cont : 0.0f};
  }
};

// render_lane's direct term of nee_textbook and mis at bounce b with
// throughput T: 0 where the probe did not reach the light.
__device__ __forceinline__ V3 direct_of(const Bounce& b, V3 T, V3 e_light) {
  V3 direct = v3(0.0f, 0.0f, 0.0f);
  if (b.success) {
    direct = v3(((b.w_nee * T.x) * b.alb.x) * e_light.x,
                ((b.w_nee * T.y) * b.alb.y) * e_light.y,
                ((b.w_nee * T.z) * b.alb.z) * e_light.z);
  }
  return direct;
}

// The adjoint launch.
template <int kScan, int kEst>
__global__ void __launch_bounds__(kBlock)
    megakernel_geom(const __grid_constant__ Params p,
                    const float4* __restrict__ sph, int n_sph,
                    const float4* __restrict__ bvh, int root,
                    const float* __restrict__ alb,
                    const float* __restrict__ emi,
                    const int* __restrict__ refl,
                    const float* __restrict__ g_img,
                    float* __restrict__ partials, float* __restrict__ out_l,
                    unsigned long long* __restrict__ counts) {
  // Dynamic shared memory: a linear table's rows (its root leaf, two float4
  // a row: staged_tab's copy, placed ahead of the slots, with one barrier
  // for both), then a row of gradient slots a warp.
  extern __shared__ float4 smem4[];
  SphereTab tab = sphere_tab(sph, n_sph, refl, bvh, root);
  const int n_staged = kScan == kScanLinear ? 2 * ((-1 - root) >> 16) : 0;
  for (int i = threadIdx.x; i < n_staged; i += kBlock) smem4[i] = tab.rows[i];
  if constexpr (kScan == kScanLinear) tab.rows = smem4;
  float* rows = reinterpret_cast<float*>(smem4 + n_staged);
  const int k_obj = p.n_rects + n_sph;
  const int n_slots = 6 * k_obj + 4 * n_sph;
  for (int i = threadIdx.x; i < kWarps * n_slots; i += kBlock) rows[i] = 0.0f;
  __syncthreads();
  float* my_row = rows + (threadIdx.x >> 5) * n_slots;
  const TableMaterials mats{alb, emi};
  const LaneRange lr = lane_range(p);
  const LightFrame lf = light_frame(p);
  const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
  const V3 gc = lr.in_range ? ld3(g_img + 3 * lr.pix) : zero;
  const V3 cam_o = ld3(p.cam_o);
  constexpr bool kDirect = direct_term(kEst);
  // nee_textbook and mis: the light's emission (their direct term), and the
  // direct terms' light-emission terms of this lane.
  V3 e_light = zero, g_le = zero;
  if constexpr (kDirect) e_light = mats.emission(p.light_id);

  using Tape = GeomTape<kEst>;
  using State = typename Tape::State;
  typename Tape::Entry tape[2][kSeg];
  State ck[kCkpt];
  TapeCtl c;
  tape_start(&c, lr.s, lr.in_range && lr.s < lr.s_stop);
  State st;  // the producer's state before its next bounce
  const auto spawn = [&] {
    st = State{cam_o, spawn_dir(p, lr.px, lr.py, lr.pid_base + c.s), one,
               zero};
  };
  if (c.tracing) spawn();
  V3 L = zero;  // the lane's radiance sum over its samples (the image)
  V3 lam_o = zero, lam_d = zero;
  float lam_mp = 0.0f;  // mis: dL/d of the carry's pdf_cont
  uint32_t n_ext = 0, n_prb = 0, n_rep = 0, n_vjp = 0, n_long = 0;

  while (__any_sync(kFull, tape_active(c))) {
    Contrib ct;
    ct.key = -1;
    if (c.tracing) {  // pass A, or a segment replay
      const int j = c.depth + 1;
      const Bounce b = bounce<TableMaterials, kScan, kEst>(
          p, tab, mats, lf, st.o, st.d, lr.pid_base + c.s, j, lr.pix,
          NoGuide{});
      tape[c.pbuf][tape_slot(j)] = Tape::entry(st, b);
      // render_lane's pickup (and direct term), in its order.
      V3 pick = v3(st.T.x * b.emi.x, st.T.y * b.emi.y, st.T.z * b.emi.z);
      if constexpr (kEst == kTextbook) {
        if (st.suppress && b.hit && b.id == p.light_id) pick = zero;
      } else if constexpr (kEst == kMis) {
        float w_b;
        if (mis_pickup(p, lf, st.d, b, st.mis_pdf, &w_b)) pick = mul(pick, w_b);
      }
      if constexpr (kDirect) pick = add(pick, direct_of(b, st.T, e_light));
      const State next = Tape::next(
          b, mul(v3(st.T.x * b.f.x, st.T.y * b.f.y, st.T.z * b.f.z), b.w),
          add(st.A, pick));
      c.depth = j;
      if (c.d_stop == 0) {  // pass A
        tape_checkpoint(ck, j, st);
        L = add(L, pick);
        n_ext += 1;
        if constexpr (est_base(kEst) == kNee) {
          n_prb += (b.survive && b.diffuse) ? 1u : 0u;
        } else if constexpr (est_base(kEst) == kMixture) {
          n_prb += (b.survive && b.diffuse && b.take) ? 1u : 0u;
        } else if constexpr (kDirect) {
          n_prb += b.diffuse ? 1u : 0u;  // before RR
        }
        if (b.survive && j < p.max_bounces) {
          st = next;
        } else {
          n_long += j > kSeg ? 1u : 0u;
          tape_end_pass_a(&c, next.A);
        }
      } else {
        n_rep += 1;
        if (j == c.d_stop) {
          tape_end_replay(&c);
        } else {
          st = next;
        }
      }
    }
    if (c.sweeping) {  // the VJP bounce j
      const auto e = tape[c.sbuf][tape_slot(c.j)];
      if (c.fresh) {
        lam_o = zero;
        lam_d = zero;
        if constexpr (kEst == kMis) lam_mp = 0.0f;
      }
      const State se = Tape::state(e);
      const Queries q = Tape::queries(e);
      const V3 o = se.o, d = se.d, T = se.T;
      const uint32_t pid = lr.pid_base + c.s_sw;
      const Bounce b = bounce<TableMaterials, kScan, kEst, NoGuide, true>(
          p, tab, mats, lf, o, d, pid, c.j, lr.pix, NoGuide{}, &q);
      const V3 LA = c.LA_sw;
      V3 pick = v3(T.x * b.emi.x, T.y * b.emi.y, T.z * b.emi.z);
      // The pickup's weight (nee_textbook: 0 where it is suppressed; mis:
      // its balance weight where the light is hit by a BSDF sample).
      float emit_f = 1.0f;
      EstCot ec{0.0f, 0.0f, 0.0f, 0.0f, false};
      if constexpr (kEst == kTextbook) {
        if (se.suppress && b.hit && b.id == p.light_id) {
          pick = zero;
          emit_f = 0.0f;
        }
      } else if constexpr (kEst == kMis) {
        float w_b = 1.0f;
        ec.pick = mis_pickup(p, lf, d, b, se.mis_pdf, &w_b);
        if (ec.pick) {
          pick = mul(pick, w_b);
          emit_f = w_b;
          ec.sig_pk = gc.x * T.x * b.emi.x + gc.y * T.y * b.emi.y +
                      gc.z * T.z * b.emi.z;
        }
        ec.mp = se.mis_pdf;
        ec.lam_mp = lam_mp;
      }
      float gate = 0.0f;  // the direct term's weight
      if constexpr (kDirect) {
        pick = add(pick, direct_of(b, T, e_light));
        if (b.success) {
          gate = b.w_nee;
          ec.sig_tb = gc.x * T.x * b.alb.x * e_light.x +
                      gc.y * T.y * b.alb.y * e_light.y +
                      gc.z * T.z * b.alb.z * e_light.z;
        }
      }
      const V3 A_new = add(se.A, pick);
      n_vjp += 1;
      const V3 fw = mul(b.f, b.w);
      const V3 TS = v3(fw.x != 0.0f ? (LA.x - A_new.x) / fw.x : 0.0f,
                       fw.y != 0.0f ? (LA.y - A_new.y) / fw.y : 0.0f,
                       fw.z != 0.0f ? (LA.z - A_new.z) / fw.z : 0.0f);
      const float f_scale = b.inv_p * b.w;
      const float s_ta = gc.x * TS.x * b.alb.x + gc.y * TS.y * b.alb.y +
                         gc.z * TS.z * b.alb.z;
      const float s_am =
          b.rr_scaled ? s_ta * b.w * (-(b.inv_p * b.inv_p)) : 0.0f;
      const float p_max = fmaxf(b.alb.x, fmaxf(b.alb.y, b.alb.z));
      const float eq_x = b.alb.x == p_max ? 1.0f : 0.0f;
      const float eq_y = b.alb.y == p_max ? 1.0f : 0.0f;
      const float eq_z = b.alb.z == p_max ? 1.0f : 0.0f;
      const float n_eq = eq_x + eq_y + eq_z;
      const float am = s_am / (n_eq > 0.0f ? n_eq : 1.0f);
      const Pullback pb = bounce_vjp<kScan, kEst>(p, tab, b, o, d, lam_o,
                                                  lam_d, s_ta * b.inv_p, ec);
      ct.key = b.id;
      ct.v[0] = gc.x * TS.x * f_scale + eq_x * am;
      ct.v[1] = gc.y * TS.y * f_scale + eq_y * am;
      ct.v[2] = gc.z * TS.z * f_scale + eq_z * am;
      if constexpr (kEst == kTextbook || kEst == kMis) {
        ct.v[3] = gc.x * T.x * emit_f;
        ct.v[4] = gc.y * T.y * emit_f;
        ct.v[5] = gc.z * T.z * emit_f;
      } else {
        ct.v[3] = gc.x * T.x;
        ct.v[4] = gc.y * T.y;
        ct.v[5] = gc.z * T.z;
      }
      if constexpr (kDirect) {
        ct.v[0] += gc.x * gate * T.x * e_light.x;
        ct.v[1] += gc.y * gate * T.y * e_light.y;
        ct.v[2] += gc.z * gate * T.z * e_light.z;
        g_le = add(g_le, v3(gc.x * gate * T.x * b.alb.x,
                            gc.y * gate * T.y * b.alb.y,
                            gc.z * gate * T.z * b.alb.z));
      }
      ct.v[6] = pb.g_c.x;
      ct.v[7] = pb.g_c.y;
      ct.v[8] = pb.g_c.z;
      ct.v[9] = pb.g_r;
      lam_o = pb.g_o;
      lam_d = pb.g_d;
      if constexpr (kEst == kMis) lam_mp = pb.g_mp;
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    warp_accumulate(ct, my_row, p.n_rects, k_obj);
  }
  if constexpr (kDirect) {
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

  if (lr.in_range) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    out_l[3 * lane + 0] = L.x;
    out_l[3 * lane + 1] = L.y;
    out_l[3 * lane + 2] = L.z;
  }
  unsigned long long c5[5] = {n_ext, n_prb, n_rep, n_vjp, n_long};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c5[i] += __shfl_down_sync(kFull, c5[i], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i < 5; ++i) atomicAdd(&counts[i], c5[i]);
  }
  block_partials(rows, n_slots, partials);
}

// Every instance's type (spelled out: a decltype of one instance would make
// it an instance of each translation unit that includes this header).
using GeomImage = void (*)(Params, const float4*, int, const float4*, int,
                           const float*, const float*, const int*, float*,
                           unsigned long long*);
using GeomAdjoint = void (*)(Params, const float4*, int, const float4*, int,
                             const float*, const float*, const int*,
                             const float*, float*, float*,
                             unsigned long long*);

// An estimator's two launches for one scan.
struct GeomKernels {
  GeomImage image;
  GeomAdjoint adjoint;
};

// Estimator kEst's kernels for the table's scan: its tree (tree) or its
// linear scan.
template <int kEst>
GeomKernels geom_of_scan(bool tree) {
  return tree ? GeomKernels{megakernel_geom_image<kScanTree, kEst>,
                            megakernel_geom<kScanTree, kEst>}
              : GeomKernels{megakernel_geom_image<kScanLinear, kEst>,
                            megakernel_geom<kScanLinear, kEst>};
}

// The host entry points' body (their arguments, kernels_of the entry's
// kernels of an estimator code and scan, {nullptr, nullptr} for a code it
// has no instance of): checks, fills Params, launches the image-only
// kernel (bk == 0) or the adjoint and reduce_partials on `stream`, and
// returns the first launch error.
inline int launch_geom(GeomKernels (*kernels_of)(int est, bool tree), int est,
                       float mixture_q, const float* rect_geom,
                       const int* rect_axis, int n_rects, const float* light_f,
                       int light_id, const float* cam_f, unsigned seed,
                       int width, int height, int spp, int g, int per,
                       unsigned s0, int pix0, int n_pix_loc,
                       int rr_start_depth, int max_bounces, const float* sph,
                       int n_spheres, const float* bvh, int root,
                       const float* alb, const float* emi, const int* refl,
                       int bk, const float* g_img, float* partials,
                       long long n_partials, float* out, float* out_l,
                       unsigned long long* counts, void* stream) {
  Params p;
  const bool tree = root >= 0;
  const GeomKernels kernels = kernels_of(est, tree);
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      kernels.image == nullptr || n_spheres < 1 ||
      n_spheres > kMaxGeomSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mixture_q = mixture_q;
  const int n_blocks = grid_of(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* sph4 = reinterpret_cast<const float4*>(sph);
  const float4* bvh4 = reinterpret_cast<const float4*>(bvh);
  cudaError_t err = cudaSuccess;
  if (!bk) {
    kernels.image<<<n_blocks, kBlock, 0, st>>>(
        p, sph4, n_spheres, bvh4, root, alb, emi, refl, out_l, counts);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_slots = 6 * (n_rects + n_spheres) + 4 * n_spheres;
  if (g_img == nullptr ||
      n_partials < static_cast<long long>(n_blocks) * n_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * kWarps * n_slots +
                      (tree ? 0 : 2 * sizeof(float4) * n_spheres);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernels.adjoint,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernels.adjoint<<<n_blocks, kBlock, smem, st>>>(
      p, sph4, n_spheres, bvh4, root, alb, emi, refl, g_img, partials,
      out_l, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of the three entry points after the estimator. Geometry,
// light and camera as fill_params (megakernel_common.cuh) reads them, in
// host memory. On the device: sph (n_spheres, 4) float32 [cx, cy, cz, r]
// and its tree bvh (root its root link) as spt_megakernel_tab takes them;
// alb, emi (n_rects + n_spheres, 3) float32 and refl (n_rects + n_spheres,)
// int32, rects first; out_l (n_pix_loc·g, 3) float32 for the shard's pixels
// [pix0, pix0 + n_pix_loc) (unsharded: all of them); counts 5 uint64,
// zeroed: [extend, probe] of pass A, replayed bounces, VJP bounces, paths
// longer than the tape (bk == 0: the image-only launch, [extend, probe]
// only). With bk != 0 also g_img (n_pix_loc, 3) float32, the shard's
// cotangent rows; partials: scratch of n_partials floats, at least
// ceil(n_pix_loc·g / 128)·n_slots with n_slots = 6·(n_rects + n_spheres)
// + 4·n_spheres; out: n_slots floats, d/d albedo (K, 3), d/d emission
// (K, 3), d/d sphere rows (S, 4). 1 to kMaxGeomSpheres spheres. Launches on
// `stream`; returns the first launch error (cudaError_t); a code the entry
// has no instance of is refused (cudaErrorInvalidValue).
#define SPT_GEOM_PARAMS                                                     \
  const float *rect_geom, const int *rect_axis, int n_rects,                \
      const float *light_f, int light_id, const float *cam_f,               \
      unsigned seed, int width, int height, int spp, int g, int per,        \
      unsigned s0, int pix0, int n_pix_loc, int rr_start_depth,             \
      int max_bounces, const float *sph, int n_spheres, const float *bvh,   \
      int root, const float *alb, const float *emi, const int *refl,        \
      int bk, const float *g_img, float *partials, long long n_partials,    \
      float *out, float *out_l, unsigned long long *counts, void *stream
#define SPT_GEOM_ARGS                                                       \
  rect_geom, rect_axis, n_rects, light_f, light_id, cam_f, seed, width,     \
      height, spp, g, per, s0, pix0, n_pix_loc, rr_start_depth,             \
      max_bounces, sph, n_spheres, bvh, root, alb, emi, refl, bk, g_img,    \
      partials, n_partials, out, out_l, counts, stream
