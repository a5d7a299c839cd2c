// Geometry and material adjoint of the sphere-table megakernel: the kernel
// templates megakernel_geom<kScan, kEst> and megakernel_geom_image<kScan,
// kEst> and the body of their three host entry points, spt_megakernel_geom
// (megakernel_geom.cu: nee), spt_megakernel_geom_est (megakernel_geom_est.cu:
// cosine, uniform, uniform_corrected, mixture, and nee and mixture with
// light_sample_mode='glibc_overflow') and spt_megakernel_geom_direct
// (megakernel_geom_direct.cu: the direct-term estimators nee_textbook and
// mis). Axis-aligned rects (unrolled) and spheres (the runtime table) with
// DIFF, SPEC and REFR materials and one parallelogram light. The adjoint's
// body is megakernel_geom_body.cuh, which megakernel_geom_ext.cu's
// instances include too: general quads (the light may be one) and GLOS
// rects and quads, through the `if constexpr` branches of the code's
// scene flags below (the quad winner's plane, the quad light's plane in
// `nee_vjp_ext`, the Phong lobe in `lobe_vjp`).
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

// nee_vjp on the _ext instances' scenes (kEst with kWithQuads): the light
// object may be a quad (the probe's distance to its plane through its
// unit normal), and at a GLOS bounce (kWithGlos) the weight's BRDF is the
// lobe's, (gl + 2) / (2π) max(dl·gm, 0)^gl max(dl·n, 0) in place of
// |dl·n| / π, and mis's p_b its pdf (gl + 1) / (2π) max(dl·gm, 0)^gl.
// Adds the cotangents of x to *g_x and, at a GLOS bounce, of the lobe's
// axis gm to *g_gm (null elsewhere); returns that of n.
// ops/megakernel_geom.py `_nee_vjp`. A function apart from nee_vjp, so
// that the instances without quads keep their code.
template <bool kBalance, int kEst>
__device__ __forceinline__ V3 nee_vjp_ext(const Params& p,
                                          const SphereTab& tab,
                                          const Bounce& b, float sig,
                                          V3 lam_dl, V3* g_x, V3* g_gm) {
  const V3 ln = ld3(p.ln);
  const V3 vl = sub(b.lp, b.x);
  const float rs_l = rsqrt_ieee(dot(vl, vl));
  const V3 dl = mul(vl, rs_l);
  // The light object's plane: its unit normal e and 1 / (dl·e). The
  // probe's distance tl is the one the probe found (t_safe): the plane's
  // distance from x but for rounding, and finite where the probe runs in
  // the light's plane (a bounce on a quad light whose sampler is the quad,
  // which the plain version's plane distance leaves at 0 / 0).
  const QuadTab& qt = *tab.quads;
  V3 e;
  if (qt.light >= 0) {
    e = ld3(qt.q[qt.light].ng);
  } else {
    const int a_l = p.rects[p.light_id].axis;
    e = v3(a_l == 0 ? 1.0f : 0.0f, a_l == 1 ? 1.0f : 0.0f,
           a_l == 2 ? 1.0f : 0.0f);
  }
  const float den = dot(dl, e);
  const float inv_l = 1.0f / (den != 0.0f ? den : 1.0f);
  const float tl = b.t_safe;
  const float a1 = p.area * dot(dl, ln);
  const float q = fabsf(a1) / (tl * tl);
  const float cs = dot(dl, b.n);
  float bb = fabsf(cs) * kInvPi;
  const bool glos = with_glos(kEst) && b.glos;
  float pw = 0.0f, dpw = 0.0f, br = 0.0f, mc = 0.0f;
  if (glos) {
    const float cg = dot(dl, b.gm);
    pw = pow_safe(cg, b.gl);
    dpw = pw > 0.0f ? b.gl * pw / cg : 0.0f;
    br = (b.gl + 2.0f) * kInv2Pi * pw;
    mc = fmaxf(cs, 0.0f);
    bb = br * mc;
  }
  float gcs_b = 0.0f, gtl_b = 0.0f, gcl_b = 0.0f, g_pw = 0.0f;
  if constexpr (kBalance) {
    const float cl = dot(dl, ln);
    const float cm = fmaxf(fabsf(cl), kCosMin);
    const float p_l = (tl * tl) / (p.area * cm);
    const float p_b =
        glos ? (b.gl + 1.0f) * kInv2Pi * pw : fmaxf(cs, 0.0f) * kInvPi;
    const float den = p_l + p_b;
    const float g_bal = sig * (q * bb);
    sig = sig * (p_l / den);
    const float g_pl = g_bal * p_b / (den * den);
    const float g_pb = -g_bal * p_l / (den * den);
    gtl_b = g_pl * 2.0f * tl / (p.area * cm);
    gcl_b = fabsf(cl) >= kCosMin ? -g_pl * p_l / cm * sgnf(cl) : 0.0f;
    if (glos) {
      g_pw = g_pb * (b.gl + 1.0f) * kInv2Pi;
    } else {
      gcs_b = cs >= 0.0f ? g_pb * kInvPi : 0.0f;
    }
  }
  const float gq = sig * bb;
  const float gb = sig * q;
  float gcs = gb * kInvPi * sgnf(cs) + gcs_b;
  float g_cg = 0.0f;
  if (glos) {
    gcs = cs >= 0.0f ? gb * br : 0.0f;
    g_cg = (gb * mc * (b.gl + 2.0f) * kInv2Pi + g_pw) * dpw;
    *g_gm = add(*g_gm, mul(dl, g_cg));
  }
  const float ga1 = gq / (tl * tl) * sgnf(a1);
  const float gtl = -2.0f * gq * q / tl + gtl_b;
  V3 gdl = add(add(lam_dl, mul(ln, ga1 * p.area + gcl_b)), mul(b.n, gcs));
  if (glos) gdl = add(gdl, mul(b.gm, g_cg));
  const V3 g_n = mul(dl, gcs);
  *g_x = sub(*g_x, mul(e, gtl * inv_l));
  gdl = sub(gdl, mul(e, gtl * tl * inv_l));
  *g_x = sub(*g_x, norm_vjp(dl, rs_l, gdl));
  return g_n;
}

// A GLOS bounce's continuation d' = norm(gu·g_alpha + gv·g_beta +
// gm·g_wz), w = (gl + 2) / (gl + 1) max(d'·n, 0) (mis: pdf_cont = (gl + 1)
// / (2π) max(d'·gm, 0)^gl) in the frame of gm = d mirrored about n (its
// axis pick and the draws fixed), pulled back under (lam_d, sig_w, mis's
// lam_mp): adds the cotangent of gm to *g_gm, returns that of n.
// ops/megakernel_geom.py `_lobe_vjp`.
template <int kEst>
__device__ __forceinline__ V3 lobe_vjp(const Bounce& b, V3 lam_d, float sig_w,
                                       float lam_mp, V3* g_gm) {
  const V3 gm = b.gm;
  const V3 a = fabsf(gm.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 cr = cross(a, gm);
  const float rs_u = rsqrt_ieee(dot(cr, cr));
  const V3 gu = mul(cr, rs_u);
  const V3 gv = cross(gm, gu);
  const V3 sv = add(add(mul(gu, b.g_alpha), mul(gv, b.g_beta)),
                    mul(gm, b.g_wz));
  const float rs_s = rsqrt_ieee(dot(sv, sv));
  const V3 g_dir = mul(sv, rs_s);
  const float g_cn =
      dot(g_dir, b.n) >= 0.0f ? sig_w * ((b.gl + 2.0f) / (b.gl + 1.0f)) : 0.0f;
  V3 lam_s = add(lam_d, mul(b.n, g_cn));
  const V3 g_n = mul(g_dir, g_cn);
  if constexpr (est_base(kEst) == kMis) {
    const float cg = dot(g_dir, gm);
    const float pw = pow_safe(cg, b.gl);
    const float g_c =
        pw > 0.0f ? lam_mp * (b.gl + 1.0f) * kInv2Pi * (b.gl * pw / cg) : 0.0f;
    lam_s = add(lam_s, mul(gm, g_c));
    *g_gm = add(*g_gm, mul(g_dir, g_c));
  }
  const V3 gsv = norm_vjp(g_dir, rs_s, lam_s);
  V3 ggu = mul(gsv, b.g_alpha);
  const V3 ggv = mul(gsv, b.g_beta);
  *g_gm = add(*g_gm, add(mul(gsv, b.g_wz), cross(gu, ggv)));
  ggu = add(ggu, cross(ggv, gm));
  const V3 gcr = norm_vjp(gu, rs_u, ggu);
  *g_gm = add(*g_gm, cross(gcr, a));
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
    if constexpr (with_quads(kEst)) {
      g_n = nee_vjp_ext<false, kEst>(p, tab, b, sig_w, lam_d, &g_x, nullptr);
    } else {
      g_n = nee_vjp<false>(p, b, sig_w, lam_d, &g_x);
    }
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
    constexpr bool kCosOut =
        est_base(kEst) == kUniformCorrected || est_base(kEst) == kMis;
    V3 lam_s = lam_d, gn_cd = zero;
    if constexpr (kCosOut) {
      // The cotangent of d'·n.
      const V3 dn = mul(sv, rs_s);
      float g_cd = 0.0f;
      if (dot(dn, b.n) >= 0.0f) {
        g_cd = est_base(kEst) == kMis ? ec.lam_mp * kInvPi : 2.0f * sig_w;
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
        if constexpr (with_quads(kEst)) {
          g_n = add(g_n, nee_vjp_ext<est_base(kEst) == kMis, kEst>(
                             p, tab, b, ec.sig_tb, zero, &g_x, nullptr));
        } else {
          g_n = add(g_n, nee_vjp<kEst == kMis>(p, b, ec.sig_tb, zero, &g_x));
        }
      }
    }
  } else if (with_glos(kEst) && b.glos) {
    // GLOS: the lobe's continuation and (nee_textbook, mis) the direct
    // term, both through gm = d mirrored about n (a GLOS winner is a rect
    // or a quad: GLOS spheres are refused).
    V3 g_gm = zero;
    g_n = lobe_vjp<kEst>(b, lam_d, sig_w, ec.lam_mp, &g_gm);
    if constexpr (direct_term(kEst)) {
      if (b.success) {
        g_n = add(g_n, nee_vjp_ext<est_base(kEst) == kMis, kEst>(
                           p, tab, b, ec.sig_tb, zero, &g_x, &g_gm));
      }
    }
    V3 gn_r;
    reflect_vjp(d, b.n, g_gm, &g_d, &gn_r);
    g_n = add(g_n, gn_r);
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
  bool quad = false;  // a quad winner (kWithQuads; its axis is -1 too)
  if constexpr (with_quads(kEst)) {
    quad = b.axis < 0 && b.id - p.n_rects < tab.quads->n;
  }
  if (b.axis < 0 && !quad) {
    int row = b.id - p.n_rects;
    if constexpr (with_quads(kEst)) row -= tab.quads->n;
    c4 = sphere_row<kScan>(tab, row);
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
  if constexpr (est_base(kEst) == kMis) {
    // The pickup's weight mp / (mp + p_h), p_h = t² / (A max(|d·ln|,
    // 1e-6)), on a BSDF-sampled hit of the light (a rect or a quad).
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
  if constexpr (with_quads(kEst)) {
    if (quad) {
      // t = ((c − o)·ng) / (d·ng), ng the quad's unit normal.
      const float dn = dot(d, b.ng);
      const float inv = 1.0f / (dn != 0.0f ? dn : 1.0f);
      out.g_o = sub(out.g_o, mul(b.ng, g_t * inv));
      out.g_d = sub(out.g_d, mul(b.ng, g_t * b.t * inv));
      return out;
    }
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

// Whether bounce b probed the light: a diffuse bounce, or (kGlos) a GLOS
// one.
template <bool kGlos>
__device__ __forceinline__ bool probed(const Bounce& b) {
  if constexpr (kGlos) {
    return b.diffuse || b.glos;
  } else {
    return b.diffuse;
  }
}

// The producer's state, its tape entry and their conversions, by estimator
// (its est_base) and whether its scenes hold GLOS objects.
template <int kEst, bool kGlos>
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

template <bool kGlos>
struct GeomTape<kTextbook, kGlos> {
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
  // suppressed exactly when this bounce probed the light (diffuse or GLOS).
  __device__ static State next(const Bounce& b, V3 T, V3 A) {
    return State{b.x, b.new_dir, T, A, probed<kGlos>(b)};
  }
};

template <bool kGlos>
struct GeomTape<kMis, kGlos> {
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
  // The carry of the next bounce: this diffuse (or GLOS) bounce's
  // continuation pdf.
  __device__ static State next(const Bounce& b, V3 T, V3 A) {
    return State{b.x, b.new_dir, T, A, probed<kGlos>(b) ? b.pdf_cont : 0.0f};
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
  constexpr const float* gloss = nullptr;
  constexpr const QuadTab* quads = nullptr;
#include "megakernel_geom_body.cuh"
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

// Launches kernels.image (bk == 0) or kernels.adjoint and reduce_partials
// on `stream` for the Params p of a scene of n_objects objects, n_spheres
// of them spheres (its tree if `tree`); `scene` are the kernels' arguments
// after Params and before the outputs. Returns the first launch error.
template <class Kernels, class... Scene>
inline int launch_geom_kernels(const Kernels& kernels, const Params& p,
                               bool tree, int n_objects, int n_spheres,
                               int bk, const float* g_img, float* partials,
                               long long n_partials, float* out, float* out_l,
                               unsigned long long* counts, void* stream,
                               Scene... scene) {
  const int n_blocks = grid_of(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (!bk) {
    kernels.image<<<n_blocks, kBlock, 0, st>>>(p, scene..., out_l, counts);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_slots = 6 * n_objects + 4 * n_spheres;
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
  kernels.adjoint<<<n_blocks, kBlock, smem, st>>>(p, scene..., g_img,
                                                  partials, out_l, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
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
  return launch_geom_kernels(
      kernels, p, tree, n_rects + n_spheres, n_spheres, bk, g_img, partials,
      n_partials, out, out_l, counts, stream,
      reinterpret_cast<const float4*>(sph), n_spheres,
      reinterpret_cast<const float4*>(bvh), root, alb, emi, refl);
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
