// Geometry and material adjoint of the sphere-table megakernel, `nee`
// estimator, axis-aligned rects (unrolled) and spheres (the runtime table)
// with DIFF, SPEC and REFR materials and one parallelogram light.
//
// Replaces the Pallas TPU kernel of small_pathtracer_tpu/ops/megakernel_geom.py:
// `build_geom_grad_kernel`, as `_build_geom_run` builds it for `geom_run` /
// `geom_vjp` (its `pallas_call` at :1488). Given the per-pixel cotangent g
// of the radiance sum I, it returns the pathwise interior cotangents of
// sum(g·I) with respect to every sphere's (center, radius) and every
// object's (albedo, emission). With bk == 0 it only renders I (the
// image-only launch of a fit step): the TPU kernel's pass A alone, which
// is row 2's loop body (`tab_body<kNee>` of megakernel_lane.cuh, the NEE
// fold on), so it is megakernel_nee_tab's image, counts and time.
// Row 12 (`geom_train_step_sharded`, megakernel_geom.py:1636, its
// `pallas_call` at :1686) runs both launches on one rank's shard lanes
// (`lane_range` with pix0), the same lanes and seed for the two, so the
// loss and the gradient share their paths; g_img holds the shard's pixel
// rows only. The sums over the mesh are torch.distributed all-reduces in
// ops/megakernel_geom.py.
//
// Algorithm: per sample, pass A traces the path once, latches its radiance
// L and its depth D, and tapes the state (o, d, T, A) before each bounce in
// the lane's local memory (megakernel_tape.cuh: a segment of kSeg bounces a
// buffer, checkpoints and segment replays for longer paths). Then the
// sweep runs bounce j = D..1 once each from the tape as a VJP bounce,
// carrying λ = (dL/do, dL/dd) of the state after bounce j. A VJP bounce
// re-evaluates bounce j on the taped (o, d) and adds
//   - the material terms of the material adjoint (megakernel_vjp.cuh):
//     d/d albedo with the RR 1/p term split over the channels tied at p_max,
//     and d/d emission, from T_j·S_{j+1} = (L − A_{j+1}) / (f_j·w_j);
//   - the pullback of the bounce's continuous map (o, d, c, r) -> (x, d', w)
//     under (λ_x, λ_d, σ_w), σ_w = dL/dw_j = Σ_c g_c·T_j S_{j+1}·albedo_c·inv_p
//     (`bounce_vjp` below): the winner sphere's (c, r) cotangent, and the new
//     λ for bounce j-1. The TPU kernel pulls back with jax.vjp inside the
//     kernel; here the pullback is derived by hand, the same formulas in the
//     same order as ops/megakernel_geom.py `bounce_vjp`, which the tests hold
//     against torch.autograd branch by branch.
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
// (PERF.md).
//
// Design: one thread per lane on the forward's lane layout (blocks of 128).
// Every bounce, of pass A, a replay or a VJP bounce, is `bounce` of
// megakernel_lane.cuh, render_lane's own, and the library is built with
// --fmad=false, so pass A's image and [extend, probe] counts are
// megakernel_nee_tab's (pass A leaves the NEE fold out: it changes
// neither), and a replay or a VJP bounce retraces pass A. A lane traces one
// segment while it sweeps the one before (two tape buffers). A warp loops
// while any of its lanes is active, so all 32 lanes meet once an iteration
// at `warp_accumulate`, which sums the VJP bounces' contributions by winner
// object into the warp's row of gradient slots in shared memory in a fixed
// order. The block sums its four rows in a fixed order into one row of
// per-block partials and `reduce_partials` sums those rows in a fixed
// order: the gradient has the same bits from run to run, without
// per-thread columns and without atomics.
//
// What bounds it: operations. The gradient needs pass A's bounces (a
// nearest-hit query and the shading each), its shadow probes, and one
// pullback of a few hundred operations a bounce; the algorithm adds each
// VJP bounce's shading and the segment replays. Bytes are the cotangent
// image, the tables, the partials and the tape (64 bytes a bounce, written
// once and read once).

#include "megakernel_lane.cuh"
#include "megakernel_tape.cuh"

namespace {

constexpr int kMaxGeomSpheres = 1024;

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
};

// The pullback of the bounce's continuous map (o, d, c, r) -> (x, d', w),
// every discrete choice fixed by the primal b, under (lam_x, lam_d, sig_w):
// ops/megakernel_geom.py `bounce_vjp`, per lane.
template <int kScan>
__device__ __forceinline__ Pullback bounce_vjp(const Params& p,
                                            const SphereTab& tab,
                                            const Bounce& b, V3 o, V3 d,
                                            V3 lam_x, V3 lam_d, float sig_w) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 g_x = zero, g_n = zero, g_ng = zero, g_d = zero;
  if (b.diffuse && b.success) {
    // d' = dl = norm(lp − x), w = |A·(dl·ln)| / tl² · |dl·n| / π.
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
    const float gq = sig_w * bb;
    const float gb = sig_w * q;
    const float gcs = gb * kInvPi * sgnf(cs);
    const float ga1 = gq / (tl * tl) * sgnf(a1);
    const float gtl = -2.0f * gq * q / tl;
    V3 gdl = add(add(lam_d, mul(ln, ga1 * p.area)), mul(b.n, gcs));
    g_n = mul(dl, gcs);
    add_comp(&g_x, a_l, -(gtl * inv_l));
    add_comp(&gdl, a_l, -(gtl * tl * inv_l));
    g_x = sub(g_x, norm_vjp(dl, rs_l, gdl));
  } else if (b.diffuse) {
    // d' = the cosine sample in the frame of n, w = 1.
    const V3 a = fabsf(b.n.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    const V3 cr = cross(a, b.n);
    const float rs_u = rsqrt_ieee(dot(cr, cr));
    const V3 fu = mul(cr, rs_u);
    const V3 fv = cross(b.n, fu);
    const V3 sv = add(add(mul(fu, b.alpha), mul(fv, b.beta)), mul(b.n, b.wz));
    const float rs_s = rsqrt_ieee(dot(sv, sv));
    const V3 gsv = norm_vjp(mul(sv, rs_s), rs_s, lam_d);
    V3 gfu = mul(gsv, b.alpha);
    const V3 gfv = mul(gsv, b.beta);
    g_n = add(mul(gsv, b.wz), cross(fu, gfv));
    gfu = add(gfu, cross(gfv, b.n));
    const V3 gcr = norm_vjp(fu, rs_u, gfu);
    g_n = add(g_n, cross(gcr, a));
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
  Pullback out{zero, g_d, zero, 0.0f};
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
  const float g_t = dot(g_x, d);
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
template <int kScan>
__global__ void __launch_bounds__(kBlock)
    megakernel_geom_image(const __grid_constant__ Params p,
                          const float4* __restrict__ sph, int n_sph,
                          const float4* __restrict__ bvh, int root,
                          const float* __restrict__ alb,
                          const float* __restrict__ emi,
                          const int* __restrict__ refl,
                          float* __restrict__ out_l,
                          unsigned long long* __restrict__ counts) {
  tab_body<kNee, kScan>(p, sph, n_sph, bvh, root, alb, emi, refl, out_l,
                        counts);
}

// A tape entry: the state before bounce j, and what its queries found.
struct __align__(16) GeomEntry {
  PathState st;
  Queries q;
};

// The adjoint launch.
template <int kScan>
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

  GeomEntry tape[2][kSeg];
  PathState ck[kCkpt];
  TapeCtl c;
  tape_start(&c, lr.s, lr.in_range && lr.s < lr.s_stop);
  PathState st;  // the producer's state before its next bounce
  const auto spawn = [&] {
    st = PathState{cam_o, spawn_dir(p, lr.px, lr.py, lr.pid_base + c.s), one,
                   zero};
  };
  if (c.tracing) spawn();
  V3 L = zero;  // the lane's radiance sum over its samples (the image)
  V3 lam_o = zero, lam_d = zero;
  uint32_t n_ext = 0, n_prb = 0, n_rep = 0, n_vjp = 0, n_long = 0;

  while (__any_sync(kFull, tape_active(c))) {
    Contrib ct;
    ct.key = -1;
    if (c.tracing) {  // pass A, or a segment replay
      const int j = c.depth + 1;
      const Bounce b = bounce<TableMaterials, kScan, kNee>(
          p, tab, mats, lf, st.o, st.d, lr.pid_base + c.s, j, lr.pix,
          NoGuide{});
      GeomEntry& e = tape[c.pbuf][tape_slot(j)];
      e.st = st;
      e.q = Queries{b.id, b.t, b.success, b.t_safe};
      const V3 pick = v3(st.T.x * b.emi.x, st.T.y * b.emi.y, st.T.z * b.emi.z);
      const PathState next{
          b.x, b.new_dir,
          mul(v3(st.T.x * b.f.x, st.T.y * b.f.y, st.T.z * b.f.z), b.w),
          add(st.A, pick)};
      c.depth = j;
      if (c.d_stop == 0) {  // pass A
        tape_checkpoint(ck, j, st);
        L = add(L, pick);
        n_ext += 1;
        n_prb += (b.survive && b.diffuse) ? 1u : 0u;
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
      const GeomEntry e = tape[c.sbuf][tape_slot(c.j)];
      if (c.fresh) {
        lam_o = zero;
        lam_d = zero;
      }
      const V3 o = e.st.o, d = e.st.d, T = e.st.T;
      const uint32_t pid = lr.pid_base + c.s_sw;
      const Bounce b = bounce<TableMaterials, kScan, kNee, NoGuide, true>(
          p, tab, mats, lf, o, d, pid, c.j, lr.pix, NoGuide{}, &e.q);
      const V3 LA = c.LA_sw;
      const V3 A_new = add(e.st.A, v3(T.x * b.emi.x, T.y * b.emi.y,
                                      T.z * b.emi.z));
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
      const Pullback pb = bounce_vjp<kScan>(p, tab, b, o, d, lam_o, lam_d,
                                            s_ta * b.inv_p);
      ct.key = b.id;
      ct.v[0] = gc.x * TS.x * f_scale + eq_x * am;
      ct.v[1] = gc.y * TS.y * f_scale + eq_y * am;
      ct.v[2] = gc.z * TS.z * f_scale + eq_z * am;
      ct.v[3] = gc.x * T.x;
      ct.v[4] = gc.y * T.y;
      ct.v[5] = gc.z * T.z;
      ct.v[6] = pb.g_c.x;
      ct.v[7] = pb.g_c.y;
      ct.v[8] = pb.g_c.z;
      ct.v[9] = pb.g_r;
      lam_o = pb.g_o;
      lam_d = pb.g_d;
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    warp_accumulate(ct, my_row, p.n_rects, k_obj);
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

}  // namespace

// Host entry point with a plain C interface (loaded with ctypes). Geometry,
// light and camera as fill_params (megakernel_common.cuh) reads them, in
// host memory. On the device: sph (n_spheres, 4) float32 [cx, cy, cz, r]
// and its tree bvh (root its root link) as spt_megakernel_tab takes them;
// alb, emi (n_rects + n_spheres, 3) float32 and refl (n_rects + n_spheres,)
// int32, rects first; out_l (n_pix_loc·g, 3) float32 for the shard's pixels
// [pix0, pix0 + n_pix_loc) (unsharded: all of them); counts 5 uint64,
// zeroed: [extend, probe] of pass A, replayed bounces, VJP bounces, paths
// longer than the tape (bk == 0: the image-only launch, [extend, probe]
// only). With bk != 0 also g_img
// (n_pix_loc, 3) float32, the shard's cotangent rows; partials: scratch of
// n_partials floats, at least ceil(n_pix_loc·g / 128)·n_slots with n_slots
// = 6·(n_rects + n_spheres)
// + 4·n_spheres; out: n_slots floats, d/d albedo (K, 3), d/d emission
// (K, 3), d/d sphere rows (S, 4). 1 to kMaxGeomSpheres spheres. Launches on
// `stream`; returns the first launch error.
extern "C" int spt_megakernel_geom(
    const float* rect_geom, const int* rect_axis, int n_rects,
    const float* light_f, int light_id, const float* cam_f, unsigned seed,
    int width, int height, int spp, int g, int per, unsigned s0, int pix0,
    int n_pix_loc, int rr_start_depth, int max_bounces, const float* sph,
    int n_spheres, const float* bvh, int root, const float* alb,
    const float* emi, const int* refl, int bk,
    const float* g_img, float* partials, long long n_partials, float* out,
    float* out_l, unsigned long long* counts, void* stream) {
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, seed, width, height, spp, g, per, s0, pix0,
                   n_pix_loc, rr_start_depth, max_bounces) ||
      n_spheres < 1 || n_spheres > kMaxGeomSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = grid_of(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* sph4 = reinterpret_cast<const float4*>(sph);
  const float4* bvh4 = reinterpret_cast<const float4*>(bvh);
  cudaError_t err = cudaSuccess;
  const bool tree = root >= 0;
  if (!bk) {
    const auto image = tree ? megakernel_geom_image<kScanTree>
                            : megakernel_geom_image<kScanLinear>;
    image<<<n_blocks, kBlock, 0, st>>>(
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
  const auto adjoint =
      tree ? megakernel_geom<kScanTree> : megakernel_geom<kScanLinear>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(adjoint,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  adjoint<<<n_blocks, kBlock, smem, st>>>(
      p, sph4, n_spheres, bvh4, root, alb, emi, refl, g_img, partials,
      out_l, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_slots, kReduceThreads, 0, st>>>(partials, n_blocks,
                                                      n_slots, out);
  return static_cast<int>(cudaGetLastError());
}
