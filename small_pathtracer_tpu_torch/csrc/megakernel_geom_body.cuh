// The body of the row 11 kernels megakernel_geom<kScan, kEst>
// (megakernel_geom.cuh) and megakernel_geom_ext<kScan, kEst>
// (megakernel_geom_ext.cu), included between each kernel's braces: it
// reads the kernel's parameters (p, sph, n_sph, bvh, root, alb, emi, refl,
// g_img, partials, out_l, counts) and `gloss` and `quads`, the Phong
// exponents and the quads of an _ext code's scene (null in
// megakernel_geom). kEst is an estimator code, with the scene flags of
// ext_code in the _ext kernels (kWithQuads; kWithGlos for cosine,
// nee_textbook and mis); without them every branch of theirs compiles
// away. A textual include, not an inlined device function, as
// megakernel_vjp_body.cuh: the existing instances keep their SASS.
//
// Object ids run rects, quads, then spheres: K = n_rects + n_quads + n_sph
// objects, a warp's row of 6·K + 4·n_sph slots (albedo, emission, then
// the spheres' (center, radius)).

  // Dynamic shared memory: a linear table's rows (its root leaf, two float4
  // a row: staged_tab's copy, placed ahead of the slots, with one barrier
  // for both), then a row of gradient slots a warp.
  extern __shared__ float4 smem4[];
  SphereTab tab = sphere_tab(sph, n_sph, refl, bvh, root, gloss, quads);
  const int n_staged = kScan == kScanLinear ? 2 * ((-1 - root) >> 16) : 0;
  for (int i = threadIdx.x; i < n_staged; i += kBlock) smem4[i] = tab.rows[i];
  if constexpr (kScan == kScanLinear) tab.rows = smem4;
  float* rows = reinterpret_cast<float*>(smem4 + n_staged);
  int n_quads = 0;  // kWithQuads: the quads' ids follow the rects'
  if constexpr (with_quads(kEst)) n_quads = quads->n;
  const int n_plane = p.n_rects + n_quads;  // the first sphere's id
  const int k_obj = n_plane + n_sph;
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

  using Tape = GeomTape<est_base(kEst), with_glos(kEst)>;
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
      if constexpr (est_base(kEst) == kTextbook) {
        if (st.suppress && b.hit && b.id == p.light_id) pick = zero;
      } else if constexpr (est_base(kEst) == kMis) {
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
          n_prb += probed<with_glos(kEst)>(b) ? 1u : 0u;  // before RR
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
        if constexpr (est_base(kEst) == kMis) lam_mp = 0.0f;
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
      if constexpr (est_base(kEst) == kTextbook) {
        if (se.suppress && b.hit && b.id == p.light_id) {
          pick = zero;
          emit_f = 0.0f;
        }
      } else if constexpr (est_base(kEst) == kMis) {
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
      if constexpr (kDirect) {
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
      if constexpr (est_base(kEst) == kMis) lam_mp = pb.g_mp;
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    warp_accumulate(ct, my_row, n_plane, k_obj);
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
