// The body of the row 9 kernels megakernel_vjp<kTab, kEst>
// (megakernel_vjp.cuh) and megakernel_vjp_ext<kTab, kEst>
// (megakernel_grad_ext.cu), included between each kernel's braces: it
// reads the kernel's parameters (p, sph, n_sph, bvh, root, alb, emi, refl,
// g_img, partials) and `gloss` and `quads`, the Phong exponents and the
// quads of an _ext code's scene (null in megakernel_vjp). kEst is an
// estimator code, with the scene flags of ext_code in the _ext kernels
// (kWithQuads; kWithGlos for cosine, nee_textbook and mis); without them
// every branch of theirs compiles away. A textual include, not an inlined
// device function: inlined, the body compiled to other SASS and registers
// in every megakernel_vjp instance (tools/sass_counts.py --same all).

  // Dynamic shared memory: the rect scene's tables or a linear sphere
  // table's rows (two float4 a row), then a row of 6K gradient slots a
  // warp (albedo, then emission), K = rects + quads + spheres.
  extern __shared__ float4 smem4[];
  int n_quads = 0;
  if constexpr (with_quads(kEst)) n_quads = quads->n;
  const int k_obj = p.n_rects + n_quads + n_sph;
  const int n_slots = 6 * k_obj;
  SphereTab tab = sphere_tab(sph, n_sph, refl, bvh, root, gloss, quads);
  int n_head = 0;
  float* s_tab = reinterpret_cast<float*>(smem4);
  if constexpr (kTab == kTabNone) {
    n_head = (6 * p.n_rects + 3) / 4;
    for (int i = threadIdx.x; i < 3 * p.n_rects; i += kBlock) {
      s_tab[i] = alb[i];
      s_tab[3 * p.n_rects + i] = emi[i];
    }
  } else if constexpr (kTab == kScanLinear) {
    n_head = 2 * ((-1 - root) >> 16);
    for (int i = threadIdx.x; i < n_head; i += kBlock) smem4[i] = tab.rows[i];
    tab.rows = smem4;
  }
  float* rows = reinterpret_cast<float*>(smem4 + n_head);
  for (int i = threadIdx.x; i < kWarps * n_slots; i += kBlock) rows[i] = 0.0f;
  __syncthreads();
  float* my_row = rows + (threadIdx.x >> 5) * n_slots;
  const TableMaterials mats =
      kTab == kTabNone ? TableMaterials{s_tab, s_tab + 3 * p.n_rects}
                       : TableMaterials{alb, emi};

  const LaneRange lr = lane_range(p);
  const LightFrame lf = light_frame(p);
  const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
  const V3 gc = lr.in_range ? ld3(g_img + 3 * lr.pix) : zero;
  const V3 cam_o = ld3(p.cam_o);
  const V3 e_light = mats.emission(p.light_id);
  V3 g_le = zero;  // the direct terms' light-emission terms of this lane

  constexpr bool kMisEst = est_base(kEst) == kMis;
  using State = VjpState<kMisEst>;
  VjpEntry<kMisEst> tape[2][kSeg];
  State ck[kCkpt];
  TapeCtl c;
  tape_start(&c, lr.s, lr.in_range && lr.s < lr.s_stop);
  State st;  // the producer's state before its next bounce
  const auto spawn = [&] {
    st = State{cam_o, spawn_dir(p, lr.px, lr.py, lr.pid_base + c.s), one,
               zero, false};  // (mis: a carry of 0)
  };
  if (c.tracing) spawn();

  while (__any_sync(kFull, tape_active(c))) {
    Contrib ct;
    ct.key = -1;
    if (c.tracing) {  // pass A, or a segment replay
      const int depth = c.depth + 1;
      const V3 T = st.T;
      Bounce b;
      bounce_hit<TableMaterials, kTab, false, with_quads(kEst)>(
          p, tab, mats, st.o, st.d, &b);
      // render_lane's pickup, direct term and sum, in its order.
      V3 pick = v3(T.x * b.emi.x, T.y * b.emi.y, T.z * b.emi.z);
      bool counted = true;
      float w_pick = 1.0f;  // mis: the pickup's balance weight
      if constexpr (est_base(kEst) == kTextbook) {
        if (st.suppress && b.hit && b.id == p.light_id) {
          pick = zero;
          counted = false;
        }
      } else if constexpr (kMisEst) {
        if (mis_pickup(p, lf, st.d, b, st.mis_pdf, &w_pick)) {
          pick = mul(pick, w_pick);
        }
      }
      bounce_scatter<kTab, kEst>(p, tab, lf, st.o, st.d, lr.pid_base + c.s,
                                 depth, lr.pix, NoGuide{}, &b);
      V3 A_new;
      float gate = 0.0f;
      if constexpr (direct_term(kEst)) {
        V3 direct = zero;
        if (b.success) {
          gate = b.w_nee;
          direct = v3(((b.w_nee * T.x) * b.alb.x) * e_light.x,
                      ((b.w_nee * T.y) * b.alb.y) * e_light.y,
                      ((b.w_nee * T.z) * b.alb.z) * e_light.z);
        }
        A_new = add(st.A, add(pick, direct));
      } else {
        A_new = add(st.A, pick);
      }
      const float p_max = fmaxf(b.alb.x, fmaxf(b.alb.y, b.alb.z));

      auto& e = tape[c.pbuf][tape_slot(depth)];
      e.code = b.id | (b.rr_scaled ? kRrBit : 0) |
               (b.alb.x == p_max ? kTieX : 0) |
               (b.alb.y == p_max ? kTieY : 0) |
               (b.alb.z == p_max ? kTieZ : 0) | (counted ? kEmitBit : 0);
      e.A_new = A_new;
      e.T = T;
      if constexpr (kMisEst) {
        e.w_pick = w_pick;
      } else {
        e.inv_p = b.inv_p;
      }
      e.w = b.w;
      e.gate = gate;

      // A path that goes on was alive after this bounce, so the next
      // pickup is suppressed exactly when this bounce probed the light
      // (diffuse or GLOS), and mis's carry is that bounce's continuation
      // pdf (the lobe's at a GLOS bounce).
      const bool probed = b.diffuse || b.glos;
      State next{b.x, b.new_dir,
                 mul(v3(T.x * b.f.x, T.y * b.f.y, T.z * b.f.z), b.w), A_new,
                 est_base(kEst) == kTextbook && probed};
      if constexpr (kMisEst) next.mis_pdf = probed ? b.pdf_cont : 0.0f;
      c.depth = depth;
      if (c.d_stop == 0) {  // pass A
        tape_checkpoint(ck, depth, st);
        if (b.survive && depth < p.max_bounces) {
          st = next;
        } else {
          tape_end_pass_a(&c, A_new);
        }
      } else if (depth == c.d_stop) {
        tape_end_replay(&c);
      } else {
        st = next;
      }
    }
    if (c.sweeping) {  // bounce j's terms
      const auto e = tape[c.sbuf][tape_slot(c.j)];
      const int id = e.code & kIdMask;
      const V3 alb_h = mats.albedo(id);
      const V3 LA = c.LA_sw, A_new = e.A_new, T = e.T;
      const float w = e.w;
      float inv_p, emit_f;  // bounce_scatter's inv_p; the pickup's weight
      if constexpr (kMisEst) {
        const float p_max = fmaxf(alb_h.x, fmaxf(alb_h.y, alb_h.z));
        inv_p = (e.code & kRrBit) ? 1.0f / (p_max > 0.0f ? p_max : 1.0f)
                                  : 1.0f;
        emit_f = e.w_pick;
      } else {
        inv_p = e.inv_p;
        emit_f = (e.code & kEmitBit) ? 1.0f : 0.0f;
      }
      const V3 fw = mul(mul(alb_h, inv_p), w);
      // T_j·S_{j+1} per channel by the guarded tail divide.
      const V3 TS = v3(fw.x != 0.0f ? (LA.x - A_new.x) / fw.x : 0.0f,
                       fw.y != 0.0f ? (LA.y - A_new.y) / fw.y : 0.0f,
                       fw.z != 0.0f ? (LA.z - A_new.z) / fw.z : 0.0f);
      const float f_scale = inv_p * w;
      const float s_am =
          (e.code & kRrBit)
              ? (gc.x * TS.x * alb_h.x + gc.y * TS.y * alb_h.y +
                 gc.z * TS.z * alb_h.z) *
                    w * (-(inv_p * inv_p))
              : 0.0f;
      const float eq_x = (e.code & kTieX) ? 1.0f : 0.0f;
      const float eq_y = (e.code & kTieY) ? 1.0f : 0.0f;
      const float eq_z = (e.code & kTieZ) ? 1.0f : 0.0f;
      const float n_eq = eq_x + eq_y + eq_z;
      const float am = s_am / (n_eq > 0.0f ? n_eq : 1.0f);
      ct.key = id;
      ct.v[0] = gc.x * TS.x * f_scale + eq_x * am;
      ct.v[1] = gc.y * TS.y * f_scale + eq_y * am;
      ct.v[2] = gc.z * TS.z * f_scale + eq_z * am;
      ct.v[3] = gc.x * T.x * emit_f;
      ct.v[4] = gc.y * T.y * emit_f;
      ct.v[5] = gc.z * T.z * emit_f;
      if constexpr (direct_term(kEst)) {
        const float gate = e.gate;
        ct.v[0] += gc.x * gate * T.x * e_light.x;
        ct.v[1] += gc.y * gate * T.y * e_light.y;
        ct.v[2] += gc.z * gate * T.z * e_light.z;
        g_le = add(g_le, v3(gc.x * gate * T.x * alb_h.x,
                            gc.y * gate * T.y * alb_h.y,
                            gc.z * gate * T.z * alb_h.z));
      }
      tape_swept(&c);
    }
    const int job = tape_handover(&c, lr.s_stop);
    if (job == 2 || (job == 1 && !tape_restore(&c, ck, &st))) spawn();
    // No key is a sphere's geometry row here: the threshold is K.
    warp_accumulate(ct, my_row, k_obj, k_obj);
  }
  if constexpr (direct_term(kEst)) {
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
  block_partials(rows, n_slots, partials);
