// The sphere table's scans (rows 2, 3-tab, 4-tab, 5-tab, 7, 11 and 12): a
// bounding-volume hierarchy over the table's rows, built on the host at
// each launch (`build_sphere_bvh`), and a per-lane traversal of it
// (`nearest_tab`, `probe_light_tab`).
//
// The tree: binary, object-median splits on the widest axis of the rows'
// centers, at most kBvhLeaf rows a leaf. A node holds its two children's
// boxes (64 bytes: two float4 of box corners each half, one of padding
// coefficients and links); a link >= 0 is a node, < 0 a leaf's run of rows
// (`bvh_leaf`). The rows are copies of the table's in leaf order, each with
// its table index, so every id the scans return is the global one (rects,
// then spheres) and the materials, normals, tapes and gradient rows read
// the table in its own order. A table of at most kBvhLinearMax rows is one
// root leaf, the whole table in id order: the linear scan, which the
// kernels run through an instance of their own (kScanLinear) that leaves
// the traversal out, so a small table costs no registers or stack for it,
// and which keeps the rows in shared memory (`staged_tab`; the normals are
// read there too). A larger table always has a root node. Rows with a
// non-finite value are left out of a tree: sphere_t gives them kMissT or
// +inf, which neither wins nor blocks. A tree's nodes and rows live in
// device memory, read through the read-only cache (a build with them in
// shared memory was no faster up to 256 spheres and 1.8x slower at 1024:
// PERF.md §6).
//
// The traversal: each lane walks the tree alone with a short stack,
// nearer child first, and skips a child whose entry distance lies beyond
// its current best t (the probe: at or beyond t_light). A leaf's rows are
// tested with sphere_t's own expressions, after two rejects that need no
// square root and reject only rows sphere_t itself would not let win or
// block (`scan_leaf`). The nearest hit is the smallest (t, id) over the
// rects (nearest) and the rows, which is the in-order strict-< scan's
// winner: ties go to the smaller id. The probe is an any-hit traversal
// bounded by t_light: spheres come after the light in id order, so a
// sphere blocks it iff its t < t_light.
//
// Exactness: a child may be skipped only if no row in it could return a t
// that wins or blocks. `child_box` pads each child's box by
// E = 2^-12·(|o|_inf + cmax), cmax >= |c|_inf + |r| over the child's rows
// (E = ecm + eo, ecm from the host, eo from the ray), and tests it in
// float32; the argument that this is conservative against sphere_t's
// rounding is beside it. Every image, trace count and gradient table is
// the linear scan's bit for bit (geometry/intersect.py defines it).

#pragma once

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#include "megakernel_common.cuh"

namespace {

constexpr int kBvhLeaf = 4;
// A table this small is one leaf, scanned linearly: on sphere_grid cut to
// S spheres the linear scan ran faster at S = 9 and 16 and the tree at
// S = 32 and 64 (one H100; PERF.md §6).
constexpr int kBvhLinearMax = 16;
// The stack holds at most one entry a level: median splits of kMaxSpheres
// rows into leaves of kBvhLeaf are 10 levels deep.
constexpr int kBvhStack = 16;
constexpr float kBvhPad = 1.0f / 4096.0f;  // 2^-12
constexpr int kBvhNone = -2147483647 - 1;  // no link (int32 min)
constexpr int kBvhError = kBvhNone;

// How a table kernel instance scans the spheres: the root leaf alone (a
// root link < 0), the tree, or the tree with its work counted (the
// counting instance, which no timed path launches).
constexpr int kScanLinear = 1, kScanTree = 2, kScanCount = 3;

// A leaf's link: rows [first, first + count).
__host__ __device__ __forceinline__ int bvh_leaf(int first, int count) {
  return -1 - (first | (count << 16));
}

// Node tests, rows tested and rows that reached the square root, counted
// by the counting instance only.
struct ScanCounts {
  uint32_t nodes, rows, roots;
};

// The sphere table of the table kernels: the rows [cx, cy, cz, r] in id
// order (normals, gradients), the material code of every object (rects,
// then spheres), and the tree: `rows` (n rows of two float4: [cx, cy, cz,
// r] and [r2_up, r_up, index bits, 0]) and `nodes` (four float4 a node),
// one device buffer; `root` its root link.
struct SphereTab {
  const float4* sph;  // (n,) [cx, cy, cz, r]
  int n;
  const int* refl;  // (n_rects + n,)
  const float4* rows;
  const float4* nodes;
  int root;
  ScanCounts* cnt;
};

__device__ __forceinline__ SphereTab sphere_tab(const float4* sph, int n,
                                                const int* refl,
                                                const float4* bvh, int root) {
  return SphereTab{sph, n, refl, bvh, bvh + 2 * n, root, nullptr};
}

// The table for scan kScan: a linear table's rows (its root leaf, the
// whole table in id order, at most kBvhLinearMax rows) copied into the
// block's shared memory; the tree stays in device memory. Every thread of
// the block calls it (it ends in a barrier for kScanLinear). The geometry
// adjoint makes the same copy ahead of its gradient slots in its dynamic
// shared memory instead (a static array beside them cost it ~1%).
template <int kScan>
__device__ __forceinline__ SphereTab staged_tab(SphereTab tab) {
  if constexpr (kScan == kScanLinear) {
    __shared__ float4 s_rows[2 * kBvhLinearMax];
    const int count = (-1 - tab.root) >> 16;
    for (int i = threadIdx.x; i < 2 * count; i += kBlock) {
      s_rows[i] = tab.rows[i];
    }
    __syncthreads();
    tab.rows = s_rows;
  }
  return tab;
}

// Sphere i's row [cx, cy, cz, r] (the normal's center): a linear table's
// staged row, else the table's row in device memory.
template <int kScan>
__device__ __forceinline__ float4 sphere_row(const SphereTab& tab, int i) {
  if constexpr (kScan == kScanLinear) {
    return tab.rows[2 * i];
  } else {
    return __ldg(tab.sph + i);
  }
}

// The ray as the box tests read it: origin, 1/d (+-inf on a zero
// component) and eo = 2^-12·|o|_inf.
struct BvhRay {
  V3 o, inv;
  float eo;
};

__device__ __forceinline__ BvhRay bvh_ray(V3 o, V3 d, const RayPrep& rp) {
  const float inf = __int_as_float(0x7F800000);
  return BvhRay{o,
                v3(rp.ok_x ? rp.inv.x : copysignf(inf, d.x),
                   rp.ok_y ? rp.inv.y : copysignf(inf, d.y),
                   rp.ok_z ? rp.inv.z : copysignf(inf, d.z)),
                kBvhPad * fmaxf(fabsf(o.x), fmaxf(fabsf(o.y), fabsf(o.z)))};
}

// Whether a row of the child [lo, hi] (padding coefficient ecm) could hit
// at t in (0, t_lim]; *tn its entry distance (>= 0).
//
// Why no such row is skipped. Let u = 2^-24, W = |c - o| for a row (c, r)
// of the child, Q = |o|_inf + cmax (so W <= sqrt(3) Q, |lo|, |hi| <= Q),
// and assume what every query direction meets, | |d|^2 - 1 | <= 2^-16
// (norm()'s output or its mirror). sphere_t's b and mlen are within 5uW
// and e_m = (12u + 2^-16) W of op·d and of the distance m from c to the
// line o + t d. A finite t needs mlen < |r|, so m < r + e_m, and then
// det <= ((r + e_m)^2 - m^2)(1 + 3u): t >= t1 - (2^-15 + 5u)(W + r + e_m)
// - 5uW, where t1 is where the line enters the ball (c, r + e_m). That
// ball lies inside the box grown by e_m, so on each axis i with d_i > 0
// the padded face lo_i - E is passed at least (E - e_m) / d_i before t1,
// and the float32 face distance ((lo_i - o_i) - E) * inv_i errs by at most
// 4.1u (Q + E) / d_i: the computed entry stays below t when E - e_m -
// 4.1u (Q + E) >= (2^-15 + 5u)(2.74 Q) + 8.7uQ, i.e. about 1180uQ
// <= E = 4096uQ. The exit is bounded the same way from the far root, and
// d_i < 0 with hi_i alike. With d_i = +-0 the row's hit needs |c_i - o_i|
// < r + e_m, so ((lo_i - o_i) - E) < 0 < ((hi_i - o_i) + E) in float32 and
// times +-inf the slab is the whole line (a 0 * inf NaN arises only when a
// face is exactly at o, where no row can hit; fminf/fmaxf drop it). So a
// row with a finite t lies in [tn, tf] of its child, and t > eps > 0: a
// child is skipped only where tn > t_lim or tf < 0 (tn <= t <= tf fails).
__device__ __forceinline__ bool child_box(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float ecm, const BvhRay& r,
                                          float t_lim, float* tn_out) {
  const float e = ecm + r.eo;
  const float ax = ((lx - r.o.x) - e) * r.inv.x;
  const float bx = ((hx - r.o.x) + e) * r.inv.x;
  const float ay = ((ly - r.o.y) - e) * r.inv.y;
  const float by = ((hy - r.o.y) + e) * r.inv.y;
  const float az = ((lz - r.o.z) - e) * r.inv.z;
  const float bz = ((hz - r.o.z) + e) * r.inv.z;
  const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                         fmaxf(fminf(az, bz), 0.0f));
  const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                         fminf(fmaxf(az, bz), t_lim));
  *tn_out = tn;
  return tn <= tf;
}

// The rows of leaf `link`. kAny (the probe): returns true at the first row
// with t <= *t (*t = the float below t_light). Otherwise merges every row
// into (*t, *best) by the smaller (t, id).
//
// The rejects: m2 >= r2_up (>= r^2) gives sqrtf(m2) >= |r|, so det <= 0 and
// sphere_t returns kMissT; and r_up >= |r| (1 + 2^-20) bounds sphere_t's
// sdet, so t >= fl(b - r_up) and a row with fl(b - r_up) > *t has t > *t.
template <bool kAny, bool kCount>
__device__ __forceinline__ bool scan_leaf(const SphereTab& tab, int link,
                                          int n_rects, V3 o, V3 d, float* t,
                                          int* best) {
  const int v = -1 - link;
  const int first = v & 0xFFFF;
  const int end = first + (v >> 16);
  for (int i = first; i < end; ++i) {
    const float4 s = __ldg(tab.rows + 2 * i);
    const float4 x = __ldg(tab.rows + 2 * i + 1);
    const SpherePre q = sphere_pre(s, o, d);
    if constexpr (kCount) tab.cnt->rows += 1;
    if (q.m2 >= x.x || q.b - x.y > *t) continue;
    if constexpr (kCount) tab.cnt->roots += 1;
    const float ti = sphere_root(s, q);
    if constexpr (kAny) {
      if (ti <= *t) return true;
    } else {
      const int id = n_rects + __float_as_int(x.z);
      if (ti < *t || (ti == *t && id < *best)) {
        *t = ti;
        *best = id;
      }
    }
  }
  return false;
}

// The linear scan of a root leaf (the whole table in id order, staged in
// shared memory): scan_leaf's rejects, then the in-order strict < (the
// rects' (t, id) came first, so a tie keeps the smaller id).
template <bool kAny>
__device__ __forceinline__ bool linear_scan(const SphereTab& tab, int n_rects,
                                            V3 o, V3 d, float* t, int* best) {
  const int n = (-1 - tab.root) >> 16;
  for (int i = 0; i < n; ++i) {
    const float4 s = tab.rows[2 * i];
    const float4 x = tab.rows[2 * i + 1];
    const SpherePre q = sphere_pre(s, o, d);
    if (q.m2 >= x.x || q.b - x.y > *t) continue;
    const float ti = sphere_root(s, q);
    if constexpr (kAny) {
      if (ti <= *t) return true;
    } else if (ti < *t) {
      *t = ti;
      *best = n_rects + i;
    }
  }
  return false;
}

// The traversal from tab.root; kAny and (*t, *best) as scan_leaf.
template <bool kAny, bool kCount>
__device__ __forceinline__ bool bvh_scan(const SphereTab& tab, int n_rects,
                                         V3 o, V3 d, const RayPrep& rp,
                                         float* t, int* best) {
  int link = tab.root;
  if (link < 0) return scan_leaf<kAny, kCount>(tab, link, n_rects, o, d, t,
                                               best);
  const BvhRay ray = bvh_ray(o, d, rp);
  int st[kBvhStack];
  float st_t[kBvhStack];
  int sp = 0;
  while (true) {
    while (link >= 0) {
      const float4* nd = tab.nodes + 4 * link;
      const float4 q0 = __ldg(nd), q1 = __ldg(nd + 1), q2 = __ldg(nd + 2),
                   q3 = __ldg(nd + 3);
      float tn0, tn1;
      const bool h0 = child_box(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q3.x, ray,
                                *t, &tn0);
      const bool h1 = child_box(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, q3.y, ray,
                                *t, &tn1);
      if constexpr (kCount) tab.cnt->nodes += 2;
      int l0 = __float_as_int(q3.z), l1 = __float_as_int(q3.w);
      if (h0 && h1) {
        if (tn1 < tn0) {
          const int l = l0;
          l0 = l1;
          l1 = l;
          tn1 = tn0;
        }
        st[sp] = l1;
        st_t[sp] = tn1;
        ++sp;
        link = l0;
      } else {
        link = h0 ? l0 : (h1 ? l1 : kBvhNone);
      }
    }
    if (link != kBvhNone &&
        scan_leaf<kAny, kCount>(tab, link, n_rects, o, d, t, best)) {
      return true;
    }
    link = kBvhNone;
    while (sp > 0) {
      --sp;
      if (st_t[sp] <= *t) {
        link = st[sp];
        break;
      }
    }
    if (link == kBvhNone) return false;
  }
}

// The rows by scan kScan from tab.root (for kScanLinear the root leaf, its
// rows in shared memory: staged_tab).
template <bool kAny, int kScan>
__device__ __forceinline__ bool sphere_scan(const SphereTab& tab, int n_rects,
                                            V3 o, V3 d, const RayPrep& rp,
                                            float* t, int* best) {
  if constexpr (kScan == kScanLinear) {
    return linear_scan<kAny>(tab, n_rects, o, d, t, best);
  } else {
    return bvh_scan<kAny, kScan == kScanCount>(tab, n_rects, o, d, rp, t,
                                               best);
  }
}

// Nearest hit over the rects (nearest), then the sphere rows: the smallest
// (t, id), the in-order strict-< scan's winner.
template <int kScan>
__device__ __forceinline__ float nearest_tab(const Params& p,
                                             const SphereTab& tab, V3 o,
                                             V3 d, int* id) {
  const RayPrep rp = prep(d);
  float t_best = nearest(p, o, d, rp, id);
  sphere_scan<false, kScan>(tab, p.n_rects, o, d, rp, &t_best, id);
  return t_best;
}

// probe_light with the spheres: they come after the light in the scan, so
// one blocks it iff its t < t_light. Stops at the first occluder.
template <int kScan>
__device__ __forceinline__ bool probe_light_tab(const Params& p,
                                                const SphereTab& tab, V3 o,
                                                V3 d, float* t_light) {
  const RayPrep rp = prep(d);
  if (!probe_light(p, o, d, rp, t_light)) return false;
  float t_lim = __int_as_float(__float_as_int(*t_light) - 1);
  int unused = 0;
  return !sphere_scan<true, kScan>(tab, p.n_rects, o, d, rp, &t_lim,
                                   &unused);
}

// ---- Host: the tree ----

// Floats of the buffer build_sphere_bvh fills for n rows: the rows (8
// floats each), then at most n - 1 nodes (16 floats each).
inline int bvh_floats(int n) { return 8 * n + 16 * (n > 1 ? n - 1 : 0); }

inline float round_up(double x) {
  float f = static_cast<float>(x);
  if (static_cast<double>(f) < x) f = std::nextafter(f, INFINITY);
  return f;
}

inline float round_down(double x) {
  float f = static_cast<float>(x);
  if (static_cast<double>(f) > x) f = std::nextafter(f, -INFINITY);
  return f;
}

struct BvhBuilder {
  const float* sph;
  float* rows;
  float* nodes;
  std::vector<int> ids;
  int n_nodes = 0;
  bool deep = false;

  void put_row(int slot, int id) {
    const float* s = sph + 4 * id;
    float* r = rows + 8 * slot;
    const double rad = std::fabs(static_cast<double>(s[3]));
    for (int c = 0; c < 4; ++c) r[c] = s[c];
    r[4] = round_up(rad * rad);
    r[5] = round_up(rad * (1.0 + 1.0 / 1048576.0));
    std::memcpy(&r[6], &id, 4);
    r[7] = 0.0f;
  }

  // The box of ids[b, e) into box[0..5] (lo, hi) and its padding
  // coefficient 2^-12·cmax (cmax >= |c|_inf + |r| with room for rounding).
  void box(int b, int e, float* out) const {
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    double cmax = 0.0;
    for (int i = b; i < e; ++i) {
      const float* s = sph + 4 * ids[i];
      const double rad = std::fabs(static_cast<double>(s[3]));
      double cm = 0.0;
      for (int c = 0; c < 3; ++c) {
        lo[c] = std::min(lo[c], s[c] - rad);
        hi[c] = std::max(hi[c], s[c] + rad);
        cm = std::max(cm, std::fabs(static_cast<double>(s[c])));
      }
      cmax = std::max(cmax, cm + rad);
    }
    for (int c = 0; c < 3; ++c) {
      out[c] = round_down(lo[c]);
      out[3 + c] = round_up(hi[c]);
    }
    out[6] = round_up(kBvhPad * cmax * (1.0 + 1.0 / 1048576.0));
  }

  // The subtree over ids[b, e): its link. The root (depth 0) is always a
  // node.
  int build(int b, int e, int depth) {
    if (e - b <= kBvhLeaf && depth > 0) {
      for (int i = b; i < e; ++i) put_row(i, ids[i]);
      return bvh_leaf(b, e - b);
    }
    if (depth >= kBvhStack) deep = true;
    const int k = n_nodes++;
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = b; i < e; ++i) {
      for (int c = 0; c < 3; ++c) {
        lo[c] = std::min(lo[c], static_cast<double>(sph[4 * ids[i] + c]));
        hi[c] = std::max(hi[c], static_cast<double>(sph[4 * ids[i] + c]));
      }
    }
    int a = 0;
    for (int c = 1; c < 3; ++c) {
      if (hi[c] - lo[c] > hi[a] - lo[a]) a = c;
    }
    const float* s = sph;
    std::sort(ids.begin() + b, ids.begin() + e, [s, a](int i, int j) {
      const float ci = s[4 * i + a], cj = s[4 * j + a];
      return ci < cj || (ci == cj && i < j);
    });
    const int m = b + (e - b) / 2;
    const int l0 = build(b, m, depth + 1);
    const int l1 = build(m, e, depth + 1);
    float b0[7], b1[7];
    box(b, m, b0);
    box(m, e, b1);
    float* nd = nodes + 16 * k;
    const float q[12] = {b0[0], b0[1], b0[2], b0[3], b0[4], b0[5],
                         b1[0], b1[1], b1[2], b1[3], b1[4], b1[5]};
    for (int c = 0; c < 12; ++c) nd[c] = q[c];
    nd[12] = b0[6];
    nd[13] = b1[6];
    std::memcpy(&nd[14], &l0, 4);
    std::memcpy(&nd[15], &l1, 4);
    return k;
  }
};

// Host: the tree over sph (n rows [cx, cy, cz, r], host memory), written
// to out (bvh_floats(n) floats, host memory, zeroed by the caller): the
// rows at out, the nodes at out + 8n. Returns the root link, or kBvhError
// for an n the kernels do not take.
inline int build_sphere_bvh(const float* sph, int n, float* out) {
  if (n < 0 || n > kMaxSpheres) return kBvhError;
  BvhBuilder bb{sph, out, out + 8 * n, {}};
  if (n <= kBvhLinearMax) {
    for (int i = 0; i < n; ++i) bb.put_row(i, i);
    return bvh_leaf(0, n);
  }
  for (int i = 0; i < n; ++i) {
    const float* s = sph + 4 * i;
    if (std::isfinite(s[0]) && std::isfinite(s[1]) && std::isfinite(s[2]) &&
        std::isfinite(s[3])) {
      bb.ids.push_back(i);
    }
  }
  const int root = bb.build(0, static_cast<int>(bb.ids.size()), 0);
  return bb.deep ? kBvhError : root;
}

}  // namespace
