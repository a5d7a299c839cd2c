"""The sphere table's tree on the CPU: ``build_sphere_bvh`` and the
traversal of ``csrc/megakernel_bvh.cuh`` (``nearest_tab``,
``probe_light_tab``), compiled for the host with the C++ compiler against
tests/_cuda_host.py's stand-in for ``cuda_runtime.h`` (FMA contraction off,
as the library's ``--fmad=false``), held to the linear scan they replace:
the rects (``nearest``), then every sphere row in id order with a strict <
(``sphere_t``), and the probe blocked by a sphere iff its t < t_light; and
held bit for bit to the plain PyTorch version of the same queries
(``megakernel.sphere_queries_plain``: ``geometry/intersect.trace``, which
the other tests hold to JAX).

Tables: the five sphere presets, ``smallpt_original``'s rects with the
original smallpt's nine spheres (the radius-1e5 walls over the rect walls,
so sphere-rect near ties; alone a linear table, with ``sphere_grid``'s 64
spheres a tree), and a table with duplicated spheres (exact two-sphere
ties). Tables of at most kBvhLinearMax rows run the kernels' linear
instance, larger ones the tree. Rays, seeded: from inside the room in every direction
and toward light samples, grazing rays tangent to a sphere (within a few
ulps either side), rays aimed at the tree's box faces, edges and corners
and rays lying in a face's plane (a zero direction component), and rays
from points on a sphere inside its self-hit epsilon. No JAX program.

Also the budget kernels' plain version over a live list against the full
plain version, bit for bit, on ragged spans with many empty ones."""

import ctypes

import numpy as np
import pytest
import torch

import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.ops import megakernel
from small_pathtracer_tpu_torch.scene.types import Spheres

from _cuda_host import build_host_lib

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

# kBvhLeaf, kBvhLinearMax, kBvhStack in csrc/megakernel_bvh.cuh.
LEAF, LINEAR_MAX, STACK = 4, 16, 16

SRC = r"""
#include "megakernel_bvh.cuh"

extern "C" int bvh_build(const float* sph, int n, float* out) {
  return build_sphere_bvh(sph, n, out);
}

// Per ray: the kernels' nearest (t, id) and probe (success, t_light), by
// the instance the entry points pick for root, then the linear scan's;
// counts (the tree's): [node tests, rows tested, rows at the root].
extern "C" int queries(const float* rect_geom, const int* rect_axis,
                       int n_rects, const float* light_f, int light_id,
                       const float* sph, int n, const float* bvh, int root,
                       const float* o, const float* d, int n_rays,
                       float* t_out, int* id_out, int* ok_out, float* tl_out,
                       float* lt_out, int* lid_out, int* lok_out,
                       unsigned* counts) {
  const float cam_f[12] = {};
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, 0u, 1, 1, 1, 1, 1, 0u, 0, 1, 5, 5)) {
    return 0;
  }
  const float4* rows = reinterpret_cast<const float4*>(sph);
  SphereTab tab = sphere_tab(rows, n, nullptr,
                             reinterpret_cast<const float4*>(bvh), root);
  ScanCounts c{0u, 0u, 0u};
  tab.cnt = &c;
  for (int i = 0; i < n_rays; ++i) {
    const V3 oi = ld3(o + 3 * i), di = ld3(d + 3 * i);
    int id;
    float tl;
    if (root >= 0) {  // the tree (counted), else the linear instance
      t_out[i] = nearest_tab<kScanCount>(p, tab, oi, di, &id);
      ok_out[i] = probe_light_tab<kScanCount>(p, tab, oi, di, &tl);
    } else {
      t_out[i] = nearest_tab<kScanLinear>(p, tab, oi, di, &id);
      ok_out[i] = probe_light_tab<kScanLinear>(p, tab, oi, di, &tl);
    }
    id_out[i] = id;
    tl_out[i] = tl;
    int lid;
    float lt = nearest(p, oi, di, &lid);
    for (int k = 0; k < n; ++k) {
      const float ts = sphere_t(rows[k], oi, di);
      if (ts < lt) {
        lt = ts;
        lid = n_rects + k;
      }
    }
    lt_out[i] = lt;
    lid_out[i] = lid;
    float tl2;
    bool ok = probe_light(p, oi, di, &tl2);
    for (int k = 0; ok && k < n; ++k) {
      if (sphere_t(rows[k], oi, di) < tl2) ok = false;
    }
    lok_out[i] = ok;
  }
  counts[0] = c.nodes;
  counts[1] = c.rows;
  counts[2] = c.roots;
  return 1;
}
"""

# The original smallpt's spheres: the six walls (radius 1e5, over
# smallpt_original's rect walls, so sphere-rect near ties), the mirror and
# glass balls and the light ball (chip_smoke.py's grazing phase keeps a copy).
SMALLPT_TRUE = np.asarray(
    ((1e5 + 1, 40.8, 81.6, 1e5), (-1e5 + 99, 40.8, 81.6, 1e5),
     (50, 40.8, 1e5, 1e5), (50, 40.8, -1e5 + 170, 1e5),
     (50, 1e5, 81.6, 1e5), (50, -1e5 + 81.6, 81.6, 1e5),
     (27, 16.5, 47, 16.5), (73, 16.5, 78, 16.5),
     (50, 681.6 - .27, 81.6, 600)), np.float32)


def _p(a):
    return a.ctypes.data


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_host_lib(tmp_path_factory.mktemp("sphere_bvh"), "bvh", SRC)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.queries.restype = ctypes.c_int
    lib.queries.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                            + [ctypes.c_void_p] * 8)
    return lib


def build(lib, sph):
    sph = np.ascontiguousarray(sph, np.float32)
    out = np.zeros(megakernel.bvh_floats(len(sph)), np.float32)
    root = lib.bvh_build(_p(sph), len(sph), _p(out))
    assert root != megakernel.BVH_ERROR
    return out, root


def leaves(buf, root, n):
    """The tree's leaves [(first, count)] and child boxes [(lo, hi)], and
    its depth."""
    nodes = buf[8 * n:].reshape(-1, 16)
    links = nodes[:, 14:16].copy().view(np.int32)
    out, boxes, depth = [], [], 0
    stack = [(root, 0)]
    while stack:
        link, dep = stack.pop()
        depth = max(depth, dep)
        if link < 0:
            v = -1 - int(link)
            out.append((v & 0xFFFF, v >> 16))
            continue
        boxes += [(nodes[link, 0:3], nodes[link, 3:6]),
                  (nodes[link, 6:9], nodes[link, 9:12])]
        stack += [(int(links[link, 0]), dep + 1), (int(links[link, 1]),
                                                    dep + 1)]
    return out, boxes, depth


def grazing_rays(sph: np.ndarray, light, n: int, seed: int):
    """Seeded rays (o, d), float32 (N, 3) numpy arrays: from inside the room
    every way and toward light samples; tangent to a sphere within a few
    ulps either side; in a sphere's tangent plane x_j = c_j +- r (its
    box's face) with d_j = 0; and from points on a sphere inside its
    self-hit epsilon (chip_smoke.py's grazing phase draws the same rays on
    the card)."""
    r = np.random.default_rng(seed)
    lo, hi = np.array([2.0, 1.0, 2.0]), np.array([98.0, 80.0, 168.0])
    os_, ds = [], []
    o = r.uniform(lo, hi, (n, 3))
    lp = (light.corner.cpu().numpy() + r.random((n, 1))
          * light.edge_u.cpu().numpy() + r.random((n, 1))
          * light.edge_v.cpu().numpy())
    os_ += [o, o]
    ds += [r.standard_normal((n, 3)), lp - o]
    k = r.integers(len(sph), size=n)
    c, rad = sph[k, :3].astype(np.float64), np.abs(sph[k, 3:4]).astype(
        np.float64)
    d = r.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = np.cross(d, r.standard_normal((n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    off = r.choice([-2.4e-7, -1.2e-7, 0.0, 1.2e-7, 2.4e-7], (n, 1))
    os_.append(c + u * rad * (1.0 + off) - d * r.uniform(1.0, 60.0, (n, 1)))
    ds.append(d)
    j = r.integers(0, 3, n)
    sgn = r.choice([-1.0, 1.0], n)
    face = (c[np.arange(n), j] + sgn * rad[:, 0]).astype(np.float32)
    step = r.choice([-1, 0, 1], n)
    face = np.where(step > 0, np.nextafter(face, np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(face, np.float32(-np.inf)),
                             face))
    d = r.standard_normal((n, 3))
    d[np.arange(n), j] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tp = c.copy()
    tp[np.arange(n), j] = face
    o4 = tp - d * r.uniform(2.0, 60.0, (n, 1))
    o4[np.arange(n), j] = face
    os_.append(o4)
    ds.append(d)
    nrm = r.standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    os_.append(c + nrm * rad * (1.0 + r.uniform(-2e-6, 2e-6, (n, 1))))
    ds.append(r.standard_normal((n, 3)))
    o = np.concatenate(os_).astype(np.float32)
    d = np.concatenate(ds).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = np.isfinite(d).all(1) & np.isfinite(o).all(1)
    return o[keep], d[keep].astype(np.float32)


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def rays(sph, boxes, light, n, seed):
    """Seeded rays of every kind the module docstring lists: (o, d)
    float32 (N, 3): ``grazing_rays``, and the tree's box faces, edges and
    corners, rays in a face's plane, axis-aligned rays through the spheres'
    centers and tangent lines, and far origins in a tangent plane."""
    r = np.random.default_rng(seed)
    o_all, d_all = grazing_rays(sph, light, n, seed)
    o_all, d_all = [o_all], [d_all]

    def add(o, d):
        o = np.asarray(o, np.float32).reshape(-1, 3)
        d = _unit(np.asarray(d, np.float32).reshape(-1, 3))
        keep = np.isfinite(d).all(1) & np.isfinite(o).all(1)
        o_all.append(o[keep])
        d_all.append(d[keep])

    room_lo, room_hi = np.array([2, 1, 2]), np.array([98, 80, 168])
    k = r.integers(len(sph), size=n)
    c, rad = sph[k, :3].astype(np.float64), np.abs(sph[k, 3:4]).astype(
        np.float64)
    if boxes:
        # At box faces, edges and corners, and along a face's plane.
        b = r.integers(len(boxes), size=n)
        lo = np.stack([boxes[i][0] for i in b]).astype(np.float64)
        hi = np.stack([boxes[i][1] for i in b]).astype(np.float64)
        pick = r.integers(0, 3, (n, 3))  # lo, hi or inside on each axis
        t = np.where(pick == 0, lo, np.where(pick == 1, hi,
                                             r.uniform(lo, hi)))
        o = r.uniform(room_lo, room_hi, (n, 3))
        add(o, t - o)
        ax = r.integers(0, 3, n)
        d = r.standard_normal((n, 3))
        d[np.arange(n), ax] = 0.0
        o2 = t - d * r.uniform(5.0, 80.0, (n, 1))
        o2[np.arange(n), ax] = t[np.arange(n), ax]
        add(o2, d)
        # Axis-aligned rays through the spheres' centers and tangent lines.
        a = r.integers(0, 3, n)
        d = np.zeros((n, 3))
        d[np.arange(n), a] = r.choice([-1.0, 1.0], n)
        o3 = c.copy()
        side = r.integers(0, 3, n)
        j = (a + 1 + (side % 2)) % 3
        o3[np.arange(n), j] += np.where(side == 2, 0.0, rad[:, 0])
        o3 -= d * 200.0
        add(o3, d)
    # In a sphere's tangent plane x_j = c_j +- r, a few ulps either side,
    # from far origins (|o| ~ 1e5, so a padding of ~25).
    j = r.integers(0, 3, n)
    sgn = r.choice([-1.0, 1.0], n)
    face = (c[np.arange(n), j] + sgn * rad[:, 0]).astype(np.float32)
    for _ in range(3):
        step = r.integers(-4, 5, n)
        face = np.where(step > 0, np.nextafter(face, np.float32(np.inf)),
                        np.where(step < 0,
                                 np.nextafter(face, np.float32(-np.inf)),
                                 face))
    d = r.standard_normal((n, 3))
    d[np.arange(n), j] = 0.0
    d = _unit(d).astype(np.float64)
    tp = c.copy()
    tp[np.arange(n), j] = face
    o4 = (tp - d * r.uniform(2e4, 2e5, (n, 1))).astype(np.float32)
    o4[np.arange(n), j] = face
    add(o4, d)
    return (torch.from_numpy(np.concatenate(o_all)),
            torch.from_numpy(np.concatenate(d_all)))


def run_queries(lib, scene, sph, o, d):
    geom = megakernel.pack_geometry(scene,
                                    spt.make_camera(device="cpu"))
    sph = np.ascontiguousarray(sph, np.float32)
    buf, root = build(lib, sph)
    o = np.ascontiguousarray(o.numpy(), np.float32)
    d = np.ascontiguousarray(d.numpy(), np.float32)
    n = len(o)
    f = [np.zeros(n, np.float32) for _ in range(3)]
    i = [np.zeros(n, np.int32) for _ in range(4)]
    counts = np.zeros(3, np.uint32)
    assert lib.queries(
        _p(geom.rect_geom), _p(geom.rect_axis), len(geom.rect_axis),
        _p(geom.light_f), geom.light_id, _p(sph), len(sph), _p(buf), root,
        _p(o), _p(d), n, _p(f[0]), _p(i[0]), _p(i[1]), _p(f[1]), _p(f[2]),
        _p(i[2]), _p(i[3]), _p(counts))
    return (f[0], i[0], i[1], f[1]), (f[2], i[2], i[3]), counts, buf, root


def _tables():
    """(name, scene, sphere rows (S, 4)) of each tested table."""
    out = []
    for name in ("sphere_grid", "sphere_grid_256", "sphere_grid_1024",
                 "cornell_spheres", "smallpt_original"):
        sc = spt.get_scene(name, device="cpu")
        out.append((name, sc, torch.cat(
            [sc.spheres.center, sc.spheres.radius[:, None]], 1).numpy()))
    smallpt = spt.get_scene("smallpt_original", device="cpu")
    out.append(("smallpt_true_walls", smallpt, SMALLPT_TRUE))
    grid = out[0][2]
    # The walls in a tree: with the grid's 64 spheres inside the room.
    out.append(("smallpt_walls_grid", smallpt,
                np.concatenate([SMALLPT_TRUE, grid])))
    dup = np.concatenate([grid[:20], grid[5:15], grid[20:], grid[:3]])
    out.append(("sphere_grid_duplicates", out[0][1], dup))
    return out


TABLES = {name: (sc, sph) for name, sc, sph in _tables()}


_TORCH_SQRT = torch.sqrt


def ieee_sqrt(x):
    """float32 square roots correctly rounded, as the card's sqrtf and the
    host build's: float32 ``torch.sqrt`` on the CPU is within about half
    an ulp, and a one-ulp root moves a sphere's t (by ~0.008 on the
    radius-1e5 walls). The root in float64, rounded once to float32, is
    the correctly rounded float32 root."""
    return _TORCH_SQRT(x.double()).to(x.dtype)


def with_spheres(sc, sph):
    """``sc`` with the sphere rows ``sph`` (S, 4) (the materials of its
    first sphere on every row; the scans read no material)."""
    t = torch.from_numpy(np.ascontiguousarray(sph, np.float32))
    sp, n = sc.spheres, len(sph)
    return sc._replace(spheres=Spheres(
        center=t[:, :3], radius=t[:, 3],
        albedo=sp.albedo[:1].repeat(n, 1),
        emission=sp.emission[:1].repeat(n, 1),
        refl=sp.refl[:1].repeat(n), gloss=sp.gloss[:1].repeat(n)))


@pytest.mark.parametrize("name", list(TABLES))
def test_tree_scans_are_the_linear_scan(lib, name, monkeypatch):
    sc, sph = TABLES[name]
    buf, root = build(lib, sph)
    _, boxes, _ = leaves(buf, root, len(sph))
    o, d = rays(sph, boxes, sc.light, 500, 11)
    (t, ids, ok, t_l), (lt, lid, lok), counts, _, _ = run_queries(
        lib, sc, sph, o, d)
    np.testing.assert_array_equal(ids, lid)
    np.testing.assert_array_equal(t, lt)
    np.testing.assert_array_equal(ok, lok)
    # The plain version of the same queries (the in-order scan in torch),
    # its square roots correctly rounded as on the card.
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", ieee_sqrt)
        p_t, p_id, p_ok, p_tl = megakernel.sphere_queries_plain(
            with_spheres(sc, sph), o, d)
    np.testing.assert_array_equal(t, p_t.numpy())
    np.testing.assert_array_equal(ids, p_id.numpy())
    np.testing.assert_array_equal(ok, p_ok.numpy())
    np.testing.assert_array_equal(t_l, p_tl.numpy())
    assert int((lid >= len(sc.rects.k)).sum()) > len(o) // 10  # spheres hit
    assert int(ok.sum()) > 50 and int((ok == 0).sum()) > 50
    if name == "sphere_grid_duplicates":
        # Exact ties: a duplicate's twin (the smaller id) wins.
        R = len(sc.rects.k)
        twin = {R + 20 + j: R + 5 + j for j in range(10)}
        twin.update({R + len(sph) - 3 + j: R + j for j in range(3)})
        assert not set(lid.tolist()) & set(twin)
    if len(sph) > LINEAR_MAX:
        # The tree skips rows: fewer tested than the linear scan's.
        assert root >= 0 and counts[1] < len(sph) * 2 * len(o) // 2


@pytest.mark.parametrize("extra", [0, 64], ids=["linear", "tree"])
def test_ties_at_the_light(lib, extra):
    """A sphere whose top touches the light's plane (y = 81.5 in
    smallpt_original), probed straight up from inside it: its far root is
    exactly t_light. The light (a rect, the smaller id) wins the nearest
    hit, and the sphere does not block the probe (t < t_light fails)."""
    sc = spt.get_scene("smallpt_original", device="cpu")
    touch = np.array([[50.0, 71.5, 80.0, 10.0]], np.float32)
    sph = np.concatenate([touch, TABLES["sphere_grid"][1][:extra]])
    y0 = np.array([72.0, 73.25, 75.0, 78.5, 80.0, 81.0], np.float32)
    o = np.stack([np.full_like(y0, 50.0), y0, np.full_like(y0, 80.0)], 1)
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (len(y0), 1))
    (t, ids, ok, t_l), (lt, lid, lok), _, _, root = run_queries(
        lib, sc, sph, torch.from_numpy(o), torch.from_numpy(d))
    assert (root >= 0) == (extra > 0)
    light = int(sc.light.light_obj_id)
    np.testing.assert_array_equal(t, 81.5 - y0)
    np.testing.assert_array_equal(t_l, 81.5 - y0)
    assert (ids == light).all() and (lid == light).all()
    assert ok.all() and lok.all()


@pytest.mark.parametrize("name", ["sphere_grid_1024", "smallpt_walls_grid",
                                  "sphere_grid_duplicates", "cornell_spheres"])
def test_tree_layout(lib, name):
    """Every finite row in exactly one leaf, with its table index; leaves
    of at most kBvhLeaf rows; the depth within the stack; small tables one
    root leaf in id order; child boxes holding their rows."""
    _, sph = TABLES[name]
    n = len(sph)
    buf, root = build(lib, sph)
    rows = buf[:8 * n].reshape(n, 8)
    idx = rows[:, 6].copy().view(np.int32)
    if n <= LINEAR_MAX:
        assert root == -1 - (n << 16)
        np.testing.assert_array_equal(idx, np.arange(n))
        np.testing.assert_array_equal(rows[:, :4], sph)
        return
    lv, boxes, depth = leaves(buf, root, n)
    assert depth < STACK and all(1 <= c <= LEAF for _, c in lv)
    slots = sorted(f + j for f, c in lv for j in range(c))
    assert slots == list(range(n))
    np.testing.assert_array_equal(np.sort(idx), np.arange(n))
    np.testing.assert_array_equal(rows[:, :4], sph[idx])
    assert (rows[:, 4].astype(np.float64)
            >= sph[idx, 3].astype(np.float64) ** 2).all()
    lo = np.min([b[0] for b in boxes], 0)
    hi = np.max([b[1] for b in boxes], 0)
    assert (lo <= (sph[:, :3] - np.abs(sph[:, 3:])).min(0)).all()
    assert (hi >= (sph[:, :3] + np.abs(sph[:, 3:])).max(0)).all()


def test_non_finite_rows_and_limits(lib):
    """Rows with a NaN or inf never win or block, so a tree leaves them
    out and the scans still equal the linear scan; more than kMaxSpheres
    rows are refused."""
    sc, sph = TABLES["sphere_grid"]
    bad = sph.copy()
    bad[3, 0] = np.nan
    bad[17, 3] = np.inf
    bad[40, 1] = -np.inf
    buf, root = build(lib, bad)
    lv, _, _ = leaves(buf, root, len(bad))
    assert sum(c for _, c in lv) == len(bad) - 3
    o, d = rays(sph, [], sc.light, 300, 5)
    (t, ids, ok, _), (lt, lid, lok), _, _, _ = run_queries(lib, sc, bad, o,
                                                           d)
    np.testing.assert_array_equal(ids, lid)
    np.testing.assert_array_equal(t, lt)
    np.testing.assert_array_equal(ok, lok)
    # A table above kBvhLinearMax rows keeps a root node even when only a
    # few of its rows are finite (a root leaf is the whole table).
    few = bad[:LINEAR_MAX + 4].copy()
    few[3:, 3] = np.nan
    buf, root = build(lib, few)
    lv, _, _ = leaves(buf, root, len(few))
    assert root >= 0 and sum(c for _, c in lv) == 3
    (t, ids, ok, _), (lt, lid, lok), _, _, _ = run_queries(lib, sc, few, o,
                                                           d)
    np.testing.assert_array_equal(ids, lid)
    np.testing.assert_array_equal(t, lt)
    np.testing.assert_array_equal(ok, lok)
    big = np.zeros((megakernel.MAX_SPHERES + 1, 4), np.float32)
    out = np.zeros(megakernel.bvh_floats(len(big)), np.float32)
    assert lib.bvh_build(_p(big), len(big), _p(out)) == megakernel.BVH_ERROR


@pytest.mark.parametrize("name", ["cornell_box", "sphere_grid"])
def test_budgets_plain_over_live_list(name):
    """The budget kernels' plain version over the live pixels (the list
    the kernels launch over, from ``live_pixels``) equals the full plain
    version (every pixel a lane, the empty ones born dead) bit for bit,
    on ragged spans with most pixels empty."""
    sc = spt.get_scene(name, device="cpu")
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=12, height=10, spp=16, seed=3)
    n_pix = cfg.width * cfg.height
    r = np.random.default_rng(9)
    s_start = torch.from_numpy(r.integers(0, 8, n_pix))
    length = torch.from_numpy(r.integers(1, 9, n_pix))
    length[torch.from_numpy(r.random(n_pix) < 0.7)] = 0
    s_stop = s_start + length
    mask = s_stop > s_start
    live = megakernel.live_pixels(mask, int(mask.sum()))
    assert torch.equal(live.long(), torch.nonzero(mask).flatten())
    full = megakernel.path_trace_regen(
        sc, cfg, 3, cam, torch.arange(n_pix), s_start, s_stop)
    got = megakernel.render_megakernel_budgets_plain(sc, cam, cfg, 3, s_start,
                                                     s_stop, live=live)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert bool((got[0][~mask] == 0).all()) and float(got[0].max()) > 0
