"""The forward kernels' rect scan on the CPU: the layout the kernels scan
(``fill_params`` in csrc/megakernel_common.cuh, compiled for the host with
the C++ compiler against tests/_cuda_host.py's stand-in for
``cuda_runtime.h``), a plain
torch copy of the device scan's winner rule over that layout, and the tie
statements that chip_smoke.py's tie phase holds the kernels to, through
the plain version.

The kernels scan the rects one axis group at a time and keep the smallest
(t, id); the shadow probe lets a rect block the light at t <= t_light when
its id is smaller than the light's and at t < t_light otherwise. Rays aimed
at shared edges (the alcove's four ceiling pieces at y = 81.6 meet at
x = 45 and 55 and at z = 63 and 96; the box's faces meet at edges) give
exact ties, which the rule must break as the in-order strict-< scan of
geometry/intersect.py and the JAX package's jnp ``trace`` do. No Pallas,
no JAX compile beyond eager jnp ops."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from small_pathtracer_tpu.geometry import intersect as jintersect
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.convert import scene_from_jax
from small_pathtracer_tpu_torch.experiment import path_guiding as pg
from small_pathtracer_tpu_torch.geometry import intersect
from small_pathtracer_tpu_torch.ops import megakernel
from small_pathtracer_tpu_torch.scene.types import Scene, insert_rect

from _cuda_host import build_host_lib

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

SCENES = ("cornell_box", "cornell_alcove_baffled", "cornell_alcove")

# fill_params on a scene's rects: the scan's ids, then each axis group's
# [begin, split, end], then the light's group; 0 if fill_params refuses.
LAYOUT_SRC = r"""
#include "megakernel_common.cuh"
extern "C" int scan_layout(const float* rect_geom, const int* rect_axis,
                           int n_rects, int light_id, int* out) {
  const float light_f[13] = {}, cam_f[12] = {};
  Params p;
  if (!fill_params(&p, rect_geom, rect_axis, n_rects, light_f, light_id,
                   cam_f, 0u, 1, 1, 1, 1, 1, 0u, 0, 1, 5, 5)) {
    return 0;
  }
  for (int i = 0; i < n_rects; ++i) out[i] = p.scan[i].id;
  for (int a = 0; a < 3; ++a) {
    out[n_rects + 3 * a] = p.groups[a].begin;
    out[n_rects + 3 * a + 1] = p.groups[a].split;
    out[n_rects + 3 * a + 2] = p.groups[a].end;
  }
  out[n_rects + 9] = p.light_axis;
  return 1;
}
"""


@pytest.fixture(scope="module")
def fill_params(tmp_path_factory):
    """fill_params's scan layout, compiled for the host: a function of
    (rect_geom (R, 5) float32, rect_axis (R,) int32, light_id) returning
    (scan ids (R,), groups (3, 3) [begin, split, end], the light's group).
    """
    lib = build_host_lib(tmp_path_factory.mktemp("fill_params"), "layout",
                         LAYOUT_SRC)
    lib.scan_layout.restype = ctypes.c_int
    lib.scan_layout.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def layout(rect_geom, rect_axis, light_id):
        geom = np.ascontiguousarray(rect_geom, dtype=np.float32)
        axis = np.ascontiguousarray(rect_axis, dtype=np.int32)
        R = len(axis)
        out = np.zeros(R + 10, np.int32)
        assert lib.scan_layout(geom.ctypes.data, axis.ctypes.data, R,
                               int(light_id), out.ctypes.data)
        return out[:R], out[R:R + 9].reshape(3, 3), int(out[R + 9])

    return layout


def _scene_layout(fill_params, geom):
    return fill_params(geom.rect_geom, geom.rect_axis, geom.light_id)


@pytest.mark.parametrize("name", SCENES)
def test_layout_keeps_ids_and_light(fill_params, name):
    sc = spt.get_scene(name, device="cpu")
    geom = megakernel.pack_geometry(sc, spt.make_camera(device="cpu"))
    order, groups, a_l = _scene_layout(fill_params, geom)
    axis, light = geom.rect_axis, geom.light_id
    assert sorted(order.tolist()) == list(range(len(axis)))
    assert groups[0, 0] == 0 and groups[2, 2] == len(axis)
    for a, (begin, split, end) in enumerate(groups):
        ids = order[begin:end]
        assert (axis[ids] == a).all() and (np.diff(ids) > 0).all()
        assert (ids[:split - begin] < light).all()
        assert (ids[split - begin:] >= light).all()
        if a > 0:
            assert begin == groups[a - 1, 2]
    assert a_l == axis[light] and order[groups[a_l, 1]] == light


def test_layout_of_uneven_groups(fill_params):
    """Random axes, every light position, an empty group."""
    r = np.random.default_rng(4)
    for axis in (r.integers(0, 3, 29), np.ones(7, np.int64),
                 np.array([2, 0, 2, 2, 0])):
        axis = axis.astype(np.int32)
        rows = np.zeros((len(axis), 5), np.float32)
        for light in range(len(axis)):
            order, groups, a_l = fill_params(rows, axis, light)
            assert sorted(order.tolist()) == list(range(len(axis)))
            assert a_l == axis[light] and order[groups[a_l, 1]] == light
            for a, (begin, split, end) in enumerate(groups):
                assert (axis[order[begin:end]] == a).all()
                assert (order[begin:split] < light).all()
                assert (order[split:end] >= light).all()


# ----------------------------------------------------------------------
# The device scan's rule, written plainly over the layout.

def _axis_hit(row, o, d, inv, d_ok, a):
    """rect_t's expressions for a rect of axis a: (t, hit)."""
    b, c = (1 if a == 0 else 0), (1 if a == 2 else 2)
    k, lo0, lo1, hi0, hi1 = row
    t = (k - o[:, a]) * inv[:, a]
    p0 = o[:, b] + t * d[:, b]
    p1 = o[:, c] + t * d[:, c]
    hit = ((p0 >= lo0) & (p0 <= hi0) & (p1 >= lo1) & (p1 <= hi1)
           & (t > intersect.SELF_HIT_EPS) & d_ok[:, a])
    return t, hit


def grouped_nearest(layout, geom, o, d):
    """nearest in csrc/megakernel_common.cuh over fill_params's layout: per
    group the strict-< scan in id order, then the groups merged by the
    smaller (t, id)."""
    order, groups, _ = _scene_layout(layout, geom)
    rows = torch.from_numpy(geom.rect_geom)
    d_ok = d != 0.0
    inv = 1.0 / torch.where(d_ok, d, 1.0)
    t_best = torch.full((o.shape[0],), intersect.MISS_T)
    best = torch.zeros(o.shape[0], dtype=torch.int64)
    for a, (begin, _, end) in enumerate(groups):
        t_g = torch.full_like(t_best, intersect.MISS_T)
        i_g = torch.full_like(best, -1)
        for i in range(begin, end):
            t, hit = _axis_hit(rows[order[i]], o, d, inv, d_ok, a)
            win = hit & (t < t_g)
            t_g = torch.where(win, t, t_g)
            i_g = torch.where(win, int(order[i]), i_g)
        take = (i_g >= 0) & ((t_g < t_best) | ((t_g == t_best)
                                               & (i_g < best)))
        t_best = torch.where(take, t_g, t_best)
        best = torch.where(take, i_g, best)
    return t_best, best


def grouped_probe(layout, geom, o, d):
    """probe_light: the light's t, then blocked by a row before the
    light's split at t < next-float-above(t_l), or from the split on at
    t < t_l. Returns (success, t_l)."""
    order, groups, _ = _scene_layout(layout, geom)
    rows = torch.from_numpy(geom.rect_geom)
    d_ok = d != 0.0
    inv = 1.0 / torch.where(d_ok, d, 1.0)
    a_l = int(geom.rect_axis[geom.light_id])
    t_l, hit_l = _axis_hit(rows[geom.light_id], o, d, inv, d_ok, a_l)
    t_l = torch.where(hit_l, t_l, intersect.MISS_T)
    t_up = torch.nextafter(t_l, torch.tensor(np.inf, dtype=t_l.dtype))
    blocked = torch.zeros_like(hit_l)
    for a, (begin, split, end) in enumerate(groups):
        for i in range(begin, end):
            t, hit = _axis_hit(rows[order[i]], o, d, inv, d_ok, a)
            blocked |= hit & (t < (t_up if i < split else t_l))
    return hit_l & ~blocked, t_l


def _edge_rays(sc, n, seed):
    """Rays from inside the room (and from points on the rects, as a bounce
    leaves them) aimed at the rects' corners and edge midpoints, and at the
    alcove's ceiling seams."""
    r = np.random.default_rng(seed)
    rects = sc.rects
    k, lo, hi = rects.k.numpy(), rects.lo.numpy(), rects.hi.numpy()
    axis = rects.axis.numpy()
    pts = []
    for i in range(len(k)):
        a = axis[i]
        b, c = (1 if a == 0 else 0), (1 if a == 2 else 2)
        for u in (lo[i, 0], hi[i, 0], (lo[i, 0] + hi[i, 0]) / 2):
            for v in (lo[i, 1], hi[i, 1], (lo[i, 1] + hi[i, 1]) / 2):
                p = np.zeros(3)
                p[a], p[b], p[c] = k[i], u, v
                pts.append(p)
    for z in np.linspace(0.0, 170.0, 35):
        pts += [[45.0, 81.6, z], [55.0, 81.6, z]]
    for x in np.linspace(1.0, 99.0, 21):
        pts += [[x, 81.6, 63.0], [x, 81.6, 96.0]]
    pts = np.asarray(pts, np.float32)
    o = np.stack([r.uniform(2, 98, n), r.uniform(1, 80, n),
                  r.uniform(2, 168, n)], 1).astype(np.float32)
    on = r.integers(len(k), size=n // 2)  # half leave a point on a rect
    a = axis[on]
    for j, (i, ai) in enumerate(zip(on, a)):
        b, c = (1 if ai == 0 else 0), (1 if ai == 2 else 2)
        o[j, ai] = k[i]
        o[j, b] = r.uniform(lo[i, 0], hi[i, 0])
        o[j, c] = r.uniform(lo[i, 1], hi[i, 1])
    d = pts[r.integers(len(pts), size=n)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    keep = np.isfinite(d).all(axis=1)
    return o[keep], d[keep].astype(np.float32)


@pytest.mark.parametrize("name", ("cornell_box", "cornell_alcove_baffled"))
def test_grouped_rule_is_the_in_order_scan(fill_params, name):
    js = jget_scene(name)
    sc = scene_from_jax(js, device="cpu")
    geom = megakernel.pack_geometry(sc, spt.make_camera(device="cpu"))
    o, d = _edge_rays(sc, 1000, 7)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, ids = grouped_nearest(fill_params, geom, to, td)
    h = intersect.trace(sc, to, td)
    ts = intersect.intersect_rects(sc.rects, to, td)
    ties = int(((ts == h.t[:, None]) & h.hit[:, None]).sum(1).gt(1).sum())
    assert ties > 100, ties  # the rays do reach shared edges
    assert torch.equal(t, h.t) and torch.equal(ids, h.obj_id)
    jh = jintersect.trace(js, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jh.obj_id))
    # The probe: success iff the in-order scan's winner is the light.
    L = geom.light_id
    ok, t_l = grouped_probe(fill_params, geom, to, td)
    assert torch.equal(ok, h.hit & (h.obj_id == L))
    assert torch.equal(t_l, ts[:, L])


def test_probe_tie_at_the_light(fill_params):
    """Rays toward light samples from the rects, so the probe meets the
    light; a coplanar copy of the light before it blocks at t == t_light,
    after it does not."""
    sc = spt.get_scene("cornell_alcove_baffled", device="cpu")
    cam = spt.make_camera(device="cpu")
    L = sc.light.light_obj_id
    r = np.random.default_rng(2)
    o, _ = _edge_rays(sc, 1000, 3)
    lp = (sc.light.corner.numpy() + r.random((len(o), 1)) *
          sc.light.edge_u.numpy() + r.random((len(o), 1)) *
          sc.light.edge_v.numpy()).astype(np.float32)
    d = lp - o
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ok, _ = grouped_probe(fill_params, megakernel.pack_geometry(sc, cam),
                          to, td)
    assert int(ok.sum()) > 100
    before = insert_rect(sc, L, L, emission=(0.0, 0.0, 0.0))
    after = insert_rect(sc, len(sc.rects.k), L, emission=(0.0, 0.0, 0.0))
    ok_b, _ = grouped_probe(fill_params, megakernel.pack_geometry(before, cam),
                            to, td)
    ok_a, _ = grouped_probe(fill_params, megakernel.pack_geometry(after, cam),
                            to, td)
    assert not bool(ok_b.any()) and torch.equal(ok_a, ok)


# ----------------------------------------------------------------------
# The tie statements of chip_smoke.py's tie phase (its scenes, made by
# scene.types.insert_rect), on the plain version.

def _with_albedo(scene: Scene, i: int, albedo) -> Scene:
    alb = scene.rects.albedo.clone()
    alb[i] = torch.tensor(albedo)
    return scene._replace(rects=scene.rects._replace(albedo=alb))


# As chip_smoke.py's TIE_WALL, TIE_TINT: the left wall and its copy's albedo.
WALL, TINT = 2, (0.3, 0.6, 0.9)


def test_tie_scenes_on_the_plain_version():
    box = spt.get_scene("cornell_box", device="cpu")
    cam = spt.make_camera(aspect=16 / 12, device="cpu")
    L = box.light.light_obj_id
    table = pg.guide_lobes(pg.train_guide(
        box, cam, spt.RenderConfig(width=16, height=12, spp=4, seed=1), 4, 1))
    renders = {
        "nee": lambda sc: megakernel.render_megakernel_plain(
            sc, cam, spt.RenderConfig(width=16, height=12, spp=2, seed=4),
            4),
        "guided": lambda sc: megakernel.render_megakernel_guided_plain(
            sc, cam, spt.RenderConfig(width=16, height=12, spp=2, seed=4,
                                      estimator="nee_textbook"),
            4, table, 0.6, 8.0),
    }
    for name, render in renders.items():
        img, tr = render(box)
        assert float(img.max()) > 0.0
        later = render(insert_rect(box, len(box.rects.k), WALL, TINT))
        assert torch.equal(later[0], img) and torch.equal(later[1], tr), name
        # Just before the wall: id 0 keeps its rect, whose materials a
        # miss takes (the reference's C15).
        earlier = render(insert_rect(box, WALL, WALL, TINT))
        tinted = render(_with_albedo(box, WALL, TINT))
        assert not torch.equal(tinted[0], img)
        assert torch.equal(earlier[0], tinted[0]), name
        assert torch.equal(earlier[1], tinted[1]), name
        dark, dark_tr = render(insert_rect(box, L, L,
                                           emission=(0.0, 0.0, 0.0)))
        assert not bool(dark.any()) and int(dark_tr[0]) > 0, name
