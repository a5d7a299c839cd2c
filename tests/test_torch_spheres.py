"""The port's sphere scenes against the JAX package: the sphere test, the
nearest hit and shading over rects and spheres, the SPEC and REFR scatter,
the sphere-table kernel's plain version against the Pallas table kernel
(interpret mode), the ``cornell_spheres`` golden, the presets, the
``sphere_table`` values, and the refusal of sphere scenes by the training
path."""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.geometry import intersect as jintersect
from small_pathtracer_tpu.integrator import wavefront as jwavefront
from small_pathtracer_tpu.ops.megakernel import render_pallas
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from small_pathtracer_tpu_torch.core import film
from small_pathtracer_tpu_torch.geometry import intersect
from small_pathtracer_tpu_torch.integrator import wavefront
from small_pathtracer_tpu_torch.ops import megakernel
from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
from small_pathtracer_tpu_torch.scene.types import Spheres

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

GOLDEN = (Path(__file__).resolve().parent.parent / "goldens"
          / "cornell_spheres_64x48x16_nee_seed42.ppm")
N = 10_000
# Rays from inside the Cornell box (the smallpt box for the giant walls).
BOX_LO, BOX_HI = (2.0, 1.0, 1.0), (98.0, 80.0, 169.0)


def _rays(seed, n=N):
    r = np.random.default_rng(seed)
    o = r.uniform(BOX_LO, BOX_HI, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _sphere_arrays(name, rows=slice(None)):
    """A JAX preset's spheres as numpy arrays (center, radius)."""
    s = jget_scene(name).spheres
    return (np.asarray(s.center)[rows].astype(np.float32),
            np.asarray(s.radius)[rows].astype(np.float32))


def _port_spheres(center, radius):
    n = radius.shape[0]
    return Spheres(center=torch.from_numpy(center),
                   radius=torch.from_numpy(radius),
                   albedo=torch.zeros(n, 3), emission=torch.zeros(n, 3),
                   refl=torch.zeros(n, dtype=torch.int64),
                   gloss=torch.zeros(n))


class _JSpheres(NamedTuple):
    center: jnp.ndarray
    radius: jnp.ndarray


def _f64_spheres(center, radius, o, d):
    """The same quadratic in float64: (t (N, S), MISS_T on miss; mask of
    ray-sphere pairs whose hit/miss decision is clear: the ray passes the
    rim by more than 1e-4 relative, and both roots clear eps by more than
    1e-4 relative)."""
    c, r = center.astype(np.float64), radius.astype(np.float64)[None]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    op = c[None] - o64[:, None]
    b = np.einsum("nsk,nk->ns", op, d64)
    m = np.linalg.norm(b[..., None] * d64[:, None] - op, axis=-1)
    det = (r - m) * (r + m)
    sdet = np.sqrt(np.maximum(det, 0.0))
    eps = np.maximum(1e-4, 4e-6 * r)
    t = np.where(b - sdet > eps, b - sdet, b + sdet)
    t = np.where((det > 0) & (t > eps), t, intersect.MISS_T)
    roots = np.stack([b - sdet, b + sdet])
    clear = (np.abs(r - m) > 1e-4 * r) & np.all(
        np.abs(roots - eps) > 1e-4 * np.maximum(np.abs(roots), eps), axis=0)
    return t, clear


@pytest.mark.parametrize("which", ["sphere_grid", "smallpt_giant_walls"])
def test_intersect_spheres_matches_jax(which):
    """Per-sphere t on 10^4 seeded rays: sphere_grid's 64 spheres, and the
    six radius-1e5 walls of smallpt_original_true (geometry only; its
    sphere light is outside this slice). Hit/miss is exact on clear
    pairs."""
    if which == "sphere_grid":
        center, radius = _sphere_arrays("sphere_grid")
    else:
        center, radius = _sphere_arrays("smallpt_original_true", slice(0, 6))
    o, d = _rays(11)
    want = np.asarray(jax.block_until_ready(jintersect.intersect_spheres(
        _JSpheres(jnp.asarray(center), jnp.asarray(radius)),
        jnp.asarray(o), jnp.asarray(d))))
    got = intersect.intersect_spheres(
        _port_spheres(center, radius), torch.from_numpy(o),
        torch.from_numpy(d)).numpy()
    miss = np.float32(intersect.MISS_T)
    t64, clear = _f64_spheres(center, radius, o, d)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal((got < miss)[clear], (want < miss)[clear])
    both = (got < miss) & (want < miss)
    assert both.any()
    if which == "sphere_grid":
        # The contract of tests/test_megakernel.py's table fuzz: t to rtol
        # 2e-4 (1/sqrt here, jax.lax.rsqrt there).
        np.testing.assert_allclose(got[both], want[both], rtol=2e-4, atol=0)
        return
    # Radius 1e5: t = b -/+ sqrt(det) cancels terms of ~1e5 in float32
    # (ulp 0.0078), and a one-ulp sqrt difference moves a near-grazing t
    # by up to ~0.5. Measured: 0.16% of hit pairs differ by more than 2e-4
    # relative (at most 5.0e-3), and the two sides are equally far from
    # the float64 quadratic (8.3e-3 relative at worst, each). So: 99.5%
    # of pairs within 2e-4, and the port no less accurate than JAX
    # (ROADMAP.md queue 3).
    rel = np.abs(got - want)[both] / want[both]
    assert np.mean(rel <= 2e-4) >= 0.995
    err_got = np.abs(got - t64)[both] / t64[both]
    err_want = np.abs(want - t64)[both] / t64[both]
    assert err_got.max() <= 1e-2
    assert err_got.max() <= 1.25 * err_want.max()
    assert np.median(err_got) <= 1.25 * np.median(err_want) + 1e-7


@pytest.fixture(scope="module")
def grid_case():
    o, d = _rays(5)
    js = jget_scene("sphere_grid")
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jh = jintersect.trace(js, jo, jd)
    jsh = jintersect.shade_info(js, jo, jd, jh)
    ts = jnp.concatenate([jintersect.intersect_rects(js.rects, jo, jd),
                          jintersect.intersect_spheres(js.spheres, jo, jd)],
                         axis=1)
    jax.block_until_ready((jh, jsh, ts))
    want = {k: np.asarray(v) for k, v in [*jh._asdict().items(),
                                            *jsh._asdict().items()]}
    want["ts"] = np.asarray(ts)
    scene = scene_from_jax(js, device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h = intersect.trace(scene, to, td)
    sh = intersect.shade_info(scene, to, td, h)
    got = {k: v.numpy() for k, v in [*h._asdict().items(),
                                      *sh._asdict().items()]}
    return want, got


def test_trace_and_shade_over_spheres(grid_case):
    want, got = grid_case
    two = np.sort(want["ts"], axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-4 * np.abs(two[:, 0])
    assert clear.mean() > 0.99
    assert (want["obj_id"][clear] >= 7).any()  # sphere winners are tested
    for k in ("obj_id", "hit", "refl", "albedo", "emission"):
        np.testing.assert_array_equal(got[k][clear], want[k][clear],
                                      err_msg=k)
    np.testing.assert_allclose(got["t"], want["t"], rtol=2e-4, atol=0)
    same = got["obj_id"] == want["obj_id"]
    for k in ("n", "n_geom"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=2e-3, err_msg=k)
    np.testing.assert_allclose(got["x"][same], want["x"][same], rtol=1e-4,
                               atol=1e-3)


def test_strict_scan_first_sphere_wins_a_tie():
    """Two coincident spheres: the lower id wins, as in the JAX argmin."""
    scene = spt.get_scene("cornell_spheres", device="cpu")
    s = scene.spheres
    spheres = Spheres(*(torch.cat([f[:1], f]) for f in s))
    scene = scene._replace(spheres=spheres)
    h = intersect.trace(scene, torch.tensor([[27.0, 60.0, 47.0]]),
                        torch.tensor([[0.0, -1.0, 0.0]]))
    assert int(h.obj_id[0]) == scene.rects.k.shape[0]
    np.testing.assert_allclose(float(h.t[0]), 60.0 - 33.0, rtol=1e-6)


class _Sh(NamedTuple):
    n: object
    n_geom: object


@pytest.fixture(scope="module")
def scatter_case():
    """Seeded incoming directions, geometric normals and coins; the
    oriented normal faces the ray, so about half the lanes enter the glass
    and half leave it (where most grazing lanes reflect totally)."""
    r = np.random.default_rng(9)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ng = r.normal(size=(N, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    n = np.where((np.sum(ng * d, axis=1) < 0)[:, None], ng, -ng)
    u = r.uniform(size=N).astype(np.float32)
    return d, ng, n, u


def test_spec_scatter_matches_jax(scatter_case):
    d, ng, n, _ = scatter_case
    jd, jw = jwavefront._spec_scatter(_Sh(jnp.asarray(n), jnp.asarray(ng)),
                                      jnp.asarray(d))
    pd, pw = wavefront._spec_scatter(
        _Sh(torch.from_numpy(n), torch.from_numpy(ng)), torch.from_numpy(d))
    # Measured: bit-identical (the same products and sums in both).
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))


def test_refr_scatter_matches_jax(scatter_case):
    d, ng, n, u = scatter_case
    jd, jw = jwavefront._refr_scatter(_Sh(jnp.asarray(n), jnp.asarray(ng)),
                                      jnp.asarray(d), jnp.asarray(u))
    jd, jw = np.asarray(jd), np.asarray(jw)
    pd, pw = wavefront._refr_scatter(
        _Sh(torch.from_numpy(n), torch.from_numpy(ng)), torch.from_numpy(d),
        torch.from_numpy(u))
    pd, pw = pd.numpy(), pw.numpy()
    into = np.sum(ng * n, axis=1) > 0
    ddn = np.sum(d * n, axis=1)
    nnt = np.where(into, 1 / 1.5, 1.5)
    cos2t = 1 - nnt * nnt * (1 - ddn * ddn)
    tir = cos2t < 0
    assert into.any() and (~into & ~tir).any() and tir.any()
    # The coin compares u with P = .25 + .5 Re; Re differs by a few ulps
    # (c*c*c*c*c and 1/sqrt here, c**5 and rsqrt there), so a lane whose u
    # lies within 1e-5 of P may take the other ray. Elsewhere: directions
    # to 1e-6, weights to rtol 1e-5 with atol 1e-6 (1 - Re cancels near
    # grazing entry). Measured: no lane near the coin's edge, directions
    # within 1.2e-7, weights within 4.8e-7 (5.6e-6 relative where w > 1e-3).
    re = 0.04 + 0.96 * (1 - np.where(into, -ddn, np.sum(jd * ng, axis=1)))**5
    sure = np.abs(u - (0.25 + 0.5 * re)) > 1e-5
    assert sure.mean() > 0.999
    np.testing.assert_allclose(pd[sure], jd[sure], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pw[sure], jw[sure], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pw[tir], 1.0)


# Whole renders: the port's plain version against the Pallas table kernel
# in interpret mode (as tests/test_megakernel.py runs it), made once.
RENDERS = {
    "sphere_grid": (16, 16, 2, "on"),
    "smallpt_original": (16, 16, 4, "auto"),
}
SEED = 4


@pytest.fixture(scope="module")
def renders():
    out = {}
    for name, (w, h, spp, table) in RENDERS.items():
        js, jc = jget_scene(name), jmake_camera()
        cfg = JRenderConfig(width=w, height=h, spp=spp, estimator="nee",
                            seed=SEED, sphere_table=table)
        img, tr = jax.block_until_ready(
            render_pallas(js, jc, cfg, SEED, interpret=True))
        pcfg = spt.RenderConfig(width=w, height=h, spp=spp, seed=SEED,
                                sphere_table=table)
        pimg, ptr = megakernel.render_megakernel(
            scene_from_jax(js, device="cpu"),
            camera_from_jax(jc, device="cpu"), pcfg, SEED)
        out[name] = (np.asarray(img) / spp, np.asarray(tr).astype(np.int64),
                     pimg.numpy() / spp, ptr.numpy())
    return out


# Measured (this file's seeds and shapes): sphere_grid traces [1422, 861]
# here against [1420, 859] in JAX, 99.6% of pixels within 1e-4, image
# means 2.0e-4 apart; smallpt_original traces equal ([2673, 1345]), every
# pixel within 4.1e-5. Floors with headroom below those shares.
PIXEL_FLOOR = {"sphere_grid": 0.98, "smallpt_original": 0.99}
TRACES_EQUAL = {"smallpt_original"}


@pytest.mark.parametrize("name", list(RENDERS))
def test_plain_version_matches_pallas_table_kernel(renders, name):
    want, want_tr, got, got_tr = renders[name]
    assert np.all(np.isfinite(got))
    if name in TRACES_EQUAL:
        np.testing.assert_array_equal(got_tr, want_tr)
    # Grazing sphere hits flip between 1/sqrt and jax.lax.rsqrt, so trace
    # counts are held to tests/test_megakernel.py's 2e-2 relative.
    np.testing.assert_allclose(got_tr, want_tr, rtol=2e-2, atol=0)
    assert abs(float(got.mean()) - float(want.mean())) < 1e-2
    same = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert same.mean() >= PIXEL_FLOOR[name], same.mean()


def test_spans_add_up_with_spheres(renders):
    """Spans of the sample range add up to the full render, SPEC and REFR
    included: every draw is keyed by (seed, path, counter)."""
    scene = spt.get_scene("smallpt_original", device="cpu")
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=16, height=16, spp=4, seed=SEED)
    a, ta = megakernel.render_megakernel(scene, cam, cfg, SEED, 0, 1)
    b, tb = megakernel.render_megakernel(scene, cam, cfg, SEED, 1, 3)
    _, _, full, full_tr = renders["smallpt_original"]
    np.testing.assert_array_equal((ta + tb).numpy(), full_tr)
    np.testing.assert_allclose((a + b).numpy() / 4, full, rtol=1e-5,
                               atol=1e-6)


# Measured here and reused by chip_smoke.py: 97.89% of bytes equal
# (grazing sphere hits flip between 1/sqrt and jax.lax.rsqrt, so below the
# box's 99%), channel means within 0.0094 levels.
GOLDEN_EQ_FLOOR = 0.96


def test_sphere_golden_without_jax():
    """The port alone against the committed cornell_spheres golden (the
    JAX package rendered it on the CPU)."""
    cfg = spt.RenderConfig(width=64, height=48, spp=16, seed=42)
    img, _ = spt.render(spt.get_scene("cornell_spheres", device="cpu"),
                        spt.make_camera(aspect=64 / 48, device="cpu"), cfg)
    got = film.tonemap_u8(img).numpy()
    golden = film.read_ppm(str(GOLDEN))
    assert got.shape == golden.shape
    assert np.mean(got == golden) >= GOLDEN_EQ_FLOOR
    gap = np.abs(got.reshape(-1, 3).astype(np.float64).mean(0)
                 - golden.reshape(-1, 3).astype(np.float64).mean(0))
    assert gap.max() <= 0.5, gap


@pytest.mark.parametrize("name", ["cornell_spheres", "smallpt_original",
                                  "sphere_grid", "sphere_grid_256",
                                  "sphere_grid_1024"])
def test_sphere_preset_leaves_match_jax(name):
    """The port's preset equals the JAX preset converted, leaf for leaf
    (sphere_grid's albedos and SPEC choices are the same numpy draws)."""
    ours = spt.get_scene(name, device="cpu")
    conv = scene_from_jax(jget_scene(name), device="cpu")
    for block in ("rects", "spheres"):
        a, b = getattr(ours, block), getattr(conv, block)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (block, f)
    for f in ("corner", "edge_u", "edge_v"):
        assert torch.equal(getattr(ours.light, f), getattr(conv.light, f))
    assert ours.light.light_obj_id == conv.light.light_obj_id == 6


@pytest.mark.parametrize("table", ["on", "off", "cluster",
                                   "cluster_scratch"])
def test_sphere_table_values_give_one_image(table):
    """One sphere scan on the card, so every sphere_table value renders
    the same image as "auto" (and the plain version ignores it)."""
    scene = spt.get_scene("sphere_grid", device="cpu")
    cam = spt.make_camera(device="cpu")
    imgs = []
    for t in ("auto", table):
        cfg = spt.RenderConfig(width=8, height=8, spp=2, seed=SEED,
                               sphere_table=t)
        imgs.append(megakernel.render_megakernel(scene, cam, cfg, SEED))
    assert torch.equal(imgs[0][0], imgs[1][0])
    assert torch.equal(imgs[0][1], imgs[1][1])


def test_sphere_scene_goes_to_the_table_kernel():
    assert not megakernel.uses_sphere_table(
        spt.get_scene("cornell_box", device="cpu"))
    for name in ("cornell_spheres", "smallpt_original", "sphere_grid"):
        assert megakernel.uses_sphere_table(spt.get_scene(name,
                                                          device="cpu"))
    # SPEC/REFR rects alone also need the table kernel's branches.
    box = spt.get_scene("cornell_box", device="cpu")
    mirror = box._replace(rects=box.rects._replace(
        refl=torch.where(torch.arange(17) == 0, 1, box.rects.refl)))
    assert megakernel.uses_sphere_table(mirror)


def _training_calls(scene, cam, cfg):
    alb, emi = (t.requires_grad_() for t in mg.pack_materials(scene))
    g = torch.zeros(cfg.height, cfg.width, 3)
    return {
        "render_megakernel_mat": lambda: mg.render_megakernel_mat(
            scene, cam, cfg, alb, emi, SEED),
        "render_megakernel_vjp": lambda: mg.render_megakernel_vjp(
            scene, cam, cfg, alb, emi, SEED, g),
        "RenderMaterials": lambda: mg.RenderMaterials.apply(
            alb, emi, scene, cam, cfg, SEED),
        "fit_megakernel": lambda: mg.fit_megakernel(
            scene, cam, cfg, g, steps=1),
    }


@pytest.mark.parametrize("call", ["render_megakernel_mat",
                                  "render_megakernel_vjp", "RenderMaterials",
                                  "fit_megakernel"])
@pytest.mark.parametrize("name", ["sphere_grid", "smallpt_original"])
def test_training_refuses_sphere_scenes(name, call):
    """Rows 8 and 9 know rects and DIFF only: every training entry point
    refuses a sphere or SPEC/REFR scene on every device, the CPU too."""
    scene = spt.get_scene(name, device="cpu")
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=4, height=4, spp=1, seed=SEED)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 23"):
        _training_calls(scene, cam, cfg)[call]()
