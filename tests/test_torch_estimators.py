"""The estimators of ROADMAP item 10's forward half in the port against the
JAX package: ``uniform``, ``uniform_corrected``, ``mixture`` (with its
``mixture_q``) and ``mis``, and ``light_sample_mode='glibc_overflow'``,
through the plain version of rows 1-7 (the eager ``path_trace_regen``)
against the jnp regenerating wavefront ``render_regen`` (the kernel's
semantic twin) on ``cornell_box`` and ``smallpt_original``, and guided
``mis`` (rows 4 and 5) against ``render_pallas_guided`` (interpret mode)
and an empty table against unguided ``mis``. The paths and refusals that
need no JAX program are in tests/test_torch_estimator_paths.py.

The JAX side of each comparison is made once per module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.integrator import wavefront as jwavefront
from small_pathtracer_tpu.ops import megakernel as jmk
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from small_pathtracer_tpu_torch.experiment import path_guiding as pg
from small_pathtracer_tpu_torch.integrator import sampling
from small_pathtracer_tpu_torch.ops import megakernel as mk

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED = 32, 24, 4, 3
GLIBC = {"light_sample_mode": "glibc_overflow"}
# cornell_box at 32x24x4, seed 3: each case's RenderConfig fields.
BOX = {
    "uniform": {"estimator": "uniform"},
    "uniform_corrected": {"estimator": "uniform_corrected"},
    "mixture": {"estimator": "mixture"},
    "mixture_q0.3": {"estimator": "mixture", "mixture_q": 0.3},
    "mis": {"estimator": "mis"},
    "nee_glibc": {"estimator": "nee", **GLIBC},
    "mixture_glibc": {"estimator": "mixture", **GLIBC},
}
EXACT = ["mixture", "mixture_q0.3", "mis", "nee_glibc", "mixture_glibc"]


def _cfgs(width=W, height=H, spp=SPP, seed=SEED, **kw):
    kw = dict(width=width, height=height, spp=spp, seed=seed, **kw)
    return JRenderConfig(**kw), spt.RenderConfig(**kw)


@pytest.fixture(scope="module")
def box():
    """Each BOX case through JAX's render_regen and the port's plain
    version of rows 1 and 2 (render_megakernel on the CPU)."""
    js, jc = jget_scene("cornell_box"), jmake_camera()
    scene = scene_from_jax(js, device="cpu")
    cam = camera_from_jax(jc, device="cpu")
    out = {}
    for name, kw in BOX.items():
        jcfg, cfg = _cfgs(**kw)
        j_img, j_tr = jax.block_until_ready(
            jwavefront.render_regen(js, jc, jcfg, jnp.uint32(SEED)))
        img, tr = mk.render_megakernel(scene, cam, cfg, SEED)
        out[name] = (np.asarray(j_img), np.asarray(j_tr).astype(np.int64),
                     img.numpy(), tr.numpy())
    return scene, cam, out


@pytest.mark.parametrize("name", EXACT)
def test_box_matches_jnp_regen(box, name):
    """Both trace counters exact and the image within 1e-4 (measured: mis
    2.2e-4 at most on values near 3, 6.8e-5 relative; the others 4.7e-5:
    1/sqrt here, jax.lax.rsqrt and XLA's fusion there)."""
    want, want_tr, got, got_tr = box[2][name]
    np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got_tr[1] > 0


@pytest.mark.parametrize("name", ["uniform", "uniform_corrected"])
def test_uniform_box_near_jnp_regen(box, name):
    """The uniform hemisphere's grazing directions turn ulp-level gaps into
    different paths: a direction one ulp apart lands a hit point 1.5e-5
    apart on the left wall, on the wall's other side, and the next
    near-tangent bounce re-hits the wall in JAX and reaches the floor
    here. Measured (this case): extend 26520 against 26570 (-0.19%), no
    probes, 1 (uniform) and 2 (uniform_corrected) of 768 pixels off by
    more than 1e-4 (ROADMAP.md queue 3). So: extend within 0.5%, >= 99.5%
    of pixels within 1e-4, the image means within 1e-3 relative."""
    want, want_tr, got, got_tr = box[2][name]
    assert got_tr[1] == want_tr[1] == 0
    assert abs(int(got_tr[0]) - int(want_tr[0])) <= 5e-3 * want_tr[0]
    same = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert same.mean() >= 0.995, same.mean()
    gm, wm = got.reshape(-1, 3).mean(0), want.reshape(-1, 3).mean(0)
    assert np.all(np.abs(gm - wm) <= 1e-3 * wm), (gm, wm)


def test_uniform_sampler_matches_jax():
    """sample_uniform on 1e4 seeded normals and uniforms against JAX's:
    the same expressions, within 2 ulp (1/sqrt against rsqrt)."""
    from small_pathtracer_tpu.integrator import sampling as jsampling

    r = np.random.default_rng(1)
    n = r.normal(size=(10_000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u1, u2 = r.random((2, 10_000)).astype(np.float32)
    want = np.asarray(jsampling.sample_uniform(*map(jnp.asarray, (n, u1, u2))))
    got = sampling.sample_uniform(*map(torch.from_numpy, (n, u1, u2))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)


def test_glibc_offset_matches_jax():
    """glibc's wrapped offsets bit for bit on every 24-bit uniform of a
    seeded draw and the edges of the range (0, 2^-24, 1 - 2^-24)."""
    from small_pathtracer_tpu.integrator import sampling as jsampling

    u = np.concatenate([
        np.random.default_rng(2).integers(0, 1 << 24, 100_000),
        [0, 1, (1 << 24) - 1]]).astype(np.float32) * np.float32(2.0 ** -24)
    want = np.asarray(jsampling._glibc_overflow_offset(jnp.asarray(u)))
    got = sampling.glibc_overflow_offset(torch.from_numpy(u)).numpy()
    assert np.array_equal(got, want)
    assert got.min() < -0.9 and got.max() > 0.9


@pytest.fixture(scope="module")
def spheres():
    """smallpt_original (mirror and glass spheres) at 16x16x4, seed 4,
    through JAX's render_regen and the port's plain version of row 2."""
    js, jc = jget_scene("smallpt_original"), jmake_camera()
    scene = scene_from_jax(js, device="cpu")
    cam = camera_from_jax(jc, device="cpu")
    out = {}
    for est in ("mis", "uniform_corrected"):
        jcfg, cfg = _cfgs(16, 16, 4, 4, estimator=est)
        j_img, j_tr = jax.block_until_ready(
            jwavefront.render_regen(js, jc, jcfg, jnp.uint32(4)))
        img, tr = mk.render_megakernel(scene, cam, cfg, 4)
        out[est] = (np.asarray(j_img) / 4, np.asarray(j_tr).astype(np.int64),
                    img.numpy() / 4, tr.numpy())
    return out


@pytest.mark.parametrize("estimator", ["mis", "uniform_corrected"])
def test_spec_refr_matches_jnp_regen(spheres, estimator):
    """tests/test_torch_spheres.py's contract for smallpt_original: traces
    equal, the mean image within 1e-2, >= 99% of pixels within 1e-4.
    uniform_corrected's traces are held to that file's 2e-2 for the other
    sphere scenes instead: the uniform sampler's grazing directions
    (test_uniform_box_near_jnp_regen) make one path a bounce longer in JAX
    (measured: extend 6964 against 6965; every pixel within 6.3e-5)."""
    want, want_tr, got, got_tr = spheres[estimator]
    assert np.all(np.isfinite(got))
    if estimator == "mis":
        np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_allclose(got_tr, want_tr, rtol=2e-2, atol=0)
    assert abs(float(got.mean()) - float(want.mean())) < 1e-2
    same = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert same.mean() >= 0.99, same.mean()


# Guided mis: the alcove at 16x12x2 with a table JAX trains once.
GW, GH, GSPP, GSEED = 16, 12, 2, 5
BETA, K = 0.6, 8.0


@pytest.fixture(scope="module")
def guided():
    """A lobe table the port trains on cornell_alcove_baffled (16x16x8, 8
    bounces, seed 1; tests/test_torch_guiding.py holds train_guide to
    JAX's), handed to both packages, and guided mis through JAX's
    render_pallas_guided (interpret mode) on it."""
    js = jget_scene("cornell_alcove_baffled")
    jc = jmake_camera(aspect=GW / GH)
    scene = scene_from_jax(js, device="cpu")
    cam = camera_from_jax(jc, device="cpu")
    guide = pg.guide_lobes(pg.train_guide(
        scene, cam, spt.RenderConfig(width=16, height=16, spp=8, seed=1), 8,
        1))
    jguide = tuple(jnp.asarray(t.numpy()) for t in guide)
    jcfg, cfg = _cfgs(GW, GH, GSPP, GSEED, estimator="mis")
    j_img, j_tr = jax.block_until_ready(jmk.render_pallas_guided(
        js, jc, jcfg, GSEED, jguide, BETA, K, interpret=True))
    return {"scene": scene, "cam": cam, "cfg": cfg, "guide": guide,
            "jax": (np.asarray(j_img) / GSPP,
                    np.asarray(j_tr).astype(np.int64))}


def test_guided_mis_matches_pallas(guided):
    """Row 4's plain version with mis (the mixture's pdf in both balance
    weights) against render_pallas_guided: traces equal, >= 99% of the
    values within 1e-4 of their magnitude (at least 1), the channel means
    within 1e-3 relative (tests/test_torch_guiding.py's nee_textbook bar:
    a probe grazing an edge can succeed on one side only)."""
    img, tr = mk.render_megakernel_guided(
        guided["scene"], guided["cam"], guided["cfg"], GSEED,
        guided["guide"], BETA, K)
    want, want_tr = guided["jax"]
    got = img.numpy() / GSPP
    assert tr.tolist() == want_tr.tolist()
    ok = np.abs(got - want) <= 1e-4 * np.maximum(np.abs(want), 1.0)
    assert ok.mean() >= 0.99, ok.mean()
    gm, wm = got.reshape(-1, 3).mean(0), want.reshape(-1, 3).mean(0)
    assert np.all(np.abs(gm - wm) <= 1e-3 * wm), (gm, wm)
    assert int(guided["guide"][1].sum()) > 20


@pytest.mark.parametrize("primary", [False, True], ids=["voxel", "primary"])
def test_empty_table_is_unguided_mis(guided, primary):
    """Rows 4 and 5 with an all-sentinel table give unguided mis bit for
    bit: the mixture's pdf is the cosine pdf wherever no lobe guides."""
    empty = (torch.zeros(pg.N_VOXELS, 3),
             torch.zeros(pg.N_VOXELS, dtype=torch.bool))
    fn = (mk.render_megakernel_guided_primary if primary
          else mk.render_megakernel_guided)
    sc, cam, cfg = guided["scene"], guided["cam"], guided["cfg"]
    img, tr = fn(sc, cam, cfg, GSEED, empty, BETA, K)
    u_img, u_tr = mk.render_megakernel(sc, cam, cfg, GSEED)
    assert torch.equal(img, u_img) and torch.equal(tr, u_tr)
