"""Path guiding and the ``cosine`` / ``nee_textbook`` estimators in the port
against the JAX package: ``pow_const``, the voxel grid, the packed lobe
table, ``train_guide``, the unguided estimators against the Pallas
megakernel (interpret mode) and the jnp regenerating wavefront, the guided
kernels' plain versions (rows 4 and 5) against ``render_pallas_guided`` and
``render_pallas_guided_primary`` (interpret mode) on one JAX-trained
table, the fixed-depth ``render_guided``, the refusals, and ``cli render
--guided`` on the CPU.

The table is trained once, by the JAX package, on
``cornell_alcove_baffled`` (16x16x8, 8 bounces, seed 1), and carried into
the port by ``guide_from_jax``; every scene renders with it (the voxel grid
is the same for all scenes, and any table keeps the estimator unbiased)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.core import vecmath as jvm
from small_pathtracer_tpu.experiment import path_guiding as jpg
from small_pathtracer_tpu.integrator import wavefront as jwavefront
from small_pathtracer_tpu.ops import megakernel as jmk
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.convert import (
    camera_from_jax, guide_from_jax, scene_from_jax,
)
from small_pathtracer_tpu_torch.core import vecmath as vm
from small_pathtracer_tpu_torch.experiment import path_guiding as pg
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
from small_pathtracer_tpu_torch.utils import checkpoint as ckpt

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED = 16, 12, 4, 5
BETA, K = 0.6, 8.0
TRAIN = dict(width=16, height=16, spp=8, seed=1)
N_BOUNCES = 8
# The fixed-depth render_guided unrolls its bounces inside one jit: 4 of
# them compile in half the time of 8 (2.3 s against 4.7 s on one core) and
# still guide and probe at several vertices of a path.
FIXED_BOUNCES = 4


@pytest.fixture(scope="module")
def cam():
    jc = jmake_camera(aspect=W / H)
    return jc, camera_from_jax(jc, device="cpu")


@pytest.fixture(scope="module")
def table(cam):
    """JAX's and the port's training pass on cornell_alcove_baffled, and
    JAX's lobe table in both packages' form."""
    js = jget_scene("cornell_alcove_baffled")
    jm = np.asarray(jpg.train_guide(js, cam[0], JRenderConfig(**TRAIN),
                                    N_BOUNCES, jnp.uint32(TRAIN["seed"])))
    pm = pg.train_guide(scene_from_jax(js, device="cpu"), cam[1],
                        spt.RenderConfig(**TRAIN), N_BOUNCES, TRAIN["seed"])
    jmu, juse = jpg.guide_lobes(jnp.asarray(jm))
    return {"jax_moments": jm, "moments": pm.numpy(),
            "jax_guide": (jmu, juse),
            "guide": guide_from_jax(np.asarray(jmu), np.asarray(juse),
                                    device="cpu")}


def _cfgs(estimator):
    kw = dict(width=W, height=H, spp=SPP, estimator=estimator, seed=SEED)
    return JRenderConfig(**kw), spt.RenderConfig(**kw)


@pytest.mark.parametrize("k", [1.0, 8.0, 16.0, 2.5])
def test_pow_const_matches_jax(k):
    """Integer k: the same squaring chain, bit for bit wherever the power is
    a normal float (XLA's CPU flushes subnormal results to zero; torch keeps
    them). k = 2.5: the port's real power (``pow_pos``, exp2/log2 from float
    operations, so the kernel and its plain version agree) within 4e-6
    relative of JAX's x ** 2.5 (measured: at most ~4 ulp)."""
    x = np.random.default_rng(0).random(10_000).astype(np.float32)
    ref = np.asarray(jvm.pow_const(jnp.asarray(x), k))
    got = vm.pow_const(torch.from_numpy(x), k).numpy()
    if float(k).is_integer():
        normal = np.abs(got) >= np.finfo(np.float32).tiny
        assert np.array_equal(got[normal], ref[normal])
        assert np.all(np.abs(got[~normal] - ref[~normal])
                      < np.finfo(np.float32).tiny)
    else:
        np.testing.assert_allclose(got, ref, rtol=4e-6, atol=1e-30)


def test_pow_pos_within_two_ulp():
    """u^(1/9), the k = 8 lobe sample, on 1e6 counter-RNG uniforms: within
    2 ulp of the float64 power (measured 1.72 ulp at most)."""
    u = (np.random.default_rng(1).integers(0, 1 << 24, 1_000_000)
         * 2.0 ** -24).astype(np.float32)
    p = np.float32(1.0 / 9.0)
    got = vm.pow_pos(torch.from_numpy(u), torch.tensor(p)).numpy()
    ref = np.power(u.astype(np.float64), np.float64(p))
    ulp = np.spacing(np.maximum(ref, 1e-30).astype(np.float32))
    assert (np.abs(got - ref) / ulp).max() <= 2.0


def test_voxel_id_matches_jax():
    """1e4 points over and beyond the grid (clamped), and the miss point
    (0, 0, 0): equal ids."""
    r = np.random.default_rng(2)
    x = r.uniform([-30.0, -30.0, -30.0], [130.0, 120.0, 200.0],
                  (10_000, 3)).astype(np.float32)
    x[0] = 0.0
    x[1] = [99.999, 84.999, 170.999]
    ref = np.asarray(jpg.voxel_id(jnp.asarray(x)))
    got = pg.voxel_id(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)
    assert pg.N_VOXELS == jpg.N_VOXELS == 1620


@pytest.mark.parametrize("name,light_id", [("cornell_alcove", 13),
                                             ("cornell_alcove_baffled", 14)])
def test_alcove_preset_leaves_match_jax(name, light_id):
    """The port's alcove presets equal the JAX presets converted, leaf for
    leaf: every rect field, the light's corner and edges and its object id."""
    ours = spt.get_scene(name, device="cpu")
    conv = scene_from_jax(jget_scene(name), device="cpu")
    for f in ours.rects._fields:
        assert torch.equal(getattr(ours.rects, f), getattr(conv.rects, f)), f
    for f in ("corner", "edge_u", "edge_v"):
        assert torch.equal(getattr(ours.light, f), getattr(conv.light, f)), f
    assert ours.light.light_obj_id == conv.light.light_obj_id == light_id


def test_pack_guide_entries_matches_jax(table):
    """The packed table bit for bit; the decoded lobes within 2e-7 of
    JAX's dequantize_guide (its rsqrt and the port's 1/sqrt differ by an
    ulp), the use flags exact."""
    got = mk.pack_guide_entries(table["guide"])
    ref = jmk.pack_guide_entries(table["jax_guide"])
    assert np.array_equal(got, ref)
    mu, use = mk.dequantize_guide(table["guide"])
    jmu, juse = jmk.dequantize_guide(table["jax_guide"])
    assert np.array_equal(use.numpy(), np.asarray(juse))
    assert np.abs(mu.numpy() - np.asarray(jmu)).max() <= 2e-7
    assert int(use.sum()) > 20  # the table guides a real share of voxels


def test_oct_decode_sign_halves():
    """The four sign combinations of the two int16 halves and the sentinel
    decode as JAX's _oct_decode does (within 2e-7), the sentinel unused."""
    halves = [(12000, 3000), (-12000, 3000), (12000, -3000), (-12000, -3000),
              (-32767, 32767), (0, 0)]
    packed = [np.int64(u & 0xFFFF) | (np.int64(v & 0xFFFF) << 16)
              for u, v in halves]
    packed = np.array([p - 2 ** 32 if p >= 2 ** 31 else p for p in packed]
                      + [int(mk.GUIDE_SENTINEL)], np.int32)
    mu, use = mk.oct_decode(torch.from_numpy(packed))
    jx, jy, jz, juse = jmk._oct_decode(jnp.asarray(packed))
    ref = np.stack([np.asarray(jx), np.asarray(jy), np.asarray(jz)], -1)
    assert np.abs(mu.numpy() - ref).max() <= 2e-7
    assert np.array_equal(use.numpy(), np.asarray(juse))
    assert use.tolist() == [True] * 6 + [False]


def test_train_guide_matches_jax(table):
    """The moments within 1e-4 of the largest (JAX sums in float32 in
    order; the port exactly, in fixed point); the use flags equal except
    for moments within 1e-6 of the threshold 1e-3."""
    jm, pm = table["jax_moments"], table["moments"]
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()
    jn = np.linalg.norm(jm.astype(np.float64), axis=1)
    pn = np.linalg.norm(pm.astype(np.float64), axis=1)
    clear = np.abs(jn - 1e-3) > 1e-6
    assert np.array_equal((pn > 1e-3)[clear], (jn > 1e-3)[clear])


def test_train_guide_is_deterministic(cam):
    """Two passes give the same table bits (the sums do not depend on the
    order of additions)."""
    scene = spt.get_scene("cornell_box", device="cpu")
    cfg = spt.RenderConfig(width=16, height=16, spp=2, seed=7)
    a = pg.train_guide(scene, cam[1], cfg, 4, 7)
    b = pg.train_guide(scene, cam[1], cfg, 4, 7)
    assert torch.equal(a, b) and float(a.abs().max()) > 0.0


@pytest.mark.parametrize("estimator", ["cosine", "nee_textbook"])
def test_unguided_estimators_match_jax(cam, estimator):
    """Row 1's plain version with the new estimators on cornell_box against
    the Pallas kernel (interpret mode) and the jnp regen wavefront: traces
    equal, the mean image within 1e-4 (nee_textbook: see _check_image)."""
    js = jget_scene("cornell_box")
    jcfg, cfg = _cfgs(estimator)
    p_img, p_tr = jax.block_until_ready(
        jmk.render_pallas(js, cam[0], jcfg, SEED, interpret=True))
    r_img, r_tr = jax.block_until_ready(
        jwavefront.render_regen(js, cam[0], jcfg, jnp.uint32(SEED)))
    img, tr = mk.render_megakernel(scene_from_jax(js, device="cpu"), cam[1],
                                   cfg, SEED)
    for ref_img, ref_tr in ((p_img, p_tr), (r_img, r_tr)):
        assert tr.tolist() == np.asarray(ref_tr).astype(np.int64).tolist()
        _check_image(img.numpy() / SPP, np.asarray(ref_img) / SPP, estimator)
    assert (tr[1] == 0) == (estimator == "cosine")


def _check_image(got, ref, estimator):
    """Every value of the mean image within 1e-4 of its magnitude (at least
    1). The alcove's light has emission 40 and pixel means reach ~24, and
    paths from points beside a light amplify the ulp-level gaps of the ray
    directions (rsqrt against 1/sqrt): measured 1.9e-5 relative on the
    guided alcove. nee_textbook: 99% of the values, and the channel means
    within 1e-3 relative. A shadow probe that grazes an edge can succeed on
    one side only; the textbook counts the probe either way, so traces stay
    equal while that sample's direct term differs (cornell_box 16x12x4 seed
    5: one pixel 1.6e-3 relative; ROADMAP.md queue 3)."""
    ok = np.abs(got - ref) <= 1e-4 * np.maximum(np.abs(ref), 1.0)
    if estimator == "cosine":
        assert ok.all(), np.abs(got - ref).max()
        return
    assert ok.mean() >= 0.99, ok.mean()
    gm, rm = got.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0)
    assert np.all(np.abs(gm - rm) <= 1e-3 * rm)


# Row 4 and 5 cases: (scene, estimator). cornell_box and the alcove are held
# to traces equal and _check_image; smallpt_original (mirror and glass
# spheres) to tests/test_megakernel_guided.py's own statistical bar.
GUIDED = [("cornell_box", "cosine"), ("cornell_alcove_baffled", "nee_textbook"),
          ("smallpt_original", "cosine")]


def _check_guided(img, tr, j_img, j_tr, scene_name, estimator):
    got = img.numpy() / SPP
    ref = np.asarray(j_img) / SPP
    if scene_name == "smallpt_original":
        # Grazing sphere hits flip between rsqrt forms: >= 93% of pixels
        # within 1e-6, means within 1e-2.
        assert (np.abs(got - ref) < 1e-6).mean() >= 0.93
        assert abs(got.mean() - ref.mean()) < 1e-2
        return
    assert tr.tolist() == np.asarray(j_tr).astype(np.int64).tolist()
    _check_image(got, ref, estimator)


@pytest.mark.parametrize("name,estimator", GUIDED,
                         ids=[f"{n}-{e}" for n, e in GUIDED])
def test_guided_matches_pallas(cam, table, name, estimator):
    """Row 4's plain version against render_pallas_guided (interpret
    mode) on the JAX-trained table."""
    js = jget_scene(name)
    jcfg, cfg = _cfgs(estimator)
    j_img, j_tr = jax.block_until_ready(jmk.render_pallas_guided(
        js, cam[0], jcfg, SEED, table["jax_guide"], BETA, K, interpret=True))
    img, tr = mk.render_megakernel_guided(
        scene_from_jax(js, device="cpu"), cam[1], cfg, SEED, table["guide"],
        BETA, K)
    _check_guided(img, tr, j_img, j_tr, name, estimator)


@pytest.mark.parametrize("name,estimator", GUIDED[1:2],
                         ids=[f"{n}-{e}" for n, e in GUIDED[1:2]])
def test_guided_primary_matches_pallas(cam, table, name, estimator):
    """Row 5's plain version against render_pallas_guided_primary
    (interpret mode), the same bars as row 4 (one scene: each interpret-mode
    render costs ~5 s of the suite's time; the table variant is held to its
    kernel on the card)."""
    js = jget_scene(name)
    jcfg, cfg = _cfgs(estimator)
    j_img, j_tr = jax.block_until_ready(jmk.render_pallas_guided_primary(
        js, cam[0], jcfg, SEED, table["jax_guide"], BETA, K, interpret=True))
    img, tr = mk.render_megakernel_guided_primary(
        scene_from_jax(js, device="cpu"), cam[1], cfg, SEED, table["guide"],
        BETA, K)
    _check_guided(img, tr, j_img, j_tr, name, estimator)


@pytest.mark.parametrize("estimator", ["cosine", "nee_textbook"])
@pytest.mark.parametrize("primary", [False, True], ids=["voxel", "primary"])
def test_empty_table_is_unguided(cam, estimator, primary):
    """An all-sentinel table gives the unguided image and traces bit for
    bit (the mixture's weight is exactly 1 where no lobe guides)."""
    scene = spt.get_scene("smallpt_original", device="cpu")
    _, cfg = _cfgs(estimator)
    empty = (torch.zeros(pg.N_VOXELS, 3),
             torch.zeros(pg.N_VOXELS, dtype=torch.bool))
    fn = (mk.render_megakernel_guided_primary if primary
          else mk.render_megakernel_guided)
    img, tr = fn(scene, cam[1], cfg, SEED, empty, BETA, K)
    u_img, u_tr = mk.render_megakernel(scene, cam[1], cfg, SEED)
    assert torch.equal(img, u_img) and torch.equal(tr, u_tr)


@pytest.mark.parametrize("estimator", ["nee"])
def test_render_guided_fixed_depth_matches_jax(cam, table, estimator):
    """The fixed-depth guided estimator ("nee": the textbook probe and the
    guided continuation) on the dequantized table against JAX's, within
    tests/test_megakernel_guided.py's 4e-4 (the mean image)."""
    js = jget_scene("cornell_box")
    jcfg = JRenderConfig(width=W, height=H, spp=SPP, seed=SEED)
    ref = np.asarray(jpg.render_guided(
        js, cam[0], jcfg, jnp.uint32(SEED),
        jmk.dequantize_guide(table["jax_guide"]), FIXED_BOUNCES, BETA, K,
        estimator=estimator))
    got = pg.render_guided(
        scene_from_jax(js, device="cpu"), cam[1],
        spt.RenderConfig(width=W, height=H, spp=SPP, seed=SEED), SEED,
        mk.dequantize_guide(table["guide"]), FIXED_BOUNCES, BETA, K,
        estimator=estimator)
    assert np.abs(got.numpy() - ref).max() < 4e-4


def _refuse(call, exc, match):
    with pytest.raises(exc, match=match):
        call()


def test_refusals(cam, table):
    """nee with a guide (ValueError, cosine-continuation), and the
    sphere_grid family and sphere_table on (sphere_table mode)."""
    box = spt.get_scene("cornell_box", device="cpu")
    grid = spt.get_scene("sphere_grid", device="cpu")
    sp = spt.get_scene("smallpt_original", device="cpu")
    g = table["guide"]
    cos = spt.RenderConfig(width=4, height=4, spp=1, estimator="cosine")
    for fn in (mk.render_megakernel_guided,
               mk.render_megakernel_guided_primary):
        _refuse(lambda: fn(box, cam[1], spt.RenderConfig(width=4, height=4,
                                                         spp=1), 0, g),
                ValueError, "cosine-continuation")
        _refuse(lambda: fn(grid, cam[1], cos, 0, g), ValueError,
                "does not support sphere_table mode")
        for mode in ("on", "cluster", "cluster_scratch"):
            c = spt.RenderConfig(width=4, height=4, spp=1,
                                 estimator="cosine", sphere_table=mode)
            _refuse(lambda: fn(sp, cam[1], c, 0, g), ValueError,
                    "does not support sphere_table mode")


def test_fit_takes_cosine(cam):
    """Training takes the cosine estimator (rows 8 and 9 trace it): one
    fit step on the box toward twice its own image gives a finite loss and
    raises the light's emission."""
    box = spt.get_scene("cornell_box", device="cpu")
    cos = spt.RenderConfig(width=8, height=8, spp=2, estimator="cosine")
    img, _ = mk.render_megakernel(box, cam[1], cos, 0)
    fitted, losses = mg.fit_megakernel(box, cam[1], cos, img, steps=1)
    assert len(losses) == 1 and losses[0] > 0.0
    light = int(box.light.light_obj_id)
    assert bool((fitted.rects.emission[light]
                 > box.rects.emission[light]).all())


def test_cli_render_guided(tmp_path, capsys, monkeypatch):
    """cli render --guided on the CPU: the guided-voxels line, online
    guiding, and a guided checkpoint that resumes: the rerun retrains the
    same table, matches the checkpoint's fingerprint and renders no span."""
    base = ["render", "--device", "cpu", "--width", "16", "--height", "12",
            "--spp", "4", "--guided", "--estimator", "nee_textbook",
            "--scene", "cornell_alcove_baffled"]
    out = tmp_path / "g.png"
    assert cli_main(base + ["-o", str(out)]) == 0
    err = capsys.readouterr().err
    n = int(re.search(r"guide table trained: (\d+) guided voxels", err)
            .group(1))
    assert n > 0 and out.exists()
    assert cli_main(base + ["--guide-online", "2", "-o", str(out)]) == 0
    assert "traces=" in capsys.readouterr().err
    ck = str(tmp_path / "g.ckpt")
    runs = []
    for name in ("a.png", "b.png"):
        assert cli_main(base + ["--checkpoint", ck, "--checkpoint-every", "2",
                                "-o", str(tmp_path / name)]) == 0
        runs.append(re.search(r"traces=(\d+)", capsys.readouterr().err)
                    .group(1))

        def no_span(*args, **kwargs):
            raise AssertionError("the resumed render rendered a span")

        monkeypatch.setattr(ckpt, "render_megakernel_guided", no_span)
    assert runs[0] == runs[1]
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    with pytest.raises(SystemExit, match="--adaptive-tol"):
        cli_main(base + ["--adaptive-tol", "0.1", "-o", str(out)])
    with pytest.raises(SystemExit, match="cosine, nee_textbook, or mis"):
        cli_main(base[:-4] + ["-o", str(out)])
