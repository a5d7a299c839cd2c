"""Material training on sphere scenes, SPEC/REFR materials and the
``cosine`` and ``nee_textbook`` estimators against the JAX package: the
runtime-material forward's plain version against ``render_pallas_mat`` on
``cornell_spheres`` and ``smallpt_original``, the adjoint's plain version
against ``render_pallas_vjp`` on ``smallpt_original`` (mirror and glass)
with ``cosine`` and on ``cornell_box`` with ``cosine`` and
``nee_textbook`` (the Pallas kernels in interpret mode, as
tests/test_megakernel_grad.py runs them), the tables' layout, the training
entry points on every sphere preset and estimator, the sharded step, and
``cli fit`` on a sphere scene.

16x12x4, max_bounces=8, seed 3 (tests/test_megakernel_grad.py's shape).
The JAX results are made once per module: the two forwards cost a few
seconds each to trace and compile in interpret mode, the three adjoints
~9 s (``smallpt_original``) and ~20-25 s (``cornell_box``) each."""

import json

import numpy as np
import pytest
import torch

import jax

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.ops import megakernel_grad as jgrad
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.convert import (
    camera_from_jax, materials_from_jax, scene_from_jax,
)
from small_pathtracer_tpu_torch.ops import megakernel, megakernel_grad as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 16, 12, 4, 3, 8
# A pixel's radiance sum "differs" from JAX's beyond this (1e-4 of the
# mean, the sphere contract of tests/test_torch_spheres.py).
PIX_TOL = 1e-4 * SPP


def _cfgs(est):
    return (JRenderConfig(width=W, height=H, spp=SPP, estimator=est,
                          seed=SEED, max_bounces=BOUNCES),
            spt.RenderConfig(width=W, height=H, spp=SPP, estimator=est,
                             seed=SEED, max_bounces=BOUNCES))


def _port(js):
    return (scene_from_jax(js, device="cpu"),
            camera_from_jax(jmake_camera(), device="cpu"))


def _differing(img, want):
    """(h, w) mask of the pixels whose radiance sums differ by more than
    PIX_TOL."""
    return np.abs(np.asarray(img) - np.asarray(want)).max(axis=-1) > PIX_TOL


@pytest.fixture(scope="module")
def jax_side():
    """JAX at 16x12x4: the runtime-material forward on cornell_spheres
    (nee) and smallpt_original (cosine); the adjoint on smallpt_original
    (cosine) under a numpy-seeded cotangent zeroed on the pixels whose
    radiance differs from the port's plain forward, and on cornell_box
    (cosine, nee_textbook) under the same cotangent unmasked."""
    rng = np.random.default_rng(11)
    g_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    jc = jmake_camera()
    out = {"g_img": g_img}
    for name, est in (("cornell_spheres", "nee"),
                      ("smallpt_original", "cosine")):
        js = jget_scene(name)
        jcfg, _ = _cfgs(est)
        alb, emi = jgrad.pack_materials(js)
        img, tr = jax.block_until_ready(jgrad.render_pallas_mat(
            js, jc, jcfg, alb, emi, SEED, interpret=True))
        out[name] = {"scene": js, "alb": np.asarray(alb),
                     "emi": np.asarray(emi), "img": np.asarray(img),
                     "traces": np.asarray(tr).astype(np.int64)}
    # The port's forward on smallpt_original picks the pixels to mask.
    sp = out["smallpt_original"]
    sc, cam = _port(sp["scene"])
    alb, emi = materials_from_jax(sp["alb"], sp["emi"], device="cpu")
    img, _ = mg.render_megakernel_mat(sc, cam, _cfgs("cosine")[1], alb, emi,
                                      SEED)
    flip = _differing(img.numpy(), sp["img"])
    g_sp = np.where(flip[..., None], 0.0, g_img).astype(np.float32)
    sp["flip"], sp["g_img"] = flip, g_sp
    sp["vjp"] = tuple(np.asarray(v) for v in jax.block_until_ready(
        jgrad.render_pallas_vjp(sp["scene"], jc, _cfgs("cosine")[0],
                                sp["alb"], sp["emi"], SEED, g_sp,
                                interpret=True)))
    box = jget_scene("cornell_box")
    alb, emi = jgrad.pack_materials(box)
    out["cornell_box"] = {"scene": box, "alb": np.asarray(alb),
                          "emi": np.asarray(emi)}
    for est in ("cosine", "nee_textbook"):
        out["cornell_box"][est] = tuple(
            np.asarray(v) for v in jax.block_until_ready(
                jgrad.render_pallas_vjp(box, jc, _cfgs(est)[0], alb, emi,
                                        SEED, g_img, interpret=True)))
    return out


# The sphere contract (tests/test_torch_spheres.py): traces equal where
# measured equal, else within 2e-2; the image means within 1e-2; this
# share of pixels within PIX_TOL. Measured: cornell_spheres traces
# [1829, 1063] here against [1822, 1056], 3 of 192 pixels beyond PIX_TOL
# (98.4%), means 2.3e-4 apart; smallpt_original (cosine) traces equal
# ([4461, 0]), every pixel within 6.3e-7.
FWD = {"cornell_spheres": ("nee", 0.97, False),
       "smallpt_original": ("cosine", 1.0, True)}


@pytest.mark.parametrize("name", list(FWD))
def test_mat_forward_matches_pallas_mat(jax_side, name):
    est, floor, traces_equal = FWD[name]
    side = jax_side[name]
    sc, cam = _port(side["scene"])
    _, cfg = _cfgs(est)
    alb, emi = materials_from_jax(side["alb"], side["emi"], device="cpu")
    img, traces = mg.render_megakernel_mat(sc, cam, cfg, alb, emi, SEED)
    got, want = img.numpy(), side["img"]
    assert np.all(np.isfinite(got))
    if traces_equal:
        np.testing.assert_array_equal(traces.numpy(), side["traces"])
    np.testing.assert_allclose(traces.numpy(), side["traces"], rtol=2e-2,
                               atol=0)
    assert abs(float(got.mean()) - float(want.mean())) / SPP < 1e-2
    assert np.mean(~_differing(got, want)) >= floor
    # Equal tables: the render wrapper's result (row 2's plain version),
    # bit for bit.
    b_img, b_tr = megakernel.render_megakernel(sc, cam, cfg, SEED)
    assert torch.equal(img, b_img) and torch.equal(traces, b_tr)


def _close_to_max(got, want, rel):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * scale, (err, scale)


def test_vjp_plain_matches_pallas_vjp_spec_refr(jax_side):
    """smallpt_original (a mirror and a glass sphere), cosine: within 1e-2
    of each table's largest entry, tests/test_megakernel_grad.py's bound
    for this scene. The cotangent is zeroed on the pixels whose radiance
    differs from JAX's (grazing sphere hits flip between 1/sqrt and
    jax.lax.rsqrt); measured: none at this seed and shape (at most 2
    allowed), albedo within 1.8e-7 and emission within 1.9e-6 of the
    largest entries (65.6 and 63.4)."""
    sp = jax_side["smallpt_original"]
    assert int(sp["flip"].sum()) <= 2
    sc, cam = _port(sp["scene"])
    _, cfg = _cfgs("cosine")
    alb, emi = materials_from_jax(sp["alb"], sp["emi"], device="cpu")
    galb, gemi = mg.render_megakernel_vjp(sc, cam, cfg, alb, emi, SEED,
                                          torch.from_numpy(sp["g_img"]))
    want_alb, want_emi = sp["vjp"]
    assert galb.shape == gemi.shape == want_alb.shape == (9, 3)
    _close_to_max(galb.numpy(), want_alb, 1e-2)
    _close_to_max(gemi.numpy(), want_emi, 1e-2)


@pytest.mark.parametrize("est", ["cosine", "nee_textbook"])
def test_vjp_plain_matches_pallas_vjp_estimators(jax_side, est):
    """cornell_box, within 5e-3 of each table's largest entry
    (tests/test_megakernel_grad.py's bound). nee_textbook leaves the
    light's albedo row out, as that test does: its gradient is knife-edge
    1/t^2 shadow rays from vertices on the light's plane (measured here
    [-1.9e4, 1.2e5, -8.6e4] against JAX's [-4.3e4, 1.7e5, -3.6e5]).
    Measured: every other entry within 3.1e-6 of the largest."""
    box = jax_side["cornell_box"]
    sc, cam = _port(box["scene"])
    _, cfg = _cfgs(est)
    alb, emi = materials_from_jax(box["alb"], box["emi"], device="cpu")
    galb, gemi = mg.render_megakernel_vjp(
        sc, cam, cfg, alb, emi, SEED, torch.from_numpy(jax_side["g_img"]))
    want_alb, want_emi = (v.copy() for v in box[est])
    galb = galb.numpy().copy()
    if est == "nee_textbook":
        light = int(sc.light.light_obj_id)
        galb[light] = want_alb[light] = 0.0
    _close_to_max(galb, want_alb, 5e-3)
    _close_to_max(gemi.numpy(), want_emi, 5e-3)


def test_pack_unpack_sphere_scene(jax_side):
    """The tables in the JAX package's order (rects, then spheres), and
    back into the scene."""
    side = jax_side["cornell_spheres"]
    sc, _ = _port(side["scene"])
    alb, emi = mg.pack_materials(sc)
    R, S = sc.rects.k.shape[0], sc.spheres.radius.shape[0]
    assert alb.shape == emi.shape == (R + S, 3) and S > 0
    j_alb, j_emi = materials_from_jax(side["alb"], side["emi"], device="cpu")
    assert torch.equal(alb, j_alb) and torch.equal(emi, j_emi)
    back = mg.unpack_materials(sc, alb * 0.5, emi + 1.0)
    assert torch.equal(back.rects.albedo, sc.rects.albedo * 0.5)
    assert torch.equal(back.spheres.albedo, sc.spheres.albedo * 0.5)
    assert torch.equal(back.spheres.emission, sc.spheres.emission + 1.0)
    for a, b in zip(mg.pack_materials(back), (alb * 0.5, emi + 1.0)):
        assert torch.equal(a, b)
    gs = mg.material_grads_to_scene(sc, alb, -emi)
    assert torch.equal(gs.spheres.albedo, sc.spheres.albedo)
    assert torch.equal(gs.spheres.emission, -sc.spheres.emission)
    assert not bool(gs.spheres.center.any())
    with pytest.raises(ValueError, match="table"):
        mg.unpack_materials(sc, alb[:R], emi[:R])


@pytest.mark.parametrize("est", ["nee", "cosine", "nee_textbook"])
@pytest.mark.parametrize("name", ["cornell_spheres", "smallpt_original",
                                  "sphere_grid"])
def test_training_entry_points_on_sphere_scenes(name, est):
    """loss_and_material_grads, RenderMaterials, fit_megakernel and
    material_train_step_sharded (a 1x1 mesh) on every sphere preset with
    every estimator: the loss and (K, 3) gradients are finite, the sharded
    step's are the unsharded step's, RenderMaterials' backward is the
    plain adjoint, and a fit step moves the tables against the
    gradient."""
    sc = spt.get_scene(name, device="cpu")
    cam = spt.make_camera(aspect=6 / 4, device="cpu")
    cfg = spt.RenderConfig(width=6, height=4, spp=2, estimator=est, seed=1,
                           max_bounces=6)
    K = sc.rects.k.shape[0] + sc.spheres.radius.shape[0]
    target = torch.full((4, 6, 3), 0.5)
    loss, galb, gemi = mg.loss_and_material_grads(sc, cam, cfg, 1, target)
    assert np.isfinite(float(loss)) and galb.shape == gemi.shape == (K, 3)
    assert bool(torch.isfinite(galb).all() & torch.isfinite(gemi).all())
    assert bool(gemi.any())
    step = mg.material_train_step_sharded(sc, cam, cfg, Mesh.single((1, 1)),
                                          target)
    s_loss, s_alb, s_emi = step(*mg.pack_materials(sc), 1)
    assert abs(float(s_loss) - float(loss)) <= 1e-6 * float(loss)
    assert torch.allclose(s_alb, galb, rtol=1e-5, atol=1e-7)
    assert torch.allclose(s_emi, gemi, rtol=1e-5, atol=1e-7)
    alb, emi = (t.requires_grad_() for t in mg.pack_materials(sc))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 6, 3)).astype(np.float32))
    mg.RenderMaterials.apply(alb, emi, sc, cam, cfg, 1).backward(g)
    want = mg.render_megakernel_vjp_plain(sc, cam, cfg, alb, emi, 1, g)
    assert torch.equal(alb.grad, want[0]) and torch.equal(emi.grad, want[1])
    fitted, losses = mg.fit_megakernel(sc, cam, cfg, target, steps=1,
                                       lr=0.5, seed=1)
    assert losses == [float(loss)]
    assert torch.equal(mg.pack_materials(fitted)[1],
                       mg.pack_materials(sc)[1] - 0.5 * gemi)


@pytest.mark.parametrize("est", ["cosine", "nee_textbook"])
def test_sharded_step_on_a_sphere_scene(est):
    """material_train_step_sharded on smallpt_original over a (2, 1) mesh,
    each pixel block in this process (Mesh.single: no collectives): the
    blocks' losses and gradients add up to the unsharded step's."""
    sc = spt.get_scene("smallpt_original", device="cpu")
    cam = spt.make_camera(aspect=8 / 6, device="cpu")
    cfg = spt.RenderConfig(width=8, height=6, spp=2, estimator=est, seed=2,
                           max_bounces=6)
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 0.6, (6, 8, 3)).astype(np.float32))
    alb, emi = mg.pack_materials(sc)
    parts = [mg.material_train_step_sharded(
        sc, cam, cfg, Mesh.single((2, 1), (i, 0)), target)(alb, emi, 2)
        for i in range(2)]
    loss, galb, gemi = mg.loss_and_material_grads(sc, cam, cfg, 2, target)
    assert abs(float(parts[0][0] + parts[1][0]) - float(loss)) <= (
        1e-5 * float(loss))
    for i, want in ((1, galb), (2, gemi)):
        got = parts[0][i] + parts[1][i]
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_cli_fit_sphere_scene_cpu(capsys):
    """The JAX CLI's fit --pallas self-test on a mirror and glass scene:
    the target is the scene with its rects' emission x1.5 at seed + 1."""
    assert cli_main(["fit", "--device", "cpu", "--scene", "smallpt_original",
                     "--estimator", "cosine", "--width", "16", "--height",
                     "12", "--spp", "4", "--steps", "2"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert len(res["light_emission"]) == 3
    assert out.err.count("step ") == 2


def test_training_refuses_more_spheres_than_the_adjoint_holds():
    """Row 9's cap (its per-warp gradient rows in shared memory), on every
    device: sphere_grid_1024 is at the cap, one more sphere is refused."""
    sc = spt.get_scene("sphere_grid_1024", device="cpu")
    assert sc.spheres.radius.shape[0] == mg.MAX_GRAD_SPHERES
    mg.check_trainable(sc)
    sp = sc.spheres
    more = sc._replace(spheres=type(sp)(*(torch.cat([t, t[:1]]) for t in sp)))
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=4, height=4, spp=1)
    with pytest.raises(NotImplementedError, match="queue 2, row 9"):
        mg.fit_megakernel(more, cam, cfg, torch.zeros(4, 4, 3), steps=1)
