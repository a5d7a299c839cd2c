"""The port's material-training path against the JAX package: the
runtime-material forward against ``render_pallas_mat``, the adjoint's plain
version against ``render_pallas_vjp`` (both Pallas kernels in interpret mode,
as tests/test_megakernel_grad.py runs them), the loss and gradients of one
training step, finite differences, and the ``fit`` trainer and CLI.

16x12x4, ``nee``, max_bounces=8, seed 3 (tests/test_megakernel_grad.py's
shape). The JAX results are made once per module: the adjoint costs ~20 s
to trace and compile in interpret mode."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.core import film as jfilm
from small_pathtracer_tpu.ops import megakernel_grad as jgrad
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.convert import (
    camera_from_jax, materials_from_jax, scene_from_jax,
)
from small_pathtracer_tpu_torch.core import film
from small_pathtracer_tpu_torch.ops import megakernel, megakernel_grad as mg

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 16, 12, 4, 3, 8
LIGHT = 6


@pytest.fixture(scope="module")
def jax_side():
    """JAX at 16x12x4: the runtime-material forward, the adjoint under a
    numpy-seeded cotangent, and one training evaluation against a
    numpy-seeded target (the last reuses both compiled kernels)."""
    scene, cam = jget_scene("cornell_box"), jmake_camera()
    cfg = JRenderConfig(width=W, height=H, spp=SPP, estimator="nee",
                        seed=SEED, max_bounces=BOUNCES)
    alb, emi = jgrad.pack_materials(scene)
    rng = np.random.default_rng(11)
    g_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    target = rng.uniform(0.0, 0.6, (H, W, 3)).astype(np.float32)
    fwd = jax.block_until_ready(jgrad.render_pallas_mat(
        scene, cam, cfg, alb, emi, SEED, interpret=True))
    vjp = jax.block_until_ready(jgrad.render_pallas_vjp(
        scene, cam, cfg, alb, emi, SEED, g_img, interpret=True))
    step = jax.block_until_ready(jgrad.loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(SEED), target, interpret=True))
    as_np = lambda vals: tuple(np.asarray(v) for v in vals)  # noqa: E731
    return {"scene": scene, "cam": cam, "alb": np.asarray(alb),
            "emi": np.asarray(emi), "g_img": g_img, "target": target,
            "fwd": as_np(fwd), "vjp": as_np(vjp), "step": as_np(step)}


@pytest.fixture(scope="module")
def port(jax_side):
    scene = scene_from_jax(jax_side["scene"], device="cpu")
    cam = camera_from_jax(jax_side["cam"], device="cpu")
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, seed=SEED,
                           max_bounces=BOUNCES)
    return scene, cam, cfg


def test_pack_unpack_roundtrip(port, jax_side):
    scene, _, _ = port
    alb, emi = mg.pack_materials(scene)
    assert alb.shape == emi.shape == (17, 3) and alb.dtype == torch.float32
    j_alb, j_emi = materials_from_jax(jax_side["alb"], jax_side["emi"],
                                      device="cpu")
    assert torch.equal(alb, j_alb) and torch.equal(emi, j_emi)
    back = mg.unpack_materials(scene, alb, emi)
    for a, b in zip(scene.rects, back.rects):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="table"):
        mg.unpack_materials(scene, alb[:16], emi)


def test_material_grads_to_scene(port):
    scene, _, _ = port
    galb = torch.arange(51, dtype=torch.float32).reshape(17, 3)
    gs = mg.material_grads_to_scene(scene, galb, -galb)
    assert torch.equal(gs.rects.albedo, galb)
    assert torch.equal(gs.rects.emission, -galb)
    assert not bool(gs.rects.k.any()) and not bool(gs.light.corner.any())


def test_srgb_from_u8_matches_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, 2)
    np.testing.assert_array_equal(film.srgb_from_u8(u8),
                                  np.asarray(jfilm.srgb_from_u8(u8)))


def test_mat_forward_matches_pallas_mat(port, jax_side):
    scene, cam, cfg = port
    alb, emi = materials_from_jax(jax_side["alb"], jax_side["emi"],
                                  device="cpu")
    img, traces = mg.render_megakernel_mat(scene, cam, cfg, alb, emi, SEED)
    want_img, want_tr = jax_side["fwd"]
    # Measured: traces equal ([1834, 1067]), max |img diff| 3.2e-5.
    np.testing.assert_array_equal(traces.numpy(), want_tr.astype(np.int64))
    np.testing.assert_allclose(img.numpy(), want_img, rtol=1e-4, atol=1e-4)
    # Equal tables: the baked wrapper's result, bit for bit.
    b_img, b_tr = megakernel.render_megakernel(scene, cam, cfg, SEED)
    assert torch.equal(img, b_img) and torch.equal(traces, b_tr)


def _close_to_max(got, want, rel):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * scale, (err, scale)


def test_vjp_plain_matches_pallas_vjp(port, jax_side):
    scene, cam, cfg = port
    alb, emi = materials_from_jax(jax_side["alb"], jax_side["emi"],
                                  device="cpu")
    galb, gemi = mg.render_megakernel_vjp(
        scene, cam, cfg, alb, emi, SEED, torch.from_numpy(jax_side["g_img"]))
    want_alb, want_emi = jax_side["vjp"]
    # Measured: albedo within 7.0e-5 of a largest entry 11.8 (5.9e-6 of
    # it), emission within 1.1e-5 of 52.8.
    _close_to_max(galb.numpy(), want_alb, 1e-5)
    _close_to_max(gemi.numpy(), want_emi, 1e-5)


def test_loss_and_material_grads_match_jax(port, jax_side):
    scene, cam, cfg = port
    loss, galb, gemi = mg.loss_and_material_grads(
        scene, cam, cfg, SEED, torch.from_numpy(jax_side["target"]))
    want_loss, want_alb, want_emi = jax_side["step"]
    # Measured: loss 7.285586 both; albedo within 1.5e-8 of 8.1e-3,
    # emission within 6.0e-8 of 0.41.
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _close_to_max(galb.numpy(), want_alb, 1e-5)
    _close_to_max(gemi.numpy(), want_emi, 1e-5)


def test_render_materials_function(port, jax_side):
    """RenderMaterials' backward on the CPU is the plain VJP."""
    scene, cam, cfg = port
    alb, emi = (t.requires_grad_() for t in mg.pack_materials(scene))
    g = torch.from_numpy(jax_side["g_img"])
    img = mg.RenderMaterials.apply(alb, emi, scene, cam, cfg, SEED)
    img.backward(g)
    galb, gemi = mg.render_megakernel_vjp_plain(
        scene, cam, cfg, alb, emi, SEED, g)
    assert torch.equal(alb.grad, galb) and torch.equal(emi.grad, gemi)


def test_fd_validates_port_gradient(port):
    """Central differences of the port's forward against its adjoint on the
    light's emission and on a non-max albedo channel (the green wall's red:
    the max channel moves the RR threshold, a discrete effect that pathwise
    gradients leave out by design)."""
    scene, cam, cfg = port
    alb, emi = mg.pack_materials(scene)
    target = torch.zeros((H, W, 3), dtype=torch.float64)

    def loss(alb_, emi_):
        # In float64: a float32 mean rounds away ~1% of a difference at h.
        img, _ = mg.render_megakernel_mat(scene, cam, cfg, alb_, emi_, SEED)
        return float(torch.mean((img.double() / cfg.spp - target) ** 2))

    img, _ = mg.render_megakernel_mat(scene, cam, cfg, alb, emi, SEED)
    g_img = (img / cfg.spp) * (2.0 / (img.numel() * cfg.spp))
    galb, gemi = mg.render_megakernel_vjp(scene, cam, cfg, alb, emi, SEED,
                                          g_img)
    h = 1e-3
    for which, idx in (("emi", (LIGHT, 0)), ("alb", (2, 0))):
        tab = emi if which == "emi" else alb
        tp, tm = tab.clone(), tab.clone()
        tp[idx] += h
        tm[idx] -= h
        if which == "emi":
            fd = (loss(alb, tp) - loss(alb, tm)) / (2 * h)
            g = float(gemi[idx])
        else:
            fd = (loss(tp, emi) - loss(tm, emi)) / (2 * h)
            g = float(galb[idx])
        assert abs(fd - g) < 2e-2 * max(abs(fd), abs(g), 1e-6), (idx, fd, g)


def test_fit_recovers_brighter_light(port):
    scene, cam, cfg = port
    bright = scene._replace(rects=scene.rects._replace(
        emission=scene.rects.emission * 1.5))
    # The target's seed is the fit's: the same paths, so the loss can reach 0.
    img, _ = megakernel.render_megakernel(bright, cam, cfg, 5)
    fitted, losses = mg.fit_megakernel(
        scene, cam, cfg, img / cfg.spp, steps=8, lr=8.0,
        train_fields=("emission",), seed=5)
    assert losses[-1] < 0.05 * losses[0], losses
    e0 = float(scene.rects.emission[LIGHT, 0])
    e1 = float(fitted.rects.emission[LIGHT, 0])
    assert e0 + 5.0 < e1 < 18.0 + 0.5, (e0, e1)
    # Albedo was not trained.
    assert torch.equal(fitted.rects.albedo, scene.rects.albedo)


def test_fit_checkpoint_and_fields_raise(port):
    scene, cam, cfg = port
    target = torch.zeros((H, W, 3))
    with pytest.raises(NotImplementedError, match="item 16"):
        mg.fit_megakernel(scene, cam, cfg, target, steps=1,
                          checkpoint="ckpt")
    with pytest.raises(ValueError, match="train_fields"):
        mg.fit_megakernel(scene, cam, cfg, target, steps=1,
                          train_fields=("radius",))


def test_cli_fit_cpu(capsys):
    assert cli_main(["fit", "--device", "cpu", "--width", "8", "--height",
                     "6", "--spp", "2", "--steps", "2", "--lr", "4",
                     "--seed", "1"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert len(res["light_emission"]) == 3
    assert out.err.count("step ") == 2


def test_cli_fit_cpu_target(tmp_path, capsys):
    """--target: a PPM, decoded to linear by srgb_from_u8; its size must be
    the render's."""
    path = tmp_path / "target.ppm"
    film.write_ppm(str(path), np.full((6, 8, 3), 200, dtype=np.uint8))
    argv = ["fit", "--device", "cpu", "--spp", "2", "--steps", "1",
            "--target", str(path)]
    assert cli_main([*argv, "--width", "8", "--height", "6"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["final_loss"])
    with pytest.raises(SystemExit):
        cli_main([*argv, "--width", "6", "--height", "8"])


@pytest.mark.parametrize("argv", [
    ["--optimizer", "adam"], ["--train", "emission,radius"], ["--steps", "0"],
])
def test_cli_fit_rejects(argv):
    with pytest.raises(SystemExit):
        cli_main(["fit", "--device", "cpu", "--width", "4", "--height", "3",
                  "--spp", "1", *argv])


def test_cuda_paths_raise_without_cuda(port):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    scene, cam, cfg = port
    alb, emi = mg.pack_materials(scene)
    g = torch.zeros((H, W, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        mg.render_megakernel_vjp(scene, cam, cfg, alb, emi, SEED, g,
                                 device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        mg.render_megakernel_mat(scene, cam, cfg, alb, emi, SEED,
                                 device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["fit", "--width", "4", "--height", "3", "--spp", "1",
                  "--steps", "1"])


def test_cpu_wrappers_count_no_launch(port):
    scene, cam, cfg = port
    before = dict(megakernel.LAUNCHES)
    alb, emi = mg.pack_materials(scene)
    mg.render_megakernel_mat(scene, cam, cfg, alb, emi, SEED, 0, 1)
    mg.render_megakernel_vjp(scene, cam, cfg, alb, emi, SEED,
                             torch.zeros((H, W, 3)))
    assert dict(megakernel.LAUNCHES) == before
