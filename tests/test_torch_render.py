"""The port's render path as a whole against the JAX package: the kernel
wrapper's plain version against the Pallas megakernel (interpret mode), the
port's ``render`` against the jnp regenerating wavefront, and the port alone
against the committed golden image."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.core import film as jfilm
from small_pathtracer_tpu.integrator import wavefront as jwavefront
from small_pathtracer_tpu.ops.megakernel import render_pallas
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from small_pathtracer_tpu_torch.core import film
from small_pathtracer_tpu_torch.integrator import wavefront
from small_pathtracer_tpu_torch.ops import megakernel

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

GOLDEN = (Path(__file__).resolve().parent.parent / "goldens"
          / "cornell_box_64x48x16_nee_seed42.ppm")
W, H, SPP, SEED = 32, 24, 4, 3


@pytest.fixture(scope="module")
def jax_box():
    """The JAX side at 32x24x4, seed 3: the Pallas kernel in interpret mode
    (as tests/test_megakernel.py runs it) and the jnp regen wavefront."""
    scene, cam = jget_scene("cornell_box"), jmake_camera()
    cfg = JRenderConfig(width=W, height=H, spp=SPP, estimator="nee",
                        seed=SEED)
    pallas = jax.block_until_ready(
        render_pallas(scene, cam, cfg, SEED, interpret=True))
    regen = jax.block_until_ready(
        jwavefront.render_regen(scene, cam, cfg, jnp.uint32(SEED)))
    return {
        "scene": scene, "cam": cam,
        "pallas": tuple(np.asarray(v) for v in pallas),
        "regen": tuple(np.asarray(v) for v in regen),
    }


@pytest.fixture(scope="module")
def port_box(jax_box):
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, seed=SEED)
    scene = scene_from_jax(jax_box["scene"])
    cam = camera_from_jax(jax_box["cam"])
    img, traces = megakernel.render_megakernel(scene, cam, cfg, SEED)
    return scene, cam, cfg, img.numpy(), traces


def test_megakernel_plain_matches_pallas(port_box, jax_box):
    _, _, _, img, traces = port_box
    want_img, want_tr = jax_box["pallas"]
    assert traces.dtype == torch.int64
    # Measured: both counters equal ([7523, 4451]), max |img diff| 4.7e-5
    # (1/sqrt here, jax.lax.rsqrt there).
    np.testing.assert_array_equal(traces.numpy(), want_tr.astype(np.int64))
    np.testing.assert_allclose(img, want_img, rtol=1e-4, atol=1e-4)


def test_render_matches_jnp_regen(port_box, jax_box):
    scene, cam, cfg, _, _ = port_box
    img, total = spt.render(scene, cam, cfg)
    want_sum, want_tr = jax_box["regen"]
    want = np.asarray(jfilm.finalize(want_sum / SPP))
    assert total == int(want_tr.sum())
    _, (extend, probe) = spt.render_counts(scene, cam, cfg)
    assert (extend, probe) == tuple(int(v) for v in want_tr)
    np.testing.assert_allclose(img.numpy(), want, rtol=1e-4, atol=1e-4)


def test_spans_add_up(port_box):
    """render_megakernel over [0, 2) plus [2, 4) equals the full render:
    per-sample radiance depends only on (seed, pixel, sample)."""
    scene, cam, cfg, img, traces = port_box
    a, ta = megakernel.render_megakernel(scene, cam, cfg, SEED, 0, 2)
    b, tb = megakernel.render_megakernel(scene, cam, cfg, SEED, 2, 2)
    np.testing.assert_array_equal((ta + tb).numpy(), traces.numpy())
    np.testing.assert_allclose((a + b).numpy(), img, rtol=1e-5, atol=1e-5)


def test_golden_without_jax():
    """The port alone against the committed golden (the JAX package
    rendered it on the CPU). Measured: 99.77% of bytes equal, channel means
    within 0.002 levels."""
    cfg = spt.RenderConfig(width=64, height=48, spp=16, seed=42)
    img, _ = spt.render(spt.get_scene("cornell_box"),
                        spt.make_camera(aspect=64 / 48), cfg)
    got = film.tonemap_u8(img).numpy()
    golden = film.read_ppm(str(GOLDEN))
    assert got.shape == golden.shape
    assert np.mean(got == golden) >= 0.99
    gap = np.abs(got.reshape(-1, 3).astype(np.float64).mean(0)
                 - golden.reshape(-1, 3).astype(np.float64).mean(0))
    assert gap.max() <= 0.5, gap


@pytest.mark.parametrize("n_pix", [1, 768, 3072, 786_432, 1_000_003])
@pytest.mark.parametrize("n_s", [1, 4, 16, 512, 7])
@pytest.mark.parametrize("target", [1 << 18, 1 << 21])
def test_lane_groups_matches_jax(n_pix, n_s, target):
    for override in (0, 3):
        assert wavefront.lane_groups(n_pix, n_s, target, override) == \
            jwavefront.lane_groups(n_pix, n_s, target, override)


@pytest.mark.parametrize("field,value", [
    ("estimator", "cosine"), ("estimator", "mis"), ("sampler", "sobol"),
    ("pixel_filter", "tent"), ("aperture", 2.0), ("wavefront", "scan"),
    ("rng_backend", "mix_packed"), ("light_sample_mode", "glibc_overflow"),
])
def test_config_outside_slice_raises(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spt.RenderConfig(**{field: value})


def test_cpu_wrapper_counts_no_launch(port_box):
    scene, cam, cfg, _, _ = port_box
    before = megakernel.LAUNCHES
    megakernel.render_megakernel(scene, cam, cfg, SEED, 0, 1)
    assert megakernel.LAUNCHES == before
