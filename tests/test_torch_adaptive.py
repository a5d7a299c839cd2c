"""The port's per-pixel budgets (``render_megakernel_budgets``, the plain
version of the row 3 kernels on the CPU) and its adaptive sampler against
the JAX package's jnp wave runner and ``adaptive_render``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
from small_pathtracer_tpu.utils.adaptive import (
    _wave_jnp_jit, adaptive_render as jadaptive_render,
)
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from small_pathtracer_tpu_torch.ops import megakernel
from small_pathtracer_tpu_torch.utils import adaptive

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

# Ragged spans as tests/test_adaptive.py draws them: s_start in [0, 16),
# lengths in [0, 16], some empty.
WAVES = {"cornell_box": (16, 12), "smallpt_original": (8, 8)}
WAVE_SPP, WAVE_SEED = 32, 7


def _spans(n_pix):
    rng = np.random.default_rng(0)
    s_start = rng.integers(0, 16, n_pix).astype(np.uint32)
    s_stop = s_start + rng.integers(0, 17, n_pix).astype(np.uint32)
    return s_start, s_stop


@pytest.fixture(scope="module")
def waves():
    """Each scene's ragged wave through the JAX jnp runner and the port's
    budgets wrapper on the CPU (its plain version)."""
    out = {}
    for name, (w, h) in WAVES.items():
        js, jc = jget_scene(name), jmake_camera()
        cfg = JRenderConfig(width=w, height=h, spp=WAVE_SPP, estimator="nee",
                            seed=WAVE_SEED)
        s_start, s_stop = _spans(w * h)
        L, tr = jax.block_until_ready(_wave_jnp_jit(
            js, jc, cfg, jnp.uint32(WAVE_SEED), jnp.asarray(s_start),
            jnp.asarray(s_stop)))
        pcfg = spt.RenderConfig(width=w, height=h, spp=WAVE_SPP,
                                seed=WAVE_SEED)
        pL, ptr = megakernel.render_megakernel_budgets(
            scene_from_jax(js, device="cpu"),
            camera_from_jax(jc, device="cpu"), pcfg, WAVE_SEED,
            s_start.astype(np.int64), s_stop.astype(np.int64))
        out[name] = (np.asarray(L), np.asarray(tr).astype(np.int64),
                     pL.numpy(), ptr.numpy())
    return out


def test_budgets_plain_matches_jax_wave_box(waves):
    """Rects only: trace counts equal, radiance within 1e-4 (measured
    here: traces [3857, 2266] on both sides)."""
    want, want_tr, got, got_tr = waves["cornell_box"]
    assert got.shape == (16 * 12, 3)
    np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_budgets_plain_matches_jax_wave_spheres(waves):
    """Mirror and glass: tests/test_torch_spheres.py's limits for sphere
    scenes (traces within 2e-2, 99% of pixels within 1e-4, means within
    1e-2). Measured here: traces equal ([1327, 664]), every pixel within
    3.1e-5."""
    want, want_tr, got, got_tr = waves["smallpt_original"]
    np.testing.assert_allclose(got_tr, want_tr, rtol=2e-2, atol=0)
    assert abs(float(got.mean()) - float(want.mean())) < 1e-2
    same = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert same.mean() >= 0.99, same.mean()


def test_empty_spans_render_nothing(waves):
    """Born-dead lanes: zero radiance, and spans that add up count the
    same traces as one span (per-sample counters)."""
    scene = spt.get_scene("cornell_box", device="cpu")
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=16, height=12, spp=WAVE_SPP,
                           seed=WAVE_SEED)
    s_start, s_stop = (a.astype(np.int64) for a in _spans(16 * 12))
    mid = (s_start + s_stop) // 2
    a, ta = megakernel.render_megakernel_budgets(scene, cam, cfg, WAVE_SEED,
                                                 s_start, mid)
    b, tb = megakernel.render_megakernel_budgets(scene, cam, cfg, WAVE_SEED,
                                                 mid, s_stop)
    _, _, full, full_tr = waves["cornell_box"]
    np.testing.assert_array_equal((ta + tb).numpy(), full_tr)
    np.testing.assert_allclose((a + b).numpy(), full, rtol=1e-5, atol=1e-5)
    empty = torch.from_numpy(s_start == mid)
    assert bool((a[empty] == 0).all())


def test_budgets_reject_wrong_span_shape():
    scene = spt.get_scene("cornell_box", device="cpu")
    cfg = spt.RenderConfig(width=4, height=3, spp=4)
    with pytest.raises(ValueError, match="span"):
        megakernel.render_megakernel_budgets(
            scene, spt.make_camera(device="cpu"), cfg, 0, np.zeros(11),
            np.ones(11))


def test_budgets_cuda_raises_without_cuda():
    """No fallback: asked for the card where there is none, the wrapper
    raises instead of running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    scene = spt.get_scene("cornell_box", device="cpu")
    cfg = spt.RenderConfig(width=4, height=3, spp=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        megakernel.render_megakernel_budgets(
            scene, spt.make_camera(device="cpu"), cfg, 0, np.zeros(12),
            np.ones(12), device="cuda")


def test_cluster_scratch_renders():
    """The JAX budgets path raises on sphere_table="cluster_scratch" (a
    known defect of the reference: ADVICE.md:3, megakernel.py:2482-2487).
    The port follows the values that work: every sphere_table value takes
    the same table path and gives the same radiance."""
    scene = spt.get_scene("smallpt_original", device="cpu")
    cam = spt.make_camera(device="cpu")
    s_start, s_stop = (a.astype(np.int64) for a in _spans(8 * 8))
    outs = [megakernel.render_megakernel_budgets(
        scene, cam, spt.RenderConfig(width=8, height=8, spp=WAVE_SPP,
                                     seed=3, sphere_table=table), 3,
        s_start, s_stop) for table in ("cluster_scratch", "auto")]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert bool(torch.isfinite(outs[0][0]).all())


# The adaptive render at tests/test_adaptive.py's shape and tolerance.
AW, AH, ASPP, ASEED, ATOL, AWAVE = 16, 12, 64, 3, 0.02, 8


@pytest.fixture(scope="module")
def adaptive_pair():
    js, jc = jget_scene("cornell_box"), jmake_camera()
    cfg = JRenderConfig(width=AW, height=AH, spp=ASPP, estimator="nee",
                        seed=ASEED)
    want = jadaptive_render(js, jc, cfg, tol=ATOL, wave=AWAVE)
    pcfg = spt.RenderConfig(width=AW, height=AH, spp=ASPP, seed=ASEED)
    got = adaptive.adaptive_render(scene_from_jax(js, device="cpu"),
                                   camera_from_jax(jc, device="cpu"), pcfg,
                                   tol=ATOL, wave=AWAVE)
    return want, got


# Pixels (row 8, columns 12 and 13) where one grazing path of this shape
# flips with the rounding of the primary ray (jax.lax.rsqrt against
# 1/sqrt, FMA contraction): the JAX package's own two runners, jnp and the
# Pallas kernel in interpret mode, also disagree there (measured on the
# CPU: jnp traces [29887, 17599], Pallas [29885, 17597], the port
# [29884, 17596] for every sample of every pixel).
FLIPPED_PIXELS = 2


def test_adaptive_matches_jax(adaptive_pair):
    """Against the JAX jnp path, the JAX package's runner-to-runner
    contract (tests/test_adaptive.py:90-108): the same waves, spp maps
    equal on >= 99% of pixels (measured: 100%), the image within 1e-4
    except on isolated flipped paths and never off by 0.03. At 16x12 that
    contract's 99% of image values allows one pixel; two pixels flip here
    (98.96% of pixels within 1e-4, at most 2.4e-3 off; every other pixel
    within 4.8e-7), the same two on which the JAX runners disagree with each
    other, so the test counts them instead."""
    want, got = adaptive_pair
    assert got.waves == want.waves
    spp_map = got.spp_map.numpy()
    assert (spp_map == want.spp_map).mean() >= 0.99
    d = np.abs(got.image.numpy() - want.image).max(axis=-1)
    assert int((d >= 1e-4).sum()) <= FLIPPED_PIXELS, np.argwhere(d >= 1e-4)
    assert d.max() < 0.03, d.max()
    assert got.total_samples == int(spp_map.sum())
    assert got.uniform_samples == want.uniform_samples == AW * AH * ASPP
    assert 16 <= spp_map.min() and spp_map.max() <= ASPP


def test_adaptive_counts_traces_of_its_samples(adaptive_pair):
    """Trace counts of the same samples: equal but for the flipped path
    (measured: [26535, 15791] against JAX's [26537, 15793])."""
    want, got = adaptive_pair
    np.testing.assert_allclose(got.traces, want.traces, rtol=1e-3, atol=0)
    assert got.traces[0] > got.traces[1] > 0


def test_tol_zero_is_uniform():
    """tol = 0 renders every sample of every pixel: exactly the uniform
    render's traces (counters are per sample) and its image within 2e-6
    (tests/test_adaptive.py's bound; the sums run in another order)."""
    scene = spt.get_scene("cornell_box", device="cpu")
    cam = spt.make_camera(device="cpu")
    cfg = spt.RenderConfig(width=24, height=18, spp=32, seed=5)
    res = adaptive.adaptive_render(scene, cam, cfg, tol=0.0, wave=8)
    img, traces = spt.render_counts(scene, cam, cfg)
    assert bool((res.spp_map == 32).all())
    assert res.waves == 4
    assert res.total_samples == res.uniform_samples
    assert res.traces == traces
    np.testing.assert_allclose(res.image.numpy(), img.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("spp,wave,budgets", [
    (20, 0, [8, 8, 4]),     # auto: max(8, spp // 8), a short last wave
    (64, 0, [8] * 8),       # auto: spp // 8
    (12, 40, [12]),         # capped at spp
], ids=["auto_min8", "auto_spp_8", "capped"])
def test_wave_schedule(monkeypatch, spp, wave, budgets):
    """The JAX rules for the wave size and each wave's budgets, read off
    the spans the sampler hands the budgets wrapper."""
    seen = []
    real = adaptive.render_megakernel_budgets

    def spy(scene, cam, cfg, seed, s_start, s_stop):
        seen.append(sorted(set((s_stop - s_start).tolist())))
        return real(scene, cam, cfg, seed, s_start, s_stop)

    monkeypatch.setattr(adaptive, "render_megakernel_budgets", spy)
    scene = spt.get_scene("cornell_box", device="cpu")
    cfg = spt.RenderConfig(width=3, height=2, spp=spp, seed=1)
    res = adaptive.adaptive_render(scene, spt.make_camera(device="cpu"),
                                   cfg, tol=0.0, wave=wave)
    assert seen == [[b] for b in budgets]
    assert res.waves == len(budgets)


def test_adaptive_log_lines(capsys):
    import sys

    scene = spt.get_scene("cornell_box", device="cpu")
    cfg = spt.RenderConfig(width=3, height=2, spp=16, seed=1)
    adaptive.adaptive_render(scene, spt.make_camera(device="cpu"), cfg,
                             tol=0.0, wave=8, log=sys.stderr)
    err = capsys.readouterr().err.splitlines()
    assert err == ["[adaptive] wave 1: active 6/6, mean spp 8.0",
                   "[adaptive] wave 2: active 0/6, mean spp 16.0"]


def test_negative_tol_raises():
    scene = spt.get_scene("cornell_box", device="cpu")
    with pytest.raises(ValueError, match="tol"):
        adaptive.adaptive_render(scene, spt.make_camera(device="cpu"),
                                 spt.RenderConfig(width=2, height=2, spp=8),
                                 tol=-1.0)
