"""The geometry adjoint with the other estimators against the JAX package:
the plain version of rows 11 and 12 (``geom_run`` / ``geom_vjp``, autograd
through the eager forward) against the JAX ``geom_run`` / ``geom_vjp`` (the
Pallas kernel in interpret mode, as tests/test_megakernel_geom.py runs it)
for ``mis``, ``nee_textbook``, ``uniform_corrected`` and ``mixture`` with
light_sample_mode='glibc_overflow'. The other codes (``cosine``,
``uniform``, ``nee`` with glibc) and ``mis`` ignoring glibc are held
without JAX: tests/test_torch_estimator_paths.py and the pullback's branch
cases in tests/test_torch_geom.py.

``cornell_spheres`` at 24x18x2, max_bounces 6, seed 9 (the shape of
tests/test_torch_geom.py). One JAX geometry program a case, compiled once
in the module fixture (~8-10 s each on the CPU); the backward flag is a
runtime input, so its three runs reuse it.

Contracts, each measured on the CPU:

- Images: grazing sphere hits flip a path between the two forwards (15 of
  432 pixels for mis and nee_textbook, 2 for uniform_corrected, 1 for the
  glibc mixture), isolated pixels, not a shift.
- Gradients under the cotangent of the pixels whose images agree within
  1e-5 ("stable"): materials within 1e-5 of each table's largest entry
  (measured up to 4.5e-7), leaving out the light's albedo row under mis
  and nee_textbook: the direct term at a hit of the black light probes
  from its own underside, a knife-edge 1/t^2 weight (1.4e5 there) on one
  float of the hit point (tests/test_torch_geom.py
  ``test_reflecting_light_gradients``); sphere rows within 1e-2 (measured
  3.8e-3 to 6.9e-3: the JAX kernel linearizes the NEE distance at the
  sampler's plane, y = 81.6, its forward probes the rect at y = 81.5;
  ROADMAP.md queue 3).
- uniform_corrected: the uniform pair's divergence contract (ROADMAP.md
  queue 3, "uniform and uniform_corrected against JAX"): a grazing uniform
  direction can send a path to another object without changing the
  image; >= 99.5% of pixels within 1e-4 and means within 1e-3 (measured
  99.54%, 9.5e-4). Where the path's later emission is 0 the flip moves
  only the emission rows: on stable pixels within 2e-2 of their largest
  entry, cosine above 0.9999 (measured 1.4e-2, 0.99995). Its sphere rows
  are 0 in exact arithmetic (its weight 2 max(d'.n, 0) is wz / |sv| for
  the sample drawn in n's frame, constant in n, and its directions carry
  no weight), so both sides' are rounding, below 1e-7 of the albedo
  table's largest entry (measured 2.2e-8 in JAX, 7.2e-9 here).
"""

import numpy as np
import pytest
import torch

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.ops import megakernel_geom as jgeom
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch import convert
from small_pathtracer_tpu_torch.ops import megakernel_geom as mg

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 24, 18, 2, 9, 6
GLIBC = {"light_sample_mode": "glibc_overflow"}
CASES = {
    "mis": {"estimator": "mis"},
    "nee_textbook": {"estimator": "nee_textbook"},
    "uniform_corrected": {"estimator": "uniform_corrected"},
    "mixture_glibc": {"estimator": "mixture", **GLIBC},
}
UNIFORM = ("uniform_corrected",)


@pytest.fixture(scope="module")
def port():
    scene = convert.scene_from_jax(jget_scene("cornell_spheres"),
                                   device="cpu")
    cam = convert.camera_from_jax(jmake_camera(), device="cpu")
    return scene, cam


def _cfg(fields):
    return spt.RenderConfig(width=W, height=H, spp=SPP, seed=SEED,
                            max_bounces=BOUNCES, **fields)


@pytest.fixture(scope="module")
def jax_side(port):
    """For each case, from one compiled JAX program: the image, the
    adjoint under a numpy-seeded cotangent, and under that cotangent on
    the stable pixels only; and the port's image."""
    scene_p, cam_p = port
    scene, cam = jget_scene("cornell_spheres"), jmake_camera()
    g_img = np.random.default_rng(21).standard_normal(
        (H, W, 3)).astype(np.float32)
    out = {}
    for case, fields in CASES.items():
        cfg = JRenderConfig(width=W, height=H, spp=SPP, max_bounces=BOUNCES,
                            sphere_table="on", **fields)
        img = np.asarray(jgeom.geom_run(scene, cam, cfg, SEED, None,
                                        interpret=True)[0])
        img_p = mg.geom_run(scene_p, cam_p, _cfg(fields), SEED)[0].numpy()
        stable = np.abs(img_p - img).max(axis=-1) < 1e-5
        vjp = {}
        for label, g in (("all", g_img),
                         ("stable", g_img * stable[..., None])):
            vjp[label] = (g, convert.geom_grads_from_jax(scene_p, *(
                np.asarray(v) for v in jgeom.geom_vjp(
                    scene, cam, cfg, SEED, g, interpret=True))))
        out[case] = {"img": img, "img_p": img_p, "stable": stable,
                     "vjp": vjp}
    return out


def _rel(a, b):
    a, b = a.numpy().reshape(-1), b.numpy().reshape(-1)
    return np.abs(a - b).max() / np.abs(b).max()


def _cos(a, b):
    a, b = a.numpy().reshape(-1), b.numpy().reshape(-1)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("case", CASES)
def test_image_matches_jax(case, jax_side):
    side = jax_side[case]
    a, b = side["img_p"] / SPP, side["img"] / SPP
    assert 0 < int(side["stable"].sum())
    assert int((~side["stable"]).sum()) < 20
    if case in UNIFORM:
        assert (np.abs(a - b).max(axis=-1) < 1e-4).mean() >= 0.995
        assert abs(a.mean() - b.mean()) < 1e-3
    else:
        assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() > 0.97
        # The glibc mixture's one flipped pixel is a corner-patch firefly:
        # measured 1.39e-2 on the mean.
        assert abs(a.mean() - b.mean()) < 0.02


@pytest.mark.parametrize("case", CASES)
def test_stable_pixel_grads_match_jax(case, port, jax_side):
    scene, cam = port
    g, (w_sph, w_alb, w_emi) = jax_side[case]["vjp"]["stable"]
    g_sph, g_alb, g_emi = mg.geom_vjp(scene, cam, _cfg(CASES[case]), SEED,
                                      torch.from_numpy(g))
    light = int(scene.light.light_obj_id)
    keep = torch.ones(g_alb.shape[0], dtype=torch.bool)
    if CASES[case]["estimator"] in mg.DIRECT:
        keep[light] = False
    assert _rel(g_alb[keep], w_alb[keep]) <= 1e-5
    if case in UNIFORM:
        assert _rel(g_emi, w_emi) <= 2e-2 and _cos(g_emi, w_emi) > 0.9999
        scale = float(w_alb.abs().max())
        assert float(g_sph.abs().max()) <= 1e-7 * scale
        assert float(w_sph.abs().max()) <= 1e-7 * scale
    else:
        assert _rel(g_emi, w_emi) <= 1e-5
        assert _rel(g_sph, w_sph) <= 1e-2


@pytest.mark.parametrize("case", CASES)
def test_whole_image_grads_agree_with_jax(case, port, jax_side):
    """Under the cotangent of every pixel the flipped paths move the tables
    (by up to 0.44 of a table's largest entry, the glibc mixture's albedo),
    so the bar is the tables' direction: cosine above 0.98 (measured
    0.9828 to 0.99999), the uniform case's sphere rows aside (rounding on
    both sides, test_stable_pixel_grads_match_jax)."""
    scene, cam = port
    g, want = jax_side[case]["vjp"]["all"]
    got = mg.geom_vjp(scene, cam, _cfg(CASES[case]), SEED,
                      torch.from_numpy(g))
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 0 and case in UNIFORM:
            continue
        assert _cos(a, b) > 0.98, (i, _cos(a, b))


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_are_the_two_launches(case, port):
    """loss_and_geom_grads is the image-only run and the adjoint under the
    loss's cotangent (one path set): its gradients equal geom_vjp's under
    2 (img / spp - target) / (n spp), within 1e-5 (the two round the
    cotangent in other orders)."""
    scene, cam = port
    cfg = _cfg(CASES[case])
    target = torch.from_numpy(np.random.default_rng(22).uniform(
        0.0, 0.6, (H, W, 3)).astype(np.float32))
    loss, *grads = mg.loss_and_geom_grads(scene, cam, cfg, SEED, target)
    img = mg.geom_run(scene, cam, cfg, SEED)[0]
    diff = img / SPP - target
    assert abs(float(loss) - float(torch.mean(diff * diff))) <= (
        1e-6 * float(loss))
    want = mg.geom_vjp(scene, cam, cfg, SEED,
                       diff * (2.0 / (diff.numel() * SPP)))
    for a, b in zip(grads, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
