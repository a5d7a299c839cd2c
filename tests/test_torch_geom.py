"""The port's sphere-geometry fit against the JAX package: the hand-derived
bounce pullback against torch.autograd branch by branch, the plain version
of the geometry adjoint (image and gradients) against ``geom_run`` /
``geom_vjp`` / ``loss_and_geom_grads`` (the Pallas kernel in interpret
mode, as tests/test_megakernel_geom.py runs it), the gradient layout, CRN
differences through the port's own forward, ``fit_geom``, the CLI and the
refusals.

``cornell_spheres`` at 24x18x2, ``nee``, max_bounces 6
(tests/test_megakernel_geom.py's shape). The JAX results are made once per
module from one compiled geometry program: its interpret-mode compile (~18
s) is the file's main cost; the backward flag is a runtime input, so the
adjoint calls reuse it."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.ops import megakernel_geom as jgeom
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch import convert
from small_pathtracer_tpu_torch.camera.pinhole import primary_rays
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.core import vecmath as vm
from small_pathtracer_tpu_torch.geometry.intersect import trace
from small_pathtracer_tpu_torch.integrator import wavefront
from small_pathtracer_tpu_torch.ops import _build, megakernel
from small_pathtracer_tpu_torch.ops import megakernel_geom as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 24, 18, 2, 9, 6
N_PIXELS = 2  # stable sphere pixels checked one by one


def _port_image(scene, cam, cfg, seed):
    return mg.geom_run(scene, cam, cfg, seed)[0]


def _sphere_pixels(scene, cam, cfg):
    """(H, W) bool: the pixel's centre ray hits a sphere."""
    pix = torch.arange(cfg.width * cfg.height)
    half = torch.full(pix.shape, 0.5)
    o, d = primary_rays(cam, cfg.width, cfg.height, pix % cfg.width,
                        pix // cfg.width, half, half)
    hit = trace(scene, o, d)
    return (hit.obj_id >= scene.rects.k.shape[0]).reshape(cfg.height,
                                                          cfg.width).numpy()


@pytest.fixture(scope="module")
def port():
    scene = convert.scene_from_jax(jget_scene("cornell_spheres"),
                                   device="cpu")
    cam = convert.camera_from_jax(jmake_camera(), device="cpu")
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, seed=SEED,
                           max_bounces=BOUNCES)
    return scene, cam, cfg


@pytest.fixture(scope="module")
def jax_side(port):
    """JAX at 24x18x2, one compiled program: the image-only run, the
    adjoint under a numpy-seeded cotangent, the adjoint of single stable
    sphere pixels, and one training evaluation against a numpy-seeded
    target."""
    scene_p, cam_p, cfg_p = port
    scene, cam = jget_scene("cornell_spheres"), jmake_camera()
    cfg = JRenderConfig(width=W, height=H, spp=SPP, estimator="nee",
                        max_bounces=BOUNCES, sphere_table="on")
    rng = np.random.default_rng(21)
    g_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    target = rng.uniform(0.0, 0.6, (H, W, 3)).astype(np.float32)
    as_np = lambda vals: tuple(np.asarray(v) for v in vals)  # noqa: E731
    img = np.asarray(jgeom.geom_run(scene, cam, cfg, SEED, None,
                                    interpret=True)[0])
    vjp = as_np(jgeom.geom_vjp(scene, cam, cfg, SEED, g_img, interpret=True))
    # Stable sphere pixels (the method of test_megakernel_geom.py:160):
    # the centre rays of the pixel and its 8 neighbours hit a sphere, and
    # the two images agree there to float noise (no flipped path).
    img_p = _port_image(scene_p, cam_p, cfg_p, SEED).numpy()
    stable = np.abs(img_p - img).max(axis=-1) < 1e-5
    sph = _sphere_pixels(scene_p, cam_p, cfg_p)
    pixels = [(y, x) for y in range(1, H - 1) for x in range(1, W - 1)
              if sph[y - 1:y + 2, x - 1:x + 2].all() and stable[y, x]]
    vjp_stable = as_np(jgeom.geom_vjp(scene, cam, cfg, SEED,
                                      g_img * stable[..., None],
                                      interpret=True))
    per_pixel = []
    for y, x in pixels[:N_PIXELS]:
        g1 = np.zeros((H, W, 3), np.float32)
        g1[y, x] = 1.0
        per_pixel.append(((y, x), g1, as_np(jgeom.geom_vjp(
            scene, cam, cfg, SEED, g1, interpret=True))))
    loss, gsc = jgeom.loss_and_geom_grads(scene, cam, cfg, SEED, target,
                                          interpret=True)
    return {"scene": scene, "img": img, "g_img": g_img, "target": target,
            "vjp": vjp, "stable": stable, "vjp_stable": vjp_stable,
            "per_pixel": per_pixel, "loss": float(loss), "gsc": gsc}


# --------------------------------------------------------------------------
# 1. The hand-derived pullback against torch.autograd, branch by branch.

# cornell_spheres' light: the sampler's normal (0, -1, 0) and area 1296,
# the light rect at y = 81.5.
LIGHT = mg.light_consts(spt.get_scene("cornell_spheres", device="cpu"))
LIGHT_CORNER = spt.get_scene("cornell_spheres", device="cpu").light.corner
# Each case: (the geometry of _branch_inputs, the estimator, options): the
# first thirteen are nee's; then a case for each branch the other
# estimators add (the uniform sample, uniform_corrected's weight, the
# direct term, mixture's coin, mis's balance weights, pickup and carry, and
# glibc's light point).
BRANCH_CASES = {
    "rect_nee": ("rect_nee", "nee", ()),
    "rect_cosine": ("rect_cosine", "nee", ()),
    "sphere_nee": ("sphere_nee", "nee", ()),
    "sphere_cosine": ("sphere_cosine", "nee", ()),
    "spec": ("spec", "nee", ()),
    "refr_reflect": ("refr_reflect", "nee", ()),
    "refr_refract": ("refr_refract", "nee", ()),
    "refr_inside": ("refr_inside", "nee", ()),
    "refr_inside_reflect": ("refr_inside_reflect", "nee", ()),
    "miss": ("miss", "nee", ()),
    "rect_light_axis_nee": ("rect_light_axis_nee", "nee", ()),
    "light_rect_below": ("light_rect_below", "nee", ()),
    "near_light_plane_nee": ("near_light_plane_nee", "nee", ()),
    "cosine_sphere": ("sphere_cosine", "cosine", ()),
    "cosine_refr": ("refr_refract", "cosine", ()),
    "uniform_sphere": ("sphere_cosine", "uniform", ("uniform",)),
    "uniform_rect": ("rect_cosine", "uniform", ("uniform",)),
    "uniform_corrected_sphere": ("sphere_cosine", "uniform_corrected",
                                 ("uniform",)),
    "uniform_corrected_rect": ("rect_cosine", "uniform_corrected",
                               ("uniform",)),
    "uniform_corrected_spec": ("spec", "uniform_corrected", ("uniform",)),
    "textbook_sphere": ("sphere_nee", "nee_textbook", ()),
    "textbook_rect": ("rect_nee", "nee_textbook", ()),
    "textbook_fail": ("sphere_cosine", "nee_textbook", ()),
    "textbook_light_axis": ("rect_light_axis_nee", "nee_textbook", ()),
    "mixture_take": ("sphere_nee", "mixture", ("take",)),
    "mixture_skip": ("sphere_nee", "mixture", ()),
    "mixture_coin": ("rect_nee", "mixture", ("coin",)),
    "mis_sphere": ("sphere_nee", "mis", ()),
    "mis_rect": ("rect_nee", "mis", ()),
    "mis_fail": ("sphere_cosine", "mis", ()),
    "mis_near_light_plane": ("near_light_plane_nee", "mis", ()),
    "mis_pickup": ("light_rect_below", "mis", ("pick",)),
    "mis_refr": ("refr_refract", "mis", ()),
    "glibc_nee": ("sphere_nee", "nee", ("glibc",)),
    "glibc_mixture": ("rect_nee", "mixture", ("glibc", "coin")),
}
BRANCHES = tuple(BRANCH_CASES)


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _branch_inputs(case, n=128, seed=0):
    """numpy-seeded (o, d, c, r, mp, Bounce, est, cotangents) whose lanes
    all take the branch ``case`` (BRANCH_CASES): a rect (the z = 0 wall)
    or a sphere winner hit from outside (near root) or inside (far root),
    DIFF with NEE success or the hemisphere sample, SPEC, REFR reflecting
    or refracting (inside: a mix of refraction and total internal
    reflection), or a miss. The light's cases: a rect winner on the
    light's axis (the floor, y = 0, hit from above) with NEE success; the
    light rect itself hit from below (sign -1; its probe meets the
    ceiling, so the cosine sample; mis: a BSDF-sampled pickup of the light,
    carry above 0); NEE success from wall points within 0.1 below the
    light's plane, where the probe grazes the light (dl . ln near 0). A
    light whose albedo is 0.98 scatters like any DIFF rect: the albedo
    enters the pullback only through the cotangents. Options: the uniform
    estimators' sample, mixture's coin taken on every lane ("take") or on
    about half ("coin"), mis's pickup ("pick"), glibc's light point in a
    2x2 patch at the light's corner ("glibc")."""
    geo, est, opts = BRANCH_CASES[case]
    r = np.random.default_rng(seed)
    c = r.uniform([25, 15, 40], [75, 50, 120], (n, 3))
    rad = r.uniform(6, 14, n)
    kind = np.full(n, mg.SPHERE)
    near = np.full(n, "inside" not in geo)
    axis, k = np.zeros(n, np.int64), np.zeros(n)
    if geo == "rect_light_axis_nee":
        kind[:], axis[:] = mg.RECT, 1
        o = r.uniform([20, 30, 30], [80, 70, 150], (n, 3))
        d = _unit(np.stack([r.uniform(-.3, .3, n), -np.ones(n),
                            r.uniform(-.3, .3, n)], 1))
    elif geo == "light_rect_below":
        kind[:], axis[:], k[:] = mg.RECT, 1, float(LIGHT.k)
        o = r.uniform([35, 10, 65], [65, 60, 95], (n, 3))
        d = _unit(np.stack([r.uniform(-.1, .1, n), np.ones(n),
                            r.uniform(-.1, .1, n)], 1))
    elif geo == "near_light_plane_nee":
        kind[:], axis[:], k[:] = mg.RECT, 0, 1.0
        o = np.stack([r.uniform(20, 60, n), r.uniform(81.4, 81.5, n),
                      r.uniform(40, 120, n)], 1)
        d = _unit(np.stack([-np.ones(n), r.uniform(-1e-3, 1e-3, n),
                            r.uniform(-.3, .3, n)], 1))
    elif geo.startswith("rect"):
        kind[:], axis[:] = mg.RECT, 2
        o = r.uniform([20, 10, 30], [80, 60, 150], (n, 3))
        d = _unit(np.stack([r.uniform(-.3, .3, n), r.uniform(-.3, .3, n),
                            -np.ones(n)], 1))
    elif geo == "miss":
        kind[:] = mg.MISS
        o = r.uniform([20, 10, 30], [80, 60, 150], (n, 3))
        d = _unit(r.normal(size=(n, 3)))
    elif "inside" in geo:
        o = c + _unit(r.normal(size=(n, 3))) * (
            rad * r.uniform(.5, .95, n))[:, None]
        d = _unit(r.normal(size=(n, 3)))
    else:
        o = c + _unit(r.normal(size=(n, 3))) * (rad * r.uniform(2, 4, n))[
            :, None]
        aim = c + _unit(r.normal(size=(n, 3))) * (
            rad * r.uniform(0, .7, n))[:, None]
        d = _unit(aim - o)
    refl = 1 if geo == "spec" else (2 if geo.startswith("refr") else 0)
    u1, u2 = r.random(n), r.random(n)
    lp = np.stack([32 + 36 * r.random(n), np.full(n, 81.6),
                   63 + 36 * r.random(n)], 1)
    if "glibc" in opts:
        lp = LIGHT_CORNER.numpy() + np.stack(
            [r.uniform(-1, 1, n), np.zeros(n), r.uniform(-1, 1, n)], 1)
    if "uniform" in opts:
        sin_t, wz = np.sqrt(u2 * (2 - u2)), 1 - u2
    else:
        sin_t, wz = np.sqrt(u2), np.sqrt(1 - u2)
    take = (np.full(n, "take" in opts) if "coin" not in opts
            else r.random(n) < 0.5)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    b = mg.Bounce(
        kind=torch.tensor(kind), axis=torch.tensor(axis), k=f32(k),
        near=torch.tensor(near), refl=torch.full((n,), refl),
        sign=torch.ones(n), alpha=f32(np.cos(2 * np.pi * u1) * sin_t),
        beta=f32(np.sin(2 * np.pi * u1) * sin_t), wz=f32(wz), lp=f32(lp),
        success=torch.full((n,), "cosine" not in geo
                           and geo != "light_rect_below"),
        coin=torch.full((n,), 0.0 if "reflect" in geo else 0.999),
        take=torch.tensor(take), pick=torch.full((n,), "pick" in opts))
    o, d, c, rad = f32(o), f32(d), f32(c), f32(rad)
    mp = f32(r.uniform(0.05, 0.3, n))
    with torch.no_grad():  # the primal's orientation
        x = mg.diff_step(o, d, c, rad, mp, b, LIGHT, est)[0]
        ng = torch.where((b.kind == mg.SPHERE)[:, None], vm.norm(x - c),
                         mg._onehot(b.axis, x))
    b = b._replace(sign=torch.where(vm.dot(ng, d) < 0.0, 1.0, -1.0))
    if geo == "light_rect_below":
        assert bool((b.sign == -1.0).all())
    lam = (f32(r.normal(size=(n, 3))), f32(r.normal(size=(n, 3))),
           *(f32(r.normal(size=n)) for _ in range(4)))
    return o, d, c, rad, mp, b, est, lam


@pytest.mark.parametrize("case", BRANCHES)
def test_bounce_vjp_matches_autograd(case):
    o, d, c, r, mp, b, est, lam = _branch_inputs(case)
    if case == "refr_inside":  # both sub-branches are exercised
        ddn = vm.dot(d, b.sign[:, None] * vm.norm(
            mg.diff_step(o, d, c, r, mp, b, LIGHT, est)[0] - c))
        tir = 1.0 - 2.25 * (1.0 - ddn * ddn) < 0.0
        assert 0 < int(tir.sum()) < len(tir)
    _, want = torch.autograd.functional.vjp(
        lambda *a: mg.diff_step(*a, b, LIGHT, est), (o, d, c, r, mp), lam)
    got = mg.bounce_vjp(o, d, c, r, mp, b, LIGHT, *lam, est=est)
    # Measured: within 2.4e-7 of the largest entry of each output (float32
    # rounding in two formula orders); 1e-5 relative leaves room.
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-30)


# --------------------------------------------------------------------------
# 2-7. The plain version against the port's forward and against JAX.

def test_image_only_equals_plain_render(port):
    scene, cam, cfg = port
    img, g_sph, g_alb, g_emi, traces = mg.geom_run(scene, cam, cfg, SEED,
                                                   with_counts=True)
    want, want_tr = megakernel.render_megakernel_plain(scene, cam, cfg, SEED)
    assert torch.equal(img, want) and torch.equal(traces, want_tr)
    assert not (g_sph.any() or g_alb.any() or g_emi.any())


def test_image_matches_jax(port, jax_side):
    """The bar of test_megakernel_geom.py:94-109: paths flip on grazing
    sphere hits, isolated pixels, not a shift."""
    scene, cam, cfg = port
    a = _port_image(scene, cam, cfg, SEED).numpy() / SPP
    b = jax_side["img"] / SPP
    assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() > 0.9
    assert abs(a.mean() - b.mean()) < 0.02


def _geom_vec(g_sph):
    return np.asarray(g_sph).reshape(-1)


def test_stable_pixel_grads_match_jax(port, jax_side):
    """Per-pixel cotangents on stable sphere pixels (no flipped path): the
    sphere rows within 1e-2 of the largest entry (the method of
    test_megakernel_geom.py:160-224, there against jnp autograd)."""
    scene, cam, cfg = port
    assert jax_side["per_pixel"], "no stable interior sphere pixels"
    for (y, x), g1, (gtab, galb, gemi) in jax_side["per_pixel"]:
        g_sph, g_alb, g_emi = mg.geom_vjp(scene, cam, cfg, SEED,
                                          torch.from_numpy(g1))
        w_sph, w_alb, w_emi = convert.geom_grads_from_jax(scene, gtab, galb,
                                                          gemi)
        a, b = _geom_vec(g_sph), _geom_vec(w_sph)
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a - b).max() <= 1e-2 * scale, ((y, x), a, b)
        for ga, wa in ((g_alb, w_alb), (g_emi, w_emi)):
            assert float((ga - wa).abs().max()) <= 1e-2 * float(
                wa.abs().max())


def test_whole_image_grads_match_jax(port, jax_side):
    """Under the numpy-seeded cotangent, every table against JAX's with the
    statistical bar of test_megakernel_geom.py:421-453 (largest difference
    within 0.25 of the largest entry, cosine above 0.9): the paths of 4 of
    432 pixels flip between the two forwards (grazing sphere hits), which
    moves the tables by up to 5.1e-2 of their largest entry (measured).
    With the cotangent on the stable pixels only, the materials agree
    within 1e-5 of the largest entry (measured 3.4e-7) and the sphere rows
    within 1e-2 (measured 3.8e-3: the JAX kernel linearizes the NEE
    distance at the light sampler's plane, y = 81.6, while its forward
    probes the light rect, y = 81.5; the port differentiates the probe's
    own distance)."""
    scene, cam, cfg = port
    g = jax_side["g_img"]
    stable = jax_side["stable"]
    assert 0 < int((~stable).sum()) < 20
    for g_img, want, rel_mat, rel_sph in (
            (g, jax_side["vjp"], None, None),
            (g * stable[..., None], jax_side["vjp_stable"], 1e-5, 1e-2)):
        got = mg.geom_vjp(scene, cam, cfg, SEED, torch.from_numpy(g_img))
        want = convert.geom_grads_from_jax(scene, *want)
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.numpy().reshape(-1), b.numpy().reshape(-1)
            err, scale = np.abs(a - b).max(), np.abs(b).max()
            if rel_mat is None:
                assert err <= 0.25 * scale, (i, a, b)
                assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9
            else:
                assert err <= (rel_sph if i == 0 else rel_mat) * scale, (
                    i, a, b)


def test_loss_is_crn_and_matches_jax(port, jax_side):
    scene, cam, cfg = port
    target = torch.from_numpy(jax_side["target"])
    loss, g_sph, g_alb, g_emi = mg.loss_and_geom_grads(scene, cam, cfg, SEED,
                                                       target)
    img = _port_image(scene, cam, cfg, SEED)
    own = float(torch.mean((img / SPP - target) ** 2))
    assert abs(float(loss) - own) <= 1e-6 * own
    # The 4 flipped pixels move the loss against JAX's: measured 3.8e-6
    # relative at this shape, and the sphere rows' cosine 0.99996.
    assert abs(float(loss) - jax_side["loss"]) <= 1e-4 * jax_side["loss"]
    w_sph = np.concatenate([np.asarray(jax_side["gsc"].spheres.center),
                            np.asarray(jax_side["gsc"].spheres.radius)[:,
                                                                       None]],
                           axis=1)
    a, b = _geom_vec(g_sph), w_sph.reshape(-1)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


ALBEDO = 0.98  # every object's, as chip_smoke.py's deep-path phase


def _albedo_scene(jscene, light_albedo):
    """The JAX scene with every albedo ALBEDO and the light's light_albedo."""
    ra = jnp.full_like(jscene.rects.albedo, ALBEDO).at[
        int(jscene.light.light_obj_id)].set(light_albedo)
    return jscene._replace(
        rects=jscene.rects._replace(albedo=ra),
        spheres=jscene.spheres._replace(
            albedo=jnp.full_like(jscene.spheres.albedo, ALBEDO)))


def test_reflecting_light_gradients(port, jax_side, monkeypatch):
    """Which side is off once the light reflects (every albedo 0.98,
    ROADMAP queue 3). With the light black, the port's gradients (autograd
    through the plain version) agree with the JAX kernel's on the stable
    pixels as at the preset's albedos: the JAX program is the fixture's
    (the material tables are runtime inputs; no new compile). With the
    light at 0.98 too, the JAX kernel renders another image (a different
    set of paths), so it cannot decide; on the port's own paths the NEE
    probe from the light's underside succeeds in some lanes: the hit point
    rounds one float below the light's plane, the probe meets the light
    just past the self-hit epsilon (t < 3e-3), and its weight |A (dl . ln)|
    / t^2 exceeds 1e3. Such a lane's radiance rests on that rounding (the
    point lies on the plane in real arithmetic), and so do its derivatives,
    which the kernel and autograd round in other orders (PERF.md §7)."""
    scene_p, cam_p, cfg_p = port
    cfg = JRenderConfig(width=W, height=H, spp=SPP, estimator="nee",
                        max_bounces=BOUNCES, sphere_table="on")
    jc = jmake_camera()
    js = _albedo_scene(jax_side["scene"], 0.0)
    n_programs = len(jgeom._CACHE)
    img_j = np.asarray(jgeom.geom_run(js, jc, cfg, SEED, None,
                                      interpret=True)[0])
    sc = convert.scene_from_jax(js, device="cpu")
    img_p = _port_image(sc, cam_p, cfg_p, SEED).numpy()
    stable = np.abs(img_p - img_j).max(axis=-1) < 1e-5
    assert stable.mean() > 0.95
    g = jax_side["g_img"] * stable[..., None]
    want = convert.geom_grads_from_jax(sc, *jgeom.geom_vjp(
        js, jc, cfg, SEED, g, interpret=True))
    assert len(jgeom._CACHE) == n_programs
    got = mg.geom_vjp(sc, cam_p, cfg_p, SEED, torch.from_numpy(g))
    # Measured: sphere rows 3.9e-3 (the JAX kernel's NEE distance at the
    # sampler's plane, test_whole_image_grads_match_jax), materials 5.5e-7.
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy().reshape(-1), b.numpy().reshape(-1)
        assert np.abs(a - b).max() <= (1e-2 if i == 0 else 1e-5) * np.abs(
            b).max(), (i, a, b)

    seen = []
    probe = wavefront._probe_light

    def spy(scene, x, nl, u):
        d_l, success, w = probe(scene, x, nl, u)
        seen.append((x, success, trace(scene, x, d_l).t, w))
        return d_l, success, w

    monkeypatch.setattr(wavefront, "_probe_light", spy)
    lit = convert.scene_from_jax(_albedo_scene(jax_side["scene"], ALBEDO),
                                 device="cpu")
    _port_image(lit, cam_p, cfg_p, SEED)
    x, ok, t, w = (torch.cat(v) for v in zip(*seen))
    L = lit.light.light_obj_id
    a, k = int(lit.rects.axis[L]), lit.rects.k[L]
    self_hit = ok & ((x[:, a] - k).abs() < 1e-3)
    assert int(self_hit.sum()) > 0
    below = k - x[self_hit, a]
    assert bool(((below > 0) & (below <= 2 * torch.finfo().eps * k)).all())
    assert bool(((t[self_hit] > 1e-3) & (t[self_hit] < 3e-3)).all())
    assert float(w[self_hit].max()) > 1e3


def test_grads_to_scene_matches_jax(port, jax_side):
    """convert.geom_grads_from_jax then grads_to_scene puts every JAX
    gradient where the JAX package's grads_to_scene puts it."""
    scene, _, _ = port
    tables = convert.geom_grads_from_jax(scene, *jax_side["vjp"])
    got = mg.grads_to_scene(scene, *tables)
    want = jgeom.grads_to_scene(jax_side["scene"], *jax_side["vjp"])
    for name in ("center", "radius", "albedo", "emission"):
        np.testing.assert_array_equal(getattr(got.spheres, name).numpy(),
                                      np.asarray(getattr(want.spheres, name)))
    for name in ("albedo", "emission"):
        np.testing.assert_array_equal(getattr(got.rects, name).numpy(),
                                      np.asarray(getattr(want.rects, name)))
    assert not bool(got.rects.k.any()) and not bool(got.light.corner.any())


# --------------------------------------------------------------------------
# 8-11. The port on its own.

def test_material_grads_match_crn_differences(port):
    """Sphere albedo, light emission and wall albedo cotangents against
    central differences through the port's own forward (the same paths:
    interior-exact for materials; test_megakernel_geom.py:112-158)."""
    scene, cam, cfg = port
    target = torch.zeros((H, W, 3), dtype=torch.float64)
    sph, alb, emi = mg.pack_tables(scene)
    R = scene.rects.k.shape[0]

    def loss(alb_, emi_):
        # In float64: a float32 mean rounds away ~1% of a difference at h.
        img = _port_image(mg.scene_with_tables(scene, sph, alb_, emi_), cam,
                          cfg, SEED)
        return float(torch.mean((img.double() / SPP - target) ** 2))

    img = _port_image(scene, cam, cfg, SEED)
    g_img = (img / SPP) * (2.0 / (img.numel() * SPP))
    _, g_alb, g_emi = mg.geom_vjp(scene, cam, cfg, SEED, g_img)
    h = 1e-3
    for tab, idx, g in ((alb, (R, 1), g_alb), (emi, (6, 0), g_emi),
                        (alb, (2, 0), g_alb)):
        tp, tm = tab.clone(), tab.clone()
        tp[idx] += h
        tm[idx] -= h
        if tab is alb:
            fd = (loss(tp, emi) - loss(tm, emi)) / (2 * h)
        else:
            fd = (loss(alb, tp) - loss(alb, tm)) / (2 * h)
        ad = float(g[idx])
        assert abs(fd - ad) <= 5e-2 * max(abs(fd), abs(ad)) + 1e-6, (idx, fd,
                                                                      ad)


def test_smallpt_original_gradients():
    """SPEC and REFR spheres: every gradient finite, the mirror's center
    cotangent nonzero (test_megakernel_geom.py:486-500), port only."""
    scene = spt.get_scene("smallpt_original", device="cpu")
    cam = spt.make_camera(aspect=16 / 12, device="cpu")
    cfg = spt.RenderConfig(width=16, height=12, spp=2, max_bounces=5)
    loss, g_sph, g_alb, g_emi = mg.loss_and_geom_grads(
        scene, cam, cfg, 4, torch.zeros((12, 16, 3)))
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(t).all() for t in (g_sph, g_alb, g_emi))
    assert int(scene.spheres.refl[0]) == 1  # the mirror
    assert float(g_sph[0, :3].abs().max()) > 0


def test_fit_recovers_displaced_sphere(port):
    """The contract of test_megakernel_geom.py:502-524 (best loss down
    1.35x, the returned iterate the best, the center not walking away) at
    lr 2, fitting every sphere's center: the JAX test fits sphere 0 alone,
    which adds the edge-sampled boundary terms (item 16). On the interior
    term alone the JAX test's 32x24x4 stalls (best loss down 1.03x,
    measured), so this runs at 64x48x2, and 5 steps where the JAX test
    takes 10: here the best loss stops falling after step 3 (measured over
    10 steps: 2.16x from step 3 on, the center 5.83 -> 2.28 from the
    truth)."""
    scene, cam, _ = port
    cfg = spt.RenderConfig(width=64, height=48, spp=2, max_bounces=6)
    target = _port_image(scene, cam, cfg, 13) / cfg.spp
    sp = scene.spheres
    displaced = scene._replace(spheres=sp._replace(
        center=sp.center + torch.tensor([[5.0, 0.0, -3.0], [0.0, 0.0, 0.0]])))
    fitted, losses = mg.fit_geom(displaced, cam, cfg, target,
                                 fields=("center",), steps=5, lr=2.0,
                                 seed=13)
    d0 = float(torch.linalg.vector_norm(displaced.spheres.center[0]
                                        - sp.center[0]))
    d1 = float(torch.linalg.vector_norm(fitted.spheres.center[0]
                                        - sp.center[0]))
    assert min(losses) < losses[0] / 1.35, losses
    assert losses[-1] == min(losses)
    assert d1 < d0 + 0.8, (d0, d1)


def test_moving_a_sphere_rebuilds_nothing(port, monkeypatch):
    """The spheres are runtime inputs: a moved or resized sphere changes
    the image and builds no library (on the CPU none at all)."""
    scene, cam, cfg = port

    def no_build():
        raise AssertionError("build_kernels called")

    monkeypatch.setattr(_build, "build_kernels", no_build)
    sp = scene.spheres
    moved = scene._replace(spheres=sp._replace(
        center=sp.center + torch.tensor([1.0, 0.5, -2.0]),
        radius=sp.radius * 1.1))
    a = _port_image(moved, cam, cfg, 1)
    b = _port_image(scene, cam, cfg, 1)
    assert float((a - b).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# 12-13. The CLI, the refusals, and the card paths without a card.

def test_cli_fit_geom_cpu(capsys):
    assert cli_main(["fit", "--device", "cpu", "--scene", "cornell_spheres",
                     "--width", "12", "--height", "9", "--spp", "2",
                     "--steps", "2", "--lr", "2", "--train",
                     "center,radius"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert len(res["center"]) == 3 and res["radius"] > 0
    assert out.err.count("step ") == 2


@pytest.mark.parametrize("argv, fields", [
    (["--estimator", "mis"], {"estimator": "mis"}),
    (["--estimator", "mixture", "--mixture-q", "0.3",
      "--light-sample-mode", "glibc_overflow"],
     {"estimator": "mixture", "mixture_q": 0.3,
      "light_sample_mode": "glibc_overflow"}),
    (["--estimator", "uniform_corrected"], {"estimator": "uniform_corrected"}),
], ids=["mis", "mixture_glibc", "uniform_corrected"])
def test_cli_fit_geom_estimators(argv, fields, capsys, monkeypatch):
    """cli fit --train center,radius passes --estimator, --mixture-q and
    --light-sample-mode to the geometry adjoint (it refused every
    estimator but nee before): the fit runs and its config carries them."""
    seen = []
    fit = mg.fit_geom

    def spy(scene, cam, cfg, *a, **k):
        seen.append(cfg)
        return fit(scene, cam, cfg, *a, **k)

    monkeypatch.setattr(mg, "fit_geom", spy)
    assert cli_main(["fit", "--device", "cpu", "--scene", "cornell_spheres",
                     "--width", "8", "--height", "6", "--spp", "2",
                     "--steps", "1", "--train", "center,radius",
                     *argv]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])
    (cfg,), = [seen]
    assert all(getattr(cfg, k) == v for k, v in fields.items())


@pytest.mark.parametrize("argv, err", [
    (["--train", "center", "--fd-sphere", "0"], NotImplementedError),
    (["--train", "center", "--fd-sphere", "5"], SystemExit),
    (["--train", "radius,k"], SystemExit),
    (["--train", "center", "--scene", "cornell_box"], SystemExit),
], ids=["fd_sphere", "fd_sphere_range", "field", "no_spheres"])
def test_cli_fit_geom_refuses(argv, err):
    with pytest.raises(err):
        cli_main(["fit", "--device", "cpu", "--scene", "cornell_spheres",
                  "--width", "4", "--height", "3", "--spp", "1", *argv])


def _glos(scene):
    return scene._replace(spheres=scene.spheres._replace(
        refl=torch.tensor([3, 0])))


@pytest.mark.parametrize("call, err, match", [
    (lambda s, c, f: convert.scene_from_jax(
        jget_scene("cornell_twolights"), device="cpu"),
     NotImplementedError, "item 12"),
    (lambda s, c, f: convert.scene_from_jax(
        jget_scene("cornell_spheres_roundlight"), device="cpu"),
     NotImplementedError, "item 12"),
    (lambda s, c, f: mg.geom_run(_glos(s), c, f, 0),
     ValueError, "cannot place GLOS spheres in the table"),
    (lambda s, c, f: mg.loss_and_geom_grads(s, c, f, 0, torch.zeros(3, 4, 3),
                                            edge_sphere=0),
     NotImplementedError, "item 16"),
    (lambda s, c, f: mg.fit_geom(s, c, f, torch.zeros(3, 4, 3),
                                 sphere_idx=0, fields=("radius",)),
     NotImplementedError, "item 16"),
    (lambda s, c, f: mg.fit_geom(s, c, f, torch.zeros(3, 4, 3),
                                 mesh=Mesh.single((1, 2))),
     ValueError, "spp=1 % n_dp=2"),
    (lambda s, c, f: mg.geom_run(spt.get_scene("cornell_box", device="cpu"),
                                 c, f, 0), ValueError, "no spheres"),
    (lambda s, c, f: mg.geom_run(s._replace(light=s.light._replace(
        light_obj_id=7)), c, f, 0), ValueError, "unrolled"),
    (lambda s, c, f: mg.fit_geom(s, c, f, torch.zeros(3, 4, 3),
                                 fields=("center", "gloss")),
     ValueError, "fields"),
], ids=["light_list", "sphere_light", "glos",
        "edge_sphere", "fd_sphere", "mesh", "no_spheres", "light_sphere",
        "field"])
def test_refusals(call, err, match):
    scene = spt.get_scene("cornell_spheres", device="cpu")
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = spt.RenderConfig(width=4, height=3, spp=1)
    with pytest.raises(err, match=match):
        call(scene, cam, cfg)


def test_cuda_paths_raise_without_cuda(port):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    scene, cam, cfg = port
    with pytest.raises(RuntimeError, match="CUDA"):
        mg.geom_run(scene, cam, cfg, SEED, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        mg.geom_vjp(scene, cam, cfg, SEED, torch.zeros((H, W, 3)),
                    device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["fit", "--scene", "cornell_spheres", "--width", "4",
                  "--height", "3", "--spp", "1", "--steps", "1", "--train",
                  "center"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.geom_grads_from_jax(scene, np.zeros(32), np.zeros(21),
                                    np.zeros(21), device="cuda")


def test_cpu_wrappers_count_no_launch(port):
    scene, cam, cfg = port
    before = dict(megakernel.LAUNCHES)
    mg.loss_and_geom_grads(scene, cam, cfg, SEED, torch.zeros((H, W, 3)))
    assert dict(megakernel.LAUNCHES) == before
