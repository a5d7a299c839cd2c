"""The geometry adjoint (rows 11 and 12) on general quads and GLOS
(modified-Phong) rects and quads against the JAX package (ROADMAP item 11,
geometry half).

Two scenes, built here from the JAX package's constructors and carried
over by ``convert.scene_from_jax``:

- Q: ``cornell_tilted_light``'s 16 rects and its light quad (object 16),
  with ``cornell_spheres``' two DIFF spheres;
- G: Q with the floor rect GLOS 40 (tests/test_megakernel_geom.py's
  glossy floor) and a non-emitting GLOS quad plate, exponent 60 (object
  17).

(a) The plain version (autograd through the eager forward) against the JAX
``geom_run`` / ``geom_vjp`` (interpret mode) on Q under ``nee`` and on G
under ``mis`` at 24x18x2, max_bounces 5, seed 9: one JAX program a case,
compiled once in the module fixture (~30-40 s each on the CPU). Measured
on the CPU:

- Images: a path that starts near the light quad's plane can flip
  between the two forwards (interpret mode's XLA contracts the quad test
  into FMAs, ROADMAP queue 3): 16 of 432 pixels differ by more than 1e-5
  on Q (one by 12.0 of a spp-sum: a path that reached the light in one
  forward only; the means 1.08e-2 apart), 28 on G (by at most 5.1e-2,
  the means 5.9e-5 apart). Held to: >= 90% of pixels within 1e-5, the
  means within 2e-2 relative.
- Gradients under the cotangent of the stable pixels (within 1e-5), at
  the JAX package's own bars (tests/test_megakernel_geom.py): each table
  within 1e-4 of its largest entry for ``nee`` (measured: albedo 4.1e-7,
  emission 2.0e-7, sphere rows 1.6e-6), 1e-2 for ``mis`` (5.5e-7, 1.9e-7,
  2.0e-5). The sphere rows come far closer to JAX than on
  ``cornell_spheres`` (3.8e-3, tests/test_torch_geom_est.py): the tilted
  light's sampler is the quad's exact geometry, so the JAX kernel's NEE
  distance is linearized at the plane its probe hits. On G the glossy
  floor's and the plate's albedo rows carry signal on both sides.

(b) On the port alone: the hand pullback (``bounce_vjp``) against
torch.autograd of ``diff_step`` on its quad and GLOS branches (a quad
winner, a quad light, the Phong lobe, its direct weight and mis's pdfs);
central differences of the plain forward's loss under common random
numbers against the plain adjoint for every code on Q and the GLOS codes
on G; the table layout; the routes through a stand-in library; the
refusals (the JAX kernel's ValueErrors, word for word, before any
launch); a fit and a sharded step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.ops import megakernel_geom as jgeom
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch import convert
from small_pathtracer_tpu_torch.core import vecmath as vm
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_geom as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh
from small_pathtracer_tpu_torch.scene.types import GLOS
from _recording_lib import install

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 24, 18, 2, 9, 5
# The plate of G: a tilted parallelogram in front of the left wall.
PLATE = {"corner": [[8.0, 40.0, 100.0]], "edge_u": [[22.0, 0.0, -10.0]],
         "edge_v": [[0.0, 22.0, 6.0]], "albedo": [[0.8, 0.75, 0.7]],
         "emission": [[0.0, 0.0, 0.0]]}
CODES = {
    "nee": {"estimator": "nee"},
    "cosine": {"estimator": "cosine"},
    "nee_textbook": {"estimator": "nee_textbook"},
    "uniform": {"estimator": "uniform"},
    "uniform_corrected": {"estimator": "uniform_corrected"},
    "mixture": {"estimator": "mixture", "mixture_q": 0.3},
    "mis": {"estimator": "mis"},
    "nee_glibc": {"estimator": "nee", "light_sample_mode": "glibc_overflow"},
    "mixture_glibc": {"estimator": "mixture",
                      "light_sample_mode": "glibc_overflow"},
}
GLOS_CODES = ("cosine", "nee_textbook", "mis")


def _jax_q():
    return jget_scene("cornell_tilted_light")._replace(
        spheres=jget_scene("cornell_spheres").spheres)


def _floor(js) -> int:
    r = js.rects
    return int(np.where((np.asarray(r.axis) == 1)
                        & (np.asarray(r.k) == 0.0))[0][0])


def _jax_g():
    s = _jax_q()
    r, q, floor = s.rects, s.quads, _floor(s)
    quads = q._replace(
        **{k: jnp.concatenate([getattr(q, k), jnp.asarray(v, jnp.float32)])
           for k, v in PLATE.items()},
        refl=jnp.concatenate([q.refl, jnp.asarray([GLOS], q.refl.dtype)]),
        gloss=jnp.concatenate([q.gloss, jnp.asarray([60.0], q.gloss.dtype)]))
    return s._replace(rects=r._replace(refl=r.refl.at[floor].set(GLOS),
                                       gloss=r.gloss.at[floor].set(40.0)),
                      quads=quads)


SCENES = {"Q": _jax_q, "G": _jax_g}
CASES = {"Q-nee": ("Q", "nee"), "G-mis": ("G", "mis")}


def _port(name):
    return convert.scene_from_jax(SCENES[name](), device="cpu")


def _cfg(est, **kw):
    fields = {"width": W, "height": H, "spp": SPP, "seed": SEED,
              "max_bounces": BOUNCES, **CODES[est], **kw}
    return spt.RenderConfig(**fields)


@pytest.fixture(scope="module")
def jax_side():
    """For each case, from one compiled JAX program: the image, and the
    adjoint under a numpy-seeded cotangent of the stable pixels; and the
    port's scene, camera and image."""
    jcam = jmake_camera()
    cam = convert.camera_from_jax(jcam, device="cpu")
    g_img = np.random.default_rng(21).standard_normal(
        (H, W, 3)).astype(np.float32)
    out = {}
    for case, (name, est) in CASES.items():
        js = SCENES[name]()
        sc = convert.scene_from_jax(js, device="cpu")
        cfg = JRenderConfig(width=W, height=H, spp=SPP, estimator=est,
                            max_bounces=BOUNCES, sphere_table="on")
        img = np.asarray(jgeom.geom_run(js, jcam, cfg, SEED, None,
                                        interpret=True)[0])
        img_p = mg.geom_run(sc, cam, _cfg(est), SEED)[0].numpy()
        stable = np.abs(img_p - img).max(axis=-1) < 1e-5
        g = g_img * stable[..., None]
        want = convert.geom_grads_from_jax(sc, *(
            np.asarray(v) for v in jgeom.geom_vjp(js, jcam, cfg, SEED, g,
                                                  interpret=True)))
        out[case] = {"scene": sc, "cam": cam, "img": img, "img_p": img_p,
                     "stable": stable, "g": g, "want": want}
    return out


@pytest.mark.parametrize("case", CASES)
def test_image_matches_jax(case, jax_side):
    side = jax_side[case]
    a, b = side["img_p"] / SPP, side["img"] / SPP
    assert side["stable"].mean() >= 0.9
    assert abs(a.mean() - b.mean()) <= 2e-2 * b.mean()


def _rel(a, b):
    a, b = a.numpy().reshape(-1), b.numpy().reshape(-1)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", CASES)
def test_stable_pixel_grads_match_jax(case, jax_side):
    """Each table within the JAX package's bar of its largest entry; on G
    the glossy floor's and the plate's albedo rows carry signal."""
    side = jax_side[case]
    sc, est = side["scene"], CASES[case][1]
    got = mg.geom_vjp(sc, side["cam"], _cfg(est), SEED,
                      torch.from_numpy(side["g"]))
    tol = 1e-4 if est == "nee" else 1e-2
    for a, b in zip(got, side["want"]):
        assert float(b.abs().max()) > 0
        assert _rel(a, b) <= tol
    assert sc.light.light_obj_id == 16 and sc.rects.k.shape[0] == 16
    if case == "G-mis":
        g_alb, w_alb = got[1], side["want"][1]
        scale = float(w_alb.abs().max())
        for row in (_floor(SCENES["G"]()), 17):
            assert float(w_alb[row].abs().max()) > 1e-3 * scale
            assert float((g_alb[row] - w_alb[row]).abs().max()) <= 1e-2 * (
                float(w_alb[row].abs().max()))


# --------------------------------------------------------------------------
# (b) The hand pullback's quad and GLOS branches against torch.autograd.

LIGHT_Q = mg.light_consts(_port("Q"))
LIGHT_Q_SAMPLER = _port("Q").light
# cornell_spheres' light: a rect (y = 81.5) under its sampler (y = 81.6).
LIGHT_RECT = mg.light_consts(spt.get_scene("cornell_spheres", device="cpu"))
LIGHT_RECT_SAMPLER = spt.get_scene("cornell_spheres", device="cpu").light
# Each case: (winner, estimator, options): a quad winner (a tilted plane
# hit from its upper side), a sphere winner, a rect winner (the floor hit
# from above) or the light quad hit from below; options: the probe failed
# ("fail"), a GLOS winner ("glos"), mis's pickup of the light ("pick"),
# the rect light of cornell_spheres in place of Q's quad ("rect_light").
BRANCH_CASES = {
    "quad_nee": ("quad", "nee", ()),
    "quad_cosine_sample": ("quad", "nee", ("fail",)),
    "quad_mixture": ("quad", "mixture", ()),
    "quad_uniform_corrected": ("quad", "uniform_corrected", ("fail",)),
    "quad_mis": ("quad", "mis", ()),
    "sphere_quad_light_nee": ("sphere", "nee", ()),
    "sphere_quad_light_mis": ("sphere", "mis", ()),
    "rect_quad_light_textbook": ("rect", "nee_textbook", ()),
    "mis_pickup_quad_light": ("light_below", "mis", ("pick", "fail")),
    "glos_rect_cosine": ("rect", "cosine", ("glos",)),
    "glos_rect_textbook": ("rect", "nee_textbook", ("glos",)),
    "glos_rect_mis": ("rect", "mis", ("glos",)),
    "glos_quad_textbook": ("quad", "nee_textbook", ("glos",)),
    "glos_quad_mis": ("quad", "mis", ("glos",)),
    "glos_fail_mis": ("quad", "mis", ("glos", "fail")),
    "glos_quad_mis_rect_light": ("quad", "mis", ("glos", "rect_light")),
    "quad_nee_rect_light": ("quad", "nee", ("rect_light",)),
}


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _branch_inputs(case, n=128, seed=0):
    """numpy-seeded (o, d, c, r, mp, Bounce, est, cotangents) whose lanes
    all take the branch ``case``; the light sample lies on Q's light quad,
    and a GLOS lane's exponent is in [4, 30), its lobe sample drawn as the
    forward draws it."""
    winner, est, opts = BRANCH_CASES[case]
    r = np.random.default_rng(seed)
    c = r.uniform([25, 15, 40], [75, 50, 120], (n, 3))
    rad = r.uniform(6, 14, n)
    kind = np.full(n, mg.SPHERE)
    axis, k = np.zeros(n, np.int64), np.zeros(n)
    pp, pn = np.zeros((n, 3)), np.tile([0.0, 0.0, 1.0], (n, 1))
    if winner == "quad":
        kind[:] = mg.QUAD
        pn = _unit(np.stack([r.uniform(-.4, .4, n), np.ones(n),
                             r.uniform(-.4, .4, n)], 1))
        pp = r.uniform([20, 5, 40], [80, 20, 120], (n, 3))
        o = pp + pn * r.uniform(10, 40, n)[:, None] + r.uniform(-5, 5, (n, 3))
        aim = pp + r.uniform(-5, 5, (n, 3))
        aim -= pn * ((aim - pp) * pn).sum(1, keepdims=True)
        d = _unit(aim - o)
    elif winner == "light_below":
        kind[:] = mg.QUAD
        pn = np.tile(LIGHT_Q.pn.numpy(), (n, 1)).astype(np.float64)
        pp = np.tile(LIGHT_Q.pc.numpy(), (n, 1)).astype(np.float64)
        o = r.uniform([35, 10, 65], [65, 60, 95], (n, 3))
        d = _unit(np.stack([r.uniform(-.1, .1, n), np.ones(n),
                            r.uniform(-.1, .1, n)], 1))
    elif winner == "rect":
        kind[:], axis[:] = mg.RECT, 1
        o = r.uniform([20, 30, 30], [80, 70, 150], (n, 3))
        d = _unit(np.stack([r.uniform(-.3, .3, n), -np.ones(n),
                            r.uniform(-.3, .3, n)], 1))
    else:
        o = c + _unit(r.normal(size=(n, 3))) * (rad * r.uniform(2, 4, n))[
            :, None]
        aim = c + _unit(r.normal(size=(n, 3))) * (rad * r.uniform(0, .7, n))[
            :, None]
        d = _unit(aim - o)
    u1, u2 = r.random(n), r.random(n)
    lu, lv = r.random(n), r.random(n)
    light = LIGHT_RECT_SAMPLER if "rect_light" in opts else LIGHT_Q_SAMPLER
    lp = (light.corner.numpy() + lu[:, None] * light.edge_u.numpy()
          + lv[:, None] * light.edge_v.numpy())
    gl = r.uniform(4, 30, n)
    gz = r.random(n) ** (1 / (gl + 1))
    gs = np.sqrt(1 - gz * gz)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    glos = "glos" in opts
    b = mg.Bounce(
        kind=torch.tensor(kind), axis=torch.tensor(axis), k=f32(k),
        near=torch.ones(n, dtype=torch.bool),
        refl=torch.full((n,), GLOS if glos else 0), sign=torch.ones(n),
        alpha=f32(np.cos(2 * np.pi * u1) * np.sqrt(u2)),
        beta=f32(np.sin(2 * np.pi * u1) * np.sqrt(u2)),
        wz=f32(np.sqrt(1 - u2)), lp=f32(lp),
        success=torch.full((n,), "fail" not in opts),
        coin=torch.full((n,), 0.999), take=torch.ones(n, dtype=torch.bool),
        pick=torch.full((n,), "pick" in opts), pp=f32(pp), pn=f32(pn),
        gl=f32(gl) if glos else None,
        ga=f32(np.cos(2 * np.pi * u1) * gs),
        gb=f32(np.sin(2 * np.pi * u1) * gs), gz=f32(gz))
    o, d, c, rad = f32(o), f32(d), f32(c), f32(rad)
    mp = f32(r.uniform(0.05, 0.3, n))
    with torch.no_grad():  # the primal's orientation
        x = mg.diff_step(o, d, c, rad, mp, b, _light(case), est)[0]
        ng = torch.where((b.kind == mg.SPHERE)[:, None], vm.norm(x - c),
                         torch.where((b.kind == mg.QUAD)[:, None], b.pn,
                                     mg._onehot(b.axis, x)))
    b = b._replace(sign=torch.where(vm.dot(ng, d) < 0.0, 1.0, -1.0))
    if winner == "light_below":  # the quad's normal faces down, to them
        assert bool((b.sign == 1.0).all())
    lam = (f32(r.normal(size=(n, 3))), f32(r.normal(size=(n, 3))),
           *(f32(r.normal(size=n)) for _ in range(4)))
    return o, d, c, rad, mp, b, est, lam


def _light(case):
    return LIGHT_RECT if "rect_light" in BRANCH_CASES[case][2] else LIGHT_Q


@pytest.mark.parametrize("case", BRANCH_CASES)
def test_bounce_vjp_matches_autograd(case):
    """Measured: within 2.0e-7 of the largest entry of each output; 1e-5
    relative leaves room (tests/test_torch_geom.py's bar). Each case's
    outputs carry signal: the direct term's weight where the probe
    succeeded under nee_textbook and mis, the continuation's weight on
    every lane."""
    o, d, c, r, mp, b, est, lam = _branch_inputs(case)
    light = _light(case)
    out = mg.diff_step(o, d, c, r, mp, b, light, est)
    assert bool((out[2] > 0).all())
    if est in mg.DIRECT and bool(b.success.all()):
        assert bool((out[3] > 0).all())
    _, want = torch.autograd.functional.vjp(
        lambda *a: mg.diff_step(*a, b, light, est), (o, d, c, r, mp), lam)
    got = mg.bounce_vjp(o, d, c, r, mp, b, light, *lam, est=est)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-30)


def test_pow_pos_derivative():
    """vm.pow_pos's derivative in x (the GLOS lobe's, through the eager
    forward) is p x^(p - 1) within 3e-6 relative (float64 reference), and
    0 where x is 0."""
    x = torch.tensor([0.0, 1e-3, 0.2, 0.5, 0.9, 0.999], requires_grad=True)
    p = torch.tensor([40.0, 3.0, 5.0, 60.0, 20.0, 1.5])
    vm.pow_pos(x, p).sum().backward()
    xd, pd = x.detach().double(), p.double()
    want = torch.where(xd > 0, pd * xd ** (pd - 1), 0.0)
    assert torch.allclose(x.grad.double(), want, rtol=3e-6, atol=0.0)


# --------------------------------------------------------------------------
# Finite differences, layout, routes, refusals, fits.

FD_W, FD_H, FD_SPP, FD_BOUNCES, FD_STEP = 8, 6, 2, 5, 1e-3


def _fd_cases():
    return ([f"{c}@Q" for c in CODES]
            + [f"{c}@G" for c in GLOS_CODES])


@pytest.mark.parametrize("label", _fd_cases())
def test_fd_validates_plain_adjoint(label):
    """Central differences of the plain forward's loss (float64, common
    random numbers, Russian roulette off) against the plain adjoint's
    entries: a quad-lit wall's albedo and the quad light's emission, and
    on G the glossy floor's albedo. Agreement within 2e-2 of the larger
    magnitude (the JAX package's test_fd_validates_kernel_gradient)."""
    code, name = label.split("@")
    sc = _port(name)
    cam = spt.make_camera(aspect=FD_W / FD_H, device="cpu")
    cfg = _cfg(code, width=FD_W, height=FD_H, spp=FD_SPP, seed=5,
               max_bounces=FD_BOUNCES, rr_start_depth=FD_BOUNCES)
    target = torch.full((FD_H, FD_W, 3), 0.1)
    sph, alb, emi = mg.pack_tables(sc)

    def loss(a, e):
        img = mg.geom_run(mg.scene_with_tables(sc, sph, a, e), cam, cfg,
                          5)[0]
        dd = img.double() / cfg.spp - target.double()
        return float((dd * dd).mean())

    _, _, g_alb, g_emi = mg.loss_and_geom_grads(sc, cam, cfg, 5, target)
    entries = [("emission", 16, 1), ("albedo", 2, 0)]
    if name == "G":
        entries.append(("albedo", _floor(SCENES["G"]()), 1))
    for field, row, ch in entries:
        tab, grad = (emi, g_emi) if field == "emission" else (alb, g_alb)
        fd = []
        for h in (FD_STEP, -FD_STEP):
            t = tab.clone()
            t[row, ch] += h
            fd.append(loss(alb, t) if field == "emission" else loss(t, emi))
        fd = (fd[0] - fd[1]) / (2 * FD_STEP)
        g = float(grad[row, ch])
        assert g != 0.0, (field, row)
        assert abs(fd - g) < 2e-2 * max(abs(fd), abs(g)), (field, row, fd, g)


@pytest.mark.parametrize("name", ["Q", "G"])
def test_tables_in_rect_quad_sphere_order(name):
    """The geometry adjoint's tables hold K = R + Q + S rows, the quads at
    R..R+Q-1 (the JAX grads_to_scene's order); grads_to_scene and
    convert.geom_grads_from_jax put each block back."""
    sc = _port(name)
    R, Q, S = (sc.rects.k.shape[0], sc.quads.corner.shape[0],
               sc.spheres.radius.shape[0])
    sph, alb, emi = mg.pack_tables(sc)
    assert sph.shape == (S, 4) and alb.shape == emi.shape == (R + Q + S, 3)
    assert torch.equal(alb[R:R + Q], sc.quads.albedo)
    a2 = torch.arange(3.0 * (R + Q + S)).reshape(-1, 3)
    s2 = torch.arange(4.0 * S).reshape(S, 4)
    gs = mg.grads_to_scene(sc, s2, a2, -a2)
    assert torch.equal(gs.quads.albedo, a2[R:R + Q])
    assert torch.equal(gs.spheres.emission, -a2[R + Q:])
    assert torch.equal(gs.spheres.radius, s2[:, 3])
    gtab = np.concatenate([s2.numpy(), a2[R + Q:].numpy(),
                           -a2[R + Q:].numpy(), np.zeros((S, 6))], 1)
    back = convert.geom_grads_from_jax(sc, gtab, a2[:R + Q].numpy(),
                                       -a2[:R + Q].numpy())
    for x, y in zip(back, (s2, a2, -a2)):
        assert torch.equal(x, y)


def _tree(glos: bool):
    """Q with sphere_grid's 64 spheres (the tree), the floor GLOS 40 for
    the GLOS codes."""
    sc = _port("G" if glos else "Q")
    if glos:
        sc = sc._replace(quads=_port("Q").quads)
    return sc._replace(spheres=spt.get_scene("sphere_grid",
                                             device="cpu").spheres)


ROUTES = {
    ("Q", "nee"): ("spt_megakernel_geom_ext", "megakernel_geom_ext"),
    ("G", "mis"): ("spt_megakernel_geom_ext", "megakernel_geom_mis_ext"),
    ("tree", "mixture_glibc"): ("spt_megakernel_geom_ext",
                                "megakernel_geom_mixture_glibc_ext"),
    ("tree_glos", "nee_textbook"): ("spt_megakernel_geom_ext",
                                    "megakernel_geom_textbook_ext"),
    ("cornell_spheres", "mis"): ("spt_megakernel_geom_direct",
                                 "megakernel_geom_mis"),
}


@pytest.mark.parametrize("key", list(ROUTES), ids="-".join)
def test_kernel_routes_by_family(monkeypatch, key):
    """Rows 11 and 12 route by ``megakernel.kernel_family``: a scene with
    quads or GLOS objects to spt_megakernel_geom_ext with the code,
    mixture_q, the quads, the sphere table and the Phong exponents, both
    launches counted as megakernel_geom[_<est>]_ext; the others as
    before."""
    lib = install(monkeypatch)
    name, code = key
    sc = (_tree(name == "tree_glos") if name.startswith("tree")
          else spt.get_scene(name, device="cpu") if name == "cornell_spheres"
          else _port(name))
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = spt.RenderConfig(width=8, height=6, spp=2, seed=1, **CODES[code])
    entry, kname = ROUTES[key]
    assert mg.geom_kernel_name(cfg, sc) == kname
    lay = mk.full_layout(cfg)
    dev = torch.device("cpu")
    mg._launch(sc, cam, cfg, 1, None, lay, dev, None)
    mg._launch(sc, cam, cfg, 1, torch.zeros(48, 3), lay, dev, None)
    calls = [(c, a) for c, a in lib.calls if c != "spt_sphere_bvh"]
    assert [c for c, _ in calls] == [entry, entry]
    assert dict(mk.LAUNCHES) == {kname: 2}
    if entry != "spt_megakernel_geom_ext":
        return
    geom = mk.pack_geometry(sc, cam)
    R, Q, S = len(geom.rect_axis), len(geom.quad_f), sc.spheres.radius.shape[0]
    n_launch = len(mk.launch_args(geom, cfg, 1, lay))
    for (_, args), bk in zip(calls, (0, 1)):
        assert args[:2] == (mk.est_code(cfg), cfg.mixture_q)
        assert args[4] == R and args[6] == Q
        tail = args[7 + n_launch:]
        # sph, n_spheres, bvh, root, alb, emi, refl, gloss, then bk.
        assert tail[1] == S and tail[8] == bk and len(tail) == 16
    n_blocks = -(-lay.n_pix_loc * lay.g // mg.KERNEL_BLOCK)
    assert calls[1][1][-5] == n_blocks * (6 * (R + Q + S) + 4 * S)


def _refusal_scenes():
    """(scene, estimator, the JAX scene) of each refusal the JAX kernel
    makes before building: a GLOS sphere (cornell_glossy), GLOS rects
    under nee, no sphere (the tilted light), a light that is not unrolled
    (cornell_spheres with sphere 0 as light_obj_id)."""
    js_light = jget_scene("cornell_spheres")
    js_light = js_light._replace(light=js_light.light._replace(
        light_obj_id=jnp.asarray(js_light.rects.k.shape[0], jnp.int32)))
    return {"glos_sphere": (jget_scene("cornell_glossy"), "mis"),
            "glos_nee": (_jax_g(), "nee"),
            "no_sphere": (jget_scene("cornell_tilted_light"), "nee"),
            "light_not_unrolled": (js_light, "nee")}


@pytest.mark.parametrize("what", ["glos_sphere", "glos_nee", "no_sphere",
                                  "light_not_unrolled"])
def test_refusals_are_the_jax_kernels(what):
    """Each refusal raises the JAX kernel's ValueError, word for word, on
    every entry point and before any launch."""
    js, est = _refusal_scenes()[what]
    with pytest.raises(ValueError) as want:
        jgeom.build_geom_grad_kernel(js, jmake_camera(), JRenderConfig(
            width=4, height=3, spp=1, estimator=est, sphere_table="on"))
    sc = convert.scene_from_jax(js, device="cpu")
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = spt.RenderConfig(width=4, height=3, spp=1, estimator=est)
    target = torch.zeros(3, 4, 3)
    before = mk.LAUNCHES.copy()
    for call in (
            lambda: mg.check_geom(sc, cfg),
            lambda: mg.geom_run(sc, cam, cfg, 0),
            lambda: mg.geom_vjp(sc, cam, cfg, 0, target),
            lambda: mg.loss_and_geom_grads(sc, cam, cfg, 0, target),
            lambda: mg.fit_geom(sc, cam, cfg, target, steps=1),
            lambda: mg.geom_train_step_sharded(sc, cam, cfg,
                                               Mesh.single((1, 1)), target)):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)
    assert mk.LAUNCHES == before


def test_fit_and_sharded_step_on_g():
    """fit_geom on G with mis takes its steps (each rejected step restored,
    so the returned loss is the best) and moves the spheres; one sharded
    step on a mesh of one is loss_and_geom_grads."""
    sc = _port("G")
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = _cfg("mis", width=8, height=6, spp=2)
    target = mg.geom_run(sc, cam, cfg, SEED + 1)[0] / cfg.spp
    moved = sc._replace(spheres=sc.spheres._replace(
        center=sc.spheres.center + torch.tensor([[2.0, 0.0, -1.5]])))
    best, losses = mg.fit_geom(moved, cam, cfg, target, steps=3, lr=1.0,
                               seed=SEED)
    assert len(losses) == 3 and losses[-1] == min(losses)
    assert all(np.isfinite(losses))
    assert not torch.equal(best.spheres.center, moved.spheres.center) or (
        losses[-1] == losses[0])
    step = mg.geom_train_step_sharded(moved, cam, cfg, Mesh.single((1, 1)),
                                      target)
    loss, _, *grads = step(*mg.pack_tables(moved), SEED)
    want = mg.loss_and_geom_grads(moved, cam, cfg, SEED, target)
    assert abs(float(loss) - float(want[0])) <= 1e-6 * float(want[0])
    for a, b in zip(grads, want[1:]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
