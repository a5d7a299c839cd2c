"""Material training with general quads and GLOS (modified-Phong) materials
against the JAX package (ROADMAP item 11, material half: rows 8, 9 and 10).

- (a) ``cornell_tilted_light`` (its light is object 16, a quad) with rect 2
  made GLOS 60 (tests/test_megakernel_grad.py's glossy rect) under ``mis``
  at 16x12x4, max_bounces 8, seed 3: the port's training evaluation
  (``loss_and_material_grads``: the plain forward and autograd through it)
  against the JAX ``loss_and_material_grads(interpret=True)`` at the JAX
  package's own bar (its ``test_vjp_matches_jnp_adjoint_glos``): each
  table within 5e-3 of its largest entry and rtol 5e-3, the light's albedo
  row left out under ``mis`` (the knife-edge 1/t^2 probes of the 81.5-vs-
  81.6 plane, tests/test_megakernel_grad.py:69-76), the loss within 1e-5.
  One JAX program, made once in the module fixture.
- (b) On the port alone: central finite differences of the plain forward
  under common random numbers (float64 losses) against the plain adjoint,
  for each estimator code on the tilted light (its quad light's emission
  row and a wall's albedo) and each GLOS code on the glossy rect box (the
  light's emission row and the GLOS wall's albedo), in the manner of the
  JAX package's ``test_fd_validates_kernel_gradient``, with Russian
  roulette off so the forward is smooth in the albedo; the tables' layout
  (rects, quads, spheres); the kernels' names and routes by
  ``kernel_family`` through a stand-in library.
- (c) The refusals, before any launch: estimators without glossy
  semantics on a GLOS scene (the JAX kernel's ValueError), more objects
  than the adjoint's shared-memory rows hold (quads count), light lists
  and sphere lights (item 12).
- (d) ``cli fit`` on ``cornell_glossy`` with ``mis`` and on the tilted
  light, whose printed ``light_emission`` is the quad's row."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.ops import megakernel_grad as jgrad
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from _recording_lib import install
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh
from small_pathtracer_tpu_torch.scene.types import GLOS

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 16, 12, 4, 3, 8
# Every estimator code of the _ext kernels, and those with glossy semantics.
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
# The finite differences: 8x6x2, max_bounces 6 with rr_start_depth past
# it, step FD_H, agreement FD_TOL of the larger magnitude (the JAX
# package's 2e-2).
FD_W, FD_H_PIX, FD_SPP, FD_BOUNCES, FD_H, FD_TOL = 8, 6, 2, 6, 1e-3, 2e-2


def _tilted_glos_jax():
    """cornell_tilted_light with rect 2 GLOS 60 (tests/test_megakernel_
    grad.py's glossy rect on the box)."""
    s = jget_scene("cornell_tilted_light")
    return s._replace(rects=s.rects._replace(
        refl=s.rects.refl.at[2].set(GLOS),
        gloss=s.rects.gloss.at[2].set(60.0)))


def _glossy_box():
    """tests/test_torch_glossy_quads.py's rect-only glossy box: cornell_box
    with the tall box's top (rect 11) GLOS 40 and the right wall (rect 3)
    GLOS 300."""
    sc = spt.get_scene("cornell_box", device="cpu")
    refl, gloss = sc.rects.refl.clone(), sc.rects.gloss.clone()
    refl[11], gloss[11] = GLOS, 40.0
    refl[3], gloss[3] = GLOS, 300.0
    return sc._replace(rects=sc.rects._replace(refl=refl, gloss=gloss))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX training evaluation of (a) against a numpy-seeded target,
    and the port's scene, camera, config and target."""
    js = _tilted_glos_jax()
    jcam = jmake_camera()
    kw = dict(width=W, height=H, spp=SPP, estimator="mis", seed=SEED,
              max_bounces=BOUNCES)
    target = np.random.default_rng(7).uniform(
        0.0, 0.5, (H, W, 3)).astype(np.float32)
    loss, galb, gemi = jgrad.loss_and_material_grads(
        js, jcam, JRenderConfig(**kw), jnp.uint32(SEED), jnp.asarray(target),
        interpret=True)
    port = (scene_from_jax(js, device="cpu"),
            camera_from_jax(jcam, device="cpu"), spt.RenderConfig(**kw),
            torch.from_numpy(target))
    return (float(loss), np.asarray(galb), np.asarray(gemi)), port


def test_training_evaluation_matches_jax(jax_side):
    """(a): the loss within 1e-5, each table within the JAX package's bar,
    the light's albedo row left out (the light is the quad, object 16)."""
    (j_loss, j_alb, j_emi), (sc, cam, cfg, target) = jax_side
    light = int(sc.light.light_obj_id)
    assert light == sc.rects.k.shape[0] == 16
    loss, galb, gemi = mg.loss_and_material_grads(sc, cam, cfg, SEED, target)
    assert abs(float(loss) - j_loss) < 1e-5 * max(1.0, abs(j_loss))
    galb, j_alb = galb.numpy().copy(), j_alb.copy()
    galb[light] = j_alb[light] = 0.0
    for got, want in ((galb, j_alb), (gemi.numpy(), j_emi)):
        assert want.shape == (17, 3)
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=5e-3 * np.abs(want).max())
    # The quad light's emission row carries the largest cotangent.
    assert np.abs(j_emi[light]).max() == np.abs(j_emi).max() > 0


def _fd_case(label):
    """(scene, config, [(table, row, channel)]) of a finite-difference
    case: every code on the tilted light (the quad light's emission, the
    green wall's red albedo, as the JAX test), the GLOS codes on the glossy
    box (the light's emission, the GLOS right wall's green albedo)."""
    code, where = label.split("@")
    cfg = spt.RenderConfig(width=FD_W, height=FD_H_PIX, spp=FD_SPP, seed=5,
                           max_bounces=FD_BOUNCES,
                           rr_start_depth=FD_BOUNCES, **CODES[code])
    if where == "tilted":
        sc = spt.get_scene("cornell_tilted_light", device="cpu")
        return sc, cfg, [("emission", 16, 0), ("albedo", 2, 0)]
    return _glossy_box(), cfg, [("emission", 6, 0), ("albedo", 3, 1)]


FD_CASES = [f"{c}@tilted" for c in CODES] + [f"{c}@glossy_box"
                                              for c in GLOS_CODES]


@pytest.mark.parametrize("label", FD_CASES)
def test_fd_validates_plain_adjoint(label):
    """Central differences of the plain forward's loss under common random
    numbers against the plain adjoint's entries."""
    sc, cfg, entries = _fd_case(label)
    cam = spt.make_camera(aspect=FD_W / FD_H_PIX, device="cpu")
    alb, emi = mg.pack_materials(sc)
    target = torch.full((FD_H_PIX, FD_W, 3), 0.1)

    def loss(a, e):
        img, _ = mg.render_megakernel_mat(sc, cam, cfg, a, e, 5)
        d = img.double() / cfg.spp - target.double()
        return float((d * d).mean())

    img, _ = mg.render_megakernel_mat(sc, cam, cfg, alb, emi, 5)
    g_img = (img / cfg.spp - target) * (2.0 / (img.numel() * cfg.spp))
    galb, gemi = mg.render_megakernel_vjp(sc, cam, cfg, alb, emi, 5, g_img)
    for field, row, ch in entries:
        tab, grad = (emi, gemi) if field == "emission" else (alb, galb)
        fd = []
        for h in (FD_H, -FD_H):
            t = tab.clone()
            t[row, ch] += h
            fd.append(loss(alb, t) if field == "emission" else loss(t, emi))
        fd = (fd[0] - fd[1]) / (2 * FD_H)
        g = float(grad[row, ch])
        assert g != 0.0, (field, row)
        assert abs(fd - g) < FD_TOL * max(abs(fd), abs(g)), (field, row, fd, g)


def _tree_scene():
    """The tilted light with sphere_grid's spheres, sphere 0 GLOS: rects,
    a quad and spheres with every material code."""
    sc = spt.get_scene("cornell_tilted_light", device="cpu")
    sp = spt.get_scene("sphere_grid", device="cpu").spheres
    refl, gloss = sp.refl.clone(), sp.gloss.clone()
    refl[0], gloss[0] = GLOS, 20.0
    return sc._replace(spheres=sp._replace(refl=refl, gloss=gloss))


@pytest.mark.parametrize("name", ["cornell_tilted_light", "cornell_glossy",
                                  "tree"])
def test_tables_in_rect_quad_sphere_order(name):
    """pack_materials holds the rects, the quads, then the spheres;
    unpack_materials and material_grads_to_scene put each block back."""
    sc = (_tree_scene() if name == "tree"
          else spt.get_scene(name, device="cpu"))
    R, Q, S = (sc.rects.k.shape[0], sc.quads.corner.shape[0],
               sc.spheres.radius.shape[0])
    alb, emi = mg.pack_materials(sc)
    assert alb.shape == emi.shape == (R + Q + S, 3)
    for t, f in ((alb, "albedo"), (emi, "emission")):
        want = torch.cat([getattr(b, f) for b in (sc.rects, sc.quads,
                                                  sc.spheres)])
        assert torch.equal(t, want)
    a2 = torch.arange(3.0 * (R + Q + S)).reshape(-1, 3)
    back = mg.unpack_materials(sc, a2, -a2)
    assert torch.equal(back.rects.albedo, a2[:R])
    assert torch.equal(back.quads.albedo, a2[R:R + Q])
    assert torch.equal(back.spheres.emission, -a2[R + Q:])
    assert torch.equal(mg.pack_materials(back)[0], a2)
    gs = mg.material_grads_to_scene(sc, a2, -a2)
    assert torch.equal(gs.quads.emission, -a2[R:R + Q])
    assert not gs.quads.corner.any() and not gs.spheres.center.any()
    with pytest.raises(ValueError, match=f"\\({R + Q + S}, 3\\)"):
        mg.unpack_materials(sc, a2[:-1], a2[:-1])


# (scene, estimator code) -> (row 8's and row 9's entry points, their
# launch names).
ROUTES = {
    ("cornell_tilted_light", "nee"): (
        "spt_megakernel_ext", "spt_megakernel_vjp_ext",
        "megakernel_nee_mat_ext", "megakernel_vjp_ext"),
    ("cornell_tilted_light", "mixture_glibc"): (
        "spt_megakernel_ext", "spt_megakernel_vjp_ext",
        "megakernel_mixture_glibc_mat_ext",
        "megakernel_vjp_mixture_glibc_ext"),
    ("cornell_glossy", "mis"): (
        "spt_megakernel_ext", "spt_megakernel_vjp_ext",
        "megakernel_mis_mat_ext", "megakernel_vjp_mis_ext"),
    ("tree", "nee_textbook"): (
        "spt_megakernel_ext", "spt_megakernel_vjp_ext",
        "megakernel_textbook_mat_ext", "megakernel_vjp_textbook_ext"),
    ("cornell_spheres", "cosine"): (
        "spt_megakernel_tab", "spt_megakernel_vjp",
        "megakernel_cosine_mat_tab", "megakernel_vjp_cosine_tab"),
    ("cornell_box", "mis"): (
        "spt_megakernel_est_mat", "spt_megakernel_vjp_est",
        "megakernel_mis_mat", "megakernel_vjp_mis"),
}


@pytest.mark.parametrize("key", list(ROUTES), ids="-".join)
def test_kernel_routes_by_family(monkeypatch, key):
    """Rows 8 and 9 route by ``megakernel.kernel_family``: an _ext scene
    (quads or GLOS objects) to the _ext entry points with the quads, the
    code and the Phong exponents, the others as before; each launch counts
    under its name."""
    lib = install(monkeypatch)
    name, code = key
    sc = (_tree_scene() if name == "tree"
          else spt.get_scene(name, device="cpu"))
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = spt.RenderConfig(width=8, height=6, spp=2, seed=1, **CODES[code])
    m_entry, v_entry, m_name, v_name = ROUTES[key]
    assert (mg.mat_kernel_name(sc, cfg), mg.vjp_kernel_name(sc, cfg)) == (
        m_name, v_name)
    assert mk.kernel_family(sc) in m_name
    alb, emi = mg.pack_materials(sc)
    lay = mk.full_layout(cfg)
    dev = torch.device("cpu")
    mg._launch_mat(sc, cam, cfg, alb, emi, 1, lay, dev, None)
    mg._launch_vjp(sc, cam, cfg, alb, emi, 1, torch.zeros(48, 3), lay, dev,
                   None)
    calls = [(c, a) for c, a in lib.calls if c != "spt_sphere_bvh"]
    assert [c for c, _ in calls] == [m_entry, v_entry]
    assert dict(mk.LAUNCHES) == {m_name: 1, v_name: 1}
    if m_entry != "spt_megakernel_ext":
        return
    geom = mk.pack_geometry(sc, cam)
    Q, K = len(geom.quad_f), alb.shape[0]
    n_launch = len(mk.launch_args(geom, cfg, 1, lay))
    m_args, v_args = calls[0][1], calls[1][1]
    est = mk.est_code(cfg)
    assert m_args[:2] == (est, cfg.mixture_q)
    # Rects, their count, the quads' constants and their count first.
    for args in (m_args[2:], v_args):
        assert args[2] == geom.rect_geom.shape[0] and args[4] == Q
    # Row 9: after the launch settings, the tables, the cotangent, the
    # partials (a block's 6·K slots), out, the code and mixture_q.
    tail = v_args[5 + n_launch:]
    n_blocks = -(-lay.n_pix_loc * lay.g // mg.KERNEL_BLOCK)
    assert tail[4] == n_blocks * 6 * K
    assert tail[6:8] == (est, cfg.mixture_q)
    assert tail[9] == sc.spheres.radius.shape[0] and len(tail) == 15


@pytest.mark.parametrize("code", ["nee", "uniform", "uniform_corrected",
                                  "mixture", "nee_glibc", "mixture_glibc"])
def test_glos_needs_a_glossy_estimator(code):
    """Estimators without glossy semantics on a GLOS scene raise the JAX
    kernel's ValueError on every training entry point and in cli fit,
    before any launch."""
    sc = spt.get_scene("cornell_glossy", device="cpu")
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    cfg = spt.RenderConfig(width=4, height=3, spp=1, **CODES[code])
    alb, emi = mg.pack_materials(sc)
    target = torch.zeros(3, 4, 3)
    before = mk.LAUNCHES.copy()
    for call in (
            lambda: mg.check_trainable(sc, cfg),
            lambda: mg.render_megakernel_mat(sc, cam, cfg, alb, emi, 0),
            lambda: mg.render_megakernel_vjp(sc, cam, cfg, alb, emi, 0,
                                             target),
            lambda: mg.fit_megakernel(sc, cam, cfg, target, steps=1),
            lambda: mg.material_train_step_sharded(
                sc, cam, cfg, Mesh.single((1, 1)), target),
            lambda: cli_main(["fit", "--device", "cpu", "--scene",
                              "cornell_glossy", "--width", "4", "--height",
                              "3", "--spp", "1", "--steps", "1",
                              *_flags(CODES[code])])):
        with pytest.raises(ValueError, match="no glossy \\(GLOS\\) semantics"):
            call()
    assert mk.LAUNCHES == before
    for ok in GLOS_CODES:
        mg.check_trainable(sc, spt.RenderConfig(**CODES[ok]))


def _flags(fields):
    argv = ["--estimator", fields["estimator"]]
    if "mixture_q" in fields:
        argv += ["--mixture-q", str(fields["mixture_q"])]
    if "light_sample_mode" in fields:
        argv += ["--light-sample-mode", fields["light_sample_mode"]]
    return argv


def test_training_refuses_more_objects_than_the_adjoint_holds():
    """Row 9's cap counts every object the warps' rows hold, quads too:
    the tilted light with spheres up to MAX_GRAD_OBJECTS trains, one more
    sphere is refused."""
    sc = _tree_scene()
    sp = sc.spheres
    n_more = mg.MAX_GRAD_OBJECTS - mg._n_objects(sc)
    idx = torch.arange(n_more) % sp.radius.shape[0]
    full = sc._replace(spheres=type(sp)(*(torch.cat([t, t[idx]])
                                          for t in sp)))
    assert mg._n_objects(full) == mg.MAX_GRAD_OBJECTS
    mg.check_trainable(full, spt.RenderConfig(estimator="mis"))
    more = full._replace(spheres=type(sp)(*(torch.cat([t, t[:1]])
                                            for t in full.spheres)))
    with pytest.raises(NotImplementedError, match="queue 2, row 9"):
        mg.fit_megakernel(more, spt.make_camera(device="cpu"),
                          spt.RenderConfig(width=4, height=4, spp=1,
                                           estimator="mis"),
                          torch.zeros(4, 4, 3), steps=1)


@pytest.mark.parametrize("preset", ["cornell_twolights",
                                    "cornell_spheres_roundlight"])
def test_light_lists_and_sphere_lights_stay_refused(preset):
    """A light list or a sphere light never reaches training: both ways
    into the port refuse them, naming item 12."""
    with pytest.raises(NotImplementedError, match="item 12"):
        scene_from_jax(jget_scene(preset), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        spt.get_scene(preset, device="cpu")


def test_cli_fit_glossy_and_tilted_light(capsys):
    """cli fit with mis on cornell_glossy (the GLOS sphere through the
    table route) falls at a tiny size; on the tilted light the printed
    light_emission is the quad's row: unchanged at --lr 0, moved by a
    step."""
    base = ["fit", "--device", "cpu", "--width", "12", "--height", "9",
            "--spp", "4", "--train", "emission"]
    assert cli_main([*base, "--scene", "cornell_glossy", "--estimator",
                     "mis", "--steps", "3", "--lr", "1"]) == 0
    out = capsys.readouterr()
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.err.splitlines() if "loss " in ln]
    assert len(losses) == 3 and losses[-1] < losses[0]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert np.isfinite(res["final_loss"]) and len(res["light_emission"]) == 3
    for lr, moved in (("0", False), ("1", True)):
        assert cli_main([*base, "--scene", "cornell_tilted_light",
                         "--steps", "1", "--lr", lr]) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (res["light_emission"] != [12.0, 12.0, 12.0]) == moved
