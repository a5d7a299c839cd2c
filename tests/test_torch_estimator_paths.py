"""The paths of ROADMAP item 10 that need no JAX program: ``nee_textbook``
and ``mis`` ignoring ``glibc_overflow``, per-pixel budgets and a mesh's
shards with the new estimators, ``cli render``'s ``--mixture-q`` and
``--light-sample-mode``, ``RenderConfig`` taking what rows 1-7 render,
material training (rows 8-10) and the geometry adjoint (rows 11 and 12)
taking every estimator and the light mode, and the guided kernels' JAX
refusals. The comparisons with the JAX package are in
tests/test_torch_estimators.py, tests/test_torch_grad_est.py and
tests/test_torch_geom_est.py."""

import numpy as np
import pytest
import torch

import small_pathtracer_tpu_torch as spt
from _recording_lib import install
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.experiment import path_guiding as pg
from small_pathtracer_tpu_torch.integrator import wavefront
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

SEED = 3
GLIBC = {"light_sample_mode": "glibc_overflow"}


def _cfg(width, height, spp, seed=SEED, **kw):
    return spt.RenderConfig(width=width, height=height, spp=spp, seed=seed,
                            **kw)


@pytest.fixture(scope="module")
def box():
    return (spt.get_scene("cornell_box", device="cpu"),
            spt.make_camera(aspect=16 / 12, device="cpu"))


@pytest.mark.parametrize("estimator", ["nee_textbook", "mis"])
def test_glibc_ignored_by_direct_estimators(box, estimator):
    """nee_textbook and mis always sample the whole light, as the JAX
    package's config.py:43-50 and jnp wavefront (integrator/wavefront.py:
    586-591) say: with glibc_overflow they render the intended mode's
    image and traces bit for bit. (The JAX Pallas kernels apply the mode
    to mis too, ops/megakernel.py:1963: a defect of the reference, ROADMAP.md
    "Known defects in the reference itself", which the port does not
    follow.)"""
    scene, cam = box
    a = _cfg(16, 12, 2, estimator=estimator)
    b = _cfg(16, 12, 2, estimator=estimator, **GLIBC)
    ia, ta = mk.render_megakernel(scene, cam, a, SEED)
    ib, tb = mk.render_megakernel(scene, cam, b, SEED)
    assert torch.equal(ia, ib) and torch.equal(ta, tb)
    assert mk.kernel_name(scene, a) == mk.kernel_name(scene, b)


@pytest.mark.parametrize("estimator", ["mis", "cosine"])
def test_budget_spans_add_up(box, estimator):
    """Row 3 with an estimator other than nee: spans [0, 2) and [2, 4) of
    every pixel add up to the full render (traces exactly)."""
    scene, cam = box
    cfg = _cfg(16, 12, 4, estimator=estimator)
    n = 16 * 12
    a, ta = mk.render_megakernel_budgets(scene, cam, cfg, SEED,
                                         np.zeros(n), np.full(n, 2))
    b, tb = mk.render_megakernel_budgets(scene, cam, cfg, SEED,
                                         np.full(n, 2), np.full(n, 4))
    full, t_full = mk.render_megakernel(scene, cam, cfg, SEED)
    assert torch.equal(ta + tb, t_full)
    np.testing.assert_allclose((a + b).reshape(12, 16, 3).numpy(),
                               full.numpy(), rtol=1e-5, atol=1e-5)


def test_row7_mis_shards_add_up(box):
    """Row 7 with mis on a (2, 2) mesh, shard by shard in one process: the
    sums of the shards equal the unsharded render (traces exactly)."""
    scene, cam = box
    cfg = _cfg(16, 12, 4, estimator="mis")
    shape = (2, 2)
    parts = {c: mk.render_megakernel_sharded(scene, cam, cfg,
                                             Mesh.single(shape, c), SEED)
             for c in ((i, j) for i in range(2) for j in range(2))}
    rows = [parts[(i, 0)][0] + parts[(i, 1)][0] for i in range(2)]
    traces = sum(v[1] for v in parts.values())
    full, t_full = mk.render_megakernel(scene, cam, cfg, SEED)
    assert torch.equal(traces, t_full)
    np.testing.assert_allclose(torch.cat(rows).reshape(12, 16, 3).numpy(),
                               full.numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("argv, kw", [
    (["--estimator", "mixture", "--mixture-q", "0.3"],
     {"estimator": "mixture", "mixture_q": 0.3}),
    (["--light-sample-mode", "glibc_overflow"], GLIBC),
], ids=["mixture_q", "glibc"])
def test_cli_render_flags(tmp_path, capsys, argv, kw):
    """cli render --device cpu takes --mixture-q and --light-sample-mode:
    the traces it prints are the plain version's for that config."""
    out = tmp_path / "r.ppm"
    assert cli_main(["render", "--device", "cpu", "--width", "16",
                     "--height", "12", "--spp", "2", *argv,
                     "-o", str(out)]) == 0
    err = capsys.readouterr().err
    cfg = _cfg(16, 12, 2, 0, **kw)
    _, total = wavefront.render(spt.get_scene("cornell_box", device="cpu"),
                                spt.make_camera(aspect=16 / 12, device="cpu"),
                                cfg)
    assert f"traces={total} " in err and out.stat().st_size > 0


@pytest.mark.parametrize("field,value", [
    ("estimator", "uniform"), ("estimator", "mis"),
    ("light_sample_mode", "glibc_overflow"),
])
def test_config_takes_item_10(field, value):
    """RenderConfig takes what rows 1-7 now render (it refused these
    before this slice)."""
    cfg = spt.RenderConfig(**{field: value})
    assert getattr(cfg, field) == value


def _sph():
    return (spt.get_scene("cornell_spheres", device="cpu"),
            spt.make_camera(aspect=4 / 3, device="cpu"))


def _tiny(**kw):
    return spt.RenderConfig(width=4, height=3, spp=1, **kw)


def _mat(fn, cfg):
    """Calls a training entry point on cornell_spheres at 4x3x1; checks
    what it returns against the render, the plain adjoint or the names of
    the estimator code's kernels."""
    sc, cam = _sph()
    K = sc.rects.k.shape[0] + sc.spheres.radius.shape[0]
    alb, emi = mg.pack_materials(sc)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 4, 3)).astype(np.float32))
    target = torch.full((3, 4, 3), 0.25)
    img, traces = mk.render_megakernel(sc, cam, cfg, 0)
    if fn in (mg.render_megakernel_mat, mg.render_megakernel_mat_plain):
        got = fn(sc, cam, cfg, alb, emi, 0)
        assert torch.equal(got[0], img) and torch.equal(got[1], traces)
    elif fn is mg.render_megakernel_vjp:
        galb, gemi = fn(sc, cam, cfg, alb, emi, 0, g)
        assert galb.shape == gemi.shape == (K, 3)
        want = mg.render_megakernel_vjp_plain(sc, cam, cfg, alb, emi, 0, g)
        assert torch.equal(galb, want[0]) and torch.equal(gemi, want[1])
        # The render is linear in emission: sum(emi * d/d emi) = sum(g * I).
        lin = float((emi.double() * gemi.double()).sum())
        assert abs(lin - float((g.double() * img.double()).sum())) <= (
            1e-5 * float((g.abs() * img).sum().double()))
    elif fn is mg.loss_and_material_grads:
        loss, galb, gemi = fn(sc, cam, cfg, 0, target)
        diff = img / cfg.spp - target
        assert abs(float(loss) - float(torch.mean(diff * diff))) <= (
            1e-6 * float(loss))
        assert galb.shape == gemi.shape == (K, 3) and bool(
            torch.isfinite(galb).all() & torch.isfinite(gemi).all())
    elif fn is mg.fit_megakernel:
        fitted, losses = fn(sc, cam, cfg, target, steps=1, lr=0.5)
        _, _, gemi = mg.loss_and_material_grads(sc, cam, cfg, 0, target)
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert torch.equal(mg.pack_materials(fitted)[1], emi - 0.5 * gemi)
    elif fn is mg.material_train_step_sharded:
        loss, galb, gemi = fn(sc, cam, cfg, Mesh.single((1, 1)), target)(
            alb, emi, 0)
        w_loss, w_alb, w_emi = mg.loss_and_material_grads(sc, cam, cfg, 0,
                                                          target)
        assert abs(float(loss) - float(w_loss)) <= 1e-6 * float(w_loss)
        assert torch.allclose(galb, w_alb, rtol=1e-5, atol=1e-7)
        assert torch.allclose(gemi, w_emi, rtol=1e-5, atol=1e-7)
    else:
        row = "mat" if fn is mg.mat_kernel_name else "vjp"
        return fn(sc, cfg), row


# The estimator codes rows 8-10 take beside nee, cosine and nee_textbook,
# and each one's part of its kernels' names.
EST_CODES = [
    ({"estimator": "uniform"}, "uniform"),
    ({"estimator": "uniform_corrected"}, "uniform_corrected"),
    ({"estimator": "mixture"}, "mixture"),
    ({"estimator": "mis"}, "mis"),
    ({"estimator": "nee", **GLIBC}, "nee_glibc"),
    ({"estimator": "mixture", **GLIBC}, "mixture_glibc"),
]


@pytest.mark.parametrize("fn", [
    mg.render_megakernel_mat, mg.render_megakernel_mat_plain,
    mg.render_megakernel_vjp, mg.loss_and_material_grads, mg.fit_megakernel,
    mg.material_train_step_sharded, mg.mat_kernel_name, mg.vjp_kernel_name,
], ids=lambda f: f.__name__)
@pytest.mark.parametrize("kw, est", EST_CODES,
                         ids=[e for _, e in EST_CODES])
def test_material_training_takes(fn, kw, est):
    """Rows 8-10 take every estimator and glibc_overflow (they refused
    these, naming item 10, before this slice): the forward equals the
    render, the adjoint its plain version and the emission identity, the
    training steps their definitions, and the kernels are named by the
    estimator code (cornell_spheres: the _tab instances)."""
    got = _mat(fn, _tiny(**kw))
    if got is not None:
        name, row = got
        assert name == (f"megakernel_{est}_mat_tab" if row == "mat"
                        else f"megakernel_vjp_{est}_tab")


# The estimator codes rows 11 and 12 take beside nee, each one's part of
# its kernel's name, and its entry point (csrc/megakernel_geom_est.cu or
# csrc/megakernel_geom_direct.cu).
GEOM_CODES = [
    ({"estimator": "cosine"}, "cosine", "est"),
    ({"estimator": "nee_textbook"}, "textbook", "direct"),
    ({"estimator": "uniform"}, "uniform", "est"),
    ({"estimator": "uniform_corrected"}, "uniform_corrected", "est"),
    ({"estimator": "mixture"}, "mixture", "est"),
    ({"estimator": "mis"}, "mis", "direct"),
    ({"estimator": "nee", **GLIBC}, "nee_glibc", "est"),
    ({"estimator": "mixture", **GLIBC}, "mixture_glibc", "est"),
]


@pytest.mark.parametrize("fn", [
    mgeo.geom_run, mgeo.geom_run_plain, mgeo.loss_and_geom_grads,
    mgeo.fit_geom, mgeo.geom_train_step_sharded,
], ids=lambda f: f.__name__)
@pytest.mark.parametrize("kw, est, entry", GEOM_CODES,
                         ids=[e for _, e, _ in GEOM_CODES])
def test_geometry_adjoint_takes(fn, kw, est, entry, monkeypatch):
    """Rows 11 and 12 take every estimator and glibc_overflow (they once
    refused all but nee, naming ROADMAP item 10): on the CPU each entry point
    runs the plain version, whose image is the render's (cornell_spheres
    at 4x3x1: render_megakernel's plain version) and whose gradients are
    finite (the sharded step on a mesh of one: the unsharded step's); on
    the card the launch goes to the estimator code's entry point and counts
    as megakernel_geom_<est> (a stand-in library records it)."""
    sc, cam = _sph()
    cfg = _tiny(**kw)
    img, traces = mk.render_megakernel(sc, cam, cfg, 0)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 4, 3)).astype(np.float32))
    target = torch.full((3, 4, 3), 0.25)
    if fn is mgeo.geom_run:
        got, gs, ga, ge, tr = fn(sc, cam, cfg, 0, with_counts=True)
        assert torch.equal(got, img) and torch.equal(tr, traces)
        assert not (gs.any() or ga.any() or ge.any())
        grads = mgeo.geom_vjp(sc, cam, cfg, 0, g)
    elif fn is mgeo.geom_run_plain:
        got, *grads, tr = fn(sc, cam, cfg, 0, g)
        assert torch.equal(got, img) and torch.equal(tr, traces)
    elif fn is mgeo.loss_and_geom_grads:
        loss, *grads = fn(sc, cam, cfg, 0, target)
        diff = img / cfg.spp - target
        assert abs(float(loss) - float(torch.mean(diff * diff))) <= (
            1e-6 * float(loss))
    elif fn is mgeo.geom_train_step_sharded:
        loss, img_loc, *grads = fn(sc, cam, cfg, Mesh.single((1, 1)),
                                   target)(*mgeo.pack_tables(sc), 0)
        w_loss, *want = mgeo.loss_and_geom_grads(sc, cam, cfg, 0, target)
        assert torch.equal(img_loc, img.reshape(-1, 3))
        assert abs(float(loss) - float(w_loss)) <= 1e-6 * float(w_loss)
        for a, b in zip(grads, want):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    else:
        fitted, losses = fn(sc, cam, cfg, target, steps=1)
        assert len(losses) == 1 and np.isfinite(losses[0])
        grads = mgeo.loss_and_geom_grads(sc, cam, cfg, 0, target)[1:]
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    lib = install(monkeypatch)
    mgeo._launch(sc, cam, cfg, 0, None, mk.full_layout(cfg),
                 torch.device("cpu"), None)
    (name, args), = [c for c in lib.calls if c[0] != "spt_sphere_bvh"]
    assert name == f"spt_megakernel_geom_{entry}"
    assert args[:2] == (mk.est_code(cfg), cfg.mixture_q)
    assert mgeo.geom_kernel_name(cfg) == f"megakernel_geom_{est}"
    assert dict(mk.LAUNCHES) == {f"megakernel_geom_{est}": 1}


def test_geometry_adjoint_mis_ignores_glibc():
    """mis trains its geometry as mis under glibc_overflow (the JAX
    package's config.py:43-50; ROADMAP.md, known defects in the
    reference): the plain adjoint's image and gradients bit for bit, and
    the same kernel."""
    sc, cam = _sph()
    a, b = _tiny(estimator="mis"), _tiny(estimator="mis", **GLIBC)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 4, 3)).astype(np.float32))
    ra = mgeo.geom_run_plain(sc, cam, a, 0, g)
    rb = mgeo.geom_run_plain(sc, cam, b, 0, g)
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    assert mgeo.geom_kernel_name(a) == mgeo.geom_kernel_name(b)


@pytest.mark.parametrize("estimator", ["nee", "uniform", "mixture"])
def test_guided_refuses_continuation_estimators(estimator):
    """The guided entries refuse what JAX's refuses (ValueError, its
    message), and cli render --guided exits."""
    cfg = _tiny(estimator=estimator)
    alcove = spt.get_scene("cornell_alcove_baffled", device="cpu")
    cam = spt.make_camera(aspect=4 / 3, device="cpu")
    empty = (torch.zeros(pg.N_VOXELS, 3),
             torch.zeros(pg.N_VOXELS, dtype=torch.bool))
    for fn in (mk.render_megakernel_guided,
               mk.render_megakernel_guided_primary):
        with pytest.raises(ValueError, match="cosine-continuation"):
            fn(alcove, cam, cfg, 0, empty)
    with pytest.raises(SystemExit, match="--guided requires"):
        cli_main(["render", "--device", "cpu", "--width", "4", "--height",
                  "3", "--spp", "1", "--estimator", estimator, "--guided"])
