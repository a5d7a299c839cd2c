"""The paths of ROADMAP item 10 that need no JAX program: ``nee_textbook``
and ``mis`` ignoring ``glibc_overflow``, per-pixel budgets and a mesh's
shards with the new estimators, ``cli render``'s ``--mixture-q`` and
``--light-sample-mode``, ``RenderConfig`` taking what rows 1-7 render,
material training (rows 8-10) taking every estimator and the light mode,
and the refusals of the entry points whose kernels do not take them yet
(the geometry adjoint, and the guided kernels' JAX refusals). The
comparisons with the JAX package are in tests/test_torch_estimators.py and
tests/test_torch_grad_est.py."""

import numpy as np
import pytest
import torch

import small_pathtracer_tpu_torch as spt
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


@pytest.mark.parametrize("call", [
    lambda sc, cam, cfg: mgeo.geom_run(sc, cam, cfg, 0),
    lambda sc, cam, cfg: mgeo.geom_run_plain(sc, cam, cfg, 0),
    lambda sc, cam, cfg: mgeo.loss_and_geom_grads(sc, cam, cfg, 0,
                                                  torch.zeros(3, 4, 3)),
    lambda sc, cam, cfg: mgeo.fit_geom(sc, cam, cfg, torch.zeros(3, 4, 3),
                                       steps=1),
], ids=["geom_run", "geom_run_plain", "loss_and_geom_grads", "fit_geom"])
@pytest.mark.parametrize("kw", [
    {"estimator": "cosine"}, {"estimator": "mis"},
    {"estimator": "nee", **GLIBC},
], ids=["cosine", "mis", "glibc"])
def test_geometry_adjoint_refuses(call, kw):
    """Rows 11 and 12 refuse every estimator but nee, and glibc_overflow,
    on every device, naming item 10."""
    with pytest.raises(NotImplementedError, match="item 10"):
        call(*_sph(), _tiny(**kw))


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
