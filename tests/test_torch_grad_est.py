"""Material training with the estimators of ROADMAP item 10 against the JAX
package: the adjoint's plain version (autograd through the eager forward)
against ``render_pallas_vjp`` (the Pallas kernel in interpret mode, as
tests/test_megakernel_grad.py runs it) for ``mis`` and for ``mixture``
with ``glibc_overflow`` on ``cornell_box``, and for ``uniform_corrected``
on ``smallpt_original`` (a mirror and a glass sphere). ``uniform`` and
``nee`` with ``glibc_overflow`` are left out of the JAX comparison: each
differs from a compared case only in the forward's own branch (the uniform
hemisphere sample, glibc's light point), which tests/test_torch_estimators.py
holds against JAX, under the same sweep as ``cosine`` and ``nee``.

Beside those, on the port's plain versions only: row 8 with the scene's own
tables against ``render_megakernel`` bit for bit for every estimator code on
a rect scene and a sphere scene; ``mis`` with ``glibc_overflow`` training
as ``mis`` (the port follows the JAX package's ``config.py:43-50`` and jnp
wavefront, not its Pallas kernels: ROADMAP.md, "Known defects in the
reference itself"); the sharded step on ``Mesh.single`` against the
unsharded one; ``cli fit --estimator mis``; and the kernels' launch
arguments (the estimator code, glibc included, and ``mixture_q``) through a
stand-in library.

16x12x4, max_bounces=8, seed 3 (tests/test_megakernel_grad.py's shape), the
cotangent made by numpy from a seed. The three JAX adjoints are compiled
once, in the module fixture (~12 s on ``smallpt_original``, ~20-26 s each on
``cornell_box``); a further call of a compiled adjoint takes ~0.1 s."""

import json
from collections import Counter

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
from _recording_lib import install
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_grad as mg
from small_pathtracer_tpu_torch.parallel.mesh import Mesh

# See tests/test_torch_core.py: single-threaded torch next to jaxlib.
torch.set_num_threads(1)

W, H, SPP, SEED, BOUNCES = 16, 12, 4, 3, 8
GLIBC = {"light_sample_mode": "glibc_overflow"}
# A pixel's radiance sum "differs" from JAX's beyond this (1e-4 of the
# mean, the sphere contract of tests/test_torch_spheres.py).
PIX_TOL = 1e-4 * SPP
# The JAX comparisons: (scene, RenderConfig fields, bound on each table's
# largest entry (tests/test_megakernel_grad.py's for the scene), whether
# the light's albedo row is left out).
JAX_CASES = {
    "mis": ("cornell_box", {"estimator": "mis"}, 5e-3, True),
    "mixture_glibc": ("cornell_box", {"estimator": "mixture", **GLIBC}, 5e-3,
                      False),
    "uniform_corrected": ("smallpt_original",
                          {"estimator": "uniform_corrected"}, 1e-2, False),
}
# Every estimator code rows 8-10 take beside nee, cosine and nee_textbook.
CODES = {
    "uniform": {"estimator": "uniform"},
    "uniform_corrected": {"estimator": "uniform_corrected"},
    "mixture": {"estimator": "mixture", "mixture_q": 0.3},
    "mis": {"estimator": "mis"},
    "nee_glibc": {"estimator": "nee", **GLIBC},
    "mixture_glibc": {"estimator": "mixture", **GLIBC},
}


def _cfgs(**kw):
    kw = dict(width=W, height=H, spp=SPP, seed=SEED, max_bounces=BOUNCES,
              **kw)
    return JRenderConfig(**kw), spt.RenderConfig(**kw)


def _port(js):
    return (scene_from_jax(js, device="cpu"),
            camera_from_jax(jmake_camera(), device="cpu"))


def _flipped(vjp, emi, g, img) -> np.ndarray:
    """(h, w) mask of the pixels whose radiance sum under JAX differs from
    the port's ``img`` by more than PIX_TOL, found through JAX's compiled
    adjoint alone (no forward compile): the render is linear in emission,
    so sum(emi · d/d emission) under a cotangent equals the cotangent's
    sum against JAX's image. A set of pixels is split in halves while that
    sum differs from the port's by more than PIX_TOL times the set's
    largest cotangent."""
    out = np.zeros((H, W), dtype=bool)

    def differs(idx):
        mask = np.zeros(H * W, dtype=bool)
        mask[idx] = True
        gm = np.where(mask.reshape(H, W, 1), g, 0.0).astype(np.float32)
        got = float((emi * np.asarray(vjp(gm)[1])).sum())
        return abs(got - float((gm * img).sum())) > PIX_TOL * np.abs(gm).max()

    todo = [np.arange(H * W)]
    while todo:
        idx = todo.pop()
        if not differs(idx):
            continue
        if len(idx) == 1:
            out.reshape(-1)[idx] = True
        else:
            todo += [idx[:len(idx) // 2], idx[len(idx) // 2:]]
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Each JAX_CASES adjoint under a numpy-seeded cotangent, zeroed on the
    pixels whose radiance differs from the port's plain forward."""
    rng = np.random.default_rng(11)
    g_img = rng.standard_normal((H, W, 3)).astype(np.float32)
    jc = jmake_camera()
    out = {}
    for name, (scene, fields, _, _) in JAX_CASES.items():
        js = jget_scene(scene)
        jcfg, cfg = _cfgs(**fields)
        alb, emi = (np.asarray(t) for t in jgrad.pack_materials(js))

        def vjp(g, js=js, jcfg=jcfg, alb=alb, emi=emi):
            return jax.block_until_ready(jgrad.render_pallas_vjp(
                js, jc, jcfg, alb, emi, SEED, g, interpret=True))

        sc, cam = _port(js)
        p_alb, p_emi = materials_from_jax(alb, emi, device="cpu")
        img, _ = mg.render_megakernel_mat(sc, cam, cfg, p_alb, p_emi, SEED)
        flip = _flipped(vjp, emi, g_img, img.numpy())
        g = np.where(flip[..., None], 0.0, g_img).astype(np.float32)
        out[name] = {"scene": js, "alb": alb, "emi": emi, "g": g,
                     "flip": flip,
                     "vjp": tuple(np.asarray(v) for v in vjp(g))}
    return out


def _close_to_max(got, want, rel):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_vjp_plain_matches_pallas_vjp(jax_side, name):
    """Each table within the case's bound of its largest entry. mis leaves
    the light's albedo row out, as tests/test_megakernel_grad.py does: its
    gradient is knife-edge 1/t^2 shadow rays from vertices on the light's
    plane. uniform_corrected on smallpt_original masks the pixels whose
    radiance differs from JAX's (grazing sphere hits flip between 1/sqrt
    and jax.lax.rsqrt): measured none at this seed and shape (its extend
    count 4365 against JAX's 4363, every pixel within 1.6e-5), at most 2
    allowed."""
    scene, fields, rel, drop_light = JAX_CASES[name]
    side = jax_side[name]
    assert int(side["flip"].sum()) <= 2
    sc, cam = _port(side["scene"])
    _, cfg = _cfgs(**fields)
    alb, emi = materials_from_jax(side["alb"], side["emi"], device="cpu")
    galb, gemi = mg.render_megakernel_vjp(sc, cam, cfg, alb, emi, SEED,
                                          torch.from_numpy(side["g"]))
    want_alb, want_emi = (v.copy() for v in side["vjp"])
    galb = galb.numpy().copy()
    assert galb.shape == want_alb.shape
    if drop_light:
        light = int(sc.light.light_obj_id)
        galb[light] = want_alb[light] = 0.0
    _close_to_max(galb, want_alb, rel)
    _close_to_max(gemi.numpy(), want_emi, rel)


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("scene", ["cornell_box", "smallpt_original"])
def test_mat_plain_equals_the_render(scene, code):
    """Row 8's plain version with the scene's own tables is the render
    (rows 1 and 2's plain version) bit for bit, image and traces."""
    sc = spt.get_scene(scene, device="cpu")
    cam = spt.make_camera(aspect=8 / 6, device="cpu")
    cfg = spt.RenderConfig(width=8, height=6, spp=2, seed=5, max_bounces=8,
                           **CODES[code])
    alb, emi = mg.pack_materials(sc)
    img, tr = mg.render_megakernel_mat_plain(sc, cam, cfg, alb, emi, 5)
    r_img, r_tr = mk.render_megakernel(sc, cam, cfg, 5)
    assert torch.equal(img, r_img) and torch.equal(tr, r_tr)
    assert bool(img.any())


def test_mis_ignores_glibc_in_training():
    """mis with glibc_overflow trains as mis: the same tables bit for bit,
    under mis's kernel names (config.py:43-50 and the jnp wavefront; the
    JAX Pallas adjoint's :481 test applies the mode, a defect of the
    reference)."""
    sc = spt.get_scene("cornell_box", device="cpu")
    cam = spt.make_camera(aspect=8 / 6, device="cpu")
    target = torch.full((6, 8, 3), 0.3)
    out = []
    for kw in ({}, GLIBC):
        cfg = spt.RenderConfig(width=8, height=6, spp=2, seed=2,
                               max_bounces=8, estimator="mis", **kw)
        out.append((mg.loss_and_material_grads(sc, cam, cfg, 2, target),
                    mg.mat_kernel_name(sc, cfg), mg.vjp_kernel_name(sc, cfg)))
    (a, m_a, v_a), (b, m_b, v_b) = out
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (m_a, v_a) == (m_b, v_b) == ("megakernel_mis_mat",
                                        "megakernel_vjp_mis")


@pytest.mark.parametrize("code", ["mis", "mixture_glibc", "uniform"])
def test_sharded_step_adds_up(code):
    """material_train_step_sharded over a (2, 1) mesh, each pixel block in
    this process (Mesh.single): the blocks' losses and gradients add up to
    the unsharded step's."""
    sc = spt.get_scene("cornell_box", device="cpu")
    cam = spt.make_camera(aspect=8 / 6, device="cpu")
    cfg = spt.RenderConfig(width=8, height=6, spp=2, seed=2, max_bounces=8,
                           **CODES[code])
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


def test_cli_fit_mis_cpu(capsys):
    """cli fit --estimator mis (the JAX CLI's fit --pallas --estimator
    mis): the target is the scene with its rects' emission x1.5 at
    seed + 1; at --lr 1 on the emission the loss falls step by step."""
    assert cli_main(["fit", "--device", "cpu", "--estimator", "mis",
                     "--width", "16", "--height", "12", "--spp", "4",
                     "--steps", "3", "--lr", "1", "--train",
                     "emission"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.err.splitlines() if line.startswith("step ")]
    assert res["steps"] == 3 and len(losses) == 3
    assert losses[2] < losses[1] < losses[0]
    assert len(res["light_emission"]) == 3


@pytest.fixture
def lib(monkeypatch):
    return install(monkeypatch)


# Each code's entry points (rect scene, sphere scene) and estimator code:
# nee, cosine and nee_textbook through the entry points of
# csrc/megakernel.cu and csrc/megakernel_grad.cu, the others through those
# of csrc/megakernel_est.cu and csrc/megakernel_grad_est.cu with
# mixture_q; glibc adds 8 to nee and mixture only.
ENTRIES = {
    "nee": ({"estimator": "nee"}, 0, False),
    "nee_textbook": ({"estimator": "nee_textbook"}, 2, False),
    "mixture": (CODES["mixture"], 5, True),
    "mis_glibc": ({"estimator": "mis", **GLIBC}, 6, True),
    "nee_glibc": (CODES["nee_glibc"], 8, True),
    "mixture_glibc": (CODES["mixture_glibc"], 13, True),
}


@pytest.mark.parametrize("case", list(ENTRIES))
@pytest.mark.parametrize("scene", ["cornell_box", "smallpt_original"])
def test_launch_arguments(lib, scene, case):
    """Rows 8 and 9 launch the estimator code's entry point with its code
    (glibc included) and, for the codes of csrc/megakernel_est.cu and
    csrc/megakernel_grad_est.cu, mixture_q; each launch counts under the
    instance's name."""
    fields, code, est_entry = ENTRIES[case]
    sc = spt.get_scene(scene, device="cpu")
    cam = spt.make_camera(aspect=W / H, device="cpu")
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, seed=3, **fields)
    lay = mk.full_layout(cfg)
    alb, emi = mg.pack_materials(sc)
    tab = scene != "cornell_box"
    dev = torch.device("cpu")
    mg._launch_mat(sc, cam, cfg, alb, emi, 3, lay, dev, None)
    mg._launch_vjp(sc, cam, cfg, alb, emi, 3, torch.zeros((W * H, 3)), lay,
                   dev, None)
    calls = [c for c in lib.calls if c[0] != "spt_sphere_bvh"]
    (m_entry, m_args), (v_entry, v_args) = calls
    suffix = "_est" if est_entry else ""
    assert m_entry == ("spt_megakernel" + suffix
                       + ("_tab" if tab else "_mat"))
    assert m_args[0] == code
    if est_entry:
        assert m_args[1] == pytest.approx(cfg.mixture_q)
    elif tab:
        assert m_args[1] == 0  # spt_megakernel_tab's count flag
    assert v_entry == "spt_megakernel_vjp" + suffix
    # After the launch settings and (alb, emi, g_img, partials, n_partials,
    # out): est, mixture_q, tab.
    n_launch = len(mk.launch_args(mk.pack_geometry(sc, cam), cfg, 3, lay))
    est_at = 3 + n_launch + 6
    assert v_args[est_at:est_at + 3] == (code, cfg.mixture_q, int(tab))
    assert mk.LAUNCHES == Counter({mg.mat_kernel_name(sc, cfg): 1,
                                   mg.vjp_kernel_name(sc, cfg): 1})


@pytest.mark.parametrize("loss", [float("nan"), float("inf")])
def test_fit_result_is_strict_json(loss):
    """A fit whose loss ran to NaN or infinity (an albedo step of mis on
    the light's knife-edge row does) reports it as diverged, in strict
    JSON."""
    from small_pathtracer_tpu_torch.cli.main import _fit_result

    out = _fit_result(loss, 5)
    assert out == {"steps": 5, "final_loss": None, "diverged": True}
    json.dumps(out, allow_nan=False)
