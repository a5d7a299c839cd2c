"""The port's sharded paths (``parallel/``, queue 2 rows 7, 6, 10 and 12)
against the unsharded port and against the JAX package's sharded entries.

- The mesh: ``default_shape`` against JAX ``make_mesh`` on 1, 2, 4 and 8
  virtual devices; ``shard_layout`` against the JAX kernels' shard lanes.
- In one process, ``Mesh.single`` shard by shard at (2, 2), (4, 1) and
  (1, 4): the shards' sums against the unsharded port. Traces are equal
  exactly (integer counts of the same samples), images within the sum
  order (rtol 2e-5, atol 2e-6, tests/test_distributed.py's bar), the train
  steps' loss within 1e-5 and gradients within 1e-5 absolute
  (``__graft_entry__.dryrun_multichip``'s bars). A (1, 1) mesh is the
  unsharded launch's lanes, bit for bit.
- Against JAX at (2, 2) on 4 virtual devices, each compiled once (interpret
  mode): ``render_pallas_sharded`` (row 7), ``render_pallas_guided_sharded``
  (row 6), ``material_train_step_sharded`` (row 10) and
  ``geom_train_step_sharded`` (row 12), each held to the contract its
  unsharded test states (tests/test_torch_render.py, test_torch_guiding.py,
  test_torch_grad.py, test_torch_geom.py). Rows 10 and 12 run at
  max_bounces 4, row 10 on the Cornell box's six walls and light (the JAX
  adjoint's interpret-mode compile grows with the unrolled rects: 10 s for
  these 7 against 38 s for the box's 17).
- Four gloo ranks (``launcher.spawn`` of ``_torch_mesh_worker.sharded_paths``,
  one module fixture, 180 s timeout): rows 7 and 6 at (2, 2) and (4, 1),
  ``render_sharded`` and ``distributed_render``, checkpointed renders cut
  and resumed on the same mesh and on another, one step of rows 10 and 12,
  against the in-process values and each other; and the card a later
  ``init_distributed`` call of a rank picks.
- ``cli render --mesh 1x1`` is ``cli render`` byte for byte; the refusals.

16x12x4, one torch thread (see tests/test_torch_core.py)."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig as JRenderConfig
from small_pathtracer_tpu.camera.pinhole import make_camera as jmake_camera
from small_pathtracer_tpu.integrator import wavefront as jwavefront
from small_pathtracer_tpu.ops import megakernel as jmk
from small_pathtracer_tpu.ops import megakernel_geom as jgeom
from small_pathtracer_tpu.ops import megakernel_grad as jgrad
from small_pathtracer_tpu.parallel.mesh import make_mesh as jmake_mesh
from small_pathtracer_tpu.scene.presets import get_scene as jget_scene
import small_pathtracer_tpu_torch as spt
from small_pathtracer_tpu_torch import convert
from small_pathtracer_tpu_torch.cli import main as cli_main
from small_pathtracer_tpu_torch.ops import megakernel as mk
from small_pathtracer_tpu_torch.ops import megakernel_geom as mgeo
from small_pathtracer_tpu_torch.ops import megakernel_grad as mgr
from small_pathtracer_tpu_torch.parallel import launcher
from small_pathtracer_tpu_torch.parallel.mesh import Mesh, default_shape
from small_pathtracer_tpu_torch.parallel.sharded import (
    render_sharded, shard_lanes, shard_layout,
)
from small_pathtracer_tpu_torch.utils import checkpoint as ckpt
import _torch_mesh_worker as worker

torch.set_num_threads(1)

W, H, SPP, SEED = worker.W, worker.H, worker.SPP, worker.SEED
BETA, K = worker.GUIDE_BETA, worker.GUIDE_K
BOUNCES = worker.TRAIN_BOUNCES
SEED_MAT, SEED_GEOM = 3, 9
SHAPES = [(2, 2), (4, 1), (1, 4)]
IDS = ["2x2", "4x1", "1x4"]
RTOL, ATOL = 2e-5, 2e-6


def _coords(shape):
    return [(i, j) for i in range(shape[0]) for j in range(shape[1])]


def _assemble(parts, shape):
    """{coord: (n_pix_loc, 3)} shard partials -> (n_pix, 3): summed over dp
    in order, the sp blocks concatenated."""
    rows = []
    for i in range(shape[0]):
        acc = parts[(i, 0)]
        for j in range(1, shape[1]):
            acc = acc + parts[(i, j)]
        rows.append(acc)
    return torch.cat(rows)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def cam():
    jc = jmake_camera(aspect=W / H)
    return jc, convert.camera_from_jax(jc, device="cpu")


def _jwalls():
    sc = jget_scene("cornell_box")
    return sc._replace(rects=jax.tree.map(lambda a: a[:7], sc.rects))


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, the port's scene from it)."""
    js = {n: jget_scene(n) for n in ("cornell_box", "cornell_alcove_baffled",
                                     "cornell_spheres")}
    js["walls"] = _jwalls()
    return {n: (s, convert.scene_from_jax(s, device="cpu"))
            for n, s in js.items()}


def _cfgs(**kw):
    base = dict(width=W, height=H, spp=SPP, seed=SEED)
    base.update(kw)
    return JRenderConfig(**base), spt.RenderConfig(**base)


@functools.lru_cache(maxsize=1)
def _guide():
    mu, use = worker.alcove_guide()
    return (jnp.asarray(mu), jnp.asarray(use)), (torch.from_numpy(mu),
                                                 torch.from_numpy(use))


# ---------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_default_shape_matches_jax_make_mesh(n):
    m = jmake_mesh(jax.devices()[:n])
    assert default_shape(n) == (m.shape["sp"], m.shape["dp"])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_shard_layout_matches_jax_lanes(shape):
    """Each coordinate's lanes as JAX ``_build_render_sharded`` lays them
    out (megakernel.py:3338-3359): pixel block, sample range, g from the
    local counts, for a span starting at s0 = 8."""
    cfg = spt.RenderConfig(width=W, height=H, spp=64)
    n_s, s0 = 16, 8
    n_pix_loc, n_s_loc = W * H // shape[0], n_s // shape[1]
    g = jwavefront.lane_groups(n_pix_loc, n_s_loc, 1 << 18, 0)
    per = n_s_loc // g
    for sp, dp in _coords(shape):
        lay = shard_layout(cfg, n_s, Mesh.single(shape, (sp, dp)),
                           mk.TARGET_LANES, s0)
        pix0, samp0 = sp * n_pix_loc, s0 + dp * n_s_loc
        want_pix = pix0 + np.repeat(np.arange(n_pix_loc), g)
        want_s = samp0 + np.tile(np.arange(g) * per, n_pix_loc)
        pix, s_start, s_stop = (t.numpy() for t in shard_lanes(lay, "cpu"))
        assert (lay.g, lay.per) == (g, per)
        np.testing.assert_array_equal(pix, want_pix)
        np.testing.assert_array_equal(s_start, want_s)
        np.testing.assert_array_equal(s_stop, want_s + per)


# ------------------------------------------- shard sums in one process

def _row7(scenes, cam, shape):
    box = scenes["cornell_box"][1]
    _, cfg = _cfgs()
    out = {c: mk.render_megakernel_sharded(box, cam[1], cfg,
                                           Mesh.single(shape, c), SEED)
           for c in _coords(shape)}
    return (_assemble({c: v[0] for c, v in out.items()}, shape),
            sum(v[1] for v in out.values()))


def _row6(scenes, cam, shape):
    alcove = scenes["cornell_alcove_baffled"][1]
    _, cfg = _cfgs(estimator="nee_textbook")
    guide = _guide()[1]
    out = {c: mk.render_megakernel_guided_sharded(
        alcove, cam[1], cfg, Mesh.single(shape, c), SEED, guide, BETA, K)
        for c in _coords(shape)}
    return (_assemble({c: v[0] for c, v in out.items()}, shape),
            sum(v[1] for v in out.values()))


def _step_in_process(forward, adjoint, cfg, shape, target):
    """A train step's collectives done by hand over Mesh.single shards:
    the forward partials summed over dp, the loss and cotangent from the
    whole image, each shard's adjoint under its own pixel rows, summed.
    Returns (loss, image sums (n_pix, 3), gradients)."""
    meshes = {c: Mesh.single(shape, c) for c in _coords(shape)}
    img = _assemble({c: forward(m) for c, m in meshes.items()}, shape)
    n_pix = cfg.width * cfg.height
    diff = img / cfg.spp - torch.from_numpy(target).reshape(n_pix, 3)
    loss = float(torch.sum(diff * diff)) / (n_pix * 3)
    g = diff * (2.0 / (n_pix * 3 * cfg.spp))
    n_loc = n_pix // shape[0]
    grads = None
    for c, m in meshes.items():
        part = adjoint(m, g[c[0] * n_loc:(c[0] + 1) * n_loc])
        grads = part if grads is None else [a + b for a, b in
                                            zip(grads, part)]
    return loss, img, grads


def _row10(scenes, shape, cam):
    sc = scenes["walls"][1]
    _, cfg = _cfgs(seed=SEED_MAT, max_bounces=BOUNCES)
    alb, emi = mgr.pack_materials(sc)
    return _step_in_process(
        lambda m: mgr.render_megakernel_mat_shard(sc, cam[1], cfg, m, alb,
                                                  emi, SEED_MAT)[0],
        lambda m, g: mgr.render_megakernel_vjp_shard(sc, cam[1], cfg, m, alb,
                                                     emi, SEED_MAT, g),
        cfg, shape, worker.train_target())


def _row12(scenes, shape, cam):
    sc = scenes["cornell_spheres"][1]
    _, cfg = _cfgs(seed=SEED_GEOM, max_bounces=BOUNCES)
    return _step_in_process(
        lambda m: mgeo.geom_run_shard(sc, cam[1], cfg, m, SEED_GEOM)[0],
        lambda m, g: mgeo.geom_run_shard(sc, cam[1], cfg, m, SEED_GEOM,
                                         g)[1:4],
        cfg, shape, worker.train_target())


@pytest.fixture(scope="module")
def in_process(scenes, cam):
    """Every row's shard sums at every shape, made once."""
    return {(row, shape): fn(scenes, shape, cam) if row in (10, 12)
            else fn(scenes, cam, shape)
            for row, fn in ((7, _row7), (6, _row6), (10, _row10),
                            (12, _row12))
            for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row7_shard_sums_match_unsharded(scenes, cam, in_process, shape):
    img, tr = in_process[(7, shape)]
    _, cfg = _cfgs()
    want, want_tr = mk.render_megakernel(scenes["cornell_box"][1], cam[1],
                                         cfg, SEED)
    assert tr.tolist() == want_tr.tolist() == [1818, 1050]
    _close(img.reshape(H, W, 3), want, "row 7")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row6_shard_sums_match_unsharded(scenes, cam, in_process, shape):
    img, tr = in_process[(6, shape)]
    _, cfg = _cfgs(estimator="nee_textbook")
    want, want_tr = mk.render_megakernel_guided(
        scenes["cornell_alcove_baffled"][1], cam[1], cfg, SEED, _guide()[1],
        BETA, K)
    assert torch.equal(tr, want_tr)
    _close(img.reshape(H, W, 3), want, "row 6")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row10_shard_sums_match_unsharded(scenes, cam, in_process, shape):
    loss, _, (galb, gemi) = in_process[(10, shape)]
    _, cfg = _cfgs(seed=SEED_MAT, max_bounces=BOUNCES)
    w_loss, w_alb, w_emi = mgr.loss_and_material_grads(
        scenes["walls"][1], cam[1], cfg, SEED_MAT,
        torch.from_numpy(worker.train_target()))
    assert abs(loss - float(w_loss)) <= 1e-5
    assert float((galb - w_alb).abs().max()) <= 1e-5
    assert float((gemi - w_emi).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row12_shard_sums_match_unsharded(scenes, cam, in_process, shape):
    loss, _, (g_sph, g_alb, g_emi) = in_process[(12, shape)]
    _, cfg = _cfgs(seed=SEED_GEOM, max_bounces=BOUNCES)
    w_loss, w_sph, w_alb, w_emi = mgeo.loss_and_geom_grads(
        scenes["cornell_spheres"][1], cam[1], cfg, SEED_GEOM,
        torch.from_numpy(worker.train_target()))
    assert abs(loss - float(w_loss)) <= 1e-5
    for got, want in ((g_sph, w_sph), (g_alb, w_alb), (g_emi, w_emi)):
        assert float((got - want).abs().max()) <= 1e-5


def test_one_by_one_mesh_is_unsharded_bit_for_bit(scenes, cam):
    """A (1, 1) mesh runs the unsharded launch's lanes: rows 7 and 6 equal
    render_megakernel and render_megakernel_guided bit for bit."""
    one = Mesh.single((1, 1))
    box, alcove = scenes["cornell_box"][1], scenes["cornell_alcove_baffled"][1]
    _, cfg = _cfgs()
    L, tr = mk.render_megakernel_sharded(box, cam[1], cfg, one, SEED)
    img, want_tr = mk.render_megakernel(box, cam[1], cfg, SEED)
    assert torch.equal(L.reshape(H, W, 3), img) and torch.equal(tr, want_tr)
    _, cfg = _cfgs(estimator="nee_textbook")
    guide = _guide()[1]
    L, tr = mk.render_megakernel_guided_sharded(alcove, cam[1], cfg, one,
                                                SEED, guide, BETA, K)
    img, want_tr = mk.render_megakernel_guided(alcove, cam[1], cfg, SEED,
                                               guide, BETA, K)
    assert torch.equal(L.reshape(H, W, 3), img) and torch.equal(tr, want_tr)


# ------------------------------------------------- against JAX at (2, 2)

@pytest.fixture(scope="module")
def jax_refs(scenes, cam):
    """The JAX package's four sharded entries at (2, 2) on 4 virtual
    devices, interpret mode, each compiled once."""
    mesh = jmake_mesh(jax.devices()[:4], mesh_shape=(2, 2))
    jc = cam[0]
    out = {}
    jcfg, _ = _cfgs()
    out[7] = jax.block_until_ready(jmk.render_pallas_sharded(
        scenes["cornell_box"][0], jc, jcfg, mesh, SEED, interpret=True))
    jcfg, _ = _cfgs(estimator="nee_textbook")
    out[6] = jax.block_until_ready(jmk.render_pallas_guided_sharded(
        scenes["cornell_alcove_baffled"][0], jc, jcfg, mesh, SEED,
        _guide()[0], BETA, K, interpret=True))
    jcfg, _ = _cfgs(seed=SEED_MAT, max_bounces=BOUNCES)
    walls = scenes["walls"][0]
    step = jgrad.material_train_step_sharded(walls, jc, jcfg, mesh,
                                             worker.train_target(),
                                             interpret=True)
    out[10] = jax.block_until_ready(step(*jgrad.pack_materials(walls),
                                         SEED_MAT))
    jcfg, _ = _cfgs(seed=SEED_GEOM, max_bounces=BOUNCES, sphere_table="on")
    spheres = scenes["cornell_spheres"][0]
    step = jgeom.geom_train_step_sharded(spheres, jc, jcfg, mesh,
                                         worker.train_target(),
                                         interpret=True)
    out[12] = jax.block_until_ready(step(*jmk._sphere_tables(spheres),
                                         SEED_GEOM))
    return {k: tuple(np.asarray(v) for v in vals) for k, vals in out.items()}


def test_row7_matches_jax(in_process, jax_refs):
    """tests/test_torch_render.py's contract: traces exactly, the mean
    image within 1e-4."""
    img, tr = in_process[(7, (2, 2))]
    j_img, j_tr = jax_refs[7]
    assert tr.tolist() == j_tr.astype(np.int64).tolist() == [1818, 1050]
    np.testing.assert_allclose(img.numpy() / SPP, j_img.reshape(-1, 3) / SPP,
                               atol=1e-4)


def test_row6_matches_jax(in_process, jax_refs):
    """tests/test_torch_guiding.py's contract on the alcove: traces equal,
    99% of the mean image's values within 1e-4 of their magnitude (at least
    1), the channel means within 1e-3 relative."""
    img, tr = in_process[(6, (2, 2))]
    j_img, j_tr = jax_refs[6]
    assert tr.tolist() == j_tr.astype(np.int64).tolist()
    got, ref = img.numpy() / SPP, j_img.reshape(-1, 3) / SPP
    ok = np.abs(got - ref) <= 1e-4 * np.maximum(np.abs(ref), 1.0)
    assert ok.mean() >= 0.99, ok.mean()
    gm, rm = got.mean(0), ref.mean(0)
    assert np.all(np.abs(gm - rm) <= 1e-3 * rm)


def test_row10_matches_jax(in_process, jax_refs):
    """tests/test_torch_grad.py's contract: the loss within 1e-5 relative,
    each table within 1e-5 of its largest entry."""
    loss, _, (galb, gemi) = in_process[(10, (2, 2))]
    j_loss, j_alb, j_emi = jax_refs[10]
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for got, want in ((galb, j_alb), (gemi, j_emi)):
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_row12_matches_jax(scenes, in_process, jax_refs):
    """tests/test_torch_geom.py's statistical contract (paths flip on
    grazing sphere hits): 90% of the mean image within rtol 1e-5 / atol
    1e-6 and its mean within 0.02; the loss within 1e-4 relative; each
    gradient table within 0.25 of its largest entry, cosine above 0.9
    (test_megakernel_geom.py:421-453). Measured: the sphere rows' cosine
    0.9946 here. The flipped paths and the JAX kernel's NEE distance,
    linearized at the light sampler's plane while it probes the light rect
    (tests/test_torch_geom.py), move the sphere rows."""
    loss, img, (g_sph, g_alb, g_emi) = in_process[(12, (2, 2))]
    j_loss, j_img, gtab, galb, gemi = jax_refs[12]
    a, b = img.numpy() / SPP, j_img.reshape(-1, 3) / SPP
    assert np.isclose(a, b, rtol=1e-5, atol=1e-6).mean() > 0.9
    assert abs(a.mean() - b.mean()) < 0.02
    assert abs(loss - float(j_loss)) <= 1e-4 * float(j_loss)
    want = convert.geom_grads_from_jax(scenes["cornell_spheres"][1], gtab,
                                       galb, gemi)

    def cos(x, y):
        return x @ y / (np.linalg.norm(x) * np.linalg.norm(y))

    for got, w in ((g_sph, want[0]), (g_alb, want[1]), (g_emi, want[2])):
        x, y = got.numpy().ravel(), w.numpy().ravel()
        assert np.abs(x - y).max() <= 0.25 * np.abs(y).max()
        assert cos(x, y) > 0.9


# ------------------------------------------------------ four gloo ranks

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launcher.spawn(worker.sharded_paths, 4, "gloo", "cpu", 180.0,
                          args=(str(tmp_path_factory.mktemp("mesh")),))


@pytest.mark.parametrize("row,shape", [(7, (2, 2)), (7, (4, 1)),
                                       (6, (2, 2)), (6, (4, 1))],
                         ids=["row7-2x2", "row7-4x1", "row6-2x2", "row6-4x1"])
def test_ranks_render_match_in_process(ranks, in_process, row, shape):
    """Every rank's gathered image and the mesh's traces: the same bits on
    every rank, and the in-process shard sums within the sum order."""
    key = f"row{row}{shape}"
    img, tr = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key][0], img)
        np.testing.assert_array_equal(r[key][1], tr)
    assert sorted(r[f"coord{shape}"] for r in ranks) == _coords(shape)
    want, want_tr = in_process[(row, shape)]
    assert tr.tolist() == want_tr.tolist()
    _close(img, want, key)


@pytest.mark.parametrize("key", ["render_sharded", "distributed_render"])
def test_ranks_render_sharded_matches_unsharded(ranks, scenes, cam, key):
    """``render_sharded`` (row 7's plain version here, its kernel on the
    card) and ``distributed_render`` on the world's default 2x2 mesh, on
    every rank against the unsharded render."""
    _, cfg = _cfgs()
    want, want_tr = spt.render(scenes["cornell_box"][1], cam[1], cfg)
    for r in ranks:
        img, tr = r[key]
        assert tr == want_tr
        _close(img, want, key)


def test_ranks_checkpoint_resume_equals_one_shot(ranks):
    """Cut after its first span (2 of 4 samples) and resumed from the state
    file every rank saved, the mesh render equals the one-shot one: the same
    traces, the image within the sum order."""
    for r in ranks:
        assert r["cut_2x2"] == 2
        (img_r, tr_r, starts), (img_1, tr_1) = r["resumed_2x2"], r["one_shot"]
        assert starts == [2] and tr_r == tr_1
        _close(img_r, img_1, "resumed")
        np.testing.assert_array_equal(img_r, ranks[0]["resumed_2x2"][0])


@pytest.mark.parametrize("label, done, starts", [
    ("4x1_at_2", 2, [2]), ("4x1_at_3", 3, [0, 2])], ids=["at_2", "at_3"])
def test_ranks_checkpoint_resume_across_meshes(ranks, label, done, starts):
    """A state saved by a (4, 1) run, resumed on (2, 2): continued when its
    samples done split over dp = 2, rendered again from the start when they
    do not (the 1 sample left could not split); either way the one-shot
    render's traces and image."""
    for r in ranks:
        assert r[f"cut_{label}"] == done
        img_r, tr_r, got = r[f"resumed_{label}"]
        img_1, tr_1 = r["one_shot"]
        assert got == starts and tr_r == tr_1
        _close(img_r, img_1, label)


def test_ranks_rejoin_keeps_the_device(ranks):
    """A later ``init_distributed`` call in a spawned rank (``cli --mesh``
    inside ``spawn``), with RANK and LOCAL_RANK set and without them, picks
    the rank's own card of four, as the first call did."""
    assert [r["rejoin_device"] for r in ranks] == [[i, i] for i in range(4)]


@pytest.mark.parametrize("row", [10, 12])
def test_ranks_train_steps_match_in_process(ranks, in_process, row):
    """One step of rows 10 and 12 at (2, 2): the loss and gradients the
    same on every rank, and the in-process step's within 1e-5."""
    first = ranks[0][f"row{row}"]
    for r in ranks[1:]:
        for a, b in zip(r[f"row{row}"], first):
            np.testing.assert_array_equal(a, b)
    loss, img, grads = in_process[(row, (2, 2))]
    assert abs(first[0] - loss) <= 1e-5
    tables = first[1:] if row == 10 else first[2:]
    for got, want in zip(tables, grads):
        assert np.abs(got - want.numpy()).max() <= 1e-5
    if row == 12:
        _close(first[1], img, "row 12 image")


# ------------------------------------------------------ the CLI, refusals

def test_cli_render_mesh_1x1_equals_cli_render(tmp_path):
    argv = ["render", "--device", "cpu", "--width", str(W), "--height",
            str(H), "--spp", str(SPP), "--seed", str(SEED)]
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    assert cli_main(argv + ["-o", str(a)]) == 0
    assert cli_main(argv + ["--mesh", "1x1", "-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_cli_fit_geom_mesh_1x1(capsys):
    """fit --train center,radius --mesh 1x1: the sharded step's losses and
    sphere are the unsharded fit's (to the loss's sum order)."""
    argv = ["fit", "--device", "cpu", "--scene", "cornell_spheres",
            "--width", "16", "--height", "12", "--spp", "2", "--steps", "2",
            "--train", "center,radius"]
    outs = []
    for extra in ([], ["--mesh", "1x1"]):
        assert cli_main(argv + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert abs(outs[0]["final_loss"] - outs[1]["final_loss"]) <= (
        1e-5 * outs[0]["final_loss"])
    np.testing.assert_allclose(outs[1]["center"], outs[0]["center"],
                               rtol=1e-5)


def _box(spp=SPP):
    return (spt.get_scene("cornell_box", device="cpu"),
            spt.make_camera(aspect=W / H, device="cpu"),
            spt.RenderConfig(width=W, height=H, spp=spp))


@pytest.mark.parametrize("call, err, match", [
    (lambda: cli_main(["render", "--device", "cpu", "--width", "4",
                       "--height", "3", "--spp", "1", "--mesh", "2x2",
                       "-o", "unused.png"]),
     ValueError, "mesh 2x2 needs 4 ranks, the world has 1"),
    (lambda: ckpt.render_with_checkpoints(*_box(3), "", 0,
                                          mesh=Mesh.single((1, 2))),
     ValueError, r"spp \(3\) not divisible by dp=2"),
    (lambda: render_sharded(*_box(3), Mesh.single((1, 2))),
     ValueError, r"spp \(3\) not divisible by dp=2"),
    (lambda: mk.render_megakernel_sharded(*_box(), Mesh.single((5, 1)), 0),
     ValueError, "n_pix=192 % n_sp=5"),
    (lambda: mgeo.fit_geom(spt.get_scene("cornell_spheres", device="cpu"),
                           _box()[1], _box()[2], torch.zeros(H, W, 3),
                           sphere_idx=0, fields=("center",),
                           mesh=Mesh.single((2, 1))),
     NotImplementedError, "item 16"),
    (lambda: cli_main(["render", "--device", "cpu", "--width", "4",
                       "--height", "3", "--spp", "2", "--mesh", "1x1",
                       "--adaptive-tol", "0.1", "-o", "unused.png"]),
     SystemExit, None),
], ids=["mesh_over_world", "checkpoint_spp_dp", "render_sharded_spp_dp",
        "n_pix_sp", "edge_sphere", "adaptive"])
def test_refusals(call, err, match):
    with pytest.raises(err, match=match):
        call()
