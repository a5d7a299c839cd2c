"""The port's sharded paths at a small size on every rank of a spawned world
(``launcher.spawn(sharded_paths, 4, "gloo", "cpu", ...)``), for
``tests/test_torch_parallel.py``. It imports the port alone, no JAX, so a
rank starts without it (as ``_mp_worker.py`` does for the JAX package).

Each rank returns host arrays, keyed by path, so the caller can hold the
ranks against each other and against the shard sums of one process
(``Mesh.single``).
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import torch

from small_pathtracer_tpu_torch.camera.pinhole import make_camera
from small_pathtracer_tpu_torch.config import RenderConfig
from small_pathtracer_tpu_torch.experiment.path_guiding import (
    guide_lobes, train_guide,
)
from small_pathtracer_tpu_torch.ops import (
    megakernel, megakernel_geom, megakernel_grad,
)
from small_pathtracer_tpu_torch.parallel import launcher
from small_pathtracer_tpu_torch.parallel.mesh import make_mesh
from small_pathtracer_tpu_torch.parallel.sharded import render_sharded
from small_pathtracer_tpu_torch.scene.presets import get_scene
from small_pathtracer_tpu_torch.utils import checkpoint

W, H, SPP = 16, 12, 4
SEED = 7
GUIDE_BETA, GUIDE_K = 0.6, 8.0
TRAIN_BOUNCES = 4
CARDS = 4  # the card count a rank pretends to see in ``rejoin_device``


def walls(device="cpu"):
    """``cornell_box`` without its two boxes: the six walls and the light
    (rect ids 0-6, the light 6), the material step's scene."""
    sc = get_scene("cornell_box", device=device)
    return sc._replace(rects=sc.rects._replace(
        **{f: getattr(sc.rects, f)[:7] for f in sc.rects._fields}))


def alcove_guide():
    """The voxel lobe table (mu (V, 3) float32, use (V,) bool numpy arrays)
    of a training pass on ``cornell_alcove_baffled`` (16x16x8, 8 bounces,
    seed 1; ``train_guide`` sums in fixed point, so every rank trains the
    same bits)."""
    mu, use = guide_lobes(train_guide(
        get_scene("cornell_alcove_baffled", device="cpu"),
        make_camera(aspect=W / H, device="cpu"),
        RenderConfig(width=16, height=16, spp=8, seed=1), 8, 1))
    return mu.numpy(), use.numpy()


def train_target(seed: int = 11):
    """A seeded (H, W, 3) float32 target image of the train steps."""
    return np.random.default_rng(seed).uniform(
        0.0, 0.6, (H, W, 3)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


def rejoin_device() -> list:
    """The device ``init_distributed`` gives a later call of this rank,
    with the environment torchrun sets and without it (the group's rank),
    on a machine that seems to hold CARDS cards: [index, index]."""
    with (mock.patch.object(launcher, "resolve",
                            lambda d: torch.device("cuda")),
          mock.patch.object(torch.cuda, "device_count", lambda: CARDS),
          mock.patch.object(torch.cuda, "set_device", lambda d: None)):
        got = [launcher.init_distributed("gloo").index]
        with mock.patch.dict(os.environ):
            for key in ("RANK", "LOCAL_RANK"):
                os.environ.pop(key, None)
            got.append(launcher.init_distributed("gloo").index)
    return got


def _checkpointed(box, cam, cfg, path, every, mesh, cut=False):
    """A checkpointed render with its state in ``path``, each span's start
    recorded. With ``cut`` a failure in the second span stops it (the state
    file then holds the first span). Returns (image, traces, span starts),
    the image None when cut."""
    real = checkpoint.render_megakernel_sharded
    starts = []

    def spy(*args, **kw):
        starts.append(args[5])
        if cut and len(starts) > 1:
            raise RuntimeError("cut after the first span")
        return real(*args, **kw)

    with mock.patch.object(checkpoint, "render_megakernel_sharded", spy):
        try:
            img, tr = checkpoint.render_with_checkpoints(box, cam, cfg, path,
                                                         every, mesh=mesh)
        except RuntimeError:
            if not cut:
                raise
            return None, 0, starts
    return _np(img), tr, starts


def sharded_paths(ckpt_dir: str) -> dict:
    """On this rank: rows 7 and 6 at meshes (2, 2) and (4, 1),
    ``render_sharded`` and ``distributed_render`` (the mesh of the world's
    default shape), checkpointed (2, 2) renders cut after their first span
    and resumed (state files under ``ckpt_dir``, shared by the ranks; one
    saved by a (2, 2) run, one by a (4, 1) run that stopped at a sample
    count dp splits, one by a (4, 1) run that stopped at one it does not),
    one step of rows 10 and 12 at (2, 2), and the device of a later
    ``init_distributed`` call. Returns a dict of host arrays and ints."""
    torch.set_num_threads(1)
    cam = make_camera(aspect=W / H, device="cpu")
    box = get_scene("cornell_box", device="cpu")
    alcove = get_scene("cornell_alcove_baffled", device="cpu")
    cfg = RenderConfig(width=W, height=H, spp=SPP, seed=SEED)
    cfg_tb = RenderConfig(width=W, height=H, spp=SPP, seed=SEED,
                          estimator="nee_textbook")
    guide = tuple(torch.from_numpy(a) for a in alcove_guide())
    out = {"rejoin_device": rejoin_device()}
    meshes = {shape: make_mesh(shape) for shape in ((2, 2), (4, 1))}
    for shape, mesh in meshes.items():
        out[f"coord{shape}"] = mesh.coord
        L, tr = megakernel.render_megakernel_sharded(box, cam, cfg, mesh,
                                                     SEED)
        out[f"row7{shape}"] = (_np(mesh.gather_sp(L)), _np(tr))
        L, tr = megakernel.render_megakernel_guided_sharded(
            alcove, cam, cfg_tb, mesh, SEED, guide, GUIDE_BETA, GUIDE_K)
        out[f"row6{shape}"] = (_np(mesh.gather_sp(L)), _np(tr))

    mesh = meshes[(2, 2)]
    img, traces = render_sharded(box, cam, cfg, mesh)
    out["render_sharded"] = (_np(img), traces)
    img, traces = launcher.distributed_render(box, cam, cfg, backend="gloo",
                                              device="cpu")
    out["distributed_render"] = (_np(img), traces)

    img_1, tr_1 = checkpoint.render_with_checkpoints(box, cam, cfg, "", 0,
                                                     mesh=mesh)
    out["one_shot"] = (_np(img_1), tr_1)
    for label, first, every in (("2x2", mesh, 2),
                                ("4x1_at_2", meshes[(4, 1)], 2),
                                ("4x1_at_3", meshes[(4, 1)], 3)):
        path = os.path.join(ckpt_dir, f"{label}.ckpt")
        _checkpointed(box, cam, cfg, path, every, first, cut=True)
        st = checkpoint.load_state(path, checkpoint.fingerprint(box, cam,
                                                                cfg))
        out[f"cut_{label}"] = -1 if st is None else st[1]
        out[f"resumed_{label}"] = _checkpointed(box, cam, cfg, path, 2, mesh)

    cfg_t = RenderConfig(width=W, height=H, spp=SPP, seed=3,
                         max_bounces=TRAIN_BOUNCES)
    sc = walls()
    step = megakernel_grad.material_train_step_sharded(
        sc, cam, cfg_t, mesh, train_target())
    loss, galb, gemi = step(*megakernel_grad.pack_materials(sc), 3)
    out["row10"] = (float(loss), _np(galb), _np(gemi))

    cfg_g = RenderConfig(width=W, height=H, spp=SPP, seed=9,
                         max_bounces=TRAIN_BOUNCES)
    sph_sc = get_scene("cornell_spheres", device="cpu")
    step = megakernel_geom.geom_train_step_sharded(
        sph_sc, cam, cfg_g, mesh, train_target())
    loss, img_loc, g_sph, g_alb, g_emi = step(
        *megakernel_geom.pack_tables(sph_sc), 9)
    out["row12"] = (float(loss), _np(mesh.gather_sp(img_loc)), _np(g_sph),
                    _np(g_alb), _np(g_emi))
    return out

