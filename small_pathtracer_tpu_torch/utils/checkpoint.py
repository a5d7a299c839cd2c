"""Render-state checkpoint and resume, and progressive previews (the port of
the JAX package's ``utils/checkpoint.py``).

Every draw is a pure function of (seed, path id, counter), so the whole
state of a render is (accumulated radiance, samples done, traces, a
fingerprint of the config, scene and camera), and resuming continues the
sample loop at the samples done: the image equals an uninterrupted
render's up to the order of float additions.

Spans run through ``ops.megakernel.render_megakernel(..., s0, n_s)``, or
``render_megakernel_guided`` with a guide table: the render kernels on the
card, their plain version on the CPU. With a mesh (``parallel/mesh.py``)
each span is sharded (``render_megakernel_sharded``, or
``render_megakernel_guided_sharded``), spans are a multiple of dp samples,
and every rank gathers the span's whole image, so every rank holds the same
state and saves it (each writer renames its own temporary file over the
path); only rank 0 writes the preview. The mesh shape is not part of the
fingerprint: the state is the whole image's sums, so a run on another
mesh continues it when the samples done split over its dp; otherwise the
spans left could not split either, and the run starts over. The resume file
is an npz of the port's own: the JAX package does not read it, nor does the
port read the JAX package's (their fingerprints hash different configs).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

import numpy as np
import torch

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import film, imageio
from ..ops.megakernel import (
    pack_guide_entries, render_megakernel, render_megakernel_guided,
    render_megakernel_guided_sharded, render_megakernel_sharded,
)
from ..scene.types import Scene


def _leaves(tree):
    """The tensors of a (nested) NamedTuple, in field order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for item in tree:
            yield from _leaves(item)


def fingerprint(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                guide=None, beta: float = 0.5, k: float = 8.0) -> str:
    """Hash of the config and of every scene and camera tensor (and the
    light's object id); with a guide, of its packed table, beta and k too
    (the JAX package's fingerprint leaves the guide out, so a resume there
    can mix two tables)."""
    h = hashlib.sha256()
    h.update(json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode())
    h.update(str(scene.light.light_obj_id).encode())
    if guide is not None:
        h.update(pack_guide_entries(guide).tobytes())
        h.update(repr((float(beta), float(k))).encode())
    for leaf in _leaves((scene, cam)):
        h.update(str(leaf.dtype).encode())
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


def _atomic_write(path: str, write) -> None:
    """Calls write(temporary path) beside ``path``, then renames it over
    ``path``: a reader never sees a half-written file. The temporary name
    ends in ``path``'s extension, which picks the image format."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    ext = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp" + ext)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_state(path: str, acc: np.ndarray, spp_done: int, traces: int,
               fp: str) -> None:
    """Atomic save of the render state: acc (h*w, 3) float32 radiance sum,
    samples done, traces (extend + probe) and the fingerprint."""
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, acc=np.asarray(acc, np.float32),
                     spp_done=np.int64(spp_done), traces=np.int64(traces),
                     fingerprint=np.bytes_(fp.encode()))

    _atomic_write(path, write)


def load_state(path: str, fp: str):
    """(acc, spp_done, traces), or None when the file is absent or was
    written for another fingerprint."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if z["fingerprint"].item().decode() != fp:
            return None
        return np.asarray(z["acc"]), int(z["spp_done"]), int(z["traces"])


def render_with_checkpoints(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, ckpt_path: str,
                            every_spp: int = 0, mesh=None,
                            preview_path: str = "", guide=None,
                            guide_beta: float = 0.5, guide_k: float = 8.0):
    """Render in spans of ``every_spp`` samples (0: one span), saving the
    state to ``ckpt_path`` after each span ("" saves nothing) and resuming
    from it when it holds this render's state. With ``preview_path``, the
    tone-mapped running mean (the final image at the samples done so far)
    is written there after each span, atomically, PPM or PNG by extension.
    With ``guide`` ((mu, use) from ``guide_lobes``) the spans are guided
    renders (``render_megakernel_guided`` with guide_beta and guide_k).
    With ``mesh`` each span is this rank's share of a sharded render (spp
    divisible by dp, ValueError otherwise; spans rounded down to a multiple
    of dp samples, at least dp; a saved state whose samples done do not
    split over dp is rendered again from the start), and every rank
    returns the whole image.

    Returns (clamped linear (h, w, 3) image on the scene's device, total
    traces (extend + probe) as an int)."""
    dev = scene.device
    n_pix = cfg.width * cfg.height
    fp = fingerprint(scene, cam, cfg, guide, guide_beta, guide_k)
    st = load_state(ckpt_path, fp) if ckpt_path else None
    if st is not None and mesh is not None and st[1] % mesh.n_dp:
        st = None  # saved by another mesh: the rest does not split over dp
    if st is not None:
        acc_np, spp_done, traces = st
        acc = torch.as_tensor(acc_np, device=dev).reshape(n_pix, 3)
    else:
        acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        spp_done, traces = 0, 0

    step = every_spp if every_spp > 0 else cfg.spp
    if mesh is not None:
        if cfg.spp % mesh.n_dp:
            raise ValueError(
                f"spp ({cfg.spp}) not divisible by dp={mesh.n_dp}")
        step = max(mesh.n_dp, (step // mesh.n_dp) * mesh.n_dp)
    while spp_done < cfg.spp:
        n_s = min(step, cfg.spp - spp_done)
        if guide is not None and mesh is not None:
            L, tr = render_megakernel_guided_sharded(
                scene, cam, cfg, mesh, cfg.seed, guide, guide_beta, guide_k,
                spp_done, n_s)
            L = mesh.gather_sp(L)
        elif guide is not None:
            L, tr = render_megakernel_guided(scene, cam, cfg, cfg.seed, guide,
                                             guide_beta, guide_k, spp_done,
                                             n_s)
        elif mesh is not None:
            L, tr = render_megakernel_sharded(scene, cam, cfg, mesh, cfg.seed,
                                              spp_done, n_s)
            L = mesh.gather_sp(L)
        else:
            L, tr = render_megakernel(scene, cam, cfg, cfg.seed, spp_done,
                                      n_s)
        acc = acc + L.reshape(n_pix, 3)
        traces += int(tr.sum())
        spp_done += n_s
        if ckpt_path:
            save_state(ckpt_path, acc.cpu().numpy(), spp_done, traces, fp)
        if preview_path and (mesh is None or mesh.rank == 0):
            _write_preview(preview_path, acc, spp_done, cfg)

    spp_t = torch.tensor(float(cfg.spp), device=dev)
    img = (acc / spp_t).reshape(cfg.height, cfg.width, 3)
    return film.finalize(img), traces


def _write_preview(path: str, acc: torch.Tensor, spp_done: int,
                   cfg: RenderConfig) -> None:
    """Atomic write of the tone-mapped running mean: the final image at
    ``spp_done`` samples, so previews converge to it."""
    done_t = torch.tensor(float(spp_done), device=acc.device)
    img = (acc / done_t).reshape(cfg.height, cfg.width, 3)
    u8 = film.tonemap_u8(film.finalize(img)).cpu().numpy()
    _atomic_write(path, lambda tmp: imageio.write_image(tmp, u8))
