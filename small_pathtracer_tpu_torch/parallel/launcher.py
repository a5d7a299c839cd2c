"""Process groups, multi-rank launch and the retrying distributed render
(the port of the JAX package's ``parallel/launcher.py``).

The whole state of a render is a small resumable checkpoint
(``utils/checkpoint.py``), so the recovery model is the JAX package's:
join the process group, render with periodic checkpoints, and on a failure
that is not a configuration error, render again, resuming from the last
saved span.

Under ``torchrun`` (``python -m torch.distributed.run``) every rank reads
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    from small_pathtracer_tpu_torch.parallel.launcher import distributed_render
    img, traces = distributed_render(scene, cam, cfg, backend="nccl")

``spawn`` runs a function on ``world`` ranks of one machine (the tests, on
the CPU with gloo, and ``chip_smoke.py``, several ranks on one card with
gloo, since NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..device import resolve
from ..scene.types import Scene
from .mesh import make_mesh
from .sharded import render_sharded

log = logging.getLogger("small_pathtracer_tpu_torch.launcher")

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(backend: str, device: str = "cuda",
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None,
                     master_addr: str | None = None,
                     master_port: int | None = None) -> torch.device:
    """Joins the process group (once; a later call only returns the
    device) and returns this rank's device: cuda:(LOCAL_RANK % the card
    count) for ``device="cuda"``, else the CPU. Each value left None is read
    from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT); without it the process is rank 0 of a world of 1 on a
    free localhost port. Once the group is joined, the rank is the group's
    and LOCAL_RANK defaults to it, so a later call picks the card the first
    one picked. ``backend`` is "nccl" or "gloo", chosen by the caller:
    nothing falls back from one to the other."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    env = os.environ
    joined = dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if joined else int(env.get("RANK", 0))
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if joined:
        return dev
    addr = master_addr or env.get("MASTER_ADDR", "localhost")
    port = master_port or env.get("MASTER_PORT") or free_port()
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size)
    return dev


def distributed_render(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                       backend: str = "nccl", device: str = "cuda",
                       mesh_shape: tuple[int, int] | None = None,
                       max_retries: int = 3, retry_delay_s: float = 5.0,
                       checkpoint: str | None = None,
                       checkpoint_every: int = 0, **init):
    """Joins the process group (``init_distributed(backend, device,
    **init)``), builds the mesh and renders over it with retries. With
    ``checkpoint`` every retry resumes from the last saved span
    (``render_with_checkpoints`` with the mesh, every ``checkpoint_every``
    samples, default spp / 8); without it a retry renders from the start
    (``render_sharded``). Configuration errors (TypeError, ValueError,
    KeyError, AttributeError) raise at once; any other error is retried
    up to ``max_retries`` times, then RuntimeError. Returns (clamped
    linear (h, w, 3) image, total traces) on every rank."""
    dev = init_distributed(backend, device, **init)
    mesh = make_mesh(mesh_shape)
    scene, cam = scene.to(dev), cam.to(dev)
    last = None
    for attempt in range(max_retries + 1):
        try:
            if checkpoint:
                from ..utils.checkpoint import render_with_checkpoints

                every = checkpoint_every or max(1, cfg.spp // 8)
                return render_with_checkpoints(scene, cam, cfg, checkpoint,
                                               every, mesh=mesh)
            return render_sharded(scene, cam, cfg, mesh)
        except (TypeError, ValueError, KeyError, AttributeError):
            # A configuration error fails the same way every time.
            raise
        except Exception as e:  # a device or transport failure: retry
            last = e
            log.warning("render attempt %d failed: %s", attempt, e)
            if attempt < max_retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"distributed render failed after {max_retries + 1} attempts"
    ) from last


def _rank_main(fn, args, rank: int, world: int, backend: str, device: str,
               port: int, results) -> None:
    """One spawned rank: sets torchrun's environment for its rank, joins
    the group, runs fn(*args), puts (rank, ok, result or traceback) on
    ``results``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        init_distributed(backend, device)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device: str = "cuda",
          timeout: float = 600.0, args: tuple = ()) -> list:
    """Runs fn(*args) on ``world`` ranks of this machine, each a fresh
    process (the ``spawn`` start method) in one process group on a free
    localhost port; ``fn`` and ``args`` are pickled, so ``fn`` lives in an
    importable module. Returns the ranks' results in rank order. Raises
    RuntimeError, after killing every rank, when a rank fails or the
    results are not all in within ``timeout`` seconds."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world, backend, device, port,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=max(0.1, min(left, 1.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if left <= 0 or dead:
                    raise RuntimeError(
                        f"spawn: ranks {sorted(set(range(world)) - set(got))}"
                        f" gave no result (exit codes "
                        f"{[p.exitcode for p in procs]}, timeout {timeout} s)"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
