"""The (sp, dp) mesh of ranks (the port of the JAX package's
``parallel/mesh.py``).

A path tracer has two parallel axes, the image's pixels and each pixel's
samples, and the mesh splits both:

    axis "sp": shards pixels (a rank renders a contiguous pixel block),
    axis "dp": shards samples (a rank renders a range of each pixel's).

Rank r sits at (sp_idx, dp_idx) = (r // n_dp, r % n_dp), the order of the
JAX package's ``devices.reshape(mesh_shape)``. A rank's partial radiance
sums reduce over "dp" (the ranks that share sp_idx), the scalar loss of a
training step over "sp" (the ranks that share dp_idx: the loss is already
replicated along dp), and trace counts and scene gradients over the whole
world. The collectives are ``torch.distributed`` calls on process groups:
NCCL on the card, gloo on the CPU (gloo takes CUDA tensors here by staging
them through host memory, for several ranks on one card, which NCCL
refuses).

``Mesh.single`` is a mesh with no process group: one process evaluates one
coordinate's share, every collective is the identity. Tests and the card's
smoke run use it to hold each shard's kernel against its plain version and
to sum the shards in one process.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXIS_PIXEL = "sp"
AXIS_SAMPLE = "dp"


def default_shape(n: int) -> tuple[int, int]:
    """(n_sp, n_dp) for n ranks, as the JAX package factors its devices:
    the largest n_dp <= isqrt(n) that divides n, so the pixel axis (which
    needs no collective in the forward pass) is favoured."""
    n_dp = 1
    for cand in range(math.isqrt(n), 0, -1):
        if n % cand == 0:
            n_dp = cand
            break
    return n // n_dp, n_dp


class Mesh:
    """This rank's place in an (n_sp, n_dp) mesh and its process groups.

    ``shape`` maps AXIS_PIXEL and AXIS_SAMPLE to their sizes, as the JAX
    mesh's does; ``coord`` is (sp_idx, dp_idx). Without groups (``single``)
    every collective returns its input."""

    def __init__(self, mesh_shape, coord, backend: str | None = None,
                 dp_group=None, sp_group=None, distributed: bool = False):
        n_sp, n_dp = (int(v) for v in mesh_shape)
        sp_idx, dp_idx = (int(v) for v in coord)
        if n_sp < 1 or n_dp < 1 or not (0 <= sp_idx < n_sp
                                        and 0 <= dp_idx < n_dp):
            raise ValueError(f"coordinate {coord} outside mesh {mesh_shape}")
        self.n_sp, self.n_dp = n_sp, n_dp
        self.sp_idx, self.dp_idx = sp_idx, dp_idx
        self.backend = backend
        self.distributed = distributed
        self._dp_group, self._sp_group = dp_group, sp_group

    @classmethod
    def single(cls, mesh_shape, coord=(0, 0)) -> "Mesh":
        """One coordinate of ``mesh_shape`` in this process, with no
        collectives: a shard's own partial sums."""
        return cls(mesh_shape, coord)

    @property
    def shape(self) -> dict:
        return {AXIS_PIXEL: self.n_sp, AXIS_SAMPLE: self.n_dp}

    @property
    def coord(self) -> tuple[int, int]:
        return self.sp_idx, self.dp_idx

    @property
    def rank(self) -> int:
        return self.sp_idx * self.n_dp + self.dp_idx

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the collective runs on: a host copy for gloo, a
        private copy for NCCL (the collectives work in place)."""
        if self.backend == "gloo":
            return t.detach().to("cpu", copy=True).contiguous()
        return t.detach().clone().contiguous()

    def _all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        if not self.distributed:
            return t
        buf = self._host(t)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)

    def sum_dp(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that share this rank's pixel block."""
        return self._all_reduce(t, self._dp_group)

    def sum_sp(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that share this rank's sample range."""
        return self._all_reduce(t, self._sp_group)

    def sum_world(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh."""
        return self._all_reduce(t, None)

    def gather_sp(self, t: torch.Tensor) -> torch.Tensor:
        """The pixel blocks of the sp axis concatenated along dim 0, in
        sp order (every rank gets the whole image; with no groups, ``t``)."""
        if not self.distributed:
            return t
        buf = self._host(t)
        parts = [torch.empty_like(buf) for _ in range(self.n_sp)]
        dist.all_gather(parts, buf, group=self._sp_group)
        return torch.cat(parts).to(t.device)


def make_mesh(mesh_shape=None) -> Mesh:
    """The mesh of this process group's world (``torch.distributed`` must be
    initialized, see ``launcher.init_distributed``): ``mesh_shape`` (n_sp,
    n_dp), or ``default_shape`` of the world size. Every rank must call it,
    in the same order as any other group creation: it creates one dp group
    for each sp index and one sp group for each dp index."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launcher.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_sp, n_dp = default_shape(world) if mesh_shape is None else (
        int(v) for v in mesh_shape)
    if n_sp * n_dp != world:
        raise ValueError(f"mesh {n_sp}x{n_dp} needs {n_sp * n_dp} ranks, the "
                         f"world has {world}")
    sp_idx, dp_idx = divmod(rank, n_dp)
    dp_group = sp_group = None
    for i in range(n_sp):
        grp = dist.new_group([i * n_dp + j for j in range(n_dp)])
        if i == sp_idx:
            dp_group = grp
    for j in range(n_dp):
        grp = dist.new_group([i * n_dp + j for i in range(n_sp)])
        if j == dp_idx:
            sp_group = grp
    return Mesh((n_sp, n_dp), (sp_idx, dp_idx), dist.get_backend(),
                dp_group, sp_group, distributed=True)
