"""The node mesh: the node axis split over a ``torch.distributed`` group.

Takes the place of the reference package's ``jax.sharding.Mesh`` over the
``"nodes"`` axis (kubebatch_tpu/kernels/batched_sharded.py ``node_mesh``,
kernels/sharded.py ``demo_mesh``). A :class:`NodeMesh` holds the process
group, this process's rank, the world size and the rank's
``torch.device``; rank r owns the contiguous node block
``[r * N_sh / k, (r + 1) * N_sh / k)`` of a node bucket ``N_sh`` that
:func:`shard_bucket` makes a multiple of the world size.

The caller creates the group (``torch.distributed.init_process_group``,
for example over a ``FileStore``, which needs no network; or
:func:`kubebatch_tpu_torch.parallel.worker.launch`, which a caller calls
to spawn solver workers and join them). Nothing here creates one. A
world size of 1, or no mesh at all, means one device.

The collectives the sharded engines use are the helpers below, and they
are exact in bits: rows travel as int32 words (float rows are bit views,
so -0.0 and +0.0 both survive; the round compares -0.0 in places), and
every reduction the engines need (the first argmax in global node order,
the owner's row) is taken on the gathered words, never by a float
all-reduce.

**Transport.** NCCL refuses two ranks on one card, so k ranks sharing one
card use a gloo group, a host library. A mesh takes gloo groups only
(another backend raises when the mesh is built; the NCCL leg across
cards is ROADMAP queue B). Gloo took all_gather and
all_gather_into_tensor on CUDA tensors in the H100 machine's torch
(2.11), but each by copying through host memory inside the backend,
where no count sees it; so a mesh on a CUDA device stages every
collective here, through pinned host buffers, decided once when the
mesh is built (:attr:`NodeMesh.staged`), never by catching a failed
call. Each stage's device->host copy is a counted ``device.to_host``;
:attr:`NodeMesh.stats` counts collectives, stages and the host
milliseconds spent in them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..device import to_host
from ..kernels.tensorize import pad_to_bucket

#: the backends a mesh takes: gloo (host memory, staged from a card);
#: "" is the one-device mesh without a group
BACKENDS = ("", "gloo")


def shard_bucket(n: int, n_devices: int, minimum: int = 8) -> int:
    """Node bucket of the sharded engines (reference ``shard_bucket``):
    ``pad_to_bucket`` (powers of two, re-grained above its large bucket),
    rounded up to the next multiple of the mesh size so every rank owns
    the same number of rows (k = 3 gives a bucket that is not a power of
    two)."""
    b = pad_to_bucket(max(n, minimum), minimum)
    if b % n_devices:
        b = -(-b // n_devices) * n_devices
    return b


class NodeMesh:
    """One rank's view of the node mesh. ``group`` None is the default
    group; without an initialised group the mesh is the one-device mesh
    (rank 0 of 1)."""

    def __init__(self, group=None, device="cuda"):
        self.device = torch.device(device)
        if dist.is_available() and dist.is_initialized():
            self.group = group
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        else:
            if group is not None:
                raise ValueError("node_mesh: a group was given but "
                                 "torch.distributed is not initialised")
            self.group, self.rank, self.world, self.backend = None, 0, 1, ""
        if self.backend not in BACKENDS:
            raise NotImplementedError(
                f"node_mesh over a {self.backend} group: a mesh takes gloo "
                f"groups only (the NCCL leg across cards is ROADMAP queue "
                f"B)")
        #: collective name -> True when it stages through host memory
        self.staged = {"all_gather": self.device.type == "cuda"}
        self._pinned = {}
        self.reset_stats()

    # ---- node blocks ----------------------------------------------------

    def block(self, n_sh: int, rank: Optional[int] = None):
        """(lo, hi) of ``rank``'s block (this rank's by default) of a
        node bucket ``n_sh`` (a multiple of the world size)."""
        if n_sh % self.world:
            raise ValueError(f"node bucket {n_sh} does not split over "
                             f"{self.world} ranks")
        r = self.rank if rank is None else rank
        nb = n_sh // self.world
        return r * nb, (r + 1) * nb

    def reset_stats(self) -> None:
        self.stats = {"collectives": 0, "stages": 0, "collective_ms": 0.0}

    # ---- collectives ----------------------------------------------------

    def _host_buffer(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=self.device.type == "cuda")
            self._pinned[key] = buf
        return buf

    def _stage_out(self, key, t: torch.Tensor) -> torch.Tensor:
        """The counted device->host copy of a stage, into a pinned
        buffer kept for ``key``."""
        host = self._host_buffer(key, t)
        to_host(t, out=host)
        self.stats["stages"] += 1
        return host

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` (int32 words), in
        rank order, on this rank's device."""
        if t.dtype != torch.int32:
            raise ValueError("NodeMesh.all_gather moves int32 words (view "
                             "float rows as int32)")
        t = t.contiguous()
        self.stats["collectives"] += 1
        if self.world == 1:
            return t.unsqueeze(0)
        t0 = time.perf_counter()
        if self.staged["all_gather"]:
            src = self._stage_out(("ag", t.shape), t)
            outs = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(outs, src, group=self.group)
            out = torch.stack(outs).to(self.device, non_blocking=True)
        else:
            outs = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(outs, t, group=self.group)
            out = torch.stack(outs)
        self.stats["collective_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    # ---- host objects (solve headers, blocks, replies) -------------------

    def send_objects(self, obj=None, per_rank: Optional[List] = None):
        """Rank 0 sends ``obj`` to every rank and ``per_rank[r]`` to rank
        r; every rank returns (obj, its own item). Host objects (numpy
        arrays, options) over the group's CPU path."""
        if self.world == 1:
            return obj, (per_rank[0] if per_rank else None)
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        mine = [None]
        dist.scatter_object_list(
            mine, per_rank if self.rank == 0 else None, src=0,
            group=self.group)
        return box[0], mine[0]

    def gather_objects(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0 (None elsewhere)."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def node_mesh(group=None, device="cuda") -> NodeMesh:
    """This process's :class:`NodeMesh` over ``group`` (the default group
    when None) with its node blocks on ``device``."""
    from ..device import resolve_device

    return NodeMesh(group, resolve_device(device))


def world_size(mesh: Optional[NodeMesh]) -> int:
    """The mesh's world size; 1 without a mesh."""
    return 1 if mesh is None else mesh.world
