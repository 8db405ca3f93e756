"""Device session and the shared node-score term.

Decision codes (the host applies them through Session.allocate/pipeline
so plugin event handlers and the gang dispatch barrier still fire):

  0 SKIP      task not processed (job became ready first, or its job was
              never visited)
  1 ALLOC     init_resreq fits node idle -> Allocated
  2 ALLOC_OB  fits idle+backfilled but not idle -> AllocatedOverBackfill
  3 PIPELINE  fits releasing -> Pipelined onto releasing resources
  4 FAIL      no feasible node -> job dropped this cycle (allocate.go:187)

Fit rules mirror allocate.go:153-184: a node is feasible if the launch
request fits accessible (idle+backfilled) OR releasing; the highest-scoring
feasible node wins (ties -> lowest node index); the fit kind is then read
off that node.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..api import NodeInfo
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device
from . import _build
from .tensorize import NodeState

SKIP, ALLOC, ALLOC_OB, PIPELINE, FAIL = 0, 1, 2, 3, 4


def dynamic_node_score_plain(nz_req: torch.Tensor, t_nz: torch.Tensor,
                             allocatable_cm: torch.Tensor,
                             dyn_weights: torch.Tensor) -> torch.Tensor:
    """nodeorder's allocation-dependent terms over all nodes, [N] float32.

    Mirrors plugins/nodeorder.py least_requested_score /
    balanced_resource_score (upstream k8s-1.13 arithmetic). The Go integer
    division ``((cap - req) * 10) // cap`` is evaluated as a threshold
    count (how many d in 1..10 satisfy (cap-req)*10 >= d*cap), so float32
    rounding can only bite when a product pair is within an ulp of equal.
    dyn_weights: [least_requested_w, balanced_resource_w] float32.
    """
    f32 = torch.float32
    dev = nz_req.device
    ten = torch.tensor(10.0, dtype=f32, device=dev)
    req = nz_req + t_nz[None, :]                        # [N,2]
    cap = allocatable_cm                                # [N,2]
    d = torch.arange(1, 11, dtype=f32, device=dev)      # [10]
    ge = (cap - req)[None] * ten >= d[:, None, None] * cap[None]
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    dim = torch.where((cap > 0) & (req <= cap), ge.sum(dim=0).to(f32), zero)
    least = torch.floor((dim[:, 0] + dim[:, 1]) / 2.0)
    frac = torch.where(cap > 0, req / torch.where(cap > 0, cap, one), one)
    diff = torch.abs(frac[:, 0] - frac[:, 1])
    balanced = torch.where((frac[:, 0] >= 1.0) | (frac[:, 1] >= 1.0), zero,
                           torch.trunc(ten - diff * ten))
    return least * dyn_weights[0] + balanced * dyn_weights[1]


def dynamic_node_score(nz_req: torch.Tensor, t_nz: torch.Tensor,
                       allocatable_cm: torch.Tensor,
                       dyn_weights: torch.Tensor) -> torch.Tensor:
    """The node score on the tensors' device: the CUDA kernel
    (csrc/node_score.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    args = (nz_req, t_nz, allocatable_cm, dyn_weights)
    devs = {a.device.type for a in args}
    if devs == {"cpu"}:
        return dynamic_node_score_plain(*args)
    if devs != {"cuda"}:
        raise ValueError(f"dynamic_node_score: mixed devices {devs}")
    n = nz_req.shape[0]
    for name, t, shape in (("nz_req", nz_req, (n, 2)), ("t_nz", t_nz, (2,)),
                           ("allocatable_cm", allocatable_cm, (n, 2)),
                           ("dyn_weights", dyn_weights, (2,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"dynamic_node_score: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    nz_req, t_nz, allocatable_cm, dyn_weights = (
        a.contiguous() for a in args)
    out = torch.empty(n, dtype=torch.float32, device=nz_req.device)
    lib = _build.library("node_score.cu")
    err = lib.kb_dynamic_node_score(
        nz_req.data_ptr(), t_nz.data_ptr(), allocatable_cm.data_ptr(),
        dyn_weights.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(nz_req.device).cuda_stream)
    _build.check_launch("dynamic_node_score", err)
    _build.count_launch("dynamic_node_score")
    return out


def ensure_device_snapshot(ssn) -> "DeviceSession":
    """The session's DeviceSession. Built on first use by the cache (on
    the cache's device); rebuilt from host truth when this session has
    already touched node rows since (an earlier action's host-side
    mutations would make those rows stale)."""
    if ssn.device_snapshot is None or ssn.touched_nodes:
        ssn.device_snapshot = ssn.cache.device_session(ssn)
    return ssn.device_snapshot


class DeviceSession:
    """Per-session node arrays on the device, kept in lock-step with the
    host Session's NodeInfo maps (the host applies exactly the decisions
    the kernel produced). ``state`` is the host numpy mirror."""

    def __init__(self, nodes: Dict[str, NodeInfo], min_bucket: int = 8,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.state = NodeState.from_nodes(nodes, min_bucket)
        st = self.state

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.idle = up(st.idle)
        self.releasing = up(st.releasing)
        self.backfilled = up(st.backfilled)
        self.allocatable_cm = up(st.allocatable[:, :2])
        self.nz_req = up(st.nz_requested)
        self.n_tasks = up(st.n_tasks)
        self.max_task_num = up(st.max_task_num)
        self.node_ok = up(st.schedulable & st.valid)

    @property
    def n_padded(self) -> int:
        return self.state.n_padded

    def node_name(self, idx: int) -> str:
        return self.state.names[idx]

    def node_index(self, name: str) -> Optional[int]:
        return self.state.index.get(name)

    def resync(self, nodes: Dict[str, NodeInfo]) -> None:
        """Rebuild device arrays from host truth (used if a host-side apply
        failed halfway)."""
        fresh = DeviceSession(nodes, min_bucket=self.n_padded,
                              device=self.device)
        self.__dict__.update(fresh.__dict__)
