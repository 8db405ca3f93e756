"""Plugin tensor terms — how policy plugins feed the device solve.

The host dispatch evaluates predicate/node-order callbacks per (task, node)
pair with tier semantics AND / SUM (session_plugins.go:331-370). The device
solve needs the same information as tensors. `solver_terms` produces them
when every registered callback is expressible:

- the built-in `predicates` plugin's static chain (node selector, required
  node affinity, taints, unschedulable, pod count) becomes a sig-indexed
  mask via kernels/encode.py;
- the built-in `nodeorder` plugin splits into a static part (preferred
  node-affinity weights -> score matrix) and a dynamic part
  (least-requested + balanced-resource, computed in-kernel from the
  capacity carry; see DynamicScoreSpec);
- inter-pod affinity and host ports depend on in-cycle assignments:
  outside the fused solve's vocabulary, carried by the batched engine
  (kernels/affinity.py) and by the victim path's host-side masks;
- anything else (a third-party plugin callback) returns None and the
  allocate action keeps the reference-literal host path for the cycle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..api import TaskInfo
from .encode import StaticTerms, build_static_terms, dynamic_features

#: plugin names whose predicate / node-order callbacks the encoder + kernels
#: fully express
_DEVICE_PREDICATE_PLUGINS = {"predicates"}
_DEVICE_NODE_ORDER_PLUGINS = {"nodeorder"}


@dataclass(frozen=True)
class DynamicScoreSpec:
    """In-kernel score terms and their nodeorder weights (0 = disabled)."""
    least_requested: float = 0.0
    balanced_resource: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.least_requested != 0.0 or self.balanced_resource != 0.0


@dataclass
class SolverTerms:
    """Everything the device solve needs for one cycle's policy terms."""
    static: StaticTerms
    dynamic: DynamicScoreSpec

    def matrices(self, batch) -> Tuple[np.ndarray, np.ndarray]:
        """[T_pad, N] static score / predicate rows for a task batch
        (kernels/tensorize.TaskBatch), the per-visit scan's inputs."""
        return self.static.task_rows(batch.tasks, batch.t_padded)

    def task_sig(self, tasks: Sequence[TaskInfo], t_pad: int) -> np.ndarray:
        return self.static.task_sig(tasks, t_pad)


def _active(ssn, fns: dict, disable_attr: str):
    """Plugin names whose callback actually runs under the tier config."""
    names = []
    for tier in ssn.tiers:
        for opt in tier.plugins:
            if getattr(opt, disable_attr) or opt.name not in fns:
                continue
            names.append(opt.name)
    return names


def device_supported(ssn, pending: Sequence[TaskInfo],
                     allow_affinity: bool = False) -> bool:
    """Cheap pre-check (no tensorization, no device work): can this cycle's
    registered callbacks run on device at all? Lets the action skip
    DeviceSession construction — a full-cluster upload — on snapshots that
    will take the host path anyway.

    ``allow_affinity``: the batched engine carries inter-pod affinity and
    host ports in its round state (kernels/affinity.py) — build_cycle_inputs
    passes True and the dynamic-feature check is skipped (the affinity
    encoder still refuses past its own vocabulary caps). The victim
    solvers also pass True and apply an exact host-side node mask and
    interpod score at choice time (affinity.SessionAffinityMasks). The
    fused and per-visit allocate paths keep the strict default."""
    return unsupported_reason(ssn, pending, allow_affinity) is None


def unsupported_reason(ssn, pending: Sequence[TaskInfo],
                       allow_affinity: bool = False) -> Optional[str]:
    """Why ``device_supported`` fails (None where it holds): "a volume
    binder", "predicate or node-order plugins outside the device terms",
    or "dynamic_features: ..." for inter-pod affinity and host ports."""
    from ..cache.interface import NullVolumeBinder

    # a real volume binder makes placement feasibility depend on per-node
    # volume state the kernels don't model; the host path handles its
    # try-next-node semantics
    if type(getattr(ssn.cache, "volume_binder", None)) \
            is not NullVolumeBinder:
        return "a volume binder"
    pred_plugins = _active(ssn, ssn.predicate_fns, "predicate_disabled")
    order_plugins = _active(ssn, ssn.node_order_fns, "node_order_disabled")
    if any(p not in _DEVICE_PREDICATE_PLUGINS for p in pred_plugins) \
            or any(p not in _DEVICE_NODE_ORDER_PLUGINS
                   for p in order_plugins):
        return "predicate or node-order plugins outside the device terms"
    if not allow_affinity and (pred_plugins or order_plugins):
        dyn = dynamic_features(ssn, pending)
        if dyn is not None:
            return f"dynamic_features: {dyn}"
    return None


def solver_terms(ssn, device, pending: Sequence[TaskInfo],
                 assume_supported: bool = False) -> Optional[SolverTerms]:
    """Static+dynamic terms for the cycle, or None when some registered
    callback can't run on device (the action then takes the host path).
    ``assume_supported`` skips the re-check when the caller already ran
    device_supported on the same pending set (it walks every job's tasks)."""
    if not assume_supported and not device_supported(ssn, pending):
        return None
    pred_plugins = _active(ssn, ssn.predicate_fns, "predicate_disabled")
    order_plugins = _active(ssn, ssn.node_order_fns, "node_order_disabled")
    if not pred_plugins and not order_plugins:
        # nothing registered: trivial terms, no encoding needed
        state = device.state
        static = StaticTerms(
            pred=np.ones((1, state.n_padded), bool),
            score=np.zeros((1, state.n_padded), np.float32),
            sig_of={t.uid: 0 for t in pending})
        return SolverTerms(static=static, dynamic=DynamicScoreSpec())

    dyn = DynamicScoreSpec()
    node_aff_weight = 1
    if order_plugins:
        weights = getattr(ssn.plugins.get("nodeorder"), "weights", None) \
            or {"least": 1, "balanced": 1, "node_aff": 1}
        dyn = DynamicScoreSpec(least_requested=float(weights["least"]),
                               balanced_resource=float(weights["balanced"]))
        node_aff_weight = weights["node_aff"]

    # persistent encoder state: profiles/sig rows survive across cycles
    # (SchedulerCache nulls terms_cache on any node shape change); fake
    # caches without the slot fall back to the per-cycle build
    tc = getattr(ssn.cache, "terms_cache", False) \
        if ssn.cache is not None else False
    if tc is not False:
        if tc is None:
            from .encode import TermsCache
            tc = TermsCache()
            # persistence is refused if a node-shape event landed after
            # this session's snapshot (tc then stays session-local)
            offer = getattr(ssn.cache, "offer_terms_cache", None)
            if offer is not None:
                offer(tc)
        static = tc.static_terms(
            device.state, ssn, pending,
            with_predicates=bool(pred_plugins),
            with_node_affinity_score=bool(order_plugins),
            node_affinity_weight=node_aff_weight)
        return SolverTerms(static=static, dynamic=dyn)

    node_labels = {}
    node_taints = {}
    for name, ni in ssn.nodes.items():
        node_labels[name] = ni.node.labels if ni.node else {}
        node_taints[name] = ni.node.taints if ni.node else []

    static = build_static_terms(
        device.state, pending, node_labels, node_taints,
        with_predicates=bool(pred_plugins),
        with_node_affinity_score=bool(order_plugins),
        node_affinity_weight=node_aff_weight)
    return SolverTerms(static=static, dynamic=dyn)
