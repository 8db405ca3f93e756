"""nodeorder — weighted node scoring.

ref: pkg/scheduler/plugins/nodeorder/nodeorder.go, which calls the
upstream k8s-1.13 priority MAP functions. Reimplemented natively with the
upstream arithmetic preserved exactly:

- LeastRequested:   per dim ((capacity - requested) * 10) / capacity with
                    Go integer division; score = (cpu + mem) // 2
- BalancedResource: int(10 - |cpuFraction - memFraction| * 10); 0 if
                    either fraction >= 1
- NodeAffinity:     raw sum of matching preferred-term weights (the
                    reference calls only the Map fn — upstream's
                    normalize-to-10 reduce never runs, nodeorder.go:297)
- InterPodAffinity: weighted (anti-)affinity counts over existing pods,
                    normalized to 0..10 across nodes (upstream
                    CalculateInterPodAffinityPriority normalizes
                    internally), including the symmetric terms from
                    existing pods' preferred/required affinity

"requested" uses upstream's NonZero semantics: a pod with no request
counts as 100m CPU / 200MB memory (priorityutil.GetNonzeroRequests).
Weights come from plugin arguments (nodeaffinity.weight etc.), default 1.
"""
from __future__ import annotations

from typing import Dict, List

from ..api import NodeInfo, TaskInfo, allocated_status
from ..framework import EventHandler, Plugin, Session
from ..kernels import tensorize as _tz
from ..objects import Pod

NAME = "nodeorder"

NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"

#: upstream DefaultNonZeroRequest (priorityutil) — canonical values live in
#: kernels/tensorize.py (device units); derived here in host units (bytes)
#: so the in-kernel dynamic scores can never drift from the host scores
NONZERO_MILLI_CPU = _tz.NONZERO_MILLI_CPU
NONZERO_MEMORY = _tz.NONZERO_MEM_MIB * 1024 * 1024
#: upstream v1.DefaultHardPodAffinitySymmetricWeight
HARD_POD_AFFINITY_SYMMETRIC_WEIGHT = 1


def nonzero_request(milli_cpu: float, memory: float):
    return (milli_cpu if milli_cpu != 0 else NONZERO_MILLI_CPU,
            memory if memory != 0 else NONZERO_MEMORY)


def _weights(args: Dict[str, str]) -> Dict[str, int]:
    out = {"least": 1, "node_aff": 1, "pod_aff": 1, "balanced": 1}
    mapping = {NODE_AFFINITY_WEIGHT: "node_aff",
               POD_AFFINITY_WEIGHT: "pod_aff",
               LEAST_REQUESTED_WEIGHT: "least",
               BALANCED_RESOURCE_WEIGHT: "balanced"}
    for key, slot in mapping.items():
        val = args.get(key, "")
        if val != "":
            try:
                out[slot] = int(val)
            except ValueError:
                pass
    return out


def _node_nonzero_requested(node: NodeInfo):
    cpu = mem = 0.0
    for t in node.tasks.values():
        c, m = nonzero_request(t.resreq.milli_cpu, t.resreq.memory)
        cpu += c
        mem += m
    return cpu, mem


def least_requested_score(task: TaskInfo, node: NodeInfo) -> int:
    """upstream leastRequestedScore + LeastRequestedPriorityMap."""
    def dim(requested: float, capacity: float) -> int:
        if capacity == 0:
            return 0
        if requested > capacity:
            return 0
        return int(((capacity - requested) * 10) // capacity)

    ncpu, nmem = _node_nonzero_requested(node)
    tcpu, tmem = nonzero_request(task.resreq.milli_cpu, task.resreq.memory)
    cpu_score = dim(ncpu + tcpu, node.allocatable.milli_cpu)
    mem_score = dim(nmem + tmem, node.allocatable.memory)
    return (cpu_score + mem_score) // 2


def balanced_resource_score(task: TaskInfo, node: NodeInfo) -> int:
    """upstream BalancedResourceAllocationMap."""
    def fraction(requested: float, capacity: float) -> float:
        return requested / capacity if capacity else 1.0

    ncpu, nmem = _node_nonzero_requested(node)
    tcpu, tmem = nonzero_request(task.resreq.milli_cpu, task.resreq.memory)
    cpu_f = fraction(ncpu + tcpu, node.allocatable.milli_cpu)
    mem_f = fraction(nmem + tmem, node.allocatable.memory)
    if cpu_f >= 1 or mem_f >= 1:
        return 0
    return int(10 - abs(cpu_f - mem_f) * 10)


def node_affinity_score(pod: Pod, node: NodeInfo) -> int:
    """Raw sum of matching preferred node-affinity weights
    (upstream CalculateNodeAffinityPriorityMap, no reduce)."""
    aff = pod.affinity
    if aff is None or aff.node_affinity is None or node.node is None:
        return 0
    total = 0
    for weight, term in aff.node_affinity.preferred:
        if term.matches(node.node.labels):
            total += weight
    return total


def _namespaces_match(term, pod: Pod, other: Pod) -> bool:
    if term.namespaces:
        return other.namespace in term.namespaces
    return other.namespace == pod.namespace


def _domain_nodes(ssn: Session, key: str) -> Dict[str, List[str]]:
    """Node names per value of node label ``key``, in session order;
    memoized on the session (its nodes' labels do not change)."""
    memo = ssn.__dict__.setdefault("_kb_domain_nodes", {})
    got = memo.get(key)
    if got is None:
        got = memo[key] = {}
        for name, node in ssn.nodes.items():
            if node.node is not None:
                value = node.node.labels.get(key)
                if value is not None:
                    got.setdefault(value, []).append(name)
    return got


def interpod_affinity_counts(ssn: Session, task: TaskInfo) -> Dict[str, float]:
    """Weighted counts per node (upstream CalculateInterPodAffinityPriority
    before normalization; hostname-equivalent topology through node
    labels)."""
    counts: Dict[str, float] = {name: 0.0 for name in ssn.nodes}
    pod = task.pod
    aff = pod.affinity

    existing: List[TaskInfo] = []
    for job in ssn.jobs.values():
        for status, tasks in job.task_status_index.items():
            if allocated_status(status):
                existing.extend(t for t in tasks.values() if t.node_name)
    seen = {t.key for t in existing}
    for n in ssn.nodes.values():
        for t in n.tasks.values():
            if t.key not in seen:
                seen.add(t.key)
                existing.append(t)

    def add_topology(anchor_node: str, topology_key: str, weight: float):
        anchor = ssn.nodes.get(anchor_node)
        if anchor is None or anchor.node is None:
            return
        topo_val = anchor.node.labels.get(topology_key)
        if topo_val is None:
            return
        # every node of the anchor's domain, in session order (the same
        # additions, in the same order per node, as a walk over all nodes)
        for name in _domain_nodes(ssn, topology_key).get(topo_val, ()):
            counts[name] += weight

    for t in existing:
        other = t.pod
        other_aff = other.affinity
        # incoming pod's preferred terms matching the existing pod
        if aff is not None:
            for weight, term in aff.pod_affinity_preferred:
                if _namespaces_match(term, pod, other) and term.selects(other):
                    add_topology(t.node_name, term.topology_key, weight)
            for weight, term in aff.pod_anti_affinity_preferred:
                if _namespaces_match(term, pod, other) and term.selects(other):
                    add_topology(t.node_name, term.topology_key, -weight)
        if other_aff is None:
            continue
        # symmetric: existing pod's terms matching the incoming pod
        for term in other_aff.pod_affinity_required:
            if HARD_POD_AFFINITY_SYMMETRIC_WEIGHT == 0:
                continue
            if _namespaces_match(term, other, pod) and term.selects(pod):
                add_topology(t.node_name, term.topology_key,
                             HARD_POD_AFFINITY_SYMMETRIC_WEIGHT)
        for weight, term in other_aff.pod_affinity_preferred:
            if _namespaces_match(term, other, pod) and term.selects(pod):
                add_topology(t.node_name, term.topology_key, weight)
        for weight, term in other_aff.pod_anti_affinity_preferred:
            if _namespaces_match(term, other, pod) and term.selects(pod):
                add_topology(t.node_name, term.topology_key, -weight)
    return counts


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        #: read by kernels/terms.py to weight the in-kernel dynamic terms
        self.weights = _weights(self.arguments)

    @property
    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn: Session) -> None:
        weights = self.weights
        # interpod counts are identical across the N node_order calls for
        # one task; memoize per (task, allocation epoch) — the epoch bumps
        # on every allocate/evict event
        cache: Dict[str, tuple] = {}
        epoch = [0]

        def _bump(event):
            epoch[0] += 1

        # owner tag lets the bulk decision-replay collapse the N bumps of a
        # decision batch into one — invalidation is idempotent
        ssn.add_event_handler(EventHandler(allocate_func=_bump,
                                           deallocate_func=_bump,
                                           owner=NAME))

        def node_order(task: TaskInfo, node: NodeInfo) -> float:
            score = 0.0
            score += least_requested_score(task, node) * weights["least"]
            score += balanced_resource_score(task, node) * weights["balanced"]
            score += node_affinity_score(task.pod, node) * weights["node_aff"]
            key = task.uid
            hit = cache.get(key)
            if hit is None or hit[0] != epoch[0]:
                counts = interpod_affinity_counts(ssn, task)
                cmin, cmax = min(counts.values()), max(counts.values())
                cache[key] = (epoch[0], counts, cmin, cmax)
                hit = cache[key]
            _, counts, cmin, cmax = hit
            if cmax != cmin:
                f = 10.0 * (counts.get(node.name, 0.0) - cmin) / (cmax - cmin)
                score += int(f) * weights["pod_aff"]
            return score

        ssn.add_node_order_fn(NAME, node_order)


def new(arguments=None) -> NodeOrderPlugin:
    return NodeOrderPlugin(arguments)
