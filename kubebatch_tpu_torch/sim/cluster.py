"""Synthetic cluster generation — the simulated e2e substrate.

Plays the role the reference's kubemark/DIND harness plays (SURVEY.md
sect. 4 tier 3) without needing a real k8s cluster: deterministic
generators for nodes, queues, PodGroups and pods sized to the BASELINE.md
benchmark configs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cache import SchedulerCache
from ..objects import (Affinity, Node, Pod, PodAffinityTerm, PodGroup,
                       PodPhase, PriorityClass, Queue, Container, Taint,
                       TaintEffect, Toleration, GROUP_NAME_ANNOTATION,
                       resource_list)

GiB = 1024 ** 3


@dataclass
class _GroupShape:
    """Per-group predicate template (pods of a group share it, like a
    real workload's pod template)."""
    selector_zone: Optional[str] = None
    tolerate: bool = False
    anti_self: bool = False
    zone_affine: bool = False
    pref_label: Optional[str] = None
    host_port: Optional[int] = None
    app: str = ""

    def apply(self, pod: Pod) -> None:
        if self.app:
            pod.labels["app"] = self.app
        if self.selector_zone is not None:
            pod.node_selector["zone"] = self.selector_zone
        if self.tolerate:
            pod.tolerations.append(Toleration(
                key="dedicated", operator="Equal", value="batch",
                effect=TaintEffect.NO_SCHEDULE.value))
        terms = Affinity()
        used = False
        if self.anti_self:
            terms.pod_anti_affinity_required.append(PodAffinityTerm(
                match_labels={"app": self.app},
                topology_key="kubernetes.io/hostname"))
            used = True
        if self.zone_affine:
            terms.pod_affinity_required.append(PodAffinityTerm(
                match_labels={"app": self.app}, topology_key="zone"))
            used = True
        if self.pref_label is not None:
            terms.pod_affinity_preferred.append((10, PodAffinityTerm(
                match_labels={"app": self.pref_label},
                topology_key="kubernetes.io/hostname")))
            used = True
        if used:
            pod.affinity = terms
        if self.host_port is not None:
            pod.containers[0].ports = [self.host_port]


def group_shape(spec: "ClusterSpec", rng, g: int) -> Optional[_GroupShape]:
    """Roll one group's predicate template from the spec fractions.
    Features are exclusive per group (a group gets at most one affinity
    kind) so the fractions compose predictably."""
    shape = _GroupShape(app=f"app-{g % 16}")
    if spec.selector_frac > 0 and rng.random() < spec.selector_frac:
        shape.selector_zone = f"z{int(rng.integers(max(1, spec.n_zones)))}"
    if spec.toleration_frac > 0 and rng.random() < spec.toleration_frac:
        shape.tolerate = True
    roll = rng.random()
    if roll < spec.anti_affinity_frac:
        shape.anti_self = True
    elif roll < spec.anti_affinity_frac + spec.zone_affinity_frac:
        shape.zone_affine = True
    elif roll < (spec.anti_affinity_frac + spec.zone_affinity_frac
                 + spec.pref_affinity_frac):
        shape.pref_label = f"app-{int(rng.integers(16))}"
    if spec.hostport_frac > 0 and rng.random() < spec.hostport_frac:
        shape.host_port = 30000 + int(rng.integers(16))
    return shape


@dataclass
class ClusterSpec:
    n_nodes: int = 50
    node_cpu_millis: int = 8000
    node_mem_bytes: float = 16 * GiB
    node_pods: int = 110
    n_groups: int = 100
    pods_per_group: int = 8
    min_member: Optional[int] = None     # default: pods_per_group (full gang)
    pod_cpu_millis: int = 1000
    pod_mem_bytes: float = 2 * GiB
    n_queues: int = 1
    queue_weights: Tuple[int, ...] = ()
    priority_classes: Tuple[Tuple[str, int], ...] = ()
    #: fraction of cluster pre-filled with running pods
    running_fill: float = 0.0
    seed: int = 0
    jitter: float = 0.0                  # relative size jitter on requests
    # --- predicate-rich knobs. Nodes get hostname +
    # zone labels whenever any knob is set. Fractions are of GROUPS —
    # pods of one group share a template, like real workloads. ----------
    n_zones: int = 0                     # zone label cardinality
    selector_frac: float = 0.0           # node-selector on a zone
    taint_frac: float = 0.0              # NoSchedule-tainted node fraction
    toleration_frac: float = 0.0         # groups tolerating the taint
    anti_affinity_frac: float = 0.0      # self anti-affinity on hostname
    zone_affinity_frac: float = 0.0      # required self-affinity on zone
    pref_affinity_frac: float = 0.0      # preferred co-location (score)
    hostport_frac: float = 0.0           # one host port per group

    @property
    def predicate_rich(self) -> bool:
        return any((self.n_zones, self.selector_frac, self.taint_frac,
                    self.anti_affinity_frac, self.zone_affinity_frac,
                    self.pref_affinity_frac, self.hostport_frac))


@dataclass
class SimCluster:
    spec: ClusterSpec
    nodes: List[Node] = field(default_factory=list)
    queues: List[Queue] = field(default_factory=list)
    groups: List[PodGroup] = field(default_factory=list)
    pods: List[Pod] = field(default_factory=list)
    priority_classes: List[PriorityClass] = field(default_factory=list)

    def populate(self, cache: SchedulerCache) -> None:
        for q in self.queues:
            cache.add_queue(q)
        for pc in self.priority_classes:
            cache.add_priority_class(pc)
        for n in self.nodes:
            cache.add_node(n)
        for g in self.groups:
            cache.add_pod_group(g)
        for p in self.pods:
            cache.add_pod(p)

    _pod_index: Optional[Dict[Tuple[str, str], Pod]] = None
    _churn_seq: int = 0

    def churn_tick(self, cache: SchedulerCache, n_pods: int,
                   arrival_queue: Optional[int] = None) -> int:
        """Steady-state churn trickle: the oldest fully-bound gangs finish
        (pod + PodGroup delete events) and the same number of fresh gangs
        arrives pending — the regime the 1 s schedule-period loop lives in
        once the cluster is mostly scheduled (the kubemark plan's
        density/latency scenario, ref
        doc/design/Benchmark/kubemark/kubemark-benchmarking.md:40-42).
        Returns the number of pods actually recycled.

        ``arrival_queue`` pins ALL of this tick's fresh gangs onto one
        queue index instead of the round-robin default — alternating it
        between ticks sustains cross-queue imbalance (the arriving
        queue's allocated sits below its deserved while others sit at or
        above), the regime where reclaim's provably-idle gates correctly
        do NOT fire and the victim wave path stays hot every cycle
        (a skewed steady workload)."""
        spec = self.spec
        per = max(1, spec.pods_per_group)
        n_groups = max(1, n_pods // per)
        by_group: Dict[str, List[Pod]] = {}
        for p in self.pods:
            by_group.setdefault(p.annotations.get(GROUP_NAME_ANNOTATION, ""),
                                []).append(p)
        recycled = 0
        done = 0
        doomed_pods: set = set()
        doomed_groups: set = set()
        for g in self.groups:
            if done >= n_groups:
                break
            if not g.name.startswith("job-"):
                continue        # leave cfg4's running fill alone
            pods = by_group.get(g.name, [])
            if not pods or not all(p.node_name for p in pods):
                continue
            for p in pods:
                cache.delete_pod(p)
                doomed_pods.add(p.uid)
            cache.delete_pod_group(g)
            doomed_groups.add(g.name)
            recycled += len(pods)
            done += 1
        if doomed_pods:
            # one rebuild instead of per-pod list.remove (each remove is a
            # field-by-field dataclass scan of the full 10k+ pod list)
            self.pods = [p for p in self.pods if p.uid not in doomed_pods]
            self.groups = [g for g in self.groups
                           if g.name not in doomed_groups]
        self._pod_index = None
        base_ts = 1e9 + self._churn_seq
        rich = spec.predicate_rich
        rng = np.random.default_rng(spec.seed + 7919 + self._churn_seq) \
            if rich else None
        for k in range(done):
            gid = self._churn_seq
            self._churn_seq += 1
            qi = (arrival_queue if arrival_queue is not None
                  else gid) % len(self.queues)
            queue = self.queues[qi].name
            # named job-* so the next tick can recycle churn gangs too
            pg = PodGroup(name=f"job-churn-{gid:06d}", namespace="sim",
                          min_member=per, queue=queue,
                          creation_timestamp=base_ts + k)
            self.groups.append(pg)
            cache.add_pod_group(pg)
            shape = group_shape(spec, rng, gid) if rich else None
            for p in range(per):
                pod = Pod(
                    name=f"{pg.name}-{p:03d}", namespace="sim",
                    annotations={GROUP_NAME_ANNOTATION: pg.name},
                    containers=[Container(requests=resource_list(
                        cpu=spec.pod_cpu_millis,
                        memory=spec.pod_mem_bytes))],
                    creation_timestamp=base_ts + k + p / 1000.0)
                if shape is not None:
                    shape.apply(pod)
                self.pods.append(pod)
                cache.add_pod(pod)
        # let the deleted-job GC run (no repair worker in benchmarks)
        cache.process_cleanup_jobs()
        return recycled

    def pod_lister(self, ns: str, name: str) -> Optional[Pod]:
        """O(1) ground-truth lookup for the resync repair loop (every
        err_tasks retry calls this; a linear scan walks 10k pods at the
        stress config)."""
        index = self._pod_index
        if index is None or len(index) != len(self.pods):
            index = {(p.namespace, p.name): p for p in self.pods}
            self._pod_index = index
        return index.get((ns, name))


def build_cluster(spec: ClusterSpec) -> SimCluster:
    rng = np.random.default_rng(spec.seed)
    sim = SimCluster(spec)

    n_queues = max(1, spec.n_queues)
    weights = (spec.queue_weights if spec.queue_weights
               else tuple([1] * n_queues))
    for i in range(n_queues):
        sim.queues.append(Queue(name=f"q{i + 1}", weight=weights[i]))
    for name, value in spec.priority_classes:
        sim.priority_classes.append(PriorityClass(name=name, value=value))

    def _jit(v: float) -> float:
        if spec.jitter <= 0:
            return v
        return float(v * (1.0 + rng.uniform(-spec.jitter, spec.jitter)))

    rich = spec.predicate_rich
    n_zones = max(1, spec.n_zones) if rich else 0
    for i in range(spec.n_nodes):
        alloc = resource_list(cpu=_jit(spec.node_cpu_millis),
                              memory=_jit(spec.node_mem_bytes),
                              pods=spec.node_pods)
        name = f"node-{i:05d}"
        labels = {}
        taints = []
        if rich:
            labels = {"kubernetes.io/hostname": name,
                      "zone": f"z{i % n_zones}"}
            if spec.taint_frac > 0 and rng.random() < spec.taint_frac:
                taints = [Taint(key="dedicated", value="batch",
                                effect=TaintEffect.NO_SCHEDULE)]
        sim.nodes.append(Node(name=name, allocatable=alloc, labels=labels,
                              taints=taints))

    pc_names = [name for name, _ in spec.priority_classes]
    min_member = (spec.min_member if spec.min_member is not None
                  else spec.pods_per_group)
    for g in range(spec.n_groups):
        queue = sim.queues[g % n_queues].name
        pg = PodGroup(name=f"job-{g:05d}", namespace="sim",
                      min_member=min_member, queue=queue,
                      creation_timestamp=float(g))
        if pc_names:
            pg.priority_class_name = pc_names[g % len(pc_names)]
        sim.groups.append(pg)
        shape = group_shape(spec, rng, g) if rich else None
        for p in range(spec.pods_per_group):
            pod = Pod(
                name=f"job-{g:05d}-{p:03d}", namespace="sim",
                annotations={GROUP_NAME_ANNOTATION: pg.name},
                containers=[Container(requests=resource_list(
                    cpu=_jit(spec.pod_cpu_millis),
                    memory=_jit(spec.pod_mem_bytes)))],
                creation_timestamp=float(g * 10000 + p))
            if shape is not None:
                shape.apply(pod)
            sim.pods.append(pod)

    # pre-fill part of the cluster with running pods (for preempt/reclaim
    # scenarios): round-robin placement until the fill fraction is reached,
    # skipping nodes whose remaining capacity can't hold another fill pod
    # (a real cluster never runs pods past allocatable)
    if spec.running_fill > 0:
        budget = spec.running_fill * spec.n_nodes * spec.node_cpu_millis
        cpu_room = [n.allocatable.get("cpu", spec.node_cpu_millis)
                    for n in sim.nodes]
        mem_room = [n.allocatable.get("memory", spec.node_mem_bytes)
                    for n in sim.nodes]
        pod_room = [n.allocatable.get("pods", spec.node_pods)
                    for n in sim.nodes]
        used = 0.0
        i = 0
        misses = 0
        while used + spec.pod_cpu_millis <= budget \
                and misses < spec.n_nodes:
            k = i % spec.n_nodes
            if (cpu_room[k] < spec.pod_cpu_millis
                    or mem_room[k] < spec.pod_mem_bytes
                    or pod_room[k] < 1):
                misses += 1
                i += 1
                continue
            misses = 0
            cpu_room[k] -= spec.pod_cpu_millis
            mem_room[k] -= spec.pod_mem_bytes
            pod_room[k] -= 1
            node = sim.nodes[k]
            pg_name = f"fill-{i:05d}"
            sim.groups.append(PodGroup(
                name=pg_name, namespace="sim", min_member=1,
                queue=sim.queues[i % n_queues].name,
                creation_timestamp=-1.0))
            sim.pods.append(Pod(
                name=f"fill-{i:05d}", namespace="sim",
                node_name=node.name, phase=PodPhase.RUNNING,
                annotations={GROUP_NAME_ANNOTATION: pg_name},
                containers=[Container(requests=resource_list(
                    cpu=spec.pod_cpu_millis,
                    memory=spec.pod_mem_bytes))]))
            used += spec.pod_cpu_millis
            i += 1
    return sim


#: BASELINE.md benchmark configs (sect. "Metrics to measure")
BASELINE_SPECS: Dict[int, ClusterSpec] = {
    1: ClusterSpec(n_nodes=1, node_cpu_millis=8000, node_mem_bytes=16 * GiB,
                   n_groups=1, pods_per_group=3, pod_cpu_millis=1000,
                   pod_mem_bytes=GiB),
    2: ClusterSpec(n_nodes=50, n_groups=100, pods_per_group=8),
    3: ClusterSpec(n_nodes=500, n_groups=1000, pods_per_group=4,
                   n_queues=4, queue_weights=(1, 2, 3, 4),
                   pod_cpu_millis=800, pod_mem_bytes=GiB),
    4: ClusterSpec(n_nodes=2000, n_groups=625, pods_per_group=8,
                   min_member=4, running_fill=0.6,
                   priority_classes=(("low", 10), ("mid", 100),
                                     ("high", 1000)),
                   pod_cpu_millis=1000, pod_mem_bytes=2 * GiB),
    5: ClusterSpec(n_nodes=5000, n_groups=1250, pods_per_group=8,
                   n_queues=4, queue_weights=(1, 2, 3, 4),
                   pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                   jitter=0.2),
    # --- the scale axis past cfg5 (50k / 100k nodes) ------------------
    6: ClusterSpec(n_nodes=50000, n_groups=6250, pods_per_group=8,
                   n_queues=4, queue_weights=(1, 2, 3, 4),
                   pod_cpu_millis=1000, pod_mem_bytes=2 * GiB),
    7: ClusterSpec(n_nodes=100000, n_groups=13000, pods_per_group=8,
                   n_queues=4, queue_weights=(1, 2, 3, 4),
                   pod_cpu_millis=1000, pod_mem_bytes=2 * GiB),
}

#: predicate-rich variants: same scale as the
#: base configs, with node labels/taints, selectors, tolerations, both
#: affinity kinds, preferred co-location scores, and host ports at
#: real-workload-ish fractions. "2p"/"3p"/"5p" on the bench CLI.
BASELINE_SPECS["2p"] = ClusterSpec(
    n_nodes=50, n_groups=100, pods_per_group=8,
    n_zones=4, selector_frac=0.15, taint_frac=0.1, toleration_frac=0.15,
    anti_affinity_frac=0.08, zone_affinity_frac=0.06,
    pref_affinity_frac=0.08, hostport_frac=0.05)
BASELINE_SPECS["3p"] = ClusterSpec(
    n_nodes=500, n_groups=1000, pods_per_group=4,
    n_queues=4, queue_weights=(1, 2, 3, 4),
    pod_cpu_millis=800, pod_mem_bytes=GiB,
    n_zones=8, selector_frac=0.15, taint_frac=0.1, toleration_frac=0.15,
    anti_affinity_frac=0.08, zone_affinity_frac=0.05,
    pref_affinity_frac=0.08, hostport_frac=0.04)
#: one tenant's cluster of the multi-tenant mix: small enough that every
#: cycle stays below the batched threshold (the fused engine's regime)
BASELINE_SPECS["t"] = ClusterSpec(
    n_nodes=12, n_groups=16, pods_per_group=2,
    n_queues=2, queue_weights=(1, 3),
    pod_cpu_millis=900, pod_mem_bytes=GiB)

BASELINE_SPECS["5p"] = ClusterSpec(
    n_nodes=5000, n_groups=1250, pods_per_group=8,
    n_queues=4, queue_weights=(1, 2, 3, 4),
    pod_cpu_millis=1000, pod_mem_bytes=2 * GiB, jitter=0.2,
    n_zones=16, selector_frac=0.15, taint_frac=0.1, toleration_frac=0.15,
    anti_affinity_frac=0.05, zone_affinity_frac=0.03,
    pref_affinity_frac=0.05, hostport_frac=0.02)


def baseline_cluster(config) -> SimCluster:
    return build_cluster(BASELINE_SPECS[config])
