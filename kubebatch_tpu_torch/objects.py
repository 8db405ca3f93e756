"""Cluster API objects — the vocabulary the scheduler watches and mutates.

These are the framework's equivalent of the Kubernetes core/v1 + CRD types the
reference consumes (ref: pkg/apis/scheduling/v1alpha1/types.go, plus the
subset of v1.Pod / v1.Node fields the scheduler actually reads). They are
plain dataclasses so that synthetic event streams, tests and the gRPC
boundary can construct them cheaply; nothing in here imports JAX.

Resource quantities convention (ref: pkg/scheduler/api/resource_info.go:58-73):
CPU and GPU are *milli* units, memory is bytes, ``pods`` is a count.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

# --- well-known keys (ref: pkg/apis/scheduling/v1alpha1/labels.go:221-223) ---
GROUP_NAME_ANNOTATION = "scheduling.k8s.io/group-name"
BACKFILL_ANNOTATION = "scheduling.k8s.io/kube-batch/backfill"

# resource names (ref: resource_info.go:37, v1.ResourceCPU/Memory/Pods)
CPU = "cpu"
MEMORY = "memory"
GPU = "nvidia.com/gpu"
PODS = "pods"

DEFAULT_SCHEDULER_NAME = "kube-batch"

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


_QUANTITY_SUFFIXES = {
    "Ki": 1024.0, "Mi": 1024.0 ** 2, "Gi": 1024.0 ** 3, "Ti": 1024.0 ** 4,
    "Pi": 1024.0 ** 5, "Ei": 1024.0 ** 6,
    "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
}


def parse_quantity(s) -> float:
    """Parse a Kubernetes resource.Quantity string to its plain value
    ("500m" -> 0.5, "1Gi" -> 1073741824, "2" -> 2.0, "1e3" -> 1000.0) —
    the subset of the apimachinery Quantity grammar pod specs actually use
    (binary Ki..Ei, decimal n/u/m/k..E, plain and scientific numbers)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    for suffix, mult in _QUANTITY_SUFFIXES.items():
        if s.endswith(suffix):
            head = s[:-len(suffix)]
            # "1e3" must parse as scientific, not exa ("E" suffix needs a
            # bare integer head; "1e3E" is not produced by k8s anyway)
            if suffix == "E" and ("e" in head or "E" in head):
                continue
            return float(head) * mult
    return float(s)


def resource_list(cpu=0.0, memory=0.0, gpu=0.0, pods=0.0) -> Dict[str, float]:
    """Build a ResourceList. Numeric arguments follow the internal
    convention (cpu/gpu in MILLIS, memory in bytes); string arguments are
    Kubernetes quantity strings with their k8s meaning (cpu="1" is one
    core = 1000 millis, cpu="500m" is 500 millis, memory="1Gi" is
    1073741824 bytes), matching what a pod spec would carry."""
    def _cores_to_millis(v):
        return parse_quantity(v) * 1000.0 if isinstance(v, str) else float(v)

    rl: Dict[str, float] = {}
    for key, value in ((CPU, _cores_to_millis(cpu)),
                       (MEMORY, parse_quantity(memory)),
                       (GPU, _cores_to_millis(gpu)),
                       (PODS, parse_quantity(pods))):
        if value:       # "0"/"0m" and 0 alike omit the key
            rl[key] = value
    return rl


class PodPhase(str, Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


class TaintEffect(str, Enum):
    NO_SCHEDULE = "NoSchedule"
    PREFER_NO_SCHEDULE = "PreferNoSchedule"
    NO_EXECUTE = "NoExecute"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: TaintEffect = TaintEffect.NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""            # empty key + Exists matches everything
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""         # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect.value:
            return False
        if not self.key and self.operator == "Exists":
            return True
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class MatchExpression:
    """A single node/pod selector requirement (key op values)."""
    key: str
    operator: str            # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key)
        if self.operator == "In":
            return has and val in self.values
        if self.operator == "NotIn":
            return not has or val not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator in ("Gt", "Lt"):
            lhs = _as_int(val) if has else None
            rhs = _as_int(self.values[0]) if self.values else None
            if lhs is None or rhs is None:
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        return False


def _as_int(v) -> Optional[int]:
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


@dataclass
class NodeSelectorTerm:
    match_expressions: List[MatchExpression] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass
class NodeAffinity:
    # ORed terms; empty list = no requirement
    required: List[NodeSelectorTerm] = field(default_factory=list)
    # (weight, term) preferences summed into node score
    preferred: List[Tuple[int, NodeSelectorTerm]] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    """Inter-pod (anti-)affinity term: match pods by label selector within a
    topology domain (we support the node-hostname topology, the only one the
    reference's e2e suite exercises)."""
    match_labels: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)  # empty = pod's own ns

    def selects(self, pod: "Pod") -> bool:
        return all(pod.labels.get(k) == v for k, v in self.match_labels.items())


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: List[Tuple[int, PodAffinityTerm]] = field(default_factory=list)
    pod_anti_affinity_preferred: List[Tuple[int, PodAffinityTerm]] = field(default_factory=list)


@dataclass
class Container:
    requests: Dict[str, float] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)  # host ports


@dataclass
class Pod:
    """The subset of v1.Pod the scheduler reads."""
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pod"))
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""
    phase: PodPhase = PodPhase.PENDING
    priority: Optional[int] = None
    priority_class_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    deletion_timestamp: Optional[float] = None
    creation_timestamp: float = 0.0
    owner_uid: str = ""       # controller owner (ref: pkg/apis/utils/utils.go:305)
    status_conditions: List[Dict[str, str]] = field(default_factory=list)
    #: PersistentVolumeClaim names this pod mounts (same namespace);
    #: consumed by the PV-aware volume binder seam (sim/source.py)
    pvc_names: List[str] = field(default_factory=list)

    @property
    def group_name(self) -> str:
        return self.annotations.get(GROUP_NAME_ANNOTATION, "")

    def host_ports(self) -> List[int]:
        ports: List[int] = []
        for c in self.containers:
            ports.extend(c.ports)
        return ports

    def has_host_ports(self) -> bool:
        """Memoized truthiness of host_ports() — the device-feature screen
        asks this per pending pod per cycle, and container specs are
        immutable for the pod's lifetime."""
        flag = getattr(self, "_kb_hostports", None)
        if flag is None:
            flag = any(c.ports for c in self.containers)
            self._kb_hostports = flag
        return flag

    def has_pod_affinity(self) -> bool:
        """Any inter-pod (anti-)affinity term — the feature class that
        makes predicates/scores allocation-dependent (kernels/encode.py
        dynamic_features). Memoized: pod spec fields are immutable for
        the pod's lifetime."""
        flag = getattr(self, "_kb_podaff", None)
        if flag is None:
            aff = self.affinity
            flag = bool(aff is not None
                        and (aff.pod_affinity_required
                             or aff.pod_anti_affinity_required
                             or aff.pod_affinity_preferred
                             or aff.pod_anti_affinity_preferred))
            self._kb_podaff = flag
        return flag


class PodGroupPhase(str, Enum):
    """ref: pkg/apis/scheduling/v1alpha1/types.go:28-39"""
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"


# PodGroup condition types (ref: types.go:41-46; Backfilled is fork-specific)
UNSCHEDULABLE_CONDITION = "Unschedulable"
BACKFILLED_CONDITION = "Backfilled"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughPodsScheduled"


@dataclass
class PodGroupCondition:
    type: str
    status: str = "True"
    transition_id: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupStatus:
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    """ref: pkg/apis/scheduling/v1alpha1/types.go:90-149"""
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pg"))
    min_member: int = 0
    #: desired membership for elastic gangs (0 = fixed-size: desired ==
    #: min_member). A gang with allocated >= min_member but < max_member
    #: is AlmostReady — schedulable at its minimum, backfilled later.
    max_member: int = 0
    queue: str = ""
    priority_class_name: str = ""
    creation_timestamp: float = 0.0
    annotations: Dict[str, str] = field(default_factory=dict)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


@dataclass
class Queue:
    """ref: pkg/apis/scheduling/v1alpha1/types.go:170-186"""
    name: str
    weight: int = 1
    uid: str = field(default_factory=lambda: new_uid("queue"))


@dataclass
class PriorityClass:
    name: str
    value: int = 0
    global_default: bool = False


@dataclass
class PodDisruptionBudget:
    """Legacy gang-grouping path kept for reference parity
    (ref: job_info.go:204-211; cache/event_handlers.go:477-515)."""
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pdb"))
    min_available: int = 0
    match_labels: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    owner_uid: str = ""


@dataclass
class Node:
    """The subset of v1.Node the scheduler reads."""
    name: str
    uid: str = field(default_factory=lambda: new_uid("node"))
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    capacity: Dict[str, float] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False

    def __post_init__(self):
        if not self.capacity and self.allocatable:
            self.capacity = dict(self.allocatable)
        # every node implicitly carries its hostname label, like kubelet does
        self.labels.setdefault("kubernetes.io/hostname", self.name)


def is_backfill_pod(pod: Pod) -> bool:
    """ref: pkg/scheduler/api/job_info.go:72-84 (invalid values -> False)."""
    val = pod.annotations.get(BACKFILL_ANNOTATION, "")
    if not val:
        return False
    return val.strip().lower() in ("1", "t", "true")
