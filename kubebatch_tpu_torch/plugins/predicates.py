"""predicates — node feasibility chain.

ref: pkg/scheduler/plugins/predicates/predicates.go, which chains the
upstream k8s-1.13 predicate library. Reimplemented natively (no k8s): the
checks run in the same order with the same failure semantics —
pod count (MaxTaskNum), node selector + required node affinity, host
ports, node unschedulable, taints/tolerations, inter-pod (anti-)affinity
against the session's allocated tasks (the reference's session-backed
podLister, predicates.go:47-91).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from ..api import NodeInfo, TaskInfo, allocated_status
from ..framework import PredicateError, Plugin, Session
from ..objects import Affinity, Pod, PodAffinityTerm, TaintEffect

NAME = "predicates"


def match_node_selector(pod: Pod, node_labels: Dict[str, str]) -> bool:
    """PodMatchNodeSelector: spec.nodeSelector AND required node affinity
    (upstream predicates.PodMatchNodeSelector)."""
    for k, v in pod.node_selector.items():
        if node_labels.get(k) != v:
            return False
    aff = pod.affinity
    if aff is not None and aff.node_affinity is not None:
        required = aff.node_affinity.required
        if required:
            # ORed node selector terms
            if not any(term.matches(node_labels) for term in required):
                return False
    return True


def tolerates_node_taints(pod: Pod, node) -> bool:
    """PodToleratesNodeTaints: only NoSchedule/NoExecute taints filter
    (PreferNoSchedule is scoring-only upstream)."""
    for taint in node.taints:
        if taint.effect == TaintEffect.PREFER_NO_SCHEDULE:
            continue
        if not any(t.tolerates(taint) for t in pod.tolerations):
            return False
    return True


def fits_host_ports(pod: Pod, used_ports: Iterable[int]) -> bool:
    wanted = set(pod.host_ports())
    return not (wanted & set(used_ports))


def node_used_ports(node: NodeInfo) -> List[int]:
    ports: List[int] = []
    for t in node.tasks.values():
        ports.extend(t.pod.host_ports())
    return ports


def _allocated_tasks(ssn: Session) -> List[TaskInfo]:
    """The session-backed pod lister: allocated-family tasks with their
    session node assignment (ref: predicates.go:51-70)."""
    out = []
    for job in ssn.jobs.values():
        for status, tasks in job.task_status_index.items():
            if allocated_status(status):
                out.extend(tasks.values())
    return out


def _topology_value(ssn: Session, node: NodeInfo, key: str) -> Optional[str]:
    if node.node is None:
        return None
    return node.node.labels.get(key)


def candidate_tasks(ssn: Session) -> List[TaskInfo]:
    """Allocated-family session tasks plus anything already sitting on
    nodes — build ONCE per predicate evaluation and reuse across terms."""
    seen = set()
    out = []
    for t in _allocated_tasks(ssn):
        if t.node_name and t.key not in seen:
            seen.add(t.key)
            out.append(t)
    for n in ssn.nodes.values():
        for t in n.tasks.values():
            if t.key not in seen:
                seen.add(t.key)
                out.append(t)
    return out


def _cluster_has_match(ssn: Session, term: PodAffinityTerm, pod: Pod,
                       candidates: List[TaskInfo]) -> bool:
    for t in candidates:
        other = t.pod
        if term.namespaces and other.namespace not in term.namespaces:
            continue
        if not term.namespaces and other.namespace != pod.namespace:
            continue
        if term.selects(other):
            return True
    return False


def anti_affinity_candidates(tasks: List[TaskInfo]) -> List[TaskInfo]:
    """The sublist carrying required anti-affinity — the only candidates
    the symmetry check must scan (normally empty)."""
    return [t for t in tasks
            if t.pod.affinity is not None
            and t.pod.affinity.pod_anti_affinity_required]


def own_term_domains(ssn: Session, task: TaskInfo,
                     candidates: List[TaskInfo]) -> dict:
    """For each of ``task``'s required (anti-)affinity terms, the topology
    values holding a candidate the term selects — and for a required
    affinity term whether any candidate matches cluster-wide (the
    bootstrap rule). Task-dependent only: callers compute it once per
    (task, epoch) instead of scanning the candidates at every node."""
    aff = task.pod.affinity or Affinity()

    def values(term):
        out = set()
        for t in candidates:
            other = t.pod
            if term.namespaces and other.namespace not in term.namespaces:
                continue
            if not term.namespaces and other.namespace != task.pod.namespace:
                continue
            if not term.selects(other):
                continue
            other_node = ssn.nodes.get(t.node_name)
            if other_node is None:
                continue
            value = _topology_value(ssn, other_node, term.topology_key)
            if value is not None:
                out.add(value)
        return out

    return {"req": [(values(term),
                     _cluster_has_match(ssn, term, task.pod, candidates))
                    for term in aff.pod_affinity_required],
            "anti": [values(term) for term in aff.pod_anti_affinity_required]}


def symmetry_domains(ssn: Session, task: TaskInfo,
                     anti_candidates: List[TaskInfo]
                     ) -> Dict[str, Set[str]]:
    """The topology domains (key -> values) where an existing pod's
    required anti term selects ``task``: the symmetry check rejects a node
    whose value for one of those keys is among them. It depends on the
    task, not the node, so callers compute it once per (task, epoch)
    instead of scanning every carrier at every node."""
    out: Dict[str, Set[str]] = {}
    for t in anti_candidates:
        other_node = ssn.nodes.get(t.node_name)
        if other_node is None:
            continue
        for term in t.pod.affinity.pod_anti_affinity_required:
            if term.namespaces and task.pod.namespace not in term.namespaces:
                continue
            if not term.namespaces and task.pod.namespace != t.pod.namespace:
                continue
            if not term.selects(task.pod):
                continue
            value = _topology_value(ssn, other_node, term.topology_key)
            if value is not None:
                out.setdefault(term.topology_key, set()).add(value)
    return out


def satisfies_pod_affinity(ssn: Session, task: TaskInfo, node: NodeInfo,
                           own: dict, sym_domains: Dict[str, Set[str]]
                           ) -> bool:
    """The inter-pod (anti-)affinity predicate of ``task`` at ``node``
    (ref: predicates.go:47-104), from the domains its own required terms
    reach (own_term_domains) and the domains where existing pods'
    required anti terms reject it (symmetry_domains), both of one
    candidate set. A node lacking a term's topology key belongs to no
    domain (upstream semantics)."""
    aff = task.pod.affinity or Affinity()
    for term, (vals, has_match) in zip(aff.pod_affinity_required,
                                       own["req"]):
        value = _topology_value(ssn, node, term.topology_key)
        if value is not None and value in vals:
            continue
        # first-pod special case (upstream anySchedulable semantics): a pod
        # matching its own affinity selector may start the group when
        # nothing matches cluster-wide
        if (not has_match and term.selects(task.pod)
                and (not term.namespaces
                     or task.pod.namespace in term.namespaces)):
            continue
        return False
    for term, vals in zip(aff.pod_anti_affinity_required, own["anti"]):
        value = _topology_value(ssn, node, term.topology_key)
        if value is not None and value in vals:
            return False
    # symmetry: existing pods' required ANTI-affinity must not reject us
    # (it applies to pods without own affinity too)
    for key, values in sym_domains.items():
        value = _topology_value(ssn, node, key)
        if value is not None and value in values:
            return False
    return True


class PredicatesPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn: Session) -> None:
        # candidate list is identical across the N predicate calls for one
        # allocation step; memoize per allocation epoch (same pattern as
        # nodeorder's interpod count cache)
        from ..framework import EventHandler

        memo = {"epoch": -1, "tasks": None}
        epoch = [0]

        def _bump(event):
            epoch[0] += 1

        # owner tag lets the bulk decision-replay collapse the N bumps of a
        # decision batch into one — invalidation is idempotent
        ssn.add_event_handler(EventHandler(allocate_func=_bump,
                                           deallocate_func=_bump,
                                           owner=NAME))

        def cached_candidates():
            if memo["epoch"] != epoch[0]:
                memo["epoch"] = epoch[0]
                memo["tasks"] = candidate_tasks(ssn)
                # the symmetry check only cares about candidates carrying
                # required anti-affinity — normally none, and scanning the
                # full list per (task, node) call dominates whole actions
                memo["anti"] = anti_affinity_candidates(memo["tasks"])
                memo["sym"] = {}
            return memo["tasks"], memo["anti"]

        def domains(task, candidates, anti_candidates):
            got = memo["sym"].get(task.uid)
            if got is None:
                got = memo["sym"][task.uid] = (
                    own_term_domains(ssn, task, candidates),
                    symmetry_domains(ssn, task, anti_candidates))
            return got

        def predicate(task: TaskInfo, node: NodeInfo) -> None:
            # pod count (ref: predicates.go:127)
            if node.allocatable.max_task_num <= len(node.tasks):
                raise PredicateError(
                    f"node <{node.name}> can not allow more task running "
                    f"on it")
            labels = node.node.labels if node.node else {}
            if not match_node_selector(task.pod, labels):
                raise PredicateError(
                    f"node <{node.name}> didn't match task "
                    f"<{task.namespace}/{task.name}> node selector")
            if not fits_host_ports(task.pod, node_used_ports(node)):
                raise PredicateError(
                    f"node <{node.name}> didn't have available host ports "
                    f"for task <{task.namespace}/{task.name}>")
            if node.node is None or node.node.unschedulable:
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> node "
                    f"<{node.name}> set to unschedulable")
            if not tolerates_node_taints(task.pod, node.node):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> does not "
                    f"tolerate node <{node.name}> taints")
            candidates, anti_candidates = cached_candidates()
            # the domains the terms reach are the task's, not the node's:
            # one scan of the candidates per (task, epoch)
            own, sym = domains(task, candidates, anti_candidates)
            if not satisfies_pod_affinity(ssn, task, node, own, sym):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> "
                    f"affinity/anti-affinity failed on node <{node.name}>")

        ssn.add_predicate_fn(NAME, predicate)


def new(arguments=None) -> PredicatesPlugin:
    return PredicatesPlugin(arguments)
