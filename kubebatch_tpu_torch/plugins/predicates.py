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

from typing import Dict, Iterable, List, Optional

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


def _term_matches_on_node(ssn: Session, term: PodAffinityTerm,
                          node: NodeInfo, pod: Pod,
                          candidates: List[TaskInfo]) -> bool:
    """Does any existing (allocated or on-node) pod matching `term` sit in
    `node`'s topology domain? Topology is resolved through node labels
    (hostname by default). A node lacking the topology key belongs to NO
    domain (upstream semantics) — None never matches."""
    topo_val = _topology_value(ssn, node, term.topology_key)
    if topo_val is None:
        return False
    for t in candidates:
        other = t.pod
        if term.namespaces and other.namespace not in term.namespaces:
            continue
        if not term.namespaces and other.namespace != pod.namespace:
            continue
        if not term.selects(other):
            continue
        other_node = ssn.nodes.get(t.node_name)
        if other_node is None:
            continue
        if _topology_value(ssn, other_node, term.topology_key) == topo_val:
            return True
    return False


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


def satisfies_pod_affinity(ssn: Session, task: TaskInfo, node: NodeInfo,
                           candidates: List[TaskInfo],
                           anti_candidates: Optional[List[TaskInfo]] = None
                           ) -> bool:
    # symmetry check applies to pods WITHOUT own affinity too
    aff = task.pod.affinity or Affinity()
    for term in aff.pod_affinity_required:
        if _term_matches_on_node(ssn, term, node, task.pod, candidates):
            continue
        # first-pod special case (upstream anySchedulable semantics): a pod
        # matching its own affinity selector may start the group when
        # nothing matches cluster-wide
        if (not _cluster_has_match(ssn, term, task.pod, candidates)
                and term.selects(task.pod)
                and (not term.namespaces
                     or task.pod.namespace in term.namespaces)):
            continue
        return False
    for term in aff.pod_anti_affinity_required:
        if _term_matches_on_node(ssn, term, node, task.pod, candidates):
            return False
    # symmetry: existing pods' required ANTI-affinity must not reject us
    # (callers precompute the anti-affinity-carrying sublist per epoch)
    if anti_candidates is None:
        anti_candidates = anti_affinity_candidates(candidates)
    topo_cache: Dict[str, Optional[str]] = {}
    for t in anti_candidates:
        other_aff = t.pod.affinity
        other_node = ssn.nodes.get(t.node_name)
        if other_node is None:
            continue
        for term in other_aff.pod_anti_affinity_required:
            if term.namespaces and task.pod.namespace not in term.namespaces:
                continue
            if not term.namespaces and task.pod.namespace != t.pod.namespace:
                continue
            if not term.selects(task.pod):
                continue
            key = f"{t.node_name}/{term.topology_key}"
            if key not in topo_cache:
                topo_cache[key] = _topology_value(ssn, other_node,
                                                  term.topology_key)
            if (topo_cache[key] is not None and topo_cache[key]
                    == _topology_value(ssn, node, term.topology_key)):
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
            return memo["tasks"], memo["anti"]

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
            if not satisfies_pod_affinity(ssn, task, node, candidates,
                                          anti_candidates):
                raise PredicateError(
                    f"task <{task.namespace}/{task.name}> "
                    f"affinity/anti-affinity failed on node <{node.name}>")

        ssn.add_predicate_fn(NAME, predicate)


def new(arguments=None) -> PredicatesPlugin:
    return PredicatesPlugin(arguments)
