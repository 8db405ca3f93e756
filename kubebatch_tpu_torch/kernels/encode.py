"""Static-term encoder: (task signature x node profile) -> dense matrices.

The reference evaluates predicates and node scores per (task, node) call
(plugins/predicates/predicates.go, plugins/nodeorder/nodeorder.go). Most of
those checks are *static* within a scheduling cycle — they read only pod
spec fields and node labels/taints, which no action mutates. This module
evaluates them once per (unique task signature, unique node profile) pair —
reusing the host matcher functions verbatim, so semantics cannot drift —
and broadcasts the results to dense ``[S, N_pad]`` matrices the solver
kernels index by ``task_sig``.

Why signatures/profiles: pods of one PodGroup share a template, and nodes
share label shapes, so S and P are tiny (≈ #jobs, #node-pools) while T x N
is huge (10k x 5k at the stress config). The Python cost is O(S x P); the
broadcast is a numpy gather.

Dynamic terms are NOT encoded here:
- least-requested / balanced-resource scores depend on each node's running
  request sum, which changes with every in-cycle assignment — the solver
  kernels compute them from the capacity carry (kernels/solver.py,
  kernels/fused.py), mirroring nodeorder.go's per-call recompute.
- inter-pod (anti-)affinity and host-port conflicts depend on in-cycle
  assignments; `dynamic_features` detects them. The BATCHED engine
  carries them as domain-count tensors in its round state
  (kernels/affinity.py); the VICTIM solvers keep their device kernels
  and apply an exact host-side node mask at choice time
  (affinity.SessionAffinityMasks — the features only gate the
  preemptor's node, never the victims); the per-visit/fused allocate
  engines fall back to the host path on them (actions/allocate.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api import TaskInfo
from ..objects import Pod
from ..plugins.predicates import match_node_selector, tolerates_node_taints
from .tensorize import NodeState


def _expr_key(e) -> Tuple:
    return (e.key, e.operator, tuple(e.values))


def _term_key(term) -> Tuple:
    return tuple(_expr_key(e) for e in term.match_expressions)


def _node_affinity_keys(pod: Pod) -> Tuple[Tuple, Tuple]:
    """(required, preferred) signature components of a pod's node affinity."""
    aff = pod.affinity
    if aff is None or aff.node_affinity is None:
        return (), ()
    req = tuple(_term_key(t) for t in aff.node_affinity.required)
    pref = tuple((w, _term_key(t)) for w, t in aff.node_affinity.preferred)
    return req, pref


def _toleration_key(pod: Pod) -> Tuple:
    return tuple((t.key, t.operator, t.value, t.effect)
                 for t in pod.tolerations)


#: the signature of a pod with no selectors/affinity/tolerations — the
#: overwhelmingly common shape; shared so the per-pod fast path is one
#: truthiness check per field
_EMPTY_SIG = ((), (), (), ())


def task_signature(pod: Pod) -> Tuple:
    """Everything the static predicate/score terms read from the pod.
    Cached on the pod object — pod spec fields are immutable for the pod's
    lifetime, and this runs per pending task per cycle otherwise."""
    sig = getattr(pod, "_kb_sig", None)
    if sig is None:
        if not (pod.node_selector or pod.affinity or pod.tolerations):
            sig = _EMPTY_SIG
        else:
            na_req, na_pref = _node_affinity_keys(pod)
            sig = (tuple(sorted(pod.node_selector.items())), na_req,
                   na_pref, _toleration_key(pod))
        pod._kb_sig = sig
    return sig


def referenced_label_keys(pods: Sequence[Pod]) -> Set[str]:
    """Label keys the pod set can observe on nodes — the node profile only
    needs to distinguish nodes on these keys."""
    keys: Set[str] = set()
    for pod in pods:
        keys.update(pod.node_selector)
        aff = pod.affinity
        if aff is not None and aff.node_affinity is not None:
            for term in aff.node_affinity.required:
                keys.update(e.key for e in term.match_expressions)
            for _, term in aff.node_affinity.preferred:
                keys.update(e.key for e in term.match_expressions)
    return keys


class _FakeNode:
    """Just enough node for tolerates_node_taints."""
    __slots__ = ("taints",)

    def __init__(self, taints):
        self.taints = taints


@dataclass
class StaticTerms:
    """Sig-indexed static predicate mask and score for one cycle.

    ``pred``/``score`` rows are per unique task signature; ``sig_of`` maps a
    TaskInfo uid to its row. Columns follow NodeState order (padded columns
    are masked by the kernels' node validity, not here).
    """
    pred: np.ndarray            # [S, N_pad] bool
    score: np.ndarray           # [S, N_pad] float32
    sig_of: Dict[str, int]      # task uid -> sig row

    def task_rows(self, tasks: Sequence[TaskInfo], t_pad: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Gather [T_pad, N] score/pred matrices for a task batch."""
        sig = np.zeros(t_pad, np.int32)
        for i, t in enumerate(tasks):
            sig[i] = self.sig_of[t.uid]
        return self.score[sig], self.pred[sig]

    def task_sig(self, tasks: Sequence[TaskInfo], t_pad: int) -> np.ndarray:
        sig = np.zeros(t_pad, np.int32)
        for i, t in enumerate(tasks):
            sig[i] = self.sig_of[t.uid]
        return sig

    @property
    def n_sigs(self) -> int:
        return self.pred.shape[0]


def _build_profiles(names: Sequence[str], n_padded: int, rel_keys: Tuple,
                    labels_taints_of):
    """Dedup nodes into (restricted-labels, taints) profiles. Shared by
    the per-cycle builder and the persistent TermsCache — their contract
    is exact equality (test_terms_cache_matches_fresh_build_across_cycles),
    so the profile key lives in exactly one place.

    ``labels_taints_of(name) -> (labels, taints)`` resolves both fields in
    one lookup; the loop runs once per node per (re)build — O(5k) at the
    stress config — so the dominant plain-node shape (no referenced
    labels, no taints) takes the hoisted-key fast branch."""
    profile_of = np.zeros(n_padded, np.int32)
    profiles: List[Tuple[Dict[str, str], list]] = []
    prof_index: Dict[Tuple, int] = {}
    no_rel = not rel_keys
    plain_key = ((), ())
    plain_restricted: Dict[str, str] = {}
    for col, name in enumerate(names):
        labels, taints = labels_taints_of(name)
        if no_rel or not labels:
            restricted = plain_restricted
            key = (plain_key if not taints
                   else ((), tuple((t.key, t.value, t.effect)
                                   for t in taints)))
        else:
            restricted = {k: labels[k] for k in rel_keys if k in labels}
            key = (tuple(sorted(restricted.items())),
                   tuple((t.key, t.value, t.effect) for t in taints))
        p = prof_index.get(key)
        if p is None:
            p = len(profiles)
            prof_index[key] = p
            profiles.append((restricted, taints))
        profile_of[col] = p
    return profile_of, profiles


def _eval_sig_rows(pod: Pod, profiles, with_predicates: bool,
                   with_node_affinity_score: bool,
                   node_affinity_weight: int):
    """One signature's (pred, score) row over the node profiles, via the
    host matcher functions verbatim (shared, see _build_profiles)."""
    n_prof = max(1, len(profiles))
    pred_row = np.ones(n_prof, bool)
    score_row = np.zeros(n_prof, np.float32)
    aff = pod.affinity
    preferred = (aff.node_affinity.preferred
                 if (aff is not None and aff.node_affinity is not None)
                 else [])
    for p, (labels, taints) in enumerate(profiles):
        if with_predicates:
            pred_row[p] = (match_node_selector(pod, labels)
                           and tolerates_node_taints(pod, _FakeNode(taints)))
        if with_node_affinity_score and preferred:
            total = sum(w for w, term in preferred if term.matches(labels))
            score_row[p] = total * node_affinity_weight
    return pred_row, score_row


def build_static_terms(state: NodeState, tasks: Sequence[TaskInfo],
                       node_labels: Dict[str, Dict[str, str]],
                       node_taints: Dict[str, list],
                       with_predicates: bool,
                       with_node_affinity_score: bool,
                       node_affinity_weight: int = 1) -> StaticTerms:
    """Evaluate static terms per (signature, profile) and broadcast.

    node_labels/node_taints are keyed by node name (NodeState column order
    comes from state.names).
    """
    pods = [t.pod for t in tasks]
    rel_keys = tuple(sorted(referenced_label_keys(pods)))

    # --- unique task signatures --------------------------------------
    sig_of: Dict[str, int] = {}
    sig_pods: List[Pod] = []          # exemplar pod per signature
    sig_index: Dict[Tuple, int] = {}
    for t in tasks:
        key = task_signature(t.pod)
        s = sig_index.get(key)
        if s is None:
            s = len(sig_pods)
            sig_index[key] = s
            sig_pods.append(t.pod)
        sig_of[t.uid] = s
    n_sigs = max(1, len(sig_pods))

    # --- unique node profiles ----------------------------------------
    profile_of, profiles = _build_profiles(
        state.names, state.n_padded, rel_keys,
        lambda name: (node_labels.get(name, {}),
                      node_taints.get(name, [])))
    n_prof = max(1, len(profiles))

    # --- evaluate per (sig, profile) via the host matchers ------------
    pred_sp = np.ones((n_sigs, n_prof), bool)
    score_sp = np.zeros((n_sigs, n_prof), np.float32)
    for s, pod in enumerate(sig_pods):
        pred_sp[s], score_sp[s] = _eval_sig_rows(
            pod, profiles, with_predicates, with_node_affinity_score,
            node_affinity_weight)

    # --- broadcast to [S, N_pad] --------------------------------------
    return StaticTerms(pred=pred_sp[:, profile_of],
                       score=score_sp[:, profile_of], sig_of=sig_of)


# ---------------------------------------------------------------------
# persistent encoder state (cross-cycle)
# ---------------------------------------------------------------------

class TermsCache:
    """Static-term encoder state persisted across cycles.

    Owned by SchedulerCache.terms_cache and nulled there on ANY node
    shape change (labels/taints/unschedulable/allocatable, node add or
    delete — cache.py _mark_node_shape), so while it lives, the node
    profiles it encoded are exactly the snapshot's. Per cycle the only
    work left is mapping pending pods to signature rows (memoized on the
    pod) and evaluating rows for signatures never seen before.
    """

    #: new signatures beyond this force a full reset (degenerate churn of
    #: unique selector shapes must not grow the matrices unboundedly)
    MAX_SIGS = 4096

    def __init__(self):
        self.ready = False
        self.names: Optional[List[str]] = None
        self.rel_keys: frozenset = frozenset()
        self.flags: Optional[Tuple] = None
        self.profile_of: Optional[np.ndarray] = None
        self.profiles: List[Tuple[Dict[str, str], list]] = []
        self.sig_index: Dict[Tuple, int] = {}
        #: per-signature rows, stacked lazily (amortized growth — a
        #: full-matrix copy per new signature would be quadratic)
        self._pred_rows: List[np.ndarray] = []
        self._score_rows: List[np.ndarray] = []
        self._stacked: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: generation token for the per-pod sig-row memo; a fresh object()
        #: per rebuild invalidates every memo by identity
        self._gen = object()

    def _rebuild_profiles(self, state: NodeState, ssn,
                          rel_keys: frozenset) -> None:
        self.rel_keys = rel_keys
        self.names = list(state.names)
        nodes = ssn.nodes
        _empty_lt = ({}, [])

        def labels_taints_of(name):
            ni = nodes.get(name)
            nd = ni.node if ni is not None else None
            return (nd.labels, nd.taints) if nd is not None else _empty_lt

        self.profile_of, self.profiles = _build_profiles(
            state.names, state.n_padded, tuple(sorted(rel_keys)),
            labels_taints_of)
        self.sig_index = {}
        self._pred_rows = []
        self._score_rows = []
        self._stacked = None
        self._gen = object()    # identity token for the per-pod row memo
        self.ready = True

    def _sig_row(self, pod: Pod, with_predicates: bool,
                 with_node_affinity_score: bool,
                 node_affinity_weight: int) -> int:
        key = task_signature(pod)
        s = self.sig_index.get(key)
        if s is not None:
            return s
        pred_row, score_row = _eval_sig_rows(
            pod, self.profiles, with_predicates, with_node_affinity_score,
            node_affinity_weight)
        s = len(self.sig_index)
        self.sig_index[key] = s
        self._pred_rows.append(pred_row)
        self._score_rows.append(score_row)
        self._stacked = None
        return s

    def static_terms(self, state: NodeState, ssn,
                     tasks: Sequence[TaskInfo],
                     with_predicates: bool,
                     with_node_affinity_score: bool,
                     node_affinity_weight: int = 1) -> StaticTerms:
        """Same result as build_static_terms, amortized across cycles."""
        pods = [t.pod for t in tasks]
        rel = frozenset(referenced_label_keys(pods))
        flags = (with_predicates, with_node_affinity_score,
                 node_affinity_weight)
        if (not self.ready or self.flags != flags
                or not rel <= self.rel_keys
                or len(self.sig_index) > self.MAX_SIGS
                or self.names != list(state.names)):
            self.flags = flags
            self._rebuild_profiles(state, ssn, rel | self.rel_keys)
        # per-pod row memo: pod specs are immutable and sig_index only
        # grows within a generation, so (gen, row) cached on the pod
        # replaces the signature-tuple hash per task per cycle — 10k
        # pending share a handful of signatures at the stress configs
        gen = self._gen
        sig_of = {}
        for t in tasks:
            pod = t.pod
            memo = getattr(pod, "_kb_sigrow", None)
            if memo is not None and memo[0] is gen:
                sig_of[t.uid] = memo[1]
            else:
                s = self._sig_row(pod, with_predicates,
                                  with_node_affinity_score,
                                  node_affinity_weight)
                pod._kb_sigrow = (gen, s)
                sig_of[t.uid] = s
        if not self._pred_rows:             # no tasks at all
            self._sig_row(Pod(name="-empty-"), with_predicates,
                          with_node_affinity_score, node_affinity_weight)
        if self._stacked is None:
            self._stacked = (np.stack(self._pred_rows),
                             np.stack(self._score_rows))
        pred_sp, score_sp = self._stacked
        terms = StaticTerms(pred=pred_sp[:, self.profile_of],
                            score=score_sp[:, self.profile_of],
                            sig_of=sig_of)
        if len(self.sig_index) > self.MAX_SIGS:
            # a single cycle with many unique selector shapes can overshoot
            # the entry check's bound (it runs before this cycle's rows are
            # added); drop the oversized matrices now rather than carrying
            # them into the next cycle
            self.ready = False
            self.sig_index = {}
            self._pred_rows = []
            self._score_rows = []
            self._stacked = None
        return terms


# ---------------------------------------------------------------------
# dynamic-feature detection (forces the host path)
# ---------------------------------------------------------------------

def _has_pod_affinity(pod: Pod) -> bool:
    return pod.has_pod_affinity()


_DYN_MISS = object()


def dynamic_features(ssn, pending: Sequence[TaskInfo]) -> Optional[str]:
    """Why this snapshot can't use the static encoder, or None if it can.

    - a pending task with host ports can conflict with a port claimed by an
      assignment made earlier in the same cycle (predicates.go's session-
      backed host-port check);
    - any pod with inter-pod (anti-)affinity makes both the affinity
      predicate and nodeorder's interpod score allocation-dependent
      (including the symmetry checks that affect OTHER pods).

    The pending-dependent scans run fresh per call (callers pass
    differently-filtered pending lists — allocate drops BestEffort
    tasks, the victim solvers don't), EXCEPT when the caller hands the
    very same list object again (the cycle tensorizer asks twice per
    build: the engine-support gate, then the affinity screen) — that
    repeat is memoized by list identity. The SESSION-WIDE walk over
    jobs/nodes is memoized too: existing pods' affinity counters can
    only decrease in-session (no pod is added mid-session), so a cached
    positive is at worst over-conservative.
    """
    memo = getattr(ssn, "_dyn_pending_memo", None)
    if memo is not None and memo[0] is pending:
        return memo[1]
    result = _dynamic_features_uncached(ssn, pending)
    try:
        ssn._dyn_pending_memo = (pending, result)
    except Exception:       # slots-only fake sessions in tests
        pass
    return result


def _dynamic_features_uncached(ssn,
                               pending: Sequence[TaskInfo]) -> Optional[str]:
    for t in pending:
        if t.pod.has_host_ports():
            return "pending task with host ports"
    # the maintained per-job counters screen the O(pending) affinity walk:
    # every pending task belongs to a session job, so zero affinity tasks
    # across jobs proves no pending pod carries a term (the walk then runs
    # only on cycles that can actually hit)
    try:
        jobs_have_affinity = any(job.affinity_tasks
                                 for job in ssn.jobs.values())
    except Exception:       # slots-only fake sessions in tests
        jobs_have_affinity = True
    if jobs_have_affinity:
        for t in pending:
            if _has_pod_affinity(t.pod):
                return "pending task with pod (anti-)affinity"
    memo = getattr(ssn, "_dyn_session_aff_memo", _DYN_MISS)
    if memo is not _DYN_MISS:
        return memo
    result = _session_affinity_present(ssn)
    try:
        ssn._dyn_session_aff_memo = result
    except Exception:       # slots-only fake sessions in tests
        pass
    return result


def _session_affinity_present(ssn) -> Optional[str]:
    # the maintained per-entity counters (JobInfo/NodeInfo.affinity_tasks,
    # pinned by debug.audit_cache) replace the per-task cluster walk this
    # detection used to cost every cycle. Pods of jobs the snapshot
    # DROPPED (no PodGroup/PDB, missing queue) can still sit on nodes and
    # reject others through anti-affinity symmetry — the node counters
    # cover them, but that walk is only needed when such jobs exist
    # (ssn.jobs_excluded; shadow PodGroups give every pod a job, so the
    # count is normally 0). Existing pods' host PORTS only matter to
    # port-requesting pending tasks, screened above.
    if any(job.affinity_tasks for job in ssn.jobs.values()):
        return "existing pod with pod (anti-)affinity"
    excluded = getattr(ssn, "jobs_excluded", None)
    if (excluded is None or excluded) \
            and any(node.affinity_tasks for node in ssn.nodes.values()):
        return "existing pod with pod (anti-)affinity"
    return None
