"""Inter-pod affinity + host-port vocabulary for the batched engine.

A port of the reference package's kernels/affinity.py (same names, same
numpy dtypes, same orders of iteration: dict order and pair order decide
the column order of every [T,P] array, and the engine's results depend on
it). The reference evaluates inter-pod (anti-)affinity and host-port
conflicts per (task, node) call against *current assignments*
(ref: pkg/scheduler/plugins/predicates/predicates.go:47-104,146,188 and
plugins/nodeorder/nodeorder.go:305-313). This module encodes them as
arrays the round engine carries (kernels/batched.py, csrc/batched_allocate.cu):

- **pairs**: every (label-selector group, topology key) referenced by a
  required / preferred (anti-)affinity term of a pending task or of an
  existing pod. A "group" is (match_labels, namespace set); topology
  domains are the distinct values of the key's node label, and a node
  lacking the key belongs to NO domain (-1).
- **carry**: per-pair domain counts of group members, of required-anti
  carriers, and a signed weighted count of preferred-term carriers
  (with the hard-affinity symmetric weight), cluster-wide group totals
  and a per-node port-claim matrix. The round commit adds accepted
  placements into them; the stranded-gang rollback subtracts them.
- **predicate**: required-positive (with the upstream first-pod
  bootstrap), required-anti, symmetry and host ports, per (task, node).

Host code only: numpy, no tensors. :class:`SessionAffinityMasks` gives
the victim path (preempt/reclaim) exact host-side node masks and the
interpod score term.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import TaskInfo, allocated_status
from ..objects import Pod, PodAffinityTerm

#: vocabulary caps on the COMPACTED spaces — snapshots beyond them fall
#: back to the host path (the same contract as TermsCache.MAX_SIGS:
#: degenerate shapes must not grow device state unboundedly). Raw
#: collections may exceed the caps by the compaction window below: pairs
#: dedupe by (group identity, domain column) and ports fold by identical
#: (claimant, base-usage) columns before the cap applies, so a snapshot
#: with >MAX_PAIRS raw terms stays on the device engines whenever its
#: distinct kernel-visible behaviors fit.
MAX_PAIRS = 128
MAX_PORTS = 64

#: raw collection window — how far past the caps the encoders keep
#: collecting before giving up without attempting compaction (a snapshot
#: whose RAW vocabulary exceeds even this is degenerate; the host-side
#: victim masks use the same window as their support bound)
RAW_PAIR_LIMIT = 8 * MAX_PAIRS
RAW_PORT_LIMIT = 8 * MAX_PORTS

#: mirror of plugins/nodeorder.HARD_POD_AFFINITY_SYMMETRIC_WEIGHT
#: (imported lazily in build to avoid a plugins<->kernels import cycle)


#: AffinityInputs array-field order on the reference's rpc wire
#: (solver.proto SnapshotRequest.affinity), kept for a port of the rpc
#: sidecar: several fields share shape and dtype, so a skew would pass
#: every structural check and misplace pods
WIRE_FIELDS = ("node_dom", "task_grp", "task_req_aff", "task_req_anti",
               "task_self_ok", "task_carry_w", "task_pref_w",
               "task_ports", "port_base", "grp_cnt0", "anti_cnt0",
               "pref_w0", "grp_total0")


@dataclass
class AffinityInputs:
    """Everything the batched kernel needs for affinity/ports, numpy."""
    # --- static per-pair / per-node -----------------------------------
    node_dom: np.ndarray       # [P, N_pad] int32, -1 = node has no domain
    # --- static per-task ----------------------------------------------
    task_grp: np.ndarray       # [T_pad, P] bool — pod in pair's group
    task_req_aff: np.ndarray   # [T_pad, P] bool — carries required affinity
    task_req_anti: np.ndarray  # [T_pad, P] bool — carries required anti
    task_self_ok: np.ndarray   # [T_pad, P] bool — bootstrap-eligible
    task_carry_w: np.ndarray   # [T_pad, P] f32 — carried preferred weight
    task_pref_w: np.ndarray    # [T_pad, P] f32 — own preferred weight
    task_ports: np.ndarray     # [T_pad, PT] bool
    port_base: np.ndarray      # [N_pad, PT] bool — ports used pre-cycle
    # --- initial carry (from existing candidates) ---------------------
    grp_cnt0: np.ndarray       # [P, D] f32
    anti_cnt0: np.ndarray      # [P, D] f32
    pref_w0: np.ndarray        # [P, D] f32
    grp_total0: np.ndarray     # [P] f32
    # --- score term ---------------------------------------------------
    ip_weight: float           # nodeorder pod_aff weight
    ip_enabled: bool

    @property
    def n_pairs(self) -> int:
        return self.node_dom.shape[0]


def affinity_features_present(ssn, pending: Sequence[TaskInfo]) -> bool:
    """True when the snapshot carries any feature this module encodes AND
    a plugin that enforces it is active — with predicates and nodeorder
    both disabled, affinity/ports are semantically inert (the host path
    would not check them either) and the plain batched graph runs.
    Feature detection mirrors encode.dynamic_features exactly."""
    from .encode import dynamic_features

    def active(fns, disable_attr):
        return any(not getattr(opt, disable_attr) and opt.name in fns
                   for tier in ssn.tiers for opt in tier.plugins)

    if not (active(ssn.predicate_fns, "predicate_disabled")
            or active(ssn.node_order_fns, "node_order_disabled")):
        return False
    return dynamic_features(ssn, pending) is not None


def affinity_within_vocabulary(ssn, pending: Sequence[TaskInfo]) -> bool:
    """Cheap host-side window check (no tensorization, no device work):
    do the snapshot's RAW pair/port counts fit the collection window the
    compacting encoder accepts? Lets build_cycle_inputs refuse degenerate
    snapshots BEFORE the full-cluster device upload (same contract as
    terms.device_supported). Snapshots inside the window but over the
    compacted caps are caught by build_affinity_inputs after the
    dedupe — a rare shape that pays the (cached, incremental) device
    snapshot before falling back."""
    pairs = _PairSpace()
    ports = set()
    for t in pending:
        pod = t.pod
        for port in pod.host_ports():
            ports.add(port)
        aff = pod.affinity
        if aff is None:
            continue
        for term in aff.pod_affinity_required:
            pairs.add(term, pod)
        for term in aff.pod_anti_affinity_required:
            pairs.add(term, pod)
        for _w, term in aff.pod_affinity_preferred:
            pairs.add(term, pod)
        for _w, term in aff.pod_anti_affinity_preferred:
            pairs.add(term, pod)
    if len(ports) > RAW_PORT_LIMIT:
        return False
    if len(pairs) > RAW_PAIR_LIMIT:
        return False
    for t in _candidates(ssn):
        pod = t.pod
        if not pod.has_pod_affinity():
            continue
        aff = pod.affinity
        for term in aff.pod_anti_affinity_required:
            pairs.add(term, pod)
        for _w, term in aff.pod_affinity_preferred:
            pairs.add(term, pod)
        for _w, term in aff.pod_anti_affinity_preferred:
            pairs.add(term, pod)
        for term in aff.pod_affinity_required:
            pairs.add(term, pod)
        if len(pairs) > RAW_PAIR_LIMIT:
            return False
    return True


def _ns_key(term: PodAffinityTerm, owner: Pod) -> Tuple[str, ...]:
    """The term's namespace set, resolved at encode time (empty list =
    the owner pod's own namespace, predicates.go semantics)."""
    if term.namespaces:
        return tuple(sorted(set(term.namespaces)))
    return (owner.namespace,)


def _pair_key(term: PodAffinityTerm, owner: Pod) -> Tuple:
    return (tuple(sorted(term.match_labels.items())),
            _ns_key(term, owner), term.topology_key)


def _interpod_weight(ssn) -> float:
    """nodeorder's pod_aff weight when the plugin is registered (the ONE
    lookup shared by the batched encoder and the victim-path masks — a
    default-weight change must hit both)."""
    no_plugin = ssn.plugins.get("nodeorder")
    weights = getattr(no_plugin, "weights", None) or {"pod_aff": 1}
    return float(weights.get("pod_aff", 1))


class _PairSpace:
    """Collects (group, topology-key) pairs and memoizes membership."""

    def __init__(self):
        self.index: Dict[Tuple, int] = {}
        self.keys: List[Tuple] = []

    def add(self, term: PodAffinityTerm, owner: Pod) -> int:
        key = _pair_key(term, owner)
        p = self.index.get(key)
        if p is None:
            p = len(self.keys)
            self.index[key] = p
            self.keys.append(key)
        return p

    def __len__(self):
        return len(self.keys)


def _member(pair_key: Tuple, pod: Pod) -> bool:
    labels_kv, ns_set, _ = pair_key
    if pod.namespace not in ns_set:
        return False
    labels = pod.labels
    return all(labels.get(k) == v for k, v in labels_kv)


def _candidates(ssn) -> List[TaskInfo]:
    """The session-backed candidate set, identical to
    plugins/predicates.candidate_tasks (and nodeorder's `existing`):
    allocated-family session tasks with a node + on-node tasks."""
    seen = set()
    out = []
    for job in ssn.jobs.values():
        for status, tasks in job.task_status_index.items():
            if allocated_status(status):
                for t in tasks.values():
                    if t.node_name and t.key not in seen:
                        seen.add(t.key)
                        out.append(t)
    for n in ssn.nodes.values():
        for t in n.tasks.values():
            if t.key not in seen:
                seen.add(t.key)
                out.append(t)
    return out


class SessionAffinityMasks:
    """Exact per-preemptor affinity + host-port node masks for the
    VICTIM path (preempt/reclaim) — evaluated against the session's
    CURRENT assignments with the same pair/domain-count machinery the
    batched engine carries on device, but host-side numpy: affinity
    never filters VICTIMS (no tier fn reads it — session_plugins.go
    victim dispatch), it only gates the preemptor's node choice
    (predicates.go:47-104,146,188 inside preempt/reclaim's per-node
    predicate), so a [N] mask per (task, epoch) is the whole cost.

    Epoch discipline: counts rebuild lazily whenever the session fires
    an allocate/deallocate event (same invalidation the predicates
    plugin's candidate memo uses) — evictions move candidates to
    RELEASING but keep them on the node, so the rebuilt counts match
    what the host predicate would see mid-action.

    ``supported`` is False when the pending set exceeds the pair/port
    caps — callers fall back to the host path exactly as before.

    ``with_scores``: also maintain the interpod-affinity SCORE counts
    (nodeorder.go:305-313 / plugins/nodeorder.interpod_affinity_counts)
    so a scoring action's host-side node chooser can reproduce the
    oracle's node_order_fn sum exactly (kernels/victims.py _choose)."""

    def __init__(self, ssn, pending: Sequence[TaskInfo],
                 with_scores: bool = False, with_predicates: bool = True):
        from ..framework import EventHandler

        self._ssn = ssn
        self._epoch = 0
        self._built_epoch = -1
        self._mask_memo: Dict[Tuple[str, int], np.ndarray] = {}
        self._score_memo: Dict[Tuple[str, int], np.ndarray] = {}
        self.with_scores = with_scores
        #: False when the predicates plugin is disabled — the masks must
        #: then enforce NOTHING (the host oracle would not run the
        #: affinity/port predicate either); only the score side applies
        self.with_predicates = with_predicates
        self.ip_weight = _interpod_weight(ssn) if with_scores else 0.0
        self.supported = affinity_within_vocabulary(ssn, pending)
        if not self.supported:
            from ..metrics import count_affinity_host_fallback
            count_affinity_host_fallback("victim-masks")
            return

        def _bump(event):
            self._epoch += 1

        ssn.add_event_handler(EventHandler(allocate_func=_bump,
                                           deallocate_func=_bump,
                                           owner="predicates"))
        # pair space over the PENDING tasks' own terms + existing
        # carriers' anti terms (+ preferred terms when scoring)
        self._pairs = _PairSpace()
        #: (label-sig, ns) -> membership row; valid while the pair space
        #: hasn't grown (pipelined preemptors carrying new terms grow it)
        self._member_memo: Dict[Tuple, np.ndarray] = {}
        self._memo_pairs = 0
        self._task_terms: Dict[str, tuple] = {}
        #: uid -> tuple of (pair, weight) own preferred terms (signed)
        self._task_pref: Dict[str, tuple] = {}
        for t in pending:
            aff = t.pod.affinity
            if aff is None and not t.pod.has_host_ports():
                continue
            req = anti = ()
            if aff is not None and with_predicates:
                req = tuple(
                    (self._pairs.add(term, t.pod), term, t.pod)
                    for term in aff.pod_affinity_required)
                anti = tuple(self._pairs.add(term, t.pod)
                             for term in aff.pod_anti_affinity_required)
            if aff is not None:
                if with_scores:
                    pref = tuple(
                        (self._pairs.add(term, t.pod), float(w))
                        for w, term in aff.pod_affinity_preferred
                    ) + tuple(
                        (self._pairs.add(term, t.pod), -float(w))
                        for w, term in aff.pod_anti_affinity_preferred)
                    if pref:
                        self._task_pref[t.uid] = pref
            self._task_terms[t.uid] = (
                req, anti,
                tuple(t.pod.host_ports()) if with_predicates else ())
        self._cand_anti: list = []      # filled per rebuild

    def _node_axis(self):
        ssn = self._ssn
        names = list(ssn.nodes)
        index = {n: i for i, n in enumerate(names)}
        return names, index

    def _rebuild(self) -> None:
        from ..plugins.nodeorder import HARD_POD_AFFINITY_SYMMETRIC_WEIGHT

        ssn = self._ssn
        self._mask_memo.clear()
        self._score_memo.clear()
        names, index = self._node_axis()
        self._names = names
        n = len(names)
        cands = _candidates(ssn)
        # existing carriers' required anti terms join the pair space
        # (symmetry); with scores, their preferred + hard-sym required
        # terms too; new label shapes can add pairs — the space is
        # grow-only within the action
        cand_anti = []
        cand_pref = []           # (pair, weight, carrier task)
        hard_w = (float(HARD_POD_AFFINITY_SYMMETRIC_WEIGHT)
                  if self.with_scores and self.ip_weight else 0.0)
        for t in cands:
            pod = t.pod
            if pod.has_pod_affinity() and pod.affinity is not None:
                aff = pod.affinity
                if self.with_predicates:
                    for term in aff.pod_anti_affinity_required:
                        cand_anti.append((self._pairs.add(term, pod), t))
                if self.with_scores and self.ip_weight:
                    for w, term in aff.pod_affinity_preferred:
                        cand_pref.append(
                            (self._pairs.add(term, pod), float(w), t))
                    for w, term in aff.pod_anti_affinity_preferred:
                        cand_pref.append(
                            (self._pairs.add(term, pod), -float(w), t))
                    if hard_w:
                        for term in aff.pod_affinity_required:
                            cand_pref.append(
                                (self._pairs.add(term, pod), hard_w, t))
        p_cnt = max(1, len(self._pairs))
        node_dom = np.full((p_cnt, n), -1, np.int32)
        key_dom: Dict[str, np.ndarray] = {}
        for p, key in enumerate(self._pairs.keys):
            topo = key[2]
            col = key_dom.get(topo)
            if col is None:
                col = np.full(n, -1, np.int32)
                values: Dict[str, int] = {}
                for i, name in enumerate(names):
                    ni = ssn.nodes.get(name)
                    if ni is None or ni.node is None:
                        continue
                    v = ni.node.labels.get(topo)
                    if v is not None:
                        col[i] = values.setdefault(v, len(values))
                key_dom[topo] = col
            node_dom[p] = col
        d_cap = n + 1
        grp_cnt = np.zeros((p_cnt, d_cap), np.int32)
        grp_total = np.zeros(p_cnt, np.int64)
        anti_cnt = np.zeros((p_cnt, d_cap), np.int32)
        if self._memo_pairs != len(self._pairs):
            self._member_memo.clear()
            self._memo_pairs = len(self._pairs)

        def membership(pod):
            sig = (tuple(sorted(pod.labels.items())), pod.namespace)
            row = self._member_memo.get(sig)
            if row is None:
                row = np.fromiter(
                    (_member(k, pod) for k in self._pairs.keys), bool,
                    count=len(self._pairs))
                self._member_memo[sig] = row
            return row

        for t in cands:
            row = membership(t.pod)
            if row.any():
                grp_total[:len(row)] += row
                col = index.get(t.node_name)
                if col is not None:
                    doms = node_dom[:len(row), col]
                    ok = row & (doms >= 0)
                    grp_cnt[np.flatnonzero(ok), doms[ok]] += 1
        for p, t in cand_anti:
            col = index.get(t.node_name)
            if col is not None:
                d = node_dom[p, col]
                if d >= 0:
                    anti_cnt[p, d] += 1
        pref_w = np.zeros((p_cnt, d_cap), np.float32)
        for p, w, t in cand_pref:
            col = index.get(t.node_name)
            if col is not None:
                d = node_dom[p, col]
                if d >= 0:
                    pref_w[p, d] += w
        # ports actually used per node (only referenced ports matter,
        # but the per-node walk is over candidate tasks anyway)
        used_ports: Dict[int, set] = {}
        for name, ni in ssn.nodes.items():
            col = index[name]
            ports = set()
            for t in ni.tasks.values():
                ports.update(t.pod.host_ports())
            if ports:
                used_ports[col] = ports
        self._node_dom = node_dom
        self._grp_cnt = grp_cnt
        self._grp_total = grp_total
        self._anti_cnt = anti_cnt
        self._pref_w = pref_w
        self._used_ports = used_ports
        self._cand_anti = cand_anti
        self._cand_pref = cand_pref
        self._built_epoch = self._epoch

    def node_mask(self, task: TaskInfo, device) -> Optional[np.ndarray]:
        """[N_pad] bool over the DEVICE node columns: True = the
        affinity/port predicates allow the node. None = no constraint
        for this task (all-true)."""
        if not self.supported:
            return None
        if self._built_epoch != self._epoch:
            self._rebuild()
        terms = self._task_terms.get(task.uid)
        pod = task.pod
        # symmetry applies to EVERY task (even without own terms) when
        # anti carriers exist
        if terms is None and not self._cand_anti:
            return None
        key = (task.uid, self._built_epoch)
        got = self._mask_memo.get(key)
        if got is not None:
            return got
        n = len(self._names)
        ok = np.ones(n, bool)
        node_dom = self._node_dom
        req, anti, ports = terms if terms is not None else ((), (), ())
        for p, term, owner in req:
            doms = node_dom[p]
            cnt = np.where(doms >= 0,
                           self._grp_cnt[p][np.maximum(doms, 0)], 0)
            present = cnt > 0
            if not self._grp_total[p]:
                # first-pod bootstrap: self-matching term passes anywhere
                if term.selects(pod) and pod.namespace in _ns_key(term,
                                                                  owner):
                    continue
            ok &= present
        for p in anti:
            doms = node_dom[p]
            cnt = np.where(doms >= 0,
                           self._grp_cnt[p][np.maximum(doms, 0)], 0)
            ok &= ~(cnt > 0)
        # symmetry: existing carriers' anti terms that select THIS pod —
        # per unique PAIR (the mask depends only on p; many carriers of
        # one term would repeat identical full-array work otherwise)
        for p in {p for p, _t in self._cand_anti}:
            pkey = self._pairs.keys[p]
            if _member(pkey, pod):
                doms = node_dom[p]
                acnt = np.where(doms >= 0,
                                self._anti_cnt[p][np.maximum(doms, 0)], 0)
                ok &= ~(acnt > 0)
        if ports:
            want = set(ports)
            for col, used in self._used_ports.items():
                if want & used:
                    ok[col] = False
        # map session-node order onto the device's padded columns
        n_pad = device.n_padded
        out = np.zeros(n_pad, bool)
        for i, name in enumerate(self._names):
            col = device.node_index(name)
            if col is not None:
                out[col] = ok[i]
        self._mask_memo[key] = out
        return out

    def score_norm(self, task: TaskInfo, device) -> Optional[np.ndarray]:
        """The interpod-affinity node-order TERM for ``task`` over the
        device's padded node columns — counts from the CURRENT
        assignments, normalized exactly like the host
        (int(10 * (c - cmin) / (cmax - cmin)) * pod_aff weight, min/max
        over the session's real nodes; None when the term is zero
        everywhere). Mirrors plugins/nodeorder.interpod_affinity_counts
        + its per-(task, epoch) memoized normalization."""
        if not (self.with_scores and self.ip_weight and self.supported):
            return None
        if self._built_epoch != self._epoch:
            self._rebuild()
        pref = self._task_pref.get(task.uid, ())
        if not pref and not self._cand_pref:
            return None
        key = (task.uid, self._built_epoch)
        if key in self._score_memo:
            return self._score_memo[key]
        pod = task.pod
        n = len(self._names)
        counts = np.zeros(n, np.float64)
        node_dom = self._node_dom
        # own preferred terms: w x (#matching candidates in the node's
        # domain)
        for p, w in pref:
            doms = node_dom[p]
            cnt = np.where(doms >= 0,
                           self._grp_cnt[p][np.maximum(doms, 0)], 0)
            counts += w * cnt
        # symmetric: candidates' preferred (+ hard-sym required) terms
        # whose selector matches THIS pod weigh their carriers' domains
        for p in {p for p, _w, _t in self._cand_pref}:
            if _member(self._pairs.keys[p], pod):
                doms = node_dom[p]
                pw = np.where(doms >= 0,
                              self._pref_w[p][np.maximum(doms, 0)], 0.0)
                counts += pw
        cmin = counts.min() if n else 0.0
        cmax = counts.max() if n else 0.0
        if cmax == cmin:
            self._score_memo[key] = None
            return None
        norm = np.floor(10.0 * (counts - cmin)
                        / (cmax - cmin)) * self.ip_weight
        n_pad = device.n_padded
        out = np.zeros(n_pad, np.float32)
        for i, name in enumerate(self._names):
            col = device.node_index(name)
            if col is not None:
                out[col] = norm[i]
        self._score_memo[key] = out
        return out


def _compact_pairs(keys: List[Tuple], key_dom: Dict[str, np.ndarray]):
    """Dedupe raw (group, topology) pairs whose KERNEL behavior is
    identical: same label selector + resolved namespace set (those two
    alone decide membership, bootstrap self-selection and the symmetry
    match) AND same node->domain column (the topology key enters the
    kernel only through that column). Two such pairs are
    indistinguishable to every predicate, carry scatter and rollback, so
    one representative carries them all; weights accumulate onto it
    exactly as the host's per-term sums do. Returns (compact_keys,
    remap) with remap[raw_index] -> compact_index."""
    index: Dict[Tuple, int] = {}
    compact: List[Tuple] = []
    remap: List[int] = []
    col_sig: Dict[str, bytes] = {}
    for key in keys:
        topo = key[2]
        sig = col_sig.get(topo)
        if sig is None:
            sig = col_sig[topo] = key_dom[topo].tobytes()
        ckey = (key[0], key[1], sig)
        ci = index.get(ckey)
        if ci is None:
            ci = len(compact)
            index[ckey] = ci
            compact.append(key)
        remap.append(ci)
    return compact, remap


def _fold_ports(task_ports: np.ndarray, port_base: np.ndarray):
    """Fold port columns with identical (claimant, base-usage) patterns
    into one slot. Every engine use of a port column is boolean — the
    conflict test only asks "any overlap" and the
    per-node claim scatter ORs — so ports always claimed/used together
    are indistinguishable and one representative column suffices."""
    stack = np.concatenate([task_ports, port_base], axis=0)
    _, first = np.unique(stack.T, axis=0, return_index=True)
    keep = np.sort(first)
    return task_ports[:, keep], port_base[:, keep]


def build_affinity_inputs(ssn, tasks: Sequence[TaskInfo], device,
                          t_pad: int) -> Optional[AffinityInputs]:
    """Encode the snapshot's affinity/port features, or None when they
    exceed the vocabulary caps (callers fall back to the host path).

    ``tasks`` is the cycle's pending task list (cycle_inputs order);
    ``device`` the DeviceSession whose NodeState fixes the node axis.
    """
    from ..plugins.nodeorder import HARD_POD_AFFINITY_SYMMETRIC_WEIGHT

    state = device.state
    n_pad = state.n_padded
    names = state.names

    # ---- which halves apply (disabled plugins must not enforce) -------
    pred_active = any(
        not opt.predicate_disabled and opt.name in ssn.predicate_fns
        for tier in ssn.tiers for opt in tier.plugins)
    ip_weight = 0.0
    order_active = any(
        not opt.node_order_disabled and opt.name in ssn.node_order_fns
        for tier in ssn.tiers for opt in tier.plugins)
    if order_active:
        ip_weight = _interpod_weight(ssn)

    # ---- collect pairs ------------------------------------------------
    pairs = _PairSpace()
    # pending tasks' terms, keyed by cycle task index
    pend_terms: List[Tuple[int, Pod, list, list, list]] = []
    for i, t in enumerate(tasks):
        pod = t.pod
        aff = pod.affinity
        if aff is None:
            continue
        req = anti = []
        if pred_active:
            req = [(pairs.add(term, pod), term)
                   for term in aff.pod_affinity_required]
            anti = [(pairs.add(term, pod), term)
                    for term in aff.pod_anti_affinity_required]
        pref = []
        if ip_weight != 0.0:
            pref = [(pairs.add(term, pod), float(w))
                    for w, term in aff.pod_affinity_preferred]
            pref += [(pairs.add(term, pod), -float(w))
                     for w, term in aff.pod_anti_affinity_preferred]
        if req or anti or pref:
            pend_terms.append((i, pod, req, anti, pref))
    # existing candidates' anti terms (symmetry) + preferred (score)
    cands = _candidates(ssn)
    cand_terms: List[Tuple[TaskInfo, list, list]] = []
    for t in cands:
        pod = t.pod
        if not pod.has_pod_affinity():
            continue
        aff = pod.affinity
        anti = []
        if pred_active:
            anti = [(pairs.add(term, pod), term)
                    for term in aff.pod_anti_affinity_required]
        carry: List[Tuple[int, float]] = []
        if ip_weight != 0.0:
            carry = [(pairs.add(term, pod), float(w))
                     for w, term in aff.pod_affinity_preferred]
            carry += [(pairs.add(term, pod), -float(w))
                      for w, term in aff.pod_anti_affinity_preferred]
            if HARD_POD_AFFINITY_SYMMETRIC_WEIGHT:
                carry += [(pairs.add(term, pod),
                           float(HARD_POD_AFFINITY_SYMMETRIC_WEIGHT))
                          for term in aff.pod_affinity_required]
        if anti or carry:
            cand_terms.append((t, anti, carry))

    if len(pairs) > RAW_PAIR_LIMIT:
        return None

    # ---- node domains (per topology key; shared by compaction + kernel)
    key_dom: Dict[str, np.ndarray] = {}   # topology key -> [N_pad] ids
    nodes = ssn.nodes
    for key in pairs.keys:
        topo = key[2]
        if topo in key_dom:
            continue
        col = np.full(n_pad, -1, np.int32)
        values: Dict[str, int] = {}
        for col_i, name in enumerate(names):
            ni = nodes.get(name)
            if ni is None or ni.node is None:
                continue
            v = ni.node.labels.get(topo)
            if v is None:
                continue
            col[col_i] = values.setdefault(v, len(values))
        key_dom[topo] = col

    # ---- pair compaction (only past the cap: the common small snapshot
    # pays nothing) — dedupe raw pairs by (group, domain column), remap
    # every collected term index onto the compact space ------------------
    pair_keys: List[Tuple] = pairs.keys
    if len(pairs) > MAX_PAIRS:
        pair_keys, remap = _compact_pairs(pairs.keys, key_dom)
        if len(pair_keys) > MAX_PAIRS:
            return None
        rm = remap.__getitem__
        pend_terms = [
            (i, pod,
             [(rm(p), term) for p, term in req],
             [(rm(p), term) for p, term in anti],
             [(rm(p), w) for p, w in pref])
            for i, pod, req, anti, pref in pend_terms]
        cand_terms = [
            (t, [(rm(p), term) for p, term in anti],
             [(rm(p), w) for p, w in carry])
            for t, anti, carry in cand_terms]

    # ---- ports (a predicate: enforced only when predicates run) -------
    port_ids: Dict[int, int] = {}
    if pred_active:
        for t in tasks:
            for port in t.pod.host_ports():
                if port not in port_ids:
                    port_ids[port] = len(port_ids)
    if len(port_ids) > RAW_PORT_LIMIT:
        return None
    pt = max(1, len(port_ids))

    p_cnt = max(1, len(pair_keys))
    d_pad = n_pad  # distinct domain values per key <= real node count

    node_dom = np.full((p_cnt, n_pad), -1, np.int32)
    for p, key in enumerate(pair_keys):
        node_dom[p] = key_dom[key[2]]

    # ---- membership memo (per label-shape x namespace) ----------------
    member_memo: Dict[Tuple, np.ndarray] = {}

    def membership(pod: Pod) -> np.ndarray:
        sig = getattr(pod, "_kb_aff_lsig", None)
        if sig is None:
            sig = (tuple(sorted(pod.labels.items())), pod.namespace)
            pod._kb_aff_lsig = sig
        row = member_memo.get(sig)
        if row is None:
            row = np.fromiter(
                (_member(k, pod) for k in pair_keys), bool,
                count=len(pair_keys))
            if len(pair_keys) < p_cnt:      # p_cnt >= 1 floor
                row = np.pad(row, (0, p_cnt - len(pair_keys)))
            member_memo[sig] = row
        return row

    # ---- initial carry from candidates --------------------------------
    grp_cnt0 = np.zeros((p_cnt, d_pad), np.float32)
    anti_cnt0 = np.zeros((p_cnt, d_pad), np.float32)
    pref_w0 = np.zeros((p_cnt, d_pad), np.float32)
    grp_total0 = np.zeros(p_cnt, np.float32)
    node_index = state.index
    for t in cands:
        row = membership(t.pod)
        if not row.any():
            continue
        grp_total0 += row
        col = node_index.get(t.node_name)
        if col is None:
            continue
        doms = node_dom[:, col]
        ok = row & (doms >= 0)
        grp_cnt0[ok, doms[ok]] += 1.0
    for t, anti, carry in cand_terms:
        col = node_index.get(t.node_name)
        if col is None:
            continue
        for p, _term in anti:
            d = node_dom[p, col]
            if d >= 0:
                anti_cnt0[p, d] += 1.0
        for p, w in carry:
            d = node_dom[p, col]
            if d >= 0:
                pref_w0[p, d] += w

    # ---- per-task arrays ----------------------------------------------
    task_grp = np.zeros((t_pad, p_cnt), bool)
    task_req_aff = np.zeros((t_pad, p_cnt), bool)
    task_req_anti = np.zeros((t_pad, p_cnt), bool)
    task_self_ok = np.zeros((t_pad, p_cnt), bool)
    task_carry_w = np.zeros((t_pad, p_cnt), np.float32)
    task_pref_w = np.zeros((t_pad, p_cnt), np.float32)
    task_ports = np.zeros((t_pad, pt), bool)
    for i, t in enumerate(tasks):
        task_grp[i] = membership(t.pod)
        for port in t.pod.host_ports():
            task_ports[i, port_ids[port]] = True
    hard_w = float(HARD_POD_AFFINITY_SYMMETRIC_WEIGHT) if ip_weight else 0.0
    for i, pod, req, anti, pref in pend_terms:
        for p, term in req:
            task_req_aff[i, p] = True
            # bootstrap: the pod's own labels/ns satisfy the term
            # (upstream anySchedulable first-pod semantics)
            if term.selects(pod) and pod.namespace in _ns_key(term, pod):
                task_self_ok[i, p] = True
            if hard_w:
                task_carry_w[i, p] += hard_w
        for p, term in anti:
            task_req_anti[i, p] = True
        for p, w in pref:
            task_pref_w[i, p] += w
            task_carry_w[i, p] += w

    # ---- port base from on-node pods ----------------------------------
    port_base = np.zeros((n_pad, pt), bool)
    if port_ids:
        for name, ni in nodes.items():
            col = node_index.get(name)
            if col is None:
                continue
            for t in ni.tasks.values():
                for port in t.pod.host_ports():
                    slot = port_ids.get(port)
                    if slot is not None:
                        port_base[col, slot] = True

    # ---- port compaction (only past the cap, like pairs) ---------------
    if len(port_ids) > MAX_PORTS:
        task_ports, port_base = _fold_ports(task_ports, port_base)
        if task_ports.shape[1] > MAX_PORTS:
            return None

    ip_enabled = bool(ip_weight != 0.0
                      and (np.any(task_pref_w) or np.any(pref_w0)
                           or np.any(task_carry_w)))
    return AffinityInputs(
        node_dom=node_dom, task_grp=task_grp, task_req_aff=task_req_aff,
        task_req_anti=task_req_anti, task_self_ok=task_self_ok,
        task_carry_w=task_carry_w, task_pref_w=task_pref_w,
        task_ports=task_ports, port_base=port_base,
        grp_cnt0=grp_cnt0, anti_cnt0=anti_cnt0, pref_w0=pref_w0,
        grp_total0=grp_total0, ip_weight=ip_weight, ip_enabled=ip_enabled)
