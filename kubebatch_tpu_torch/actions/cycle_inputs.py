"""Cycle tensorization for the whole-cycle device solvers.

Builds every array the fused allocate solve (kernels/fused.py) and the
batched round engine (kernels/batched.py) consume from an open Session:
queue / job / task index spaces, fairness seeds (proportion deserved +
allocated, DRF allocated + cluster total), order-key specs, and the
sig-indexed static predicate/score terms, and for the batched engine the
inter-pod affinity / host-port vocabulary (kernels/affinity.py).  Returns
None when the session carries plugins/features outside the device
vocabulary — callers fall back.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import JobInfo, TaskInfo, TaskStatus, ready_statuses
from ..framework import Session
from ..kernels.fused import (K_DRF_SHARE, K_GANG_READY, K_PRIORITY,
                             K_PROP_SHARE)
from ..kernels.solver import DeviceSession, ensure_device_snapshot
from ..kernels.tensorize import TaskBatch, pad_to_bucket, sticky_bucket
from ..kernels.terms import device_supported, solver_terms

#: job-order plugins the kernels can express, in any tier order
_JOB_KEYS = {"priority": K_PRIORITY, "gang": K_GANG_READY,
             "drf": K_DRF_SHARE}
_QUEUE_KEYS = {"proportion": K_PROP_SHARE}

#: build_cycle_inputs result when the cycle has no schedulable pending
#: tasks at all — callers succeed without doing any work (distinct from
#: None, which means "unsupported, fall back")
EMPTY_CYCLE = "empty-cycle"


def job_order_spec(ssn: Session) -> Tuple[Tuple[str, ...], bool]:
    keys: List[str] = []
    for tier in ssn.tiers:
        for opt in tier.plugins:
            if opt.job_order_disabled or opt.name not in ssn.job_order_fns:
                continue
            key = _JOB_KEYS.get(opt.name)
            if key is None:
                return (), False
            keys.append(key)
    return tuple(keys), True


def queue_order_spec(ssn: Session) -> Tuple[Tuple[str, ...], bool]:
    keys: List[str] = []
    for tier in ssn.tiers:
        for opt in tier.plugins:
            if opt.queue_order_disabled or opt.name not in ssn.queue_order_fns:
                continue
            key = _QUEUE_KEYS.get(opt.name)
            if key is None:
                return (), False
            keys.append(key)
    return tuple(keys), True


def cycle_supported(ssn: Session) -> bool:
    """The whole-cycle kernels express the built-in order/fairness plugins;
    any custom job/queue order, overused, or ready fn falls back to the
    host path.  Predicate / node-order callbacks are checked later by
    kernels/terms (static sig matrices + in-kernel dynamic terms)."""
    _, ok_j = job_order_spec(ssn)
    _, ok_q = queue_order_spec(ssn)
    custom_overused = any(name != "proportion" for name in ssn.overused_fns)
    custom_ready = any(name != "gang" for name in ssn.job_ready_fns)
    return ok_j and ok_q and not custom_overused and not custom_ready


def gang_enabled(ssn: Session) -> bool:
    for tier in ssn.tiers:
        for opt in tier.plugins:
            if not opt.job_ready_disabled and opt.name in ssn.job_ready_fns:
                return True
    return False


def fast_task_sort_spec(ssn: Session) -> Optional[bool]:
    """Whether the session's task order is expressible as a tuple key:
    True = (-priority, creation_timestamp, uid), False = (creation, uid),
    None = a custom task-order fn is registered (per-item cmp path)."""
    names = [opt.name for tier in ssn.tiers for opt in tier.plugins
             if not opt.task_order_disabled
             and opt.name in ssn.task_order_fns]
    if any(n != "priority" for n in names):
        return None
    return bool(names)


def fast_task_sort_key(ssn: Session):
    """A tuple sort key equivalent to ``ssn.task_order_fn`` when the only
    enabled task-order callback is the built-in priority plugin's
    (descending priority, then the session's creation-timestamp/uid
    tie-break) — a key sort is ~10x a cmp_to_key sort over 10k tasks.
    Returns None when a custom task-order fn is registered."""
    spec = fast_task_sort_spec(ssn)
    if spec is None:
        return None
    if spec:
        return lambda t: (-t.priority, t.pod.creation_timestamp, t.uid)
    return lambda t: (t.pod.creation_timestamp, t.uid)


def _gather_pending(ssn: Session, jobs: List[JobInfo]):
    """Per-job gather + task-order sort of the pending, non-BestEffort
    tasks: (tasks, task_job_idx, task_ranks)."""
    tasks: List[TaskInfo] = []
    task_job_idx: List[int] = []
    task_ranks: List[int] = []
    fast_key = fast_task_sort_key(ssn)
    for ji, j in enumerate(jobs):
        pend = [t for t in j.task_status_index.get(TaskStatus.PENDING,
                                                   {}).values()
                if not t.resreq.is_empty()]
        if fast_key is not None:
            pend.sort(key=fast_key)
        else:
            pend.sort(key=functools.cmp_to_key(
                lambda a, b: -1 if ssn.task_order_fn(a, b) else 1))
        for rank, t in enumerate(pend):
            tasks.append(t)
            task_job_idx.append(ji)
            task_ranks.append(rank)
    return tasks, task_job_idx, task_ranks


@dataclass
class CycleInputs:
    """Everything the whole-cycle solves need (numpy, host side), plus
    the host-side indexes to map decisions back to Session objects."""
    # host-side indexes
    queue_ids: List[str]
    jobs: List[JobInfo]
    tasks: List[TaskInfo]
    device: DeviceSession
    # task arrays ([T_pad])
    resreq: np.ndarray
    init_resreq: np.ndarray
    resreq_raw: np.ndarray        # [T,R] f64 host units (bytes memory)
    task_nz: np.ndarray
    task_job: np.ndarray
    task_rank: np.ndarray
    task_sig: np.ndarray
    task_valid: np.ndarray
    # sig arrays ([S_pad, N])
    sig_scores: np.ndarray
    sig_pred: np.ndarray
    # job arrays ([J_pad])
    min_available: np.ndarray
    order_min_available: np.ndarray
    init_allocated: np.ndarray
    job_queue: np.ndarray
    job_priority: np.ndarray
    job_create_rank: np.ndarray
    job_valid: np.ndarray
    # queue arrays ([Q_pad])
    q_weight: np.ndarray
    q_entries: np.ndarray
    q_create_rank: np.ndarray
    q_deserved: np.ndarray
    q_alloc0: np.ndarray
    # drf
    j_alloc0: np.ndarray
    cluster_total: np.ndarray
    # dynamic nodeorder terms
    dyn_weights: np.ndarray
    dyn_enabled: bool
    # order/flag specs
    job_keys: Tuple[str, ...]
    queue_keys: Tuple[str, ...]
    gang_enabled: bool
    prop_overused: bool
    #: False when no node carries releasing resources at cycle start —
    #: lets the batched engine skip all pipeline-fit work
    pipe_enabled: bool = True
    #: inter-pod affinity / host-port vocabulary (kernels/affinity.py
    #: AffinityInputs); None when the snapshot has none (or build_cycle_inputs
    #: was told not to encode them — only the batched engine reads them)
    affinity: Optional[object] = None
    # lazy cache for pair_terms(): (max_pairs budget, result)
    _pair_terms: Optional[tuple] = None

    @property
    def n_tasks_real(self) -> int:
        return len(self.tasks)

    def pair_terms(self, max_pairs: int = 2048):
        """Cohorts for the batched engine's scoring and waterfall at (sig,
        nonzero-request) granularity: tasks in one pair share the static
        sig AND (exactly or within a quantization bucket) the nonzero
        request, so per-pair dynamic node scores equal per-task scores.

        Returns (task_pair [T_pad] int32, pair_sig [P_pad] int32,
        pair_nz [P_pad,2] f32 member mean, exact: bool). When the exact
        pair count exceeds ``max_pairs``, nz is bucketed on a log2 grid,
        coarsening by octave fractions until the count fits. The result
        is cached per budget value. (The reference package's
        CycleInputs.pair_terms, copied.)"""
        if self._pair_terms is not None and self._pair_terms[0] == max_pairs:
            return self._pair_terms[1]
        n_real = len(self.tasks)
        t_pad = self.task_sig.shape[0]
        sig = self.task_sig[:n_real].astype(np.int64)
        nz = self.task_nz[:n_real]
        exact = True
        # bucket fractions: exact first, then 16ths of an octave downward
        for steps in (0, 16, 8, 4, 2, 1):
            if steps == 0:
                key_nz = nz
            else:
                exact = False
                with np.errstate(divide="ignore"):
                    key_nz = np.exp2(
                        np.round(np.log2(np.maximum(nz, 1e-9)) * steps)
                        / steps).astype(np.float32)
            keys = np.concatenate(
                [sig[:, None].astype(np.float64),
                 key_nz.astype(np.float64)], axis=1)
            uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
            if uniq.shape[0] <= max_pairs:
                break
        else:  # pragma: no cover — 1-octave buckets always fit max_pairs
            uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        p = uniq.shape[0]
        p_pad = pad_to_bucket(p, 4)
        pair_sig = np.zeros(p_pad, np.int32)
        pair_sig[:p] = uniq[:, 0].astype(np.int32)
        # member means (exact pairs: mean of identical values = the value)
        counts = np.bincount(inverse, minlength=p_pad).astype(np.float64)
        denom = np.maximum(counts, 1.0)
        pair_nz = np.zeros((p_pad, 2), np.float32)
        for c in range(2):
            pair_nz[:, c] = (np.bincount(inverse, weights=nz[:, c],
                                         minlength=p_pad) / denom)
        task_pair = np.zeros(t_pad, np.int32)
        task_pair[:n_real] = inverse.astype(np.int32)
        result = (task_pair, pair_sig, pair_nz, exact)
        self._pair_terms = (max_pairs, result)
        return result


def build_cycle_inputs(ssn: Session,
                       allow_affinity: bool = False) -> Optional[CycleInputs]:
    """Tensorize the session for a whole-cycle solve, EMPTY_CYCLE when
    nothing is pending, or None when some registered callback / snapshot
    feature can't run on device (callers then fall back without having
    paid the device upload).

    ``allow_affinity``: encode inter-pod affinity / host ports into the
    batched engine's vocabulary (kernels/affinity.py) instead of refusing
    them; the fused engine passes False — its one-placement solve has no
    affinity carry. A vocabulary past the raw collection window or, after
    compaction, past the caps refuses (None), counted in
    metrics.affinity_host_fallback_total as the reference counts it
    (reference actions/cycle_inputs.py:344-437). Runs inside the
    "tensorize" phase span (the decision ledger's pack stage)."""
    from ..obs import span as _span

    with _span("tensorize", cat="phase"):
        return _build_cycle_inputs(ssn, allow_affinity)


def _build_cycle_inputs(ssn: Session,
                        allow_affinity: bool) -> Optional[CycleInputs]:
    # ---- queues ----------------------------------------------------------
    queue_ids = sorted(ssn.queues)          # uid order = order fallback
    q_index = {q: i for i, q in enumerate(queue_ids)}
    q_pad = pad_to_bucket(len(queue_ids), 4)

    # ---- jobs ------------------------------------------------------------
    # Only jobs with pending tasks occupy kernel job rows: the reference
    # pushes every job into its queue PQ (allocate.go:45-63), but popping
    # a job with no pending tasks changes no state — it only burns a queue
    # entry, and q_entries below counts exactly the rows built here. Keeps
    # the job axis at the pending-job count instead of the cluster job
    # count (cfg4: 625 rows instead of 10k+ when running fill pods each
    # carry their own PodGroup).
    jobs: List[JobInfo] = [
        j for j in ssn.jobs.values()
        if j.queue in q_index and TaskStatus.PENDING in j.task_status_index]
    # creation-rank tie-break (creation_timestamp, uid)
    jobs_sorted = sorted(jobs, key=lambda j: (j.creation_timestamp, j.uid))
    j_rank = {j.uid: r for r, j in enumerate(jobs_sorted)}
    # per-cache sticky store (SchedulerCache.pad_sticky): interleaved
    # schedulers in one process must not fight over a shared shape hold;
    # cache fakes without the field fall back to the process-global map
    pad_store = getattr(ssn.cache, "pad_sticky", None)
    j_pad = sticky_bucket("cycle_jobs", len(jobs), 4, store=pad_store)
    j_index = {j.uid: i for i, j in enumerate(jobs)}

    # ---- tasks (pending, non-BestEffort, in task-order per job) ----------
    tasks, task_job_idx, task_ranks = _gather_pending(ssn, jobs)
    if not tasks:
        return EMPTY_CYCLE
    # cheap feature gates BEFORE tensorizing/uploading the cluster — a
    # fallback cycle must not pay the device transfer
    if not device_supported(ssn, tasks, allow_affinity=allow_affinity):
        return None
    aff_wanted = False
    if allow_affinity:
        from ..kernels.affinity import (affinity_features_present,
                                        affinity_within_vocabulary)
        from ..metrics import count_affinity_host_fallback
        if affinity_features_present(ssn, tasks):
            if not affinity_within_vocabulary(ssn, tasks):
                # raw vocabulary past even the compaction window
                count_affinity_host_fallback("allocate-raw-window")
                return None
            aff_wanted = True
    device = ensure_device_snapshot(ssn)
    terms = solver_terms(ssn, device, tasks, assume_supported=True)
    if terms is None:
        return None
    # sticky task-axis bucket: steady churn oscillating across a pow2
    # boundary keeps one padded shape
    t_bucket = sticky_bucket("cycle_tasks", len(tasks), 8, store=pad_store)
    batch = TaskBatch.from_tasks(tasks, min_bucket=t_bucket)
    t_pad = batch.t_padded

    # ---- inter-pod affinity / host ports (batched engine only) -----------
    aff_inputs = None
    if aff_wanted:
        from ..kernels.affinity import build_affinity_inputs
        from ..metrics import count_affinity_host_fallback
        aff_inputs = build_affinity_inputs(ssn, tasks, device, t_pad)
        if aff_inputs is None:
            # inside the raw window but over MAX_PAIRS / MAX_PORTS after
            # compaction (the device snapshot was built: it is cached)
            count_affinity_host_fallback("allocate-compact-cap")
            return None

    # ---- job arrays ------------------------------------------------------
    gang = gang_enabled(ssn)
    min_av = np.zeros(j_pad, np.int32)
    order_min_av = np.zeros(j_pad, np.int32)
    init_alloc = np.zeros(j_pad, np.int32)
    job_queue = np.zeros(j_pad, np.int32)
    job_priority = np.zeros(j_pad, np.float32)
    job_create_rank = np.zeros(j_pad, np.int32)
    job_valid = np.zeros(j_pad, bool)
    for i, j in enumerate(jobs):
        min_av[i] = j.min_available if gang else 0
        order_min_av[i] = j.min_available
        init_alloc[i] = j.count(*ready_statuses())
        job_queue[i] = q_index[j.queue]
        job_priority[i] = j.priority
        job_create_rank[i] = j_rank[j.uid]
        job_valid[i] = True

    # ---- task arrays -----------------------------------------------------
    task_job = np.full(t_pad, -1, np.int32)
    task_rank = np.zeros(t_pad, np.int32)
    task_job[:len(tasks)] = task_job_idx
    task_rank[:len(tasks)] = task_ranks

    # ---- queue arrays ----------------------------------------------------
    q_weight = np.zeros(q_pad, np.float32)
    q_entries = np.zeros(q_pad, np.int32)
    q_create_rank = np.arange(q_pad, dtype=np.int32)
    q_deserved = np.zeros((q_pad, 3), np.float32)
    q_alloc0 = np.zeros((q_pad, 3), np.float32)
    for q, i in q_index.items():
        q_weight[i] = ssn.queues[q].weight
    for j in jobs:
        q_entries[q_index[j.queue]] += 1

    prop = ssn.plugins.get("proportion")
    queue_keys, _ = queue_order_spec(ssn)
    prop_overused = ("proportion" in ssn.overused_fns
                     and any(opt.name == "proportion"
                             for tier in ssn.tiers
                             for opt in tier.plugins))
    if prop is not None and getattr(prop, "queue_opts", None):
        for q, attr in prop.queue_opts.items():
            i = q_index.get(q)
            if i is not None:
                q_deserved[i] = attr.deserved.to_vec()
                q_alloc0[i] = attr.allocated.to_vec()

    # ---- drf arrays ------------------------------------------------------
    job_keys, _ = job_order_spec(ssn)
    j_alloc0 = np.zeros((j_pad, 3), np.float32)
    cluster_total = np.ones(3, np.float32)
    drf = ssn.plugins.get("drf")
    if K_DRF_SHARE in job_keys and drf is not None:
        cluster_total = drf.total_resource.to_vec()
        for j in jobs:
            attr = drf.job_opts.get(j.uid)
            if attr is not None:
                j_alloc0[j_index[j.uid]] = attr.allocated.to_vec()

    # ---- scores / predicates (sig-indexed static + in-kernel dynamic) ---
    task_sig = terms.task_sig(tasks, t_pad)
    s_pad = pad_to_bucket(terms.static.n_sigs, 4)
    sig_scores = np.zeros((s_pad, device.n_padded), np.float32)
    sig_pred = np.zeros((s_pad, device.n_padded), bool)
    sig_scores[:terms.static.n_sigs] = terms.static.score
    sig_pred[:terms.static.n_sigs] = terms.static.pred
    dyn_enabled = terms.dynamic.enabled
    dyn_weights = np.asarray([terms.dynamic.least_requested,
                              terms.dynamic.balanced_resource], np.float32)

    return CycleInputs(
        queue_ids=queue_ids, jobs=jobs, tasks=tasks, device=device,
        resreq=batch.resreq, init_resreq=batch.init_resreq,
        resreq_raw=batch.resreq_raw,
        task_nz=batch.nz_req, task_job=task_job, task_rank=task_rank,
        task_sig=task_sig, task_valid=batch.valid,
        sig_scores=sig_scores, sig_pred=sig_pred,
        min_available=min_av, order_min_available=order_min_av,
        init_allocated=init_alloc, job_queue=job_queue,
        job_priority=job_priority, job_create_rank=job_create_rank,
        job_valid=job_valid,
        q_weight=q_weight, q_entries=q_entries, q_create_rank=q_create_rank,
        q_deserved=q_deserved, q_alloc0=q_alloc0,
        j_alloc0=j_alloc0, cluster_total=cluster_total,
        dyn_weights=dyn_weights, dyn_enabled=dyn_enabled,
        job_keys=job_keys, queue_keys=queue_keys, gang_enabled=gang,
        prop_overused=prop_overused,
        # the DeviceSession's numpy mirror holds every node's releasing
        # vector in lock-step with host truth
        pipe_enabled=bool(np.any(device.state.releasing > 0.0)),
        affinity=aff_inputs)


def _segment_lists(cols: np.ndarray):
    """Group array positions by value: [(value, [positions...]), ...] with
    positions ascending within each group. One argsort + one tolist +
    list slicing — building a numpy array per group (np.split) costs more
    than the whole grouped pass at a few thousand groups."""
    n = len(cols)
    if not n:
        return []
    order = np.argsort(cols, kind="stable")
    sorted_cols = cols[order]
    cuts = (np.nonzero(np.diff(sorted_cols))[0] + 1).tolist()
    order_l = order.tolist()
    starts = [0] + cuts
    ends = cuts + [n]
    vals = sorted_cols[starts].tolist()
    return [(v, order_l[a:b]) for v, a, b in zip(vals, starts, ends)]


#: event-handler owners the bulk replay can apply as aggregates (drf /
#: proportion: share sums) or collapse to one call (nodeorder / predicates:
#: idempotent memo invalidation)
_BULK_EVENT_OWNERS = frozenset({"drf", "proportion", "nodeorder",
                                "predicates"})


def replay_decisions(ssn: Session, inputs: CycleInputs,
                     task_state: np.ndarray, task_node: np.ndarray,
                     task_seq: np.ndarray) -> None:
    """Apply a whole-cycle kernel's decisions through the Session so host
    plugin state, event handlers, and the gang dispatch barrier end up in
    the same state the per-visit path would produce.

    Two implementations with identical final state: the exact per-event
    replay (one ssn.allocate/pipeline per decision, in kernel assignment
    order) and a bulk path that applies the same mutations as per-job /
    per-node / per-queue aggregates. The bulk path only runs when every
    registered event handler is a recognized built-in and the volume
    binder is the no-op default — anything custom gets the per-event
    ordering it may depend on."""
    from ..obs import span as _span

    bulk = _bulk_replay_supported(ssn)
    with _span("replay", cat="phase", bulk=bulk):
        if bulk:
            _replay_bulk(ssn, inputs, task_state, task_node, task_seq)
        else:
            _replay_ordered(ssn, inputs, task_state, task_node, task_seq)


def rebase_inputs(ssn: Session, inputs: CycleInputs,
                  task_state: np.ndarray) -> bool:
    """Point ``inputs``' host indexes (jobs, tasks) at THIS session's
    clones before a deferred replay (ref: the reference package's
    ``rebase_inputs``).

    The pipelined executor replays cycle N's decisions into session N+1,
    but the inputs hold session N's clones; OpenSession cloned afresh, so
    the replay must go through session N+1's objects, found by uid (the
    lookup the Session's mutators use). Returns False, and the caller
    invalidates instead of replaying, when a PLACED task (or its job) no
    longer resolves as pending here: the cache moved under the flight in
    a way the conflict check did not see. Rows not placed are only read
    (FAIL fit deltas), so a vanished one keeps its old object."""
    from ..kernels.fused import ALLOC, ALLOC_OB, PIPELINE

    state = np.asarray(task_state)[:len(inputs.tasks)]
    placed = ((state == ALLOC) | (state == ALLOC_OB)
              | (state == PIPELINE)).tolist()
    jobs = [ssn.jobs.get(j.uid, j) for j in inputs.jobs]
    tasks = list(inputs.tasks)
    for i, t in enumerate(tasks):
        job = ssn.jobs.get(t.job)
        cur = None if job is None else job.tasks.get(t.uid)
        if cur is None or (placed[i] and cur.status != TaskStatus.PENDING):
            if placed[i]:
                return False
            continue
        tasks[i] = cur
    inputs.jobs = jobs
    inputs.tasks = tasks
    return True


def _bulk_replay_supported(ssn: Session) -> bool:
    from ..cache.interface import NullVolumeBinder

    if type(getattr(ssn.cache, "volume_binder", None)) is not NullVolumeBinder:
        return False
    if not hasattr(ssn.cache, "bind_many"):
        return False
    return all(eh.owner in _BULK_EVENT_OWNERS for eh in ssn.event_handlers)


def _replay_ordered(ssn: Session, inputs: CycleInputs,
                    task_state: np.ndarray, task_node: np.ndarray,
                    task_seq: np.ndarray) -> None:
    from ..kernels.fused import ALLOC, ALLOC_OB, FAIL, PIPELINE, SKIP
    from ..metrics import count_slow_path_items

    device = inputs.device
    tasks = inputs.tasks
    order = [i for i in range(len(tasks)) if task_state[i] != SKIP]
    order.sort(key=lambda i: task_seq[i])
    count_slow_path_items("replay", len(order))
    try:
        for i in order:
            task = tasks[i]
            kind = int(task_state[i])
            if kind in (ALLOC, ALLOC_OB, PIPELINE):
                node_name = device.node_name(int(task_node[i]))
                if kind == PIPELINE:
                    ssn.pipeline(task, node_name)
                else:
                    ssn.allocate(task, node_name, kind == ALLOC_OB)
            elif kind == FAIL:
                # fit-delta diagnostics for the task that broke its job,
                # against node state at failure time (host nodes mirror the
                # kernel here)
                job = ssn.jobs.get(task.job)
                if job is not None:
                    ssn.touched_jobs.add(job.uid)
                    job.nodes_fit_delta = {}
                    for node in ssn.nodes.values():
                        delta = node.idle.clone()
                        delta.fit_delta(task.resreq)
                        job.nodes_fit_delta[node.name] = delta
    except Exception:
        # host replay stopped mid-way (e.g. volume allocation failure):
        # device state holds phantom allocations — rebuild from host truth
        device.resync(ssn.nodes)
        raise


def _replay_bulk(ssn: Session, inputs: CycleInputs,
                 task_state: np.ndarray, task_node: np.ndarray,
                 task_seq: np.ndarray) -> None:
    """Aggregate application of kernel decisions. Per decision it performs
    exactly the mutations Session.allocate/pipeline/dispatch would, inlined
    (no per-task validate / net-zero arithmetic / per-bind locking), with
    the gang dispatch barrier precomputed per job (readiness is monotone in
    this replay, so the final count decides) — a task of a ready job flips
    PENDING -> ALLOCATED -> BINDING in one index move. Event-handler
    effects apply as per-job / per-queue sums afterwards."""
    from ..api import Resource
    from ..api.types import TaskStatus
    from ..kernels.fused import ALLOC, ALLOC_OB, FAIL, PIPELINE

    device = inputs.device
    tasks = inputs.tasks
    n = len(tasks)
    state = task_state[:n]
    placed_sel = np.nonzero((state == ALLOC) | (state == ALLOC_OB)
                            | (state == PIPELINE))[0]
    placed_sel = placed_sel[np.argsort(task_seq[placed_sel], kind="stable")]
    fail_sel = np.nonzero(state == FAIL)[0]

    # incremental-snapshot bookkeeping: this path inlines the Session
    # mutators, so it records the touched entities itself
    names = device.state.names
    placed_list = placed_sel.tolist()
    placed_nodes_l = task_node[placed_sel].tolist()
    ssn.touched_jobs.update(tasks[i].job for i in placed_list)
    ssn.touched_nodes.update(names[n] for n in placed_nodes_l)
    ssn.touched_jobs.update(tasks[i].job for i in fail_sel.tolist())

    # --- per-job dispatch barrier, vectorized (gang semantics) ----------
    # The ordered path only checks readiness inside ssn.allocate, so the
    # deciding count is readiness AS OF THE JOB'S LAST ALLOCATE EVENT —
    # a PIPELINE event that crosses the quorum afterwards must NOT cause
    # a dispatch (session.pipeline has no dispatch step). ready_task_num
    # = count at session open (init_allocated is built as exactly that) +
    # ALLOC/PIPELINE events up to that seq (ALLOC_OB counts toward
    # AlmostReady only). cycle_supported() guarantees the only possible
    # job-ready fn is gang's.
    placed_states = state[placed_sel]
    placed_job_idx = inputs.task_job[placed_sel]
    placed_seq = task_seq[placed_sel]
    j_pad = inputs.order_min_available.shape[0]
    if gang_enabled(ssn):
        alloc_ev = (placed_states == ALLOC) | (placed_states == ALLOC_OB)
        last_alloc_seq = np.full(j_pad, np.iinfo(np.int64).min, np.int64)
        np.maximum.at(last_alloc_seq, placed_job_idx[alloc_ev],
                      placed_seq[alloc_ev].astype(np.int64))
        ready_ev = (placed_states == ALLOC) | (placed_states == PIPELINE)
        re_jobs = placed_job_idx[ready_ev]
        in_time = (placed_seq[ready_ev].astype(np.int64)
                   <= last_alloc_seq[re_jobs])
        ready_count = inputs.init_allocated + np.bincount(
            re_jobs[in_time], minlength=j_pad).astype(np.int32)
        job_ready = ready_count >= inputs.order_min_available
    else:
        # no enabled ready fn: every job is Ready (session.py:190-192)
        job_ready = np.ones(j_pad, bool)

    binding = TaskStatus.BINDING
    status_of = {int(ALLOC): TaskStatus.ALLOCATED,
                 int(ALLOC_OB): TaskStatus.ALLOCATED_OVER_BACKFILL,
                 int(PIPELINE): TaskStatus.PIPELINED}
    nodes = ssn.nodes
    pending = TaskStatus.PENDING

    # --- vectorized arithmetic: per-node / per-job float64 sums ---------
    # The ordered path applies one Resource.add/sub per placement; the sums
    # here are the same values in a different addition order (f64, far
    # below the fit epsilons). Memory stays in BYTES via resreq_raw.
    p_nodes = task_node[placed_sel].astype(np.int64)
    p_jobs_idx = placed_job_idx.astype(np.int64)
    is_pipe = placed_states == PIPELINE
    n_cols = int(p_nodes.max()) + 1 if len(p_nodes) else 0
    sub_idle = np.zeros((n_cols, 3))
    sub_rel = np.zeros((n_cols, 3))
    add_used = np.zeros((n_cols, 3))
    p_raw = inputs.resreq_raw[placed_sel]
    np.add.at(sub_idle, p_nodes[~is_pipe], p_raw[~is_pipe])
    np.add.at(sub_rel, p_nodes[is_pipe], p_raw[is_pipe])
    np.add.at(add_used, p_nodes, p_raw)
    # job.allocated counts the allocated-status family: ALLOC stays in it
    # whether or not it dispatches to BINDING (both allocated statuses)
    is_alloc_ev2 = placed_states == ALLOC
    j_cols = int(p_jobs_idx.max()) + 1 if len(p_jobs_idx) else 0
    job_alloc_add = np.zeros((j_cols, 3))
    np.add.at(job_alloc_add, p_jobs_idx[is_alloc_ev2], p_raw[is_alloc_ev2])
    # event handlers see every placement (pipeline fires allocate events
    # too, session.py:321) — keyed by placement COUNT, not value, so
    # zero-resource placements still fire the epoch-memo handlers
    job_event_add = np.zeros((j_cols, 3))
    np.add.at(job_event_add, p_jobs_idx, p_raw)
    job_event_cnt = np.bincount(p_jobs_idx, minlength=j_cols)

    #: job uid -> (JobInfo, job index) for jobs that saw >=1 ALLOC/ALLOC_OB
    alloc_jobs: Dict[str, tuple] = {}
    #: (task, hostname) for cache.bind_many, in assignment order
    bindings: List[tuple] = []
    #: rare: backfill-annotated placements (per-task Resource add)
    backfill_adds: List[tuple] = []

    try:
        from ..kernels.tensorize import batch_clone_tasks, batch_set_attr

        placed_tasks = [tasks[i] for i in placed_list]
        # CoW ownership: the gathered task objects may still be shared
        # with cache truth (JobInfo.clone is copy-on-write) — own every
        # placed job ONCE and rebind to its canonical task objects
        # before the first attribute write below (batch_set_attr)
        p_jobs_l = p_jobs_idx.tolist()
        for ji in set(p_jobs_l):
            inputs.jobs[int(ji)]._own_tasks()
        placed_tasks = [inputs.jobs[int(ji)].tasks.get(t.uid, t)
                        for ji, t in zip(p_jobs_l, placed_tasks)]
        placed_kinds_l = placed_states.tolist()
        is_pipe_l = is_pipe.tolist()
        node_names_l = [names[c] for c in placed_nodes_l]
        placed_keys = [t.key for t in placed_tasks]
        placed_uids = [t.uid for t in placed_tasks]

        # --- pre-validation: resolve every lookup BEFORE any mutation so
        #     a bad decision (vanished node, duplicate key) cannot leave
        #     the batch half-applied with the arithmetic sums never
        #     landing; inside the try so the failure path still resyncs
        #     the device snapshot (it holds the kernel's placements).
        #     Tasks come from the jobs the tensorizer indexed, so the job
        #     objects resolve by construction (inputs.jobs) -------------
        node_by_col = {c: nodes.get(names[c])
                       for c in np.unique(p_nodes).tolist()}
        for k, col in enumerate(placed_nodes_l):
            if node_by_col[col] is None and not is_pipe_l[k]:
                raise KeyError(f"failed to find node {node_names_l[k]}")
        # duplicate-key check as set ops per node (in-batch + vs the
        # existing map); only a detected conflict pays a per-item walk to
        # reproduce the ordered path's error message. Segment index lists
        # come from ONE tolist + slicing — a numpy array per segment
        # costs more than the whole grouped pass
        segments = _segment_lists(p_nodes)
        for col, seg_l in segments:
            node = node_by_col[col]
            if node is None:
                continue
            key_set = {placed_keys[i] for i in seg_l}
            if len(key_set) != len(seg_l) or (key_set & node.tasks.keys()):
                seen: set = set()
                for i in seg_l:
                    t = placed_tasks[i]
                    if t.key in node.tasks or t.key in seen:
                        raise KeyError(f"task <{t.namespace}/{t.name}> "
                                       f"already on node <{node.name}>")
                    seen.add(t.key)

        # --- batch mutation: per-placement attribute flips and clones as
        #     native column ops (kernels/tensorize batch helpers); dict
        #     index moves grouped per node / per job --------------------
        pre_status = [status_of[k] for k in placed_kinds_l]
        disp = (placed_states == ALLOC) & job_ready[placed_job_idx]
        disp_l = disp.tolist()
        final_status = [binding if d else s
                        for s, d in zip(pre_status, disp_l)]
        nonpipe_tasks = (placed_tasks if not is_pipe.any()
                         else [t for t, p in zip(placed_tasks, is_pipe_l)
                               if not p])
        if nonpipe_tasks:
            # allocate_volumes: the bulk gate guarantees the Null volume
            # binder, whose only effect is this flag
            batch_set_attr(nonpipe_tasks, "volume_ready", True)
        for ji in np.unique(p_jobs_idx[~is_pipe]).tolist():
            job = inputs.jobs[int(ji)]
            alloc_jobs[job.uid] = (job, int(ji))

        # the node clones carry allocation-time status, like the ordered
        # path where dispatch happens after add_task; the session tasks
        # then flip to their final (possibly dispatched) status
        clones = batch_clone_tasks(placed_tasks, pre_status, node_names_l)
        batch_set_attr(placed_tasks, "node_name", node_names_l)
        batch_set_attr(placed_tasks, "status", final_status)
        # bind_volumes is a no-op on the Null volume binder
        bindings.extend((placed_tasks[i], node_names_l[i])
                        for i, d in enumerate(disp_l) if d)

        # --- node task maps (NodeInfo.add_task minus the arithmetic,
        #     which the vectorized sums above cover) --------------------
        backfill_l = [t.is_backfill for t in placed_tasks]
        has_backfill = True in backfill_l
        # the per-pod affinity walk runs only when a placed pod CAN carry
        # a term: inputs.affinity is None alone does not prove that (with
        # the predicates AND nodeorder plugins disabled such pods reach
        # the solve), so screen with the per-job counters too
        aff_l = None
        if inputs.affinity is not None or any(
                inputs.jobs[int(ji)].affinity_tasks
                for ji in np.unique(p_jobs_idx).tolist()):
            aff_l = [t.pod.has_pod_affinity() for t in placed_tasks]
        for col, seg_l in segments:
            node = node_by_col[col]
            if node is None:
                continue
            if has_backfill and node.node is not None:
                for i in seg_l:
                    if backfill_l[i]:
                        backfill_adds.append((node, placed_tasks[i].resreq))
            if aff_l is not None:
                node.affinity_tasks += sum(aff_l[i] for i in seg_l)
            node._own_tasks()
            node.tasks.update((placed_keys[i], clones[i]) for i in seg_l)

        # --- job status index moves + priority restamp, grouped --------
        for jcol, seg_l in _segment_lists(p_jobs_idx):
            job = inputs.jobs[jcol]
            index = job.task_status_index
            pend = index.get(pending)
            if pend is not None:
                if len(seg_l) == len(pend) and all(
                        placed_uids[i] in pend for i in seg_l):
                    # the batch drains the job's whole pending bucket (a
                    # full gang placing at once — the steady common
                    # case): one dict drop instead of per-task pops
                    del index[pending]
                else:
                    for i in seg_l:
                        pend.pop(placed_uids[i], None)
                    if not pend:
                        del index[pending]
            for i in seg_l:
                st = final_status[i]
                bucket = index.get(st)
                if bucket is None:
                    bucket = index[st] = {}
                bucket[placed_uids[i]] = placed_tasks[i]
            # the ordered path restamps job.priority at every placement
            # whose pod carries an explicit priority — the last one (in
            # kernel seq order) wins
            for i in reversed(seg_l):
                if placed_tasks[i].pod.priority is not None:
                    job.priority = placed_tasks[i].priority
                    break

        # --- apply the vectorized sums --------------------------------
        for col in np.nonzero(add_used.any(axis=1))[0]:
            node = nodes.get(device.node_name(int(col)))
            if node is None or node.node is None:
                continue
            node.idle.sub_vec(sub_idle[col])
            node.releasing.sub_vec(sub_rel[col])
            node.used.add_vec(add_used[col])
        for node, rr in backfill_adds:
            node.backfilled.add(rr)
        job_event_sum: Dict[str, Resource] = {}
        for col in np.nonzero(job_event_cnt)[0]:
            job = inputs.jobs[int(col)]
            job.allocated.add_vec(job_alloc_add[col])
            job_event_sum[job.uid] = Resource.empty().add_vec(
                job_event_add[col])

        if bindings:
            ssn.cache.bind_many(bindings)
        _apply_event_aggregates(ssn, job_event_sum)
        _dispatch_ready_jobs(ssn, alloc_jobs, job_ready)
        if len(fail_sel):
            _record_fit_deltas(ssn, inputs, state, task_node, task_seq,
                               placed_sel, fail_sel)
    except Exception:
        device.resync(ssn.nodes)
        raise


def _apply_event_aggregates(ssn: Session,
                            job_event_sum: Dict[str, "Resource"]) -> None:
    """Net effect of the built-in drf/proportion allocate handlers: shares
    recompute from sums, so applying per-job / per-queue totals and
    updating each touched share once matches the per-event final state."""
    if not job_event_sum:
        return
    owners = {eh.owner for eh in ssn.event_handlers}
    drf = ssn.plugins.get("drf") if "drf" in owners else None
    prop = ssn.plugins.get("proportion") if "proportion" in owners else None
    # nodeorder/predicates handlers only invalidate per-epoch memos — one
    # firing is equivalent to one per event
    for eh in ssn.event_handlers:
        if eh.owner in ("nodeorder", "predicates") and eh.allocate_func:
            from ..framework.event import Event
            eh.allocate_func(Event(None))
    if drf is not None:
        touched_attrs = []
        for job_uid, total in job_event_sum.items():
            attr = drf.job_opts.get(job_uid)
            if attr is not None:
                attr.allocated.add(total)
                touched_attrs.append(attr)
        if touched_attrs:
            # dominant_share over all touched jobs as one array op; the
            # f64 divisions/max are bitwise the per-attr Python values
            # (share semantics: 0/0 -> 0, x/0 -> 1)
            alloc = np.array(
                [(a.allocated.milli_cpu, a.allocated.memory,
                  a.allocated.milli_gpu) for a in touched_attrs])
            tot = drf.total_resource
            denom = np.array([tot.milli_cpu, tot.memory, tot.milli_gpu])
            zero_d = denom == 0.0
            sh = np.where(zero_d, np.where(alloc == 0.0, 0.0, 1.0),
                          alloc / np.where(zero_d, 1.0, denom))
            for a, s in zip(touched_attrs, sh.max(axis=1).tolist()):
                a.share = s
    if prop is not None:
        touched = {}
        for job_uid, total in job_event_sum.items():
            job = ssn.jobs.get(job_uid)
            if job is None or job.queue not in prop.queue_opts:
                continue
            attr = prop.queue_opts[job.queue]
            attr.allocated.add(total)
            touched[job.queue] = attr
        for attr in touched.values():
            prop._update_share(attr)


def _dispatch_ready_jobs(ssn: Session, alloc_jobs: Dict[str, tuple],
                         job_ready: np.ndarray):
    """Straggler sweep of the gang dispatch barrier: tasks this replay
    placed are dispatched inline by _replay_bulk, but a job that became
    Ready may still hold ALLOCATED tasks from an EARLIER action of the same
    session — the ordered path's per-allocation dispatch loop
    (session.py:340-343) would bind those too. Readiness comes from the
    same as-of-last-allocate flags the inline dispatch used, NOT the final
    session state (a later PIPELINE crossing must not dispatch)."""
    from ..api.types import TaskStatus

    bindings = []
    flips = []
    for job, ji in alloc_jobs.values():
        allocated = job.task_status_index.get(TaskStatus.ALLOCATED)
        if not allocated or not job_ready[ji]:
            continue
        for task in allocated.values():
            ssn.cache.bind_volumes(task)
            bindings.append((task, task.node_name))
            flips.append((job, task))
    if not bindings:
        return
    ssn.cache.bind_many(bindings)
    binding = TaskStatus.BINDING
    for job, task in flips:
        index = job.task_status_index
        bucket = index.get(TaskStatus.ALLOCATED)
        if bucket is not None:
            bucket.pop(task.uid, None)
            if not bucket:
                del index[TaskStatus.ALLOCATED]
        task.status = binding
        index.setdefault(binding, {})[task.uid] = task
        # ALLOCATED and BINDING both count as allocated: job.allocated is
        # net-unchanged, and skipping the sub/add avoids float drift


def _record_fit_deltas(ssn: Session, inputs: CycleInputs, state: np.ndarray,
                       task_node: np.ndarray, task_seq: np.ndarray,
                       placed_sel: np.ndarray, fail_sel: np.ndarray) -> None:
    """nodes_fit_delta diagnostics with ordered-replay parity: the ordered
    path overwrites job.nodes_fit_delta at every FAIL, so only the LAST
    failed task per job (by kernel seq) is visible, measured against node
    idle state at that point of the replay. Reconstructs those intermediate
    idle states by walking placements backward from the final state."""
    from ..api import Resource
    from ..api.resource import (MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_GPU)
    from ..kernels.fused import PIPELINE

    tasks = inputs.tasks
    device = inputs.device

    # last FAIL per job, processed in descending seq
    last_fail: Dict[str, int] = {}
    for i in sorted(fail_sel, key=lambda i: task_seq[i]):
        if ssn.jobs.get(tasks[i].job) is not None:
            last_fail[tasks[i].job] = i
    if not last_fail:
        return
    fails = sorted(last_fail.values(), key=lambda i: -task_seq[i])

    node_list = list(ssn.nodes.values())
    row = {node.name: r for r, node in enumerate(node_list)}
    idle = np.array([[nd.idle.milli_cpu, nd.idle.memory, nd.idle.milli_gpu]
                     for nd in node_list], dtype=np.float64)
    max_tasks = [nd.idle.max_task_num for nd in node_list]

    # placements that consumed idle (pipeline reuses releasing instead),
    # walked backward
    idle_placed = [i for i in placed_sel if int(state[i]) != int(PIPELINE)]
    p = len(idle_placed) - 1
    eps = np.array([MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_GPU])
    for fi in fails:
        fseq = task_seq[fi]
        while p >= 0 and task_seq[idle_placed[p]] > fseq:
            t = tasks[idle_placed[p]]
            r = row.get(device.node_name(int(task_node[idle_placed[p]])))
            if r is not None:
                idle[r, 0] += t.resreq.milli_cpu
                idle[r, 1] += t.resreq.memory
                idle[r, 2] += t.resreq.milli_gpu
            p -= 1
        task = tasks[fi]
        req = np.array([task.resreq.milli_cpu, task.resreq.memory,
                        task.resreq.milli_gpu])
        delta = np.where(req > 0, idle - (req + eps), idle)
        job = ssn.jobs[task.job]
        job.nodes_fit_delta = {}
        for r, node in enumerate(node_list):
            d = object.__new__(Resource)
            d.milli_cpu = float(delta[r, 0])
            d.memory = float(delta[r, 1])
            d.milli_gpu = float(delta[r, 2])
            d.max_task_num = max_tasks[r]
            job.nodes_fit_delta[node.name] = d
