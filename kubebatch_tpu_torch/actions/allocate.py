"""allocate — the primary scheduling action.

Solver modes (constructor arg; the scheduler loop's ``solver=``):
- "auto" (default): the reference package's size-based choice — at or
  above AUTO_HIER_MIN_NODES nodes "hier" (with the active-set engine
  allowed to claim steady cycles first), below it "fused" under
  AUTO_BATCHED_MIN pending tasks and "batched" at or above, upgraded to
  "sharded" at AUTO_SHARDED_MIN_NODES nodes or more when the action has
  a node mesh of more than one rank (the reference: more than one
  visible device).
- "fused": the whole cycle as ONE device solve (kernels/fused.py) —
  queue/job/task selection and fairness state live in the solve, bit-exact
  vs the host heap algorithm; the host replays the decisions through
  Session.allocate/pipeline so plugins and the gang barrier observe
  identical events.
- "batched": the round engine (kernels/batched.py) as ONE device solve —
  many placements per round, every round on the device; the same replay.
  Exact in capacity, predicates and gang semantics, round-granular in
  ordering (its docstring states the contract). It carries inter-pod
  affinity and host ports (kernels/affinity.py); "fused" does not.
- "sharded": the round engine with its node axis split over the
  action's node mesh (kernels/batched_sharded.py; ranks > 0 serve,
  parallel/worker.py), inter-pod affinity and host ports included (the
  [P,D] domain carry replicated, the port claims on each node's owner).
  No mesh or a one-rank mesh demotes to "batched" (counted).
- "hier": the two-level engine (kernels/hier.py): the round engine run
  wave by wave on one node pool at a time, as ONE device solve. An
  affinity cycle demotes to "batched" (counted), as in the reference,
  or with a node mesh of more than one rank to "sharded" (counted as
  ("hier", "sharded")).
- "activeset": the active-set engine (kernels/activeset.py) claims the
  cycle when its active set fits a grain, else "hier" runs.
- "jax": one device scan per job visit (kernels/solver.py
  ``DeviceSession.solve_job``: one launch of csrc/allocate_scan.cu and
  one counted copy back per visit) inside the reference's queue / job
  loops — the route of every cycle whose plugins no whole-cycle engine
  expresses.
- "host": the reference-literal per-pair loops — the semantic oracle.
- "rpc" and "native" as requests: not in this package
  (NotImplementedError naming their ROADMAP items). The rpc mode's wire
  and the tenant solve service are ported (rpc/, tenantsvc/); what it
  still lacks is the grpc transport.

Each cycle first asks the degradation ladder (faults.LADDER.cap_engine)
for the engine its level allows, as the reference does; a capped engine
is counted in engine_demotions_total. On a CUDA cache the cap never
reaches the host loops (faults.CARD_MAX_LEVEL).

A cycle outside the requested whole-cycle engine's vocabulary (custom
job/queue order, overused or ready plugins; affinity or host ports for
"fused"; the affinity vocabulary past the batched caps) takes the
reference's route (its allocate.py:190-210 and :345-361): the engine
refuses without consuming state, the demotion is counted (fused -> visit,
batched -> visit), and the queue / job loops run with the strict
terms.device_supported gate over the pending tasks deciding each cycle's
visits. Where it holds, every visit is the per-visit device scan
(``last_cycle_engine`` "<mode>-visit": "fused-visit", "batched-visit",
"jax-visit"); where it fails (inter-pod affinity or host ports, a volume
binder, predicate or order plugins outside the device terms), the host
loops ("host-visit", the gate's reason in last_host_reason). Both on any
cache.

ref: pkg/scheduler/actions/allocate/allocate.go. Control flow is preserved
exactly (queue PQ with one entry per job, overused queues dropped, one job
per queue visit, job re-pushed only when it crosses readiness, job dropped
on first unassignable task, queue re-pushed after every visit).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import obs
from ..api import JobInfo, TaskInfo, TaskStatus
from ..device import on_card
from ..faults import LADDER as _LADDER
from ..faults import check as _fault_check
from ..framework import (Action, Session, VolumeAllocationError,
                         register_action)
from ..metrics import count_engine_demotion
from ..util import PriorityQueue, select_best_node

#: the reference package's auto mode switches to its batched engine at
#: this many pending tasks
AUTO_BATCHED_MIN = 512

#: ... and to its two-level engine at this many nodes
AUTO_HIER_MIN_NODES = 16384

#: auto mode upgrades batched -> sharded when a node mesh of more than
#: one rank is attached AND the node axis is at least this large (the
#: reference's threshold, keyed on its visible device count)
AUTO_SHARDED_MIN_NODES = 512

MODES = ("auto", "fused", "batched", "sharded", "hier", "activeset", "jax",
         "host")

#: modes of the reference this package does not have, with the ROADMAP
#: items that bring them
NOT_PORTED = {
    "rpc": "the solver's grpc transport, ROADMAP queue A, A8 (the wire "
           "codec and the tenant service are ported: sim/tenants.py drives "
           "a cycle through them in process)",
    "native": "the native packer, ROADMAP queue A, A7",
}

#: engine that consumed the last allocate cycle in this process
#: ("fused" / "batched" / "sharded" / "hier" / "activeset" /
#: "<mode>-visit" /
#: "host-visit") — a fallback
#: off the whole-cycle engines shows here
last_cycle_engine: str = ""

#: why the last "host-visit" cycle ran the host loops ("mode='host'", or
#: the strict device_supported gate's reason: "dynamic_features: ..."
#: for inter-pod affinity and host ports)
last_host_reason: str = ""


def _effective_min_available(ssn: Session, job: JobInfo) -> int:
    """The readiness threshold the scan enforces: with a job-ready fn
    installed (gang), the job's MinAvailable; with none, the session
    defaults to Ready (ref: session_plugins.go:167-186), threshold 0."""
    for tier in ssn.tiers:
        for plugin in tier.plugins:
            if plugin.job_ready_disabled:
                continue
            if plugin.name in ssn.job_ready_fns:
                return int(job.min_available)
    return 0


def _init_allocated(job: JobInfo) -> int:
    """Initial ready-task count for the scan's in-kernel readiness."""
    from ..api import ready_statuses
    return job.count(*ready_statuses())


class AllocateAction(Action):
    """``mesh``: a node mesh (parallel/mesh.py) on rank 0 of a group
    whose other ranks serve (parallel/worker.py); with one of more than
    one rank, mode "sharded" and the auto upgrade run the node-sharded
    engine (kernels/batched_sharded.py) over it. Without one, "sharded"
    demotes to batched, counted, as on the reference's one-device
    host."""

    def __init__(self, mode: Optional[str] = None, mesh=None):
        mode = mode or "auto"
        self.mesh = mesh
        if mode in NOT_PORTED:
            raise NotImplementedError(
                f"allocate mode {mode!r} needs {NOT_PORTED[mode]}: not "
                f"ported yet")
        if mode not in MODES:
            raise ValueError(f"allocate mode {mode!r} is not one of {MODES}")
        self.mode = mode

    @property
    def name(self) -> str:
        return "allocate"

    def _auto_mode(self, ssn: Session) -> str:
        """Size-based engine selection with the reference package's
        thresholds, keyed on the node axis first: a cluster-scale axis
        runs the two-level family at every churn level; a batched-sized
        cycle on a node axis of AUTO_SHARDED_MIN_NODES or more runs
        sharded when the action's mesh has more than one rank (the
        reference: more than one visible device)."""
        from ..parallel.mesh import world_size

        if len(ssn.nodes) >= AUTO_HIER_MIN_NODES:
            return "hier"
        pending = sum(
            len(j.task_status_index.get(TaskStatus.PENDING, {}))
            for j in ssn.jobs.values())
        if pending < AUTO_BATCHED_MIN:
            return "fused"
        if len(ssn.nodes) >= AUTO_SHARDED_MIN_NODES \
                and world_size(self.mesh) > 1:
            return "sharded"
        return "batched"

    def execute(self, ssn: Session) -> None:
        global last_cycle_engine
        mode = self._auto_mode(ssn) if self.mode == "auto" else self.mode
        # the degradation ladder's cap (faults.py): the one consult site,
        # counted in engine_demotions_total when it caps; on a CUDA cache
        # the cap stops at the card's last tier ("fused")
        wanted = mode
        mode = _LADDER.cap_engine(mode, on_card(ssn.cache))
        if wanted in ("hier", "activeset") and mode == "batched" \
                and len(ssn.nodes) >= AUTO_HIER_MIN_NODES:
            # a demoted two-level cycle skips the flat batched engine
            # (its [T, N] state at this node count is what the two-level
            # split avoids) for the fused tier, as the reference does
            count_engine_demotion("batched", "fused")
            mode = "fused"
        if mode in ("batched", "sharded", "hier", "activeset", "fused"):
            from .allocate_batched import execute_batched
            from .allocate_fused import execute_fused
            from .cycle_inputs import cycle_supported
            # the engine that ran, or False without consuming state when
            # the snapshot carries features the solve can't model
            if not cycle_supported(ssn):
                ran = False
            elif mode == "fused":
                ran = execute_fused(ssn) and "fused"
            else:
                # the active-set engine may claim an auto-selected
                # two-level cycle or an explicit "activeset" request
                ran = execute_batched(
                    ssn, hier=mode in ("hier", "activeset"),
                    activeset=(mode == "activeset"
                               or (self.mode == "auto" and mode == "hier")),
                    sharded=mode == "sharded", mesh=self.mesh)
            if ran:
                last_cycle_engine = ran
                return
            count_engine_demotion(mode, "visit")
            if mode in ("hier", "activeset", "sharded"):
                mode = "batched"
        self._execute_queued(ssn, mode)

    def _execute_queued(self, ssn: Session, mode: str) -> None:
        """The reference's queue / job / task loops (allocate.go), every
        visit either the per-visit device scan or the host callbacks."""
        global last_cycle_engine, last_host_reason
        from ..kernels.solver import ensure_device_snapshot
        from ..kernels.terms import solver_terms, unsupported_reason

        queues = PriorityQueue(ssn.queue_order_fn)
        jobs_map: Dict[str, PriorityQueue] = {}
        pending_all: List[TaskInfo] = []
        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            # one queue entry per job, as the reference does (allocate.go:50)
            queues.push(queue)
            jobs_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn))
            jobs_map[job.queue].push(job)
            pending_all.extend(
                t for t in job.task_status_index.get(TaskStatus.PENDING,
                                                     {}).values()
                if not t.resreq.is_empty())

        # registered predicate / node-order callbacks run on the device
        # when kernels/terms expresses them; the cheap gate first keeps a
        # host cycle from paying the device snapshot
        device = None
        terms = None
        reason = "mode='host'"
        if mode in ("jax", "fused", "batched"):
            reason = unsupported_reason(ssn, pending_all)
            if reason is None:
                device = ensure_device_snapshot(ssn)
                terms = solver_terms(ssn, device, pending_all,
                                     assume_supported=True)
        if device is not None:
            last_cycle_engine = f"{mode}-visit"
        else:
            last_cycle_engine = "host-visit"
            last_host_reason = reason

        pending_tasks: Dict[str, PriorityQueue] = {}
        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            if job.uid not in pending_tasks:
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(TaskStatus.PENDING,
                                                      {}).values():
                    if task.resreq.is_empty():
                        continue  # BestEffort handled by backfill
                    tasks.push(task)
                pending_tasks[job.uid] = tasks
            tasks = pending_tasks[job.uid]
            if not tasks.empty():
                if device is not None:
                    self._visit_job_device(ssn, device, job, tasks, jobs,
                                           terms)
                else:
                    self._visit_job_host(ssn, job, tasks, jobs)
            queues.push(queue)

    # ------------------------------------------------------------------
    # device path: one allocate scan per job visit
    # ------------------------------------------------------------------
    def _visit_job_device(self, ssn: Session, device, job: JobInfo,
                          tasks: PriorityQueue, jobs: PriorityQueue,
                          terms) -> None:
        from ..kernels.solver import ALLOC, ALLOC_OB, FAIL, PIPELINE, SKIP
        from ..kernels.tensorize import TaskBatch

        # injection seam: before the dispatch AND before any session
        # mutation, so a device fault fails the cycle without leaving
        # half-applied decisions behind
        _fault_check("device.dispatch")
        ordered: List[TaskInfo] = []
        while not tasks.empty():
            ordered.append(tasks.pop())
        with obs.span("visit_rows", cat="phase"):
            batch = TaskBatch.from_tasks(ordered)
            scores, pred = terms.matrices(batch)
        decisions, _ = device.solve_job(
            batch, _effective_min_available(ssn, job), _init_allocated(job),
            scores=scores, pred_mask=pred, dyn=terms.dynamic)
        try:
            for task, dec in zip(ordered, decisions):
                if dec.kind == ALLOC:
                    ssn.allocate(task, dec.node_name, False)
                elif dec.kind == ALLOC_OB:
                    ssn.allocate(task, dec.node_name, True)
                elif dec.kind == PIPELINE:
                    ssn.pipeline(task, dec.node_name)
                elif dec.kind == FAIL:
                    self._record_fit_deltas(ssn, job, task)
                    return  # job dropped (allocate.go:187-189)
                elif dec.kind == SKIP:
                    tasks.push(task)  # not processed; next visit
            if ssn.job_ready(job):
                jobs.push(job)
        except Exception:
            # the host apply diverged (e.g. a volume binder failure): the
            # device carry no longer matches host truth; rebuild it
            device.resync(ssn.nodes)
            raise

    def _record_fit_deltas(self, ssn: Session, job: JobInfo,
                           task: TaskInfo) -> None:
        """NodesFitDelta for the breaking task (ref: allocate.go:124-126 and
        164-170: the map holds deltas of the last task that failed)."""
        ssn.touched_jobs.add(job.uid)   # nodes_fit_delta isn't cloned
        job.nodes_fit_delta = {}
        for node in ssn.nodes.values():
            delta = node.idle.clone()
            delta.fit_delta(task.resreq)
            job.nodes_fit_delta[node.name] = delta

    # ------------------------------------------------------------------
    # host path — the reference algorithm verbatim (the oracle)
    # ------------------------------------------------------------------
    def _visit_job_host(self, ssn: Session, job, tasks: PriorityQueue,
                        jobs: PriorityQueue) -> None:
        """The reference algorithm verbatim (the oracle)."""
        while not tasks.empty():
            task = tasks.pop()
            assigned = False
            if job.nodes_fit_delta:
                job.nodes_fit_delta = {}

            predicate_nodes = []
            for node in ssn.nodes.values():
                try:
                    ssn.predicate_fn(task, node)
                except Exception:
                    continue
                predicate_nodes.append(node)

            node_scores: Dict[float, list] = {}
            for node in predicate_nodes:
                score = ssn.node_order_fn(task, node)
                node_scores.setdefault(score, []).append(node)

            for node in select_best_node(node_scores):
                if task.init_resreq.less_equal(node.accessible()):
                    try:
                        ssn.allocate(task, node.name,
                                     not task.init_resreq.less_equal(
                                         node.idle))
                    except VolumeAllocationError:
                        # pre-mutation volume failure: try the next node
                        # (ref: allocate.go:157-161)
                        continue
                    assigned = True
                    break
                else:
                    delta = node.idle.clone()
                    delta.fit_delta(task.resreq)
                    job.nodes_fit_delta[node.name] = delta
                    ssn.touched_jobs.add(job.uid)
                if task.init_resreq.less_equal(node.releasing):
                    ssn.pipeline(task, node.name)
                    assigned = True
                    break

            if not assigned:
                break
            if ssn.job_ready(job):
                jobs.push(job)
                break


def new() -> AllocateAction:
    return AllocateAction()


register_action(AllocateAction())
