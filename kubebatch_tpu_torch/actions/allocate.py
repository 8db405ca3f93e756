"""allocate — the primary scheduling action.

Solver modes (constructor arg):
- "auto" (default): the reference package's size-based choice on a node
  axis below AUTO_HIER_MIN_NODES — "fused" below AUTO_BATCHED_MIN pending
  tasks, "batched" at or above it. The reference runs its sharded round
  engine instead of batched when it sees more than one device and a
  large node axis; this package has no sharded engine (ROADMAP queue A,
  multi-device), so it picks "batched" on any number of visible cards.
  At or above AUTO_HIER_MIN_NODES the reference picks its two-level
  engine ("hier"), not in this package yet: such a cycle raises
  NotImplementedError, unless it carries the affinity vocabulary, which
  the reference demotes to the batched engine (counted) and so does this
  package.
- "fused": the whole cycle as ONE device solve (kernels/fused.py) —
  queue/job/task selection and fairness state live in the solve, bit-exact
  vs the host heap algorithm; the host replays the decisions through
  Session.allocate/pipeline so plugins and the gang barrier observe
  identical events.
- "batched": the round engine (kernels/batched.py) as ONE device solve —
  many placements per round, every round on the device; the same replay.
  Exact in capacity, predicates and gang semantics, round-granular in
  ordering (its docstring states the contract).
- "batched" carries inter-pod affinity and host ports (the vocabulary of
  kernels/affinity.py) in its rounds; "fused" has no affinity carry.
- A cycle outside every engine's vocabulary takes the reference's own
  route (its allocate.py:345-361): the requested engine refuses without
  consuming state, the demotion is counted (engine_demotions_total,
  fused -> visit or batched -> visit), and the strict
  terms.device_supported gate decides. Where it fails — an affinity or
  host-port snapshot past the fused engine or past the batched
  vocabulary's caps, a volume binder, custom predicate/order plugins —
  the reference runs its host loops and so does this package, on any
  cache ("host-visit"; the reason in last_host_reason). Where it holds
  with custom order, overused or ready plugins, the reference runs its
  per-visit device scan (ROADMAP B8), not ported: a CUDA cache raises
  NotImplementedError, a CPU cache runs the host loops, which that scan
  reproduces.
- Only two requests raise on a CUDA cache: that per-visit scan (B8) and
  an affinity-free cycle at AUTO_HIER_MIN_NODES or more nodes in auto
  (the two-level engine, B10).
- "host": the reference-literal per-pair loops — the semantic oracle.

ref: pkg/scheduler/actions/allocate/allocate.go. Control flow is preserved
exactly (queue PQ with one entry per job, overused queues dropped, one job
per queue visit, job re-pushed only when it crosses readiness, job dropped
on first unassignable task, queue re-pushed after every visit).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..api import TaskStatus
from ..framework import (Action, Session, VolumeAllocationError,
                         register_action)
from ..metrics import count_engine_demotion
from ..util import PriorityQueue, select_best_node

#: the reference package's auto mode switches to its batched engine at
#: this many pending tasks
AUTO_BATCHED_MIN = 512

#: ... and to its two-level engine at this many nodes
AUTO_HIER_MIN_NODES = 16384

MODES = ("auto", "fused", "batched", "host")

#: engine that consumed the last allocate cycle in this process
#: ("fused" / "batched" / "host-visit") — a fallback off the device
#: engines shows here
last_cycle_engine: str = ""

#: why the last "host-visit" cycle was outside every engine (the strict
#: device_supported gate's reason; "dynamic_features: ..." for inter-pod
#: affinity and host ports)
last_host_reason: str = ""


class AllocateAction(Action):
    def __init__(self, mode: Optional[str] = None):
        mode = mode or "auto"
        if mode not in MODES:
            raise ValueError(f"allocate mode {mode!r} is not one of {MODES}")
        self.mode = mode

    @property
    def name(self) -> str:
        return "allocate"

    @staticmethod
    def _auto_mode(ssn: Session) -> str:
        """Size-based engine selection with the reference package's
        thresholds. No sharded engine here: "batched" on any number of
        visible cards."""
        if len(ssn.nodes) >= AUTO_HIER_MIN_NODES:
            return "hier"
        pending = sum(
            len(j.task_status_index.get(TaskStatus.PENDING, {}))
            for j in ssn.jobs.values())
        return "batched" if pending >= AUTO_BATCHED_MIN else "fused"

    def execute(self, ssn: Session) -> None:
        global last_cycle_engine, last_host_reason
        mode = self._auto_mode(ssn) if self.mode == "auto" else self.mode
        reason = "mode='host'"
        if mode in ("fused", "batched", "hier"):
            from .cycle_inputs import cycle_supported
            if mode == "fused":
                from .allocate_fused import execute_fused as run
            else:
                from .allocate_batched import execute_batched

                def run(ssn):
                    return execute_batched(ssn, hier=(mode == "hier"))
            # the engine returns the engine that ran, or False (without
            # consuming state) when the snapshot carries features the
            # solve can't model
            ran = cycle_supported(ssn) and run(ssn)
            if ran:
                last_cycle_engine = ran if isinstance(ran, str) else mode
                return
            reason = outside_the_engines(ssn, mode)
            count_engine_demotion(mode, "visit")
        self._execute_queued(ssn)
        last_cycle_engine = "host-visit"
        last_host_reason = reason

    def _execute_queued(self, ssn: Session) -> None:
        """The reference's queue / job / task loops over the host
        callbacks (allocate.go), the route of every host-visit cycle."""
        queues = PriorityQueue(ssn.queue_order_fn)
        jobs_map: Dict[str, PriorityQueue] = {}
        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            # one queue entry per job, as the reference does (allocate.go:50)
            queues.push(queue)
            jobs_map.setdefault(job.queue, PriorityQueue(ssn.job_order_fn))
            jobs_map[job.queue].push(job)

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
                self._visit_job_host(ssn, job, tasks, jobs)
            queues.push(queue)

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


def outside_the_engines(ssn: Session, mode: str) -> str:
    """The route of a cycle the requested engine refused (or whose
    custom order / overused / ready plugins no whole-cycle engine
    expresses), as the reference takes it (its allocate.py:190-210 and
    :345-361): the strict ``terms.device_supported`` gate over the
    pending tasks decides. Where it fails, the reference runs its host
    loops, and so does this package: returns why (the gate's reason:
    ``dynamic_features: ...`` for inter-pod affinity and host ports).
    Where it holds, the reference runs its per-visit device scan
    (kernels/solver.py _allocate_scan, ROADMAP B8), not ported: a CUDA
    cache raises NotImplementedError; a CPU cache runs the host loops,
    which that scan reproduces."""
    from ..kernels.terms import unsupported_reason

    pending = [t for job in ssn.jobs.values()
               if ssn.queues.get(job.queue) is not None
               for t in job.task_status_index.get(TaskStatus.PENDING,
                                                  {}).values()
               if not t.resreq.is_empty()]
    reason = unsupported_reason(ssn, pending)
    if reason is not None:
        return reason
    if ssn.cache.device.type == "cuda":
        raise NotImplementedError(
            f"this cycle is outside the {mode} solve's vocabulary "
            "(custom job/queue order, overused or ready plugins) but "
            "inside the device terms': the reference runs its "
            "per-visit device scan here (kernels/solver.py "
            "_allocate_scan), not ported yet (ROADMAP queue B, B8). "
            "Use mode='host' to run the host algorithm")
    return "per-visit scan (B8) on a CPU cache: the host loops"


def new() -> AllocateAction:
    return AllocateAction()


register_action(AllocateAction())
