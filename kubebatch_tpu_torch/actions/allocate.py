"""allocate — the primary scheduling action.

Solver modes (constructor arg):
- "auto" (default): "fused" below AUTO_BATCHED_MIN pending tasks on a
  node axis below AUTO_HIER_MIN_NODES. The reference package runs its
  batched round engine at or above the task threshold and its two-level
  engine at or above the node threshold; neither is in this package yet,
  so auto raises NotImplementedError there instead of running another
  engine.
- "fused": the whole cycle as ONE device solve (kernels/fused.py) —
  queue/job/task selection and fairness state live in the solve, bit-exact
  vs the host heap algorithm; the host replays the decisions through
  Session.allocate/pipeline so plugins and the gang barrier observe
  identical events. A snapshot the solve cannot express (custom order
  plugins, inter-pod affinity, host ports, a real volume binder) needs an
  engine this package does not have yet: on a CUDA cache the cycle
  raises NotImplementedError; on a CPU cache it runs the host path,
  counted in metrics.engine_demotions_total.
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

MODES = ("auto", "fused", "host")

#: engine that consumed the last allocate cycle in this process
#: ("fused" / "host-visit") — a fallback off the device engine shows here
last_cycle_engine: str = ""


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
        thresholds; only the fused regime exists here."""
        if len(ssn.nodes) >= AUTO_HIER_MIN_NODES:
            raise NotImplementedError(
                f"auto allocate at {len(ssn.nodes)} nodes needs the "
                f"two-level engine, not ported yet (ROADMAP queue A, "
                f"scale and streaming)")
        pending = sum(
            len(j.task_status_index.get(TaskStatus.PENDING, {}))
            for j in ssn.jobs.values())
        if pending >= AUTO_BATCHED_MIN:
            raise NotImplementedError(
                f"auto allocate with {pending} pending tasks needs the "
                f"batched round engine, not ported yet (ROADMAP queue A, "
                f"next slice: batched engine); use mode='fused'")
        return "fused"

    def execute(self, ssn: Session) -> None:
        global last_cycle_engine
        mode = self._auto_mode(ssn) if self.mode == "auto" else self.mode
        if mode == "fused":
            from .allocate_fused import execute_fused
            from .cycle_inputs import cycle_supported
            # execute_fused returns False (without consuming state) when
            # the snapshot carries features the solve can't model
            if cycle_supported(ssn) and execute_fused(ssn):
                last_cycle_engine = "fused"
                return
            if ssn.cache.device.type == "cuda":
                raise NotImplementedError(
                    "this cycle is outside the fused solve's vocabulary "
                    "(custom order/overused/ready plugins, inter-pod "
                    "affinity, host ports or a volume binder); its device "
                    "engines are not ported yet (ROADMAP queue A, affinity "
                    "vocabulary; queue B, B8 per-visit mode). Use "
                    "mode='host' to run the host algorithm")
            count_engine_demotion("fused", "host")
        self._execute_queued(ssn)
        last_cycle_engine = "host-visit"

    def _execute_queued(self, ssn: Session) -> None:
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
