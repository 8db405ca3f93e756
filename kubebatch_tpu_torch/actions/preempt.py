"""preempt — same-queue preemption under Statement transactions.

ref: pkg/scheduler/actions/preempt/preempt.go. Phase 1: inter-job
preemption within a queue (Running victims of OTHER jobs), committed only
when the preemptor job reaches readiness, discarded otherwise. Phase 2:
intra-job preemption, committed unconditionally. The `--enable-preemption`
gate is commented out in the reference (preempt.go:47-51) — the action
always runs when configured; we keep that behavior.

Two engines share the identical outer control flow (constructor arg
``mode``):
- "device" (default): the per-visit O(nodes x victims x plugins) analysis
  — predicate/score over all nodes plus the tiered-intersection victim
  masks — runs in the victim kernels (kernels/victims.py) on the cache's
  device; the host replays the chosen node's eviction walk through the
  real Statement so plugin event handlers, rollback and the gang barrier
  observe exactly the reference's mutation sequence. A snapshot outside
  the kernels' vocabulary raises NotImplementedError on a CUDA cache and
  runs the host loops on a CPU cache (an engine demotion).
- "host": the reference-literal per-pair loops below — the semantic
  oracle the kernels are held against.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..api import Resource, TaskInfo, TaskStatus
from ..framework import Action, Session, Statement, register_action
from ..metrics import (register_preemption_attempts,
                       update_preemption_victims_count)
from ..util import PriorityQueue, select_best_node

MODES = ("device", "host")


def validate_victims(victims: List[TaskInfo], resreq: Resource) -> bool:
    """Victims together must cover the request (ref: preempt.go:355-370).
    NB: uses the strict Less (every dimension) like the reference."""
    if not victims:
        return False
    total = Resource.empty()
    for v in victims:
        total.add(v.resreq)
    return not total.less(resreq)


def preempt_one(ssn: Session, stmt: Statement, preemptor: TaskInfo,
                task_filter: Optional[Callable[[TaskInfo], bool]]) -> bool:
    """Find a node where evicting filtered victims frees enough for the
    preemptor, evict cheapest-count-first, pipeline the preemptor
    (ref: preempt.go:259-353)."""
    predicate_nodes = []
    for node in ssn.nodes.values():
        try:
            ssn.predicate_fn(preemptor, node)
        except Exception:
            continue
        predicate_nodes.append(node)

    node_scores: Dict[float, list] = {}
    for node in predicate_nodes:
        score = ssn.node_order_fn(preemptor, node)
        node_scores.setdefault(score, []).append(node)

    for node in select_best_node(node_scores):
        preemptees = [task.clone() for task in node.tasks.values()
                      if task_filter is None or task_filter(task)]
        victims = ssn.preemptable(preemptor, preemptees)
        update_preemption_victims_count(len(victims))

        resreq = preemptor.init_resreq.clone()
        if not validate_victims(victims, resreq):
            continue

        preempted = Resource.empty()
        for preemptee in victims:
            stmt.evict(preemptee, "preempt")
            preempted.add(preemptee.resreq)
            if resreq.less_equal(preemptee.resreq):
                break
            resreq.sub(preemptee.resreq)
        register_preemption_attempts()

        if preemptor.init_resreq.less_equal(preempted):
            stmt.pipeline(preemptor, node.name)
            return True
    return False


class MirrorLog:
    """Pairs VictimState mirror mutations with a Statement's op log so
    discard can roll the mirrors back in reverse order (the Statement
    itself rolls back the session)."""

    def __init__(self, state):
        self.state = state
        self.ops: List[tuple] = []

    def evict(self, row: int) -> None:
        self.state.apply_evict(row)
        self.ops.append(("evict", row))

    def pipeline(self, task: TaskInfo, node_idx: int) -> None:
        self.state.apply_pipeline(task, node_idx)
        self.ops.append(("pipeline", task, node_idx))

    def commit(self) -> None:
        self.ops = []

    def rollback(self) -> None:
        for op in reversed(self.ops):
            if op[0] == "evict":
                self.state.apply_unevict(op[1])
            else:
                self.state.apply_unpipeline(op[1], op[2])
        self.ops = []


def preempt_one_device(ssn: Session, solver, stmt: Statement,
                       log: MirrorLog, preemptor: TaskInfo,
                       filter_kind: str) -> bool:
    """Kernel-driven equivalent of preempt_one: the kernel returns the
    first validating node (score order, host tie-break) plus its victim
    rows; the host replays the cumulative eviction walk in float64 through
    the Statement. A validating-but-not-covering node keeps its evictions
    (reference behavior) and triggers a re-dispatch with refreshed state,
    since those evictions changed the victim masks."""
    import numpy as np

    state = solver.state
    visited = np.zeros(state.n_pad, bool)
    while True:
        res = solver.visit(preemptor, filter_kind, visited)
        if not res.found:
            return False
        update_preemption_victims_count(res.victims_count)

        resreq = preemptor.init_resreq.clone()
        preempted = Resource.empty()
        for row in res.victim_rows:
            victim = state.victims[row].task.clone()
            stmt.evict(victim, "preempt")
            log.evict(row)
            preempted.add(victim.resreq)
            if resreq.less_equal(victim.resreq):
                break
            resreq.sub(victim.resreq)
        register_preemption_attempts()

        if preemptor.init_resreq.less_equal(preempted):
            stmt.pipeline(preemptor, res.node_name)
            log.pipeline(preemptor, res.node_idx)
            return True
        visited[res.node_idx] = True   # evictions stand; state changed


class PreemptAction(Action):
    def __init__(self, mode: str = "device"):
        if mode not in MODES:
            raise ValueError(f"preempt mode {mode!r} is not one of {MODES}")
        self.mode = mode

    @property
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn: Session) -> None:
        from ..kernels.victims import SKIP_ACTION, build_action_solver
        solver = None
        if self.mode == "device":
            solver = build_action_solver(ssn, "preemptable_fns",
                                         "preemptable_disabled",
                                         score_nodes=True)
            if solver is SKIP_ACTION:
                return

        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}
        under_request = []
        queues = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)
            if job.count(TaskStatus.PENDING) != 0:
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                under_request.append(job)
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(TaskStatus.PENDING,
                                                      {}).values():
                    tasks.push(task)
                preemptor_tasks[job.uid] = tasks

        for queue in queues.values():
            # Phase 1: inter-job preemption within the queue
            # (ref: preempt.go:86-149)
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()
                stmt = ssn.statement()
                log = MirrorLog(solver.state) if solver is not None else None
                assigned = False
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    if solver is not None:
                        ok = preempt_one_device(ssn, solver, stmt, log,
                                                preemptor, "inter_queue")
                    else:
                        def inter_job_filter(task: TaskInfo,
                                             _pj=preemptor_job,
                                             _pt=preemptor) -> bool:
                            if task.status != TaskStatus.RUNNING:
                                return False
                            job = ssn.jobs.get(task.job)
                            if job is None:
                                return False
                            # same queue, different job (preempt.go:116-128)
                            return (job.queue == _pj.queue
                                    and _pt.job != task.job)

                        ok = preempt_one(ssn, stmt, preemptor,
                                         inter_job_filter)
                    if ok:
                        assigned = True
                    if ssn.job_ready(preemptor_job):
                        stmt.commit()
                        if log is not None:
                            log.commit()
                        break
                if not ssn.job_ready(preemptor_job):
                    stmt.discard()
                    if log is not None:
                        log.rollback()
                    continue
                if assigned:
                    preemptors.push(preemptor_job)

            # Phase 2: intra-job preemption, committed unconditionally
            # (ref: preempt.go:151-181)
            for job in under_request:
                while True:
                    tasks = preemptor_tasks.get(job.uid)
                    if tasks is None or tasks.empty():
                        break
                    preemptor = tasks.pop()
                    stmt = ssn.statement()

                    if solver is not None:
                        log = MirrorLog(solver.state)
                        assigned = preempt_one_device(
                            ssn, solver, stmt, log, preemptor, "intra_job")
                        stmt.commit()
                        log.commit()
                    else:
                        def intra_job_filter(task: TaskInfo,
                                             _pt=preemptor) -> bool:
                            if task.status != TaskStatus.RUNNING:
                                return False
                            return _pt.job == task.job

                        assigned = preempt_one(ssn, stmt, preemptor,
                                               intra_job_filter)
                        stmt.commit()
                    if not assigned:
                        break


def new() -> PreemptAction:
    return PreemptAction()


register_action(PreemptAction())
