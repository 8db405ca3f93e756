"""reclaim — cross-queue resource recovery toward weighted fair share.

ref: pkg/scheduler/actions/reclaim/reclaim.go. Victims are Running tasks
of jobs in OTHER queues; evictions go straight through the session (no
Statement — reclaim.go:159-173); the reclaimer is pipelined onto the node
once enough resource is being released.

Two engines share the identical outer control flow (constructor arg
``mode``, see actions/preempt.py for the same split): "device" (default)
analyses a whole node visit — nodes in host iteration order, tiered
gang/conformance/proportion victim masks — in the victim kernels
(kernels/victims.py) and replays the chosen node's eviction walk through
ssn.evict in float64; nodes where proportion's sequential skip-guard
trips are handed to the exact host block. "host" runs the
reference-literal loops. ``fastpath=False`` disables the provably-idle
gates (both engines then always pay the full evaluation — the
equivalence mode the fast-path fuzz test runs against).
"""
from __future__ import annotations

from typing import Dict

from ..api import Resource, TaskStatus
from ..framework import Action, Session, register_action
from ..util import PriorityQueue
from .preempt import validate_victims

MODES = ("device", "host")

#: reclaimable fns whose "could any victim pass?" question has a cheap
#: whole-session over-approximation below; an unknown owner in a tier
#: makes that tier unprovable and disables the skip
_PROVABLE_RECLAIM_FNS = frozenset({"gang", "conformance", "proportion"})


def _no_possible_reclaim_victim(ssn: Session) -> bool:
    """True when the tiered Reclaimable evaluation provably yields no
    victim for ANY (reclaimer, reclaimees) call this session — the
    saturated steady regime, where every gang is exactly at quorum and
    every queue at/below its deserved share.

    Soundness: a tier's intersection is non-empty only if SOME victim is
    allowed by EVERY member fn (session_plugins.go:67-106). Each member
    check below over-approximates "this fn could allow at least one
    victim" (conformance, which can only subtract critical pods, is
    taken as always-possible), so `not possible` for every tier implies
    the real evaluation returns nil everywhere and the action's node
    loop can never evict or pipeline. Member semantics matched:
    gang.go:108-129 (stays >= MinAvailable after losing one, or the
    MinAvailable==1 quirk), proportion.go:159-184 (queue stays at/above
    deserved after losing the victim — impossible when allocated is
    already below deserved, victim resreq >= 0)."""
    possible_memo: Dict[str, bool] = {}

    def member_possible(name: str) -> bool:
        got = possible_memo.get(name)
        if got is not None:
            return got
        if name == "gang":
            from ..plugins.gang import can_lose_one
            ok = any(can_lose_one(job) for job in ssn.jobs.values()
                     if TaskStatus.RUNNING in job.task_status_index)
        elif name == "proportion":
            prop = ssn.plugins.get("proportion")
            # plugin state missing while its fn is registered: can't
            # reason about it — treat as possible (no skip). The floor
            # itself lives WITH the plugin (could_allow_any_victim is
            # documented against reclaimable_fn in proportion.py) so the
            # two evolve together.
            ok = (prop is None
                  or not hasattr(prop, "could_allow_any_victim")
                  or prop.could_allow_any_victim())
        else:           # conformance: only ever subtracts critical pods
            ok = True
        possible_memo[name] = ok
        return ok

    fns = ssn.reclaimable_fns
    # cost-ordered evaluation: a tier fires (-> return False) only when
    # ALL its members are possible, and ANY firing tier decides — so
    # check cheap members (conformance: constant; proportion: O(queues))
    # before gang's O(jobs) scan, and cheap tiers before expensive ones.
    # Pure reordering of short-circuit evaluation, same result.
    cost = {"conformance": 0, "proportion": 1, "gang": 2}
    tiers = []
    for tier in ssn.tiers:
        members = [opt.name for opt in tier.plugins
                   if not opt.reclaimable_disabled and opt.name in fns]
        if not members:
            continue
        if any(m not in _PROVABLE_RECLAIM_FNS for m in members):
            return False
        members.sort(key=lambda m: cost[m])
        tiers.append(members)
    tiers.sort(key=lambda ms: cost[ms[-1]])
    for members in tiers:
        if all(member_possible(m) for m in members):
            return False
    return True


class ReclaimAction(Action):
    def __init__(self, mode: str = "device", fastpath: bool = True):
        if mode not in MODES:
            raise ValueError(f"reclaim mode {mode!r} is not one of {MODES}")
        self.mode = mode
        self.fastpath = fastpath

    @property
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn: Session) -> None:
        # cross-queue reclaim needs at least two distinct queues; with
        # one, no task can ever be a victim (the filter requires a
        # DIFFERENT queue) — observably a no-op, skipped before paying
        # the solver build. Session jobs' queues are always a subset of
        # ssn.queues (the snapshot drops jobs with missing queues,
        # cache.py snapshot), so the queue map alone decides.
        if len(ssn.queues) <= 1:
            return

        # ONE walk over the job map feeds everything below (the gate's
        # queue membership, the solver's pending set, the preemptor PQs)
        # — this setup used to walk 10k jobs four separate times per
        # cycle in the victim-hot steady regime
        jobs_pending = [job for job in ssn.jobs.values()
                        if TaskStatus.PENDING in job.task_status_index]

        # Provably-idle fast path: the reference loop pops each queue and
        # skips it when ssn.Overused(queue) (reclaim.go:95-99) — if EVERY
        # queue holding pending work is overused up front, the loop ends
        # without a single visit or mutation, because skipped queues are
        # never re-pushed and nothing else in the loop body runs. In the
        # saturated steady regime proportion marks every queue overused
        # (allocated == deserved, proportion.go:186-200), so this cheap
        # membership check replaces the full solver build + wave analysis
        # the cycle would spend proving the no-op. Evaluating before the
        # loop is exact: overused_fns are pure reads of plugin state, and
        # the all-overused case performs no mutation that could change a
        # later answer. Queues absent from the session can't reclaim
        # (their jobs never enter preemptorsMap) and don't count.
        if self.fastpath:
            pending_queues = {job.queue for job in jobs_pending}
            reclaimer_queues = [q for quid in pending_queues
                                if (q := ssn.queues.get(quid)) is not None]
            if all(ssn.overused(q) for q in reclaimer_queues):
                return

            # Second provably-idle gate, one level deeper: even with
            # eligible reclaimer queues, the node loop can only act if
            # SOME victim passes the tiered Reclaimable evaluation. In
            # the steady regime every gang sits exactly at quorum (tier
            # 1 nil by gang's stays-at-MinAvailable rule) and pending
            # demand holds deserved above allocated for the reclaimer
            # queues while victims' queues sit below (tier 2 nil by
            # proportion's floor) — the whole action is a no-op that
            # used to cost the full solver build + a wave dispatch per
            # cycle to discover.
            if _no_possible_reclaim_victim(ssn):
                return

        from ..kernels.victims import SKIP_ACTION, build_action_solver
        solver = None
        if self.mode == "device":
            pending_tasks = [t for job in jobs_pending
                             for t in job.task_status_index[
                                 TaskStatus.PENDING].values()]
            solver = build_action_solver(ssn, "reclaimable_fns",
                                         "reclaimable_disabled",
                                         score_nodes=False,
                                         pending=pending_tasks)
            if solver is SKIP_ACTION:
                return

        queues = PriorityQueue(ssn.queue_order_fn)
        queue_map = {}
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}

        # only queues holding PENDING jobs enter the PQ: the reference
        # builds its PQ from all jobs' queues (reclaim.go:88-99), but a
        # pop without preemptors mutates nothing, so restricting to the
        # pending set is outcome-identical without the O(jobs) walk.
        # Queues of jobless/pending-less sessions must NOT be pushed —
        # proportion's queue_order_fn indexes queue_opts, which only
        # holds queues that have jobs.
        for job in jobs_pending:
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_map:
                queue_map[queue.uid] = queue
                queues.push(queue)
            preemptors_map.setdefault(
                job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
            tasks = PriorityQueue(ssn.task_order_fn)
            for task in job.task_status_index.get(TaskStatus.PENDING,
                                                  {}).values():
                tasks.push(task)
            preemptor_tasks[job.uid] = tasks

        if solver is not None:
            # the first visit per queue is knowable up front (top task of
            # the top job); one prefetch wave answers the whole steady
            # cycle's reclaim visits in a single kernel dispatch
            tops = []
            for quid, jobs_pq in preemptors_map.items():
                q = queue_map.get(quid)
                if q is None or ssn.overused(q):
                    continue
                top_job = jobs_pq.peek()
                if top_job is None:
                    continue
                tq = preemptor_tasks.get(top_job.uid)
                top_task = tq.peek() if tq is not None else None
                if top_task is not None:
                    tops.append(top_task)
            solver.prefetch(tops, "other_queue")

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            if solver is not None:
                assigned = self._reclaim_one_device(ssn, solver, task, job)
            else:
                assigned = self._reclaim_one_host(ssn, task, job)

            if assigned:
                queues.push(queue)

    # ------------------------------------------------------------------
    # host path — the reference algorithm verbatim (the oracle)
    # ------------------------------------------------------------------
    def _reclaim_one_host(self, ssn: Session, task, job) -> bool:
        for node in ssn.nodes.values():
            try:
                ssn.predicate_fn(task, node)
            except Exception:
                continue

            reclaimees = []
            for t in node.tasks.values():
                if t.status != TaskStatus.RUNNING:
                    continue
                j = ssn.jobs.get(t.job)
                if j is not None and j.queue != job.queue:
                    # clone so session status flips don't corrupt the
                    # node's accounting (reclaim.go:137)
                    reclaimees.append(t.clone())
            victims = ssn.reclaimable(task, reclaimees)
            if not validate_victims(victims, task.init_resreq):
                continue

            if self._evict_walk(ssn, task, victims, None):
                ssn.pipeline(task, node.name)
                return True
        return False

    # ------------------------------------------------------------------
    # device path
    # ------------------------------------------------------------------
    def _reclaim_one_device(self, ssn: Session, solver, task, job) -> bool:
        import numpy as np

        state = solver.state
        visited = np.zeros(state.n_pad, bool)
        while True:
            res = solver.visit(task, "other_queue", visited)
            if not res.found:
                return False
            node = ssn.nodes.get(res.node_name)
            if node is None:  # pragma: no cover — names come from the snapshot
                return False

            if res.prop_guard:
                # proportion's skip-guard tripped: victim set for this node
                # is sequential-only — evaluate the node with the exact
                # host block (real plugin callbacks)
                reclaimees = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.RUNNING:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is not None and j.queue != job.queue:
                        reclaimees.append(t.clone())
                victims = ssn.reclaimable(task, reclaimees)
                if not validate_victims(victims, task.init_resreq):
                    visited[res.node_idx] = True
                    continue
                covered = self._evict_walk(ssn, task, victims, state)
            else:
                victims = [state.victims[row].task.clone()
                           for row in res.victim_rows]
                covered = self._evict_walk(ssn, task, victims, state)

            if covered:
                ssn.pipeline(task, res.node_name)
                state.apply_pipeline(task, res.node_idx)
                return True
            visited[res.node_idx] = True   # evictions stand; state changed

    # ------------------------------------------------------------------
    def _evict_walk(self, ssn: Session, task, victims, state) -> bool:
        """The reference's cumulative eviction loop (reclaim.go:159-176):
        evict victims in candidate order until the remaining request fits
        inside the current victim; a failed evict is skipped without
        advancing the cumulative bookkeeping. Mirrors (device path) track
        successful evictions only."""
        resreq = task.init_resreq.clone()
        reclaimed = Resource.empty()
        for reclaimee in victims:
            try:
                ssn.evict(reclaimee, "reclaim")
            except Exception:
                continue
            if state is not None:
                row = state.row_of.get(reclaimee.uid)
                if row is not None:
                    state.apply_evict(row)
            reclaimed.add(reclaimee.resreq)
            if resreq.less_equal(reclaimee.resreq):
                break
            resreq.sub(reclaimee.resreq)
        return task.init_resreq.less_equal(reclaimed)


def new() -> ReclaimAction:
    return ReclaimAction()


register_action(ReclaimAction())
