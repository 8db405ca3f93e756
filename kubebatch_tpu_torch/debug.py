"""Consistency audit — invariant checks over cache/session state.

``snapshot_diff`` is the incremental snapshot's soundness oracle: the
folded snapshot must deep-equal a from-scratch clone of cache truth
(``SchedulerCache.audited_snapshot``). ``audit_cache`` walks the live
maps and verifies the arithmetic invariants every mutation path (event
handlers, decision replays, resync repairs) preserves; tests call it
between cycles.

Checked invariants:
- node: allocatable - idle == used - pipelined_sum (+/- eps; Pipelined
  tasks consume releasing, not idle); used equals the resreq sum of the
  node's task map; releasing equals the sum over RELEASING tasks minus
  PIPELINED reuse.
- job: allocated equals the resreq sum over allocated-status tasks;
  total_request equals the sum over all tasks; the status double-index
  is consistent (every task bucketed exactly once, under its own status).
- cross: every node-map task has a cache twin in some job, and bound
  tasks' node_name matches the node.

ref: kubebatch_tpu/debug.py.
"""
from __future__ import annotations

from typing import List

from .api import allocated_status
from .api.types import TaskStatus

#: float slack for audit comparisons — far below the scheduling epsilons
#: (10 milli-cpu / 10 MiB), far above f64 noise from vectorized sums
_EPS_CPU = 1e-3
_EPS_MEM = 64.0


def _close(a: float, b: float, eps: float) -> bool:
    return abs(a - b) <= eps


def audit_cache(cache) -> List[str]:
    """Returns a list of human-readable violations (empty = consistent)."""
    problems: List[str] = []

    for name, node in cache.nodes.items():
        if node.node is None:
            continue            # placeholder node: no accounting contract
        used_cpu = used_mem = 0.0
        rel_cpu = 0.0
        pipe_cpu = 0.0
        for t in node.tasks.values():
            used_cpu += t.resreq.milli_cpu
            used_mem += t.resreq.memory
            if t.status == TaskStatus.RELEASING:
                rel_cpu += t.resreq.milli_cpu
            elif t.status == TaskStatus.PIPELINED:
                rel_cpu -= t.resreq.milli_cpu
                pipe_cpu += t.resreq.milli_cpu
        if not _close(node.used.milli_cpu, used_cpu, _EPS_CPU):
            problems.append(
                f"node {name}: used.cpu {node.used.milli_cpu:.3f} != "
                f"task sum {used_cpu:.3f}")
        if not _close(node.used.memory, used_mem, _EPS_MEM):
            problems.append(
                f"node {name}: used.mem {node.used.memory:.0f} != "
                f"task sum {used_mem:.0f}")
        if not _close(node.releasing.milli_cpu, rel_cpu, _EPS_CPU):
            problems.append(
                f"node {name}: releasing.cpu {node.releasing.milli_cpu:.3f}"
                f" != releasing-pipelined sum {rel_cpu:.3f}")
        # the exact identity add_task/remove_task maintain: every task
        # consumes idle EXCEPT a Pipelined one, which consumes releasing —
        # so allocatable - idle == used - pipelined_sum
        lhs = node.allocatable.milli_cpu - node.idle.milli_cpu
        rhs = node.used.milli_cpu - pipe_cpu
        if not _close(lhs, rhs, _EPS_CPU):
            problems.append(
                f"node {name}: allocatable-idle {lhs:.3f} != "
                f"used-pipelined {rhs:.3f}")
        aff = sum(1 for t in node.tasks.values()
                  if t.pod.has_pod_affinity())
        if node.affinity_tasks != aff:
            problems.append(
                f"node {name}: affinity_tasks {node.affinity_tasks} != "
                f"recount {aff}")

    for uid, job in cache.jobs.items():
        alloc_cpu = total_cpu = 0.0
        for t in job.tasks.values():
            total_cpu += t.resreq.milli_cpu
            if allocated_status(t.status):
                alloc_cpu += t.resreq.milli_cpu
        if not _close(job.allocated.milli_cpu, alloc_cpu, _EPS_CPU):
            problems.append(
                f"job {uid}: allocated.cpu {job.allocated.milli_cpu:.3f} "
                f"!= task sum {alloc_cpu:.3f}")
        if not _close(job.total_request.milli_cpu, total_cpu, _EPS_CPU):
            problems.append(
                f"job {uid}: total_request.cpu "
                f"{job.total_request.milli_cpu:.3f} != {total_cpu:.3f}")
        aff = sum(1 for t in job.tasks.values()
                  if t.pod.has_pod_affinity())
        if job.affinity_tasks != aff:
            problems.append(
                f"job {uid}: affinity_tasks {job.affinity_tasks} != "
                f"recount {aff}")
        indexed = 0
        for status, bucket in job.task_status_index.items():
            for t_uid, t in bucket.items():
                indexed += 1
                if t.status != status:
                    problems.append(
                        f"job {uid}: task {t_uid} bucketed {status} but "
                        f"carries {t.status}")
                if job.tasks.get(t_uid) is not t:
                    problems.append(
                        f"job {uid}: task {t_uid} index entry is not the "
                        f"stored task")
        if indexed != len(job.tasks):
            problems.append(
                f"job {uid}: status index holds {indexed} tasks, map "
                f"holds {len(job.tasks)}")

    for name, node in cache.nodes.items():
        for key, t in node.tasks.items():
            job = cache.jobs.get(t.job)
            if job is None:
                continue        # job GC'd while node copy lingers is legal
            twin = job.tasks.get(t.uid)
            if twin is None:
                # the job exists but lost the task while the node kept its
                # copy — the leak class this cross-check exists to catch
                problems.append(
                    f"task {key}: on node {name} but missing from live "
                    f"job {t.job}")
            elif twin.node_name and twin.node_name != name:
                problems.append(
                    f"task {key}: on node {name} but twin says "
                    f"{twin.node_name}")
    return problems


# ---------------------------------------------------------------------
# snapshot equivalence (the incremental-snapshot soundness oracle)
# ---------------------------------------------------------------------

def _res_diff(where: str, a, b, problems: List[str]) -> None:
    """Exact float comparison: an untouched reused clone must be
    bit-identical to a fresh clone of the same cache truth; touched
    entities are re-cloned, so they are too."""
    if (a.milli_cpu != b.milli_cpu or a.memory != b.memory
            or a.milli_gpu != b.milli_gpu
            or a.max_task_num != b.max_task_num):
        problems.append(f"{where}: {a} != {b}")


def _task_diff(where: str, a, b, problems: List[str]) -> None:
    if a.uid != b.uid or a.status != b.status \
            or a.node_name != b.node_name \
            or a.is_backfill != b.is_backfill \
            or a.pod is not b.pod:
        problems.append(
            f"{where}: ({a.uid},{a.status},{a.node_name},{a.is_backfill}) "
            f"!= ({b.uid},{b.status},{b.node_name},{b.is_backfill})")
        return
    _res_diff(f"{where}.resreq", a.resreq, b.resreq, problems)
    _res_diff(f"{where}.init_resreq", a.init_resreq, b.init_resreq,
              problems)


def snapshot_diff(a, b) -> List[str]:
    """Deep-compare two ClusterInfo snapshots; returns human-readable
    differences (empty = deep-equal). Shared-by-design references
    (pod, pod_group, pdb, node spec) are compared by identity — both
    cloning paths share them with cache truth."""
    problems: List[str] = []
    if set(a.queues) != set(b.queues):
        problems.append(f"queue sets differ: {set(a.queues) ^ set(b.queues)}")
    for uid in set(a.queues) & set(b.queues):
        qa, qb = a.queues[uid], b.queues[uid]
        if qa.name != qb.name or qa.weight != qb.weight:
            problems.append(f"queue {uid}: ({qa.name},{qa.weight}) != "
                            f"({qb.name},{qb.weight})")

    if set(a.nodes) != set(b.nodes):
        problems.append(f"node sets differ: {set(a.nodes) ^ set(b.nodes)}")
    for name in set(a.nodes) & set(b.nodes):
        na, nb = a.nodes[name], b.nodes[name]
        if na.node is not nb.node:
            problems.append(f"node {name}: spec object differs")
        if na.affinity_tasks != nb.affinity_tasks:
            problems.append(f"node {name}: affinity_tasks "
                            f"{na.affinity_tasks} != {nb.affinity_tasks}")
        for fld in ("idle", "used", "releasing", "backfilled",
                    "allocatable", "capability"):
            _res_diff(f"node {name}.{fld}", getattr(na, fld),
                      getattr(nb, fld), problems)
        if set(na.tasks) != set(nb.tasks):
            problems.append(f"node {name}: task sets differ: "
                            f"{set(na.tasks) ^ set(nb.tasks)}")
            continue
        for key in na.tasks:
            _task_diff(f"node {name} task {key}", na.tasks[key],
                       nb.tasks[key], problems)

    if set(a.jobs) != set(b.jobs):
        problems.append(f"job sets differ: {set(a.jobs) ^ set(b.jobs)}")
    for uid in set(a.jobs) & set(b.jobs):
        ja, jb = a.jobs[uid], b.jobs[uid]
        if (ja.queue != jb.queue or ja.priority != jb.priority
                or ja.min_available != jb.min_available
                or ja.max_available != jb.max_available
                or ja.creation_timestamp != jb.creation_timestamp
                or ja.pod_group is not jb.pod_group
                or ja.pdb is not jb.pdb
                or ja.affinity_tasks != jb.affinity_tasks):
            problems.append(f"job {uid}: header fields differ")
        _res_diff(f"job {uid}.allocated", ja.allocated, jb.allocated,
                  problems)
        _res_diff(f"job {uid}.total_request", ja.total_request,
                  jb.total_request, problems)
        if set(ja.tasks) != set(jb.tasks):
            problems.append(f"job {uid}: task sets differ: "
                            f"{set(ja.tasks) ^ set(jb.tasks)}")
            continue
        for tuid in ja.tasks:
            _task_diff(f"job {uid} task {tuid}", ja.tasks[tuid],
                       jb.tasks[tuid], problems)
        idx_a = {st: set(bucket) for st, bucket in
                 ja.task_status_index.items() if bucket}
        idx_b = {st: set(bucket) for st, bucket in
                 jb.task_status_index.items() if bucket}
        if idx_a != idx_b:
            problems.append(f"job {uid}: status index differs")
        fd_a = set(ja.nodes_fit_delta)
        fd_b = set(jb.nodes_fit_delta)
        if fd_a != fd_b:
            problems.append(f"job {uid}: nodes_fit_delta keys differ: "
                            f"{fd_a ^ fd_b}")
    return problems
