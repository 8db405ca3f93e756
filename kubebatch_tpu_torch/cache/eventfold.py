"""EventFold — the event-driven side of the incremental cycle.

Each cache event (add/update/delete of a pod/node/podgroup, a bind, an
evict, a resync) is **folded** once, at event time, into

- the per-entity dirty marks that drive the O(churn) snapshot patch
  (``dirty_jobs`` / ``dirty_nodes``) — the folded host base (``base``,
  the previous session's clones adopted at close) is patched only at
  these keys;
- the persistent device-array dirty rows (``dev_dirty`` -> migrated to
  ``dev_refresh`` at snapshot time, consumed by the dirty-row scatter in
  kernels/solver.py ``DeviceSession.update_rows``);
- the persistent victim-segment marks (``vic_*`` / ``vicjob_*``,
  consumed by kernels/victims.py ``SegmentStore``);

and counted per kind in ``metrics.events_folded_total``.

The from-scratch ``snapshot_full()`` clone is the audit view: built on
demand (``cache.audited_snapshot`` asserts ``debug.snapshot_diff == 0``
between the two) and by the snapshot-primary mode.

Degradation rung: an audit divergence, or a fired ``cache.fold``
injection seam (faults.py) in :meth:`EventFold.record`, calls
:meth:`EventFold.demote`, which flips the cache back to
**snapshot-primary** (full clones every cycle) for the rest of the
process instead of raising. Counted in ``metrics.fold_demotions_total``.

The in-flight window (:meth:`EventFold.begin_flight` /
:meth:`EventFold.end_flight`): while a pipelined solve is in flight
(runtime/pipeline.py), every mark is also tagged into the flight sets,
node capacity/shape marks apart (``flight_caps``), so the consume-time
conflict check can ask whether an event since the dispatch touched an
entity the in-flight decisions bind against.

ref: kubebatch_tpu/cache/eventfold.py.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

from ..faults import armed as _faults_armed
from ..faults import should_fail as _should_fail
from ..metrics import count_event_folded, count_fold_demotion

log = logging.getLogger("kubebatch.fold")

#: every event kind the fold layer translates
EVENT_KINDS = (
    "pod.add", "pod.update", "pod.delete",
    "node.add", "node.update", "node.delete",
    "podgroup.add", "podgroup.update", "podgroup.delete",
    "bind", "evict", "resync", "invalidate",
)


class EventFold:
    """Per-cache event-fold state (owned by SchedulerCache).

    ``enabled`` is the fold/snapshot-primary switch: True = events fold
    into the persistent base + device marks and ``snapshot()`` is an
    O(churn) patch; False = the reference's full deep clone every cycle
    (the rung :meth:`demote` falls back to)."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        #: previous session's entity clones (jobs-by-uid, nodes-by-name),
        #: adopted at session close; None = next snapshot is a full clone
        self.base: Optional[Tuple[Dict, Dict]] = None
        #: entities whose cache truth changed since their base clone
        self.dirty_jobs: set = set()
        self.dirty_nodes: set = set()
        #: device-array row marks: ``dev_dirty`` holds marks made since
        #: the LAST snapshot; at snapshot time they migrate to
        #: ``dev_refresh``, the set the DeviceSession may safely repack
        #: from the session's clones (a mark made AFTER the snapshot
        #: refers to truth the session cannot see)
        self.dev_dirty: set = set()
        self.dev_refresh: set = set()
        #: persistent per-node victim segments — same discipline
        self.vic_dirty: set = set()
        self.vic_refresh: set = set()
        #: job-level marks for the SegmentStore's persistent job rows
        self.vicjob_dirty: set = set()
        self.vicjob_refresh: set = set()
        #: uids cache truth holds that snapshots exclude (no PodGroup/
        #: PDB, or missing queue) — rebuilt by the full snapshot paths,
        #: patched at dirty jobs by the incremental path
        self.excluded_uids: set = set()
        #: the in-flight window: while a pipelined solve is in flight
        #: every mark is also tagged here, whether or not the fold is
        #: enabled (the conflict check needs the marks after a fold
        #: demotion too)
        self._flight_open = False
        self.flight_jobs: set = set()
        self.flight_nodes: set = set()
        #: node marks from capacity/shape events: never the echo of our
        #: own binds, so they always conflict
        self.flight_caps: set = set()

    # ------------------------------------------------------------------
    # the fold entry point (called by every cache handler, under the
    # cache lock)
    # ------------------------------------------------------------------
    def record(self, kind: str, n: int = 1) -> None:
        """Count n folded events of one kind and cross the ``cache.fold``
        injection seam. A fired seam does NOT raise into the event
        handler (the event was applied to truth before this call): it
        demotes the fold to snapshot-primary. No-op when the fold is
        disabled/demoted: events_folded_total is the evidence the fold
        layer is ENGAGED."""
        if not self.enabled:
            return
        count_event_folded(kind, n)
        if _faults_armed() and _should_fail("cache.fold"):
            self.demote("fault")

    def mark_job(self, uid: str) -> None:
        if self._flight_open:
            self.flight_jobs.add(uid)
        if self.enabled:
            self.dirty_jobs.add(uid)
            self.vicjob_dirty.add(uid)

    def mark_node(self, name: str, cap: bool = False) -> None:
        """``cap`` flags a capacity/shape change (the cache's node
        handlers): inside the flight window it is also a capacity mark."""
        if self._flight_open:
            self.flight_nodes.add(name)
            if cap:
                self.flight_caps.add(name)
        if self.enabled:
            self.dirty_nodes.add(name)
            self.dev_dirty.add(name)
            self.vic_dirty.add(name)

    # ------------------------------------------------------------------
    # the in-flight window (runtime/pipeline.py)
    # ------------------------------------------------------------------
    def begin_flight(self) -> None:
        """Open the window, right after a pipelined solve dispatched:
        every mark until :meth:`end_flight` is evidence the dispatched
        inputs may be stale."""
        self.flight_jobs = set()
        self.flight_nodes = set()
        self.flight_caps = set()
        self._flight_open = True

    def end_flight(self) -> Tuple[set, set, set]:
        """Close the window and hand back the (jobs, nodes,
        capacity-nodes) marked while the solve was in flight."""
        self._flight_open = False
        marks = (self.flight_jobs, self.flight_nodes, self.flight_caps)
        self.flight_jobs = set()
        self.flight_nodes = set()
        self.flight_caps = set()
        return marks

    # ------------------------------------------------------------------
    # snapshot-side protocol
    # ------------------------------------------------------------------
    def migrate_marks(self, has_victim_store: bool) -> None:
        """Snapshot time: dirty marks become refresh marks (the session
        about to open can see the truth they refer to)."""
        self.dev_refresh |= self.dev_dirty
        self.dev_dirty = set()
        self.vic_refresh |= self.vic_dirty
        self.vic_dirty = set()
        self.vicjob_refresh |= self.vicjob_dirty
        self.vicjob_dirty = set()
        if not has_victim_store:
            # no store to refresh against (host victim mode, store
            # dropped, or never built): the next build is a full one
            # anyway — without this the marks would accumulate forever
            self.vic_refresh.clear()
            self.vicjob_refresh.clear()

    def take_active_rows(self) -> set:
        """CONSUME the device-row active set for the session being
        built: the rows whose device-array state changed since the last
        consumer (folded events migrated at snapshot time, plus rows a
        dead session handed back). Exactly one consumer per cycle (the
        DeviceSession refresh). Marks that land MID-CYCLE (after
        ``migrate_marks``) stay in ``dev_dirty`` — they refer to truth
        the open session cannot see and migrate at the NEXT snapshot.
        Call under the cache lock."""
        rows, self.dev_refresh = self.dev_refresh, set()
        return rows

    def take_base(self):
        """Consume the adopted base for this snapshot (the objects are
        handed to the new session, which will mutate them; if the
        session dies before adoption, the next snapshot is full)."""
        base, self.base = self.base, None
        dirty_jobs, self.dirty_jobs = self.dirty_jobs, set()
        dirty_nodes, self.dirty_nodes = self.dirty_nodes, set()
        return base, dirty_jobs, dirty_nodes

    def adopt(self, ssn) -> None:
        """Session close hands its entity clones back as the next
        cycle's base; session-touched entities fold into the dirty sets
        (their clones may diverge from cache truth)."""
        self.dirty_jobs |= ssn.touched_jobs
        self.dirty_nodes |= ssn.touched_nodes
        self.dev_dirty |= ssn.touched_nodes
        self.vic_dirty |= ssn.touched_nodes
        self.vicjob_dirty |= ssn.touched_jobs
        self.base = (ssn.jobs, ssn.nodes)

    def invalidate(self) -> None:
        """Cluster-wide inputs changed: the per-entity fold can't scope
        the effect — full clone next cycle."""
        self.base = None

    def demote(self, reason: str) -> None:
        """The ladder rung back to snapshot-primary: disable the fold
        for the rest of the process (full clones every cycle), keeping
        the scheduler correct at the cost of the open-phase O(cluster)
        walk. Idempotent."""
        if not self.enabled:
            return
        self.enabled = False
        self.base = None
        count_fold_demotion(reason)
        log.error("event-fold layer DEMOTED to snapshot-primary "
                  "(reason=%s): cycles fall back to full per-cycle "
                  "clones", reason)
