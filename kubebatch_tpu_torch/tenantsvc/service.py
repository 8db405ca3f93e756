"""The tenant solve service — admission, coalescing dispatch, shedding
(ref: kubebatch_tpu/tenantsvc/service.py).

Threading model ("combining leader"): there is no dedicated dispatcher
thread. Every admitted request enqueues and then races for the leader
lock; exactly one caller wins, drains a weighted-fair batch of whatever
is queued RIGHT NOW (its own request included), solves it — coalescing
same-key fused lanes into one mega launch (megasolve.py) — and fulfills
the followers' items. With one concurrent request this degenerates to an
inline solve; under concurrent load the batch forms from whatever queued
while the previous leader was solving. The card is one serial resource
either way — serializing dispatches behind the leader lock models it
honestly, and mega coalescing is what buys the throughput back.

Every solve runs on the service's ``device`` (the card unless the caller
passes ``device="cpu"``). Requests are SnapshotRequest messages
(rpc/wire.py); the grpc handler that would carry them from a socket is
the transport (ROADMAP A8), so callers hand them in-process
(``solve`` / ``solve_many``), as the reference's dryrun and tests do.

Shed semantics (faults.SHED, consulted at admission):

- level 0 "none": every lane queues (bounded).
- level 1 "serve-stale": the "batch" lane is answered from the tenant's
  stale decision mirror when one exists (``stale`` is True in the
  answer); no mirror yet -> queue normally.
- level 2 "reject-lowest": "batch" is rejected outright, "normal" is
  stale-served when possible. The "latency" lane is never shed, only
  bounded.

A full per-tenant queue always rejects that tenant's request —
back-pressure lands on the tenant generating it.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from .. import metrics
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..faults import SHED, FaultInjected, check_raise as _fault_check_raise
from ..rpc import server as rpc_server
from . import megasolve
from .admission import (AdmissionError, AdmissionQueue, Item, LANE_INDEX,
                        QuarantinedTenantError, QueueFullError,
                        ShedRejectError)
from .sessions import TenantRegistry

__all__ = ["TenantSolveService", "InjectedAdmissionFault", "active",
           "install"]


class InjectedAdmissionFault(AdmissionError, FaultInjected):
    """The rpc.admission seam's exception: BOTH a FaultInjected (the
    fault machinery counts it) and an AdmissionError (the caller runs
    the cycle in-process, as for any admission refusal; an injected
    admission failure models overload, not a failed service)."""

    reason = "fault-injected"

#: queue fraction above which an admission counts as overload pressure
#: for the shed ladder
HIGH_WATER = 0.75


class TenantSolveService:
    def __init__(self, registry: Optional[TenantRegistry] = None,
                 depth: Optional[int] = None,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.registry = registry or TenantRegistry()
        self.queue = AdmissionQueue(**({"depth": depth} if depth else {}))
        self.device = resolve_device(device)
        self._leader = threading.Lock()

    # -- admission -------------------------------------------------------
    def admit(self, tenant: str, lane: str, req) -> Item:
        """Gate one request. Returns a queued Item, or an already-done
        Item carrying the stale mirror; raises AdmissionError on
        rejection. Counted per tenant either way."""
        _fault_check_raise("rpc.admission", InjectedAdmissionFault)
        if lane not in LANE_INDEX:
            lane = "normal"
        session = self.registry.get(tenant)
        if session.quarantined():
            metrics.count_tenant(tenant, "rejected")
            raise QuarantinedTenantError(
                f"tenant {tenant!r} is quarantined (repeated stale "
                "mirror uploads); retry after the cooldown")
        # shed-ladder pressure verdict BEFORE the mode is applied, so a
        # saturated queue escalates even while rejects are flowing
        depth = self.queue.depth_total()
        SHED.record_pressure(depth >= HIGH_WATER * self.queue.capacity())
        mode = SHED.mode()
        li = LANE_INDEX[lane]
        if mode == "reject-lowest" and li == LANE_INDEX["batch"]:
            metrics.count_tenant(tenant, "rejected")
            metrics.count_load_shed("reject-lowest")
            raise ShedRejectError(
                "shedding load: lowest lane rejected under overload")
        stale_lanes = ()
        if mode == "serve-stale":
            stale_lanes = (LANE_INDEX["batch"],)
        elif mode == "reject-lowest":
            stale_lanes = (LANE_INDEX["normal"],)
        if li in stale_lanes:
            latest = session.mirrors.latest("decisions")
            if latest is not None:
                item = Item(tenant, lane, req)
                metrics.count_tenant(tenant, "stale_served")
                metrics.count_load_shed("serve-stale")
                item.finish(resp=latest[1], stale=True)
                return item
        item = Item(tenant, lane, req)
        try:
            self.queue.submit(item)
        except QueueFullError:
            metrics.count_tenant(tenant, "queue_full")
            raise
        self.queue.set_weight(tenant, session.weight)
        return item

    # -- the blocking solve ---------------------------------------------
    def solve(self, tenant: str, lane: str, req,
              timeout: float = 120.0):
        """Admit + wait; the calling thread may become the dispatch
        leader. Returns (DecisionsResponse, stale: bool)."""
        item = self.admit(tenant, lane, req)
        deadline = time.monotonic() + timeout
        while not item.done.is_set():
            if self._leader.acquire(timeout=0.005):
                try:
                    if not item.done.is_set():
                        self._drain()
                finally:
                    self._leader.release()
            else:
                item.done.wait(0.02)
            if time.monotonic() > deadline:
                # mark the abandoned item so a later leader drops it
                # instead of burning a dispatch (and advancing the
                # tenant's counters/mirror) on a result nobody reads
                item.cancelled = True
                raise TimeoutError(
                    f"tenant {tenant!r} solve timed out after {timeout}s")
        if item.error is not None:
            raise item.error
        return item.resp, item.stale

    def solve_many(self, requests: List[Tuple[str, str, object]]):
        """Deterministic batch entry: admit every request, then drain on
        this thread — same-key fused lanes (up to MAX_MEGA_LANES at a
        time) are GUARANTEED to coalesce. Returns responses in order."""
        items = [self.admit(t, lane, r) for t, lane, r in requests]
        with self._leader:
            while any(not it.done.is_set() for it in items):
                self._drain()
        out = []
        for it in items:
            if it.error is not None:
                raise it.error
            out.append(it.resp)
        return out

    # -- dispatch --------------------------------------------------------
    def _stash(self, item: Item) -> None:
        """Cache the tenant's latest decisions as a versioned mirror —
        the serve-stale shed mode's source. Monotonic per tenant.
        Routed through upload_mirror (not mirrors.upload) so the upload
        hooks see every decisions bump."""
        session = self.registry.get(item.tenant)
        version = session.mirrors.version("decisions") + 1
        session.upload_mirror("decisions", version, item.resp)

    def _drain(self) -> None:
        items = self.queue.pull(megasolve.MAX_MEGA_LANES)
        if not items:
            return
        groups: dict = {}
        singles: List[Tuple[Item, object]] = []
        for it in items:
            if it.cancelled:
                it.finish(error=TimeoutError("abandoned by its waiter"))
                continue
            try:
                w = rpc_server.decode_snapshot(it.req)
                lane = rpc_server.fused_lane_args(it.req, w)
            except Exception as e:  # noqa: BLE001 — a bad request fails
                it.finish(error=e)  # only its own future
                continue
            if lane is None:
                singles.append((it, w))
            else:
                groups.setdefault(megasolve.lane_key(*lane),
                                  []).append((it, w, lane))
        for group in groups.values():
            if len(group) == 1:
                it, w, _ = group[0]
                singles.append((it, w))
                continue
            try:
                blocks, solve_ms = megasolve.solve_lanes(
                    [lane for _, _, lane in group], device=self.device)
                metrics.count_mega_dispatch(len(group))
                for (it, w, _), hb in zip(group, blocks):
                    it.resp = rpc_server.fused_response(it.req, w, hb,
                                                        solve_ms,
                                                        tenant=it.tenant)
                    self._stash(it)
                    metrics.count_tenant(it.tenant, "solves")
                    metrics.count_tenant(it.tenant, "mega_solves")
                    it.done.set()
            except Exception as e:  # noqa: BLE001 — fail the REMAINDER
                # of the group: lanes already fulfilled (resp set, done
                # set) must not be re-finished — a waiter past its done
                # check could observe resp nulled mid-read
                for it, _, _ in group:
                    if not it.done.is_set():
                        it.finish(error=e)
        for it, w in singles:
            try:
                it.resp = rpc_server.solve_snapshot(it.req, w,
                                                    tenant=it.tenant,
                                                    device=self.device)
                self._stash(it)
                metrics.count_tenant(it.tenant, "solves")
            except Exception as e:  # noqa: BLE001
                it.error = e
            it.done.set()


#: the process's active service (``install``; the reference's
#: make_server installs the one it builds)
_ACTIVE: Optional[TenantSolveService] = None


def install(svc: Optional[TenantSolveService]) -> Optional[TenantSolveService]:
    global _ACTIVE
    _ACTIVE = svc
    return svc


def active() -> Optional[TenantSolveService]:
    return _ACTIVE
