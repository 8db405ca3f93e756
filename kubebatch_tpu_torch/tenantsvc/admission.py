"""Admission control (ref: kubebatch_tpu/tenantsvc/admission.py):
bounded per-tenant lane queues, weighted-fair dequeue, and the
admission error taxonomy.

Three lanes, drained strictly in order: "latency" (a scheduler whose
cycle deadline is live), "normal" (the default solve traffic), and
"batch" (offline/what-if solves). Within a lane the dispatcher picks
tenants by weighted-fair queuing — each tenant accumulates served
units and the next pull goes to the non-empty tenant with the least
served/weight, so a heavy tenant cannot starve a light one while
still receiving its weighted share.

Admission itself is a bound, not a scheduler: every tenant has a fixed
queue depth per lane, and a full queue rejects THAT tenant's request
(``QueueFullError``) regardless of shed level — back-pressure must land
on the tenant generating it, never on its neighbors. The shed ladder
(faults.SHED) degrades service globally under sustained overload; the
service consults it at admission (service.py) — this module only
carries the queue mechanics and the error taxonomy.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..obs import ledger as _ledger

__all__ = ["LANES", "LANE_INDEX", "AdmissionError", "QueueFullError",
           "ShedRejectError", "QuarantinedTenantError",
           "RegistryFullError", "Item", "AdmissionQueue"]

LANES = ("latency", "normal", "batch")
LANE_INDEX = {name: i for i, name in enumerate(LANES)}

#: default bound per (tenant, lane) — deep enough to ride a burst, small
#: enough that a stalled dispatcher rejects quickly instead of building
#: seconds of queueing delay (the solve deadline is tens of ms)
DEFAULT_DEPTH = 8


class AdmissionError(RuntimeError):
    """Base: the request was refused at admission (the client runs the
    cycle in-process; overload is not a failed service)."""

    reason = "rejected"


class QueueFullError(AdmissionError):
    reason = "queue_full"


class ShedRejectError(AdmissionError):
    reason = "shed"


class QuarantinedTenantError(AdmissionError):
    reason = "quarantined"


class RegistryFullError(AdmissionError):
    """The service's tenant cap is hit and this tenant is unknown — an
    admission refusal, never a generic failure."""

    reason = "registry_full"


class Item:
    """One queued solve. The handler thread waits on ``done``; the
    dispatcher (whichever thread won the leader lock) fills ``resp`` or
    ``error`` and sets it."""

    __slots__ = ("tenant", "lane", "req", "done", "resp", "error",
                 "stale", "cancelled", "t0")

    def __init__(self, tenant: str, lane: str, req):
        self.tenant = tenant
        self.lane = lane
        self.req = req
        self.done = threading.Event()
        self.resp = None
        self.error: Optional[BaseException] = None
        self.stale = False
        #: set by a waiter that gave up (timeout) — a later leader must
        #: not burn a dispatch on, or count/stash, a result nobody reads
        self.cancelled = False
        #: enqueue stamp: the WFQ pull attributes the admission wait to
        #: (tenant, lane) in the decision ledger
        self.t0 = time.monotonic()

    def finish(self, resp=None, error: Optional[BaseException] = None,
               stale: bool = False) -> None:
        self.resp = resp
        self.error = error
        self.stale = stale
        self.done.set()


class AdmissionQueue:
    """Per-tenant bounded lane queues + the weighted-fair pull."""

    def __init__(self, depth: int = DEFAULT_DEPTH):
        self.depth = depth
        self._lock = threading.Lock()
        #: tenant -> [list per lane] (small depths; a list is fine)
        self._queues: Dict[str, List[List[Item]]] = {}
        #: tenant -> served units (WFQ virtual time numerator)
        self._served: Dict[str, float] = {}
        #: tenant -> weight (updated by the service from session state)
        self._weights: Dict[str, float] = {}
        self._total = 0

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._lock:
            self._weights[tenant] = max(1e-6, float(weight))

    def submit(self, item: Item) -> None:
        """Enqueue or raise QueueFullError (per-tenant bound — one
        tenant's burst backs up on itself, not on its neighbors)."""
        with self._lock:
            lanes = self._queues.setdefault(
                item.tenant, [[] for _ in LANES])
            lane = lanes[LANE_INDEX[item.lane]]
            if len(lane) >= self.depth:
                raise QueueFullError(
                    f"tenant {item.tenant!r} lane {item.lane!r} queue "
                    f"full ({self.depth})")
            lane.append(item)
            self._total += 1

    def pull(self, max_items: int) -> List[Item]:
        """Up to ``max_items``, higher lanes strictly first; within a
        lane, repeated weighted-fair picks across tenants (min
        served/weight)."""
        out: List[Item] = []
        with self._lock:
            for li in range(len(LANES)):
                while len(out) < max_items:
                    best = None
                    best_vt = None
                    for tenant, lanes in self._queues.items():
                        if not lanes[li]:
                            continue
                        vt = (self._served.get(tenant, 0.0)
                              / self._weights.get(tenant, 1.0))
                        if best_vt is None or vt < best_vt:
                            best, best_vt = tenant, vt
                    if best is None:
                        break
                    out.append(self._queues[best][li].pop(0))
                    self._served[best] = self._served.get(best, 0.0) + 1.0
                    self._total -= 1
        if out:
            now = time.monotonic()
            for item in out:
                _ledger.observe_admission(item.tenant, item.lane,
                                          max(0.0, now - item.t0))
        return out

    def depth_total(self) -> int:
        with self._lock:
            return self._total

    def capacity(self) -> int:
        """Overload reference for the shed ladder: one LANE's worth of
        depth per tenant (at least one tenant's worth so an empty
        service has a capacity). Deliberately NOT depth x tenants x
        lanes: real overload concentrates on one lane (a burst of
        normal-lane solves), and a reference summed over all three
        lanes could never be approached by single-lane traffic — the
        shed ladder would be unreachable exactly when it is needed."""
        with self._lock:
            return self.depth * max(1, len(self._queues))
