"""Multi-tenant simulation: N simulated clusters through ONE tenant solve
service, and the saturation run (ref: kubebatch_tpu/sim/tenants.py).

Two entry points, both over an in-process ``TenantSolveService`` on
``device`` (the card unless the caller passes ``device="cpu"``):

- :func:`run_multi_tenant` — every tenant is an independent simulated
  cluster (the "t" spec, seeded by tenant index) driving real scheduling
  cycles against one shared service, one thread per tenant (so the
  service's combining dispatcher sees real concurrency and coalesces
  opportunistically). Each tenant's end state is compared against a
  DEDICATED in-process run of the same seeded cluster.
- :func:`run_saturation` — per-tenant callers fire pre-built solve
  requests closed-loop to measure solves/s at capacity, then an
  open-loop pass offers 2x that rate and records the p99 latency of
  completed solves, each timed from its scheduled send, plus the shed
  census (rejected / stale-served) and
  the errors (anything that is not an admission refusal).

A shared cycle does what the reference's ``AllocateAction(mode="rpc")``
does, minus the socket: encode the session (``rpc.client.
build_snapshot``), send the request through its bytes, solve it in the
service, send the answer back through its bytes, and replay it
(``apply_decisions``). A snapshot outside the wire's vocabulary
(ValueError) or a refused admission runs the cycle in-process (counted
as an rpc -> in-process demotion), as the reference does. Every request
and answer crosses the codec (rpc/wire.py), so the numbers include what
a tenant pays for it; only the socket is missing.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device
from .cluster import BASELINE_SPECS, build_cluster

__all__ = ["run_multi_tenant", "run_saturation", "drive_tenant_cycles",
           "MultiTenantReport", "SaturationReport", "TENANT_CONFIG",
           "wire_solve"]

#: the per-tenant cluster spec key (sim/cluster.py BASELINE_SPECS)
TENANT_CONFIG = "t"

#: canonical churn per steady tick for the tenant spec
_TENANT_CHURN = 32


class _Binder:
    def __init__(self):
        self.binds: Dict[str, str] = {}
        self.fresh: List = []

    def bind(self, pod, hostname):
        self.binds[pod.uid] = hostname
        pod.node_name = hostname
        self.fresh.append(pod)

    def evict(self, pod):
        pod.deletion_timestamp = 1.0


def _tenant_cluster(idx: int, config=TENANT_CONFIG,
                    device: DeviceLike = DEFAULT_DEVICE):
    from ..cache import SchedulerCache

    spec = replace(BASELINE_SPECS[config], seed=idx)
    sim = build_cluster(spec)
    binder = _Binder()
    cache = SchedulerCache(binder=binder, evictor=binder,
                           async_writeback=False, device=device)
    sim.populate(cache)
    return sim, cache, binder


def wire_solve(svc, tenant: str, lane: str, req):
    """One request through the service as a tenant sends it, minus the
    socket: the request and the answer each cross the codec as bytes.
    Returns (DecisionsResponse, stale)."""
    from ..rpc.wire import DecisionsResponse, SnapshotRequest

    sent = SnapshotRequest.FromString(req.SerializeToString())
    resp, stale = svc.solve(tenant, lane, sent)
    return DecisionsResponse.FromString(resp.SerializeToString()), stale


def _execute_service(ssn, svc, tenant: str, lane: str = "normal") -> bool:
    """One allocate through the service; False = run it in-process. The
    fallback is taken only BEFORE any session mutation."""
    from ..actions import allocate as _allocate
    from ..rpc.client import apply_decisions, build_snapshot
    from ..tenantsvc.admission import AdmissionError

    try:
        req, tasks_by_uid = build_snapshot(ssn)
    except ValueError:
        return False          # outside the wire's vocabulary: quiet
    try:
        resp, stale = wire_solve(svc, tenant, lane, req)
    except AdmissionError:
        return False          # shed: this cycle in-process
    if stale:
        return False          # a stale mirror is never replayed
    apply_decisions(ssn, resp, tasks_by_uid)
    _allocate.last_cycle_engine = "rpc"
    return True


def drive_tenant_cycles(sim, cache, binder, cycles: int, mode: str,
                        tiers=None, svc=None, tenant: str = "default",
                        churn: int = _TENANT_CHURN) -> Dict[str, tuple]:
    """Run ``cycles`` scheduling cycles (kubelet tick + a churn of
    ``churn`` pods between cycles — the steady regime) and return the
    final task state map {task_key: (status, node)}. ``mode`` "rpc"
    sends each allocate through ``svc`` as ``tenant``; any other mode is
    an in-process ``AllocateAction`` mode."""
    from ..actions.allocate import AllocateAction
    from ..conf import shipped_tiers
    from ..framework import CloseSession, OpenSession
    from ..metrics import count_engine_demotion
    from ..objects import PodPhase

    tiers = tiers or shipped_tiers()
    act = AllocateAction(mode="auto" if mode == "rpc" else mode)
    state: Dict[str, tuple] = {}
    for cyc in range(cycles):
        for pod in binder.fresh:
            if pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)
        binder.fresh.clear()
        if cyc:
            sim.churn_tick(cache, churn)
        ssn = OpenSession(cache, tiers)
        if mode != "rpc" or not _execute_service(ssn, svc, tenant):
            if mode == "rpc":
                count_engine_demotion("rpc", "in-process")
            act.execute(ssn)
        state = {t.key: (str(t.status), t.node_name)
                 for job in ssn.jobs.values() for t in job.tasks.values()}
        CloseSession(ssn)
    return state


@dataclass
class MultiTenantReport:
    tenants: int
    cycles: int
    bit_identical: bool
    mismatched: List[str] = field(default_factory=list)
    solves_by_tenant: Dict[str, int] = field(default_factory=dict)
    mega_dispatches: int = 0
    mega_lanes: int = 0
    rpc_errors: List[str] = field(default_factory=list)


def run_multi_tenant(n_tenants: int = 4, cycles: int = 4,
                     config=TENANT_CONFIG,
                     device: DeviceLike = DEFAULT_DEVICE,
                     svc=None) -> MultiTenantReport:
    """N seeded tenant clusters, one thread each, through one service
    (``svc``, or a fresh one on ``device``); per-tenant end states
    compared to dedicated in-process auto runs of the same seeds."""
    from .. import metrics
    from ..rpc.client import current_tenant, set_tenant
    from ..tenantsvc.service import TenantSolveService

    dev = resolve_device(device)
    svc = svc or TenantSolveService(device=dev)
    mega0 = metrics.mega_dispatches_total()
    lanes0 = metrics.mega_lanes_total()
    solves0 = {t: per.get("solves", 0)
               for t, per in metrics.tenant_counters().items()}
    dedicated = {}
    for i in range(n_tenants):
        sim, cache, binder = _tenant_cluster(i, config, dev)
        dedicated[f"tenant-{i}"] = drive_tenant_cycles(
            sim, cache, binder, cycles, mode="auto")

    shared: Dict[str, Dict] = {}
    errors: List[str] = []

    def worker(i: int):
        tenant = f"tenant-{i}"
        set_tenant(tenant)
        try:
            sim, cache, binder = _tenant_cluster(i, config, dev)
            shared[tenant] = drive_tenant_cycles(
                sim, cache, binder, cycles, mode="rpc", svc=svc,
                tenant=current_tenant())
        except Exception as e:  # noqa: BLE001 — reported, not raised
            errors.append(f"{tenant}: {type(e).__name__}: {e}")
        finally:
            set_tenant(None)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"kb-tenant-{i}")
               for i in range(n_tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)

    mismatched = [t for t in dedicated if shared.get(t) != dedicated[t]]
    per_tenant = metrics.tenant_counters()
    return MultiTenantReport(
        tenants=n_tenants, cycles=cycles,
        bit_identical=not mismatched and not errors,
        mismatched=mismatched,
        solves_by_tenant={t: per_tenant.get(t, {}).get("solves", 0)
                          - solves0.get(t, 0) for t in dedicated},
        mega_dispatches=metrics.mega_dispatches_total() - mega0,
        mega_lanes=metrics.mega_lanes_total() - lanes0,
        rpc_errors=errors)


# ---------------------------------------------------------------------
# saturation
# ---------------------------------------------------------------------

def _tenant_requests(n_tenants: int, config=TENANT_CONFIG,
                     device: DeviceLike = DEFAULT_DEVICE) -> list:
    """One pre-built SnapshotRequest per tenant (seeded numerics, one
    shape class — the coalescible mix)."""
    from ..conf import shipped_tiers
    from ..framework import CloseSession, OpenSession
    from ..rpc.client import build_snapshot

    out = []
    tiers = shipped_tiers()
    for i in range(n_tenants):
        _, cache, _ = _tenant_cluster(i, config, device)
        ssn = OpenSession(cache, tiers)
        req, _ = build_snapshot(ssn)
        CloseSession(ssn)
        out.append(req)
    return out


@dataclass
class SaturationReport:
    tenants: int
    capacity_solves_per_sec: float
    capacity_p50_ms: float
    capacity_solves: int
    #: the schedule's rate (2x capacity) and the rate the sends reached
    overload_offered_per_sec: float
    overload_sent_per_sec: float
    overload_completed_per_sec: float
    overload_p99_ms: float
    overload_rejected: int
    overload_stale_served: int
    #: NON-admission failures during the overload phase (timeouts,
    #: solve errors) — kept apart from rejected so a failing service can
    #: never masquerade as healthy load shedding
    overload_errors: int = 0
    shed_modes_seen: Dict[str, int] = field(default_factory=dict)


def run_saturation(n_tenants: int = 4, duration_s: float = 3.0,
                   config=TENANT_CONFIG,
                   device: DeviceLike = DEFAULT_DEVICE, svc=None,
                   requests: Optional[list] = None) -> SaturationReport:
    """Closed-loop capacity, then 2x-offered overload, through one
    service (``svc``, or a fresh one on ``device``). ``requests``: one
    pre-built SnapshotRequest per tenant (default: the seeded ``config``
    clusters'). Callers use the "batch" lane and accept stale answers
    (they measure service behavior; they schedule nothing).

    The overload pass is open loop, one caller per request, and times
    each latency from the request's scheduled send (the reference's
    pass paces 2 x tenants blocking callers and times from the actual
    send, so a saturated service slows its own offered load and hides
    the backlog). Completed solves give the p99; refusals and stale
    answers are the shed census. The shed ladder is process-wide and
    stays where the overload left it."""
    from .. import metrics
    from ..tenantsvc.admission import AdmissionError
    from ..tenantsvc.service import TenantSolveService

    dev = resolve_device(device)
    svc = svc or TenantSolveService(device=dev)
    reqs = requests if requests is not None else _tenant_requests(
        n_tenants, config, dev)
    n_tenants = len(reqs)
    tenants = [f"tenant-{i}" for i in range(n_tenants)]
    # warm the service off the clock
    for tenant, req in zip(tenants, reqs):
        wire_solve(svc, tenant, "batch", req)

    # ---- phase 1: closed-loop capacity ------------------------------
    lat: List[float] = []
    lock = threading.Lock()
    stop_at = time.perf_counter() + duration_s

    def cap_worker(i: int):
        mine = []
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            wire_solve(svc, tenants[i], "batch", reqs[i])
            mine.append(time.perf_counter() - t0)
        with lock:
            lat.extend(mine)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=cap_worker, args=(i,))
               for i in range(n_tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    capacity = len(lat) / wall if wall else 0.0

    # ---- phase 2: 2x offered overload, open loop ---------------------
    # one caller per request, each sent at its scheduled time k / rate
    # whatever the earlier ones are doing; a latency runs from that
    # scheduled time, so a send that could not go out on time is charged
    # its wait too (no coordinated omission)
    shed0 = metrics.load_shed_total()
    offered_rate = 2.0 * max(1.0, capacity)
    n_sends = max(1, int(offered_rate * duration_s))
    over_lat: List[float] = []
    sent_at: List[float] = []
    rejected = [0]
    errored = [0]
    start = time.perf_counter() + 0.05

    def over_send(k: int):
        due = start + k / offered_rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        with lock:
            sent_at.append(time.perf_counter())
        try:
            wire_solve(svc, tenants[k % n_tenants], "batch",
                       reqs[k % n_tenants])
            done = time.perf_counter() - due
            with lock:
                over_lat.append(done)
        except AdmissionError:
            with lock:
                rejected[0] += 1
        except Exception:   # noqa: BLE001 — NOT shedding
            with lock:
                errored[0] += 1

    threads = [threading.Thread(target=over_send, args=(k,))
               for k in range(n_sends)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall2 = time.perf_counter() - start
    span = max(sent_at) - start + 1.0 / offered_rate
    shed_delta = {k: v - shed0.get(k, 0)
                  for k, v in metrics.load_shed_total().items()
                  if v - shed0.get(k, 0)}
    return SaturationReport(
        tenants=n_tenants,
        capacity_solves_per_sec=capacity,
        capacity_p50_ms=float(np.percentile(lat, 50)) * 1e3 if lat else 0.0,
        capacity_solves=len(lat),
        overload_offered_per_sec=offered_rate,
        overload_sent_per_sec=n_sends / span,
        overload_completed_per_sec=len(over_lat) / wall2 if wall2 else 0.0,
        overload_p99_ms=(float(np.percentile(over_lat, 99)) * 1e3
                         if over_lat else 0.0),
        overload_rejected=rejected[0],
        overload_stale_served=shed_delta.get("serve-stale", 0),
        overload_errors=errored[0],
        shed_modes_seen=shed_delta)
