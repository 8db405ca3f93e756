"""The port's tenant solve service (kubebatch_tpu_torch/tenantsvc) against
the reference package's (kubebatch_tpu/tenantsvc).

The reference's own cases that need no grpc (tests/test_tenantsvc.py)
run against both packages (``pkg``), and where both can be driven the
same way their outcomes are compared: the weighted-fair pull order, the
shed ladder's levels, the per-tenant counters. The mega solve's plain
version is held bitwise against the reference's jitted ``_mega_fused``
on 2, 4 and 8 lanes through ``interop.mega_lanes_from_numpy``; the
coalesced service answers and the multi-tenant run against dedicated
runs of both packages. The port runs on the CPU. Tolerance 0.
"""
from __future__ import annotations

import itertools
import os
import threading
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.rpc import client as j_client  # noqa: E402
from kubebatch_tpu.rpc import server as j_server  # noqa: E402
from kubebatch_tpu.sim import tenants as j_tenants  # noqa: E402
from kubebatch_tpu.tenantsvc import admission as j_admission  # noqa: E402
from kubebatch_tpu.tenantsvc import megasolve as j_mega  # noqa: E402
from kubebatch_tpu.tenantsvc import service as j_service  # noqa: E402
from kubebatch_tpu.tenantsvc import sessions as j_sessions  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels.mega import mega_fused, mega_fused_plain  # noqa: E402
from kubebatch_tpu_torch.rpc import client as t_client  # noqa: E402
from kubebatch_tpu_torch.rpc import server as t_server  # noqa: E402
from kubebatch_tpu_torch.sim import tenants as t_tenants  # noqa: E402
from kubebatch_tpu_torch.tenantsvc import admission as t_admission  # noqa: E402
from kubebatch_tpu_torch.tenantsvc import service as t_service  # noqa: E402
from kubebatch_tpu_torch.tenantsvc import sessions as t_sessions  # noqa: E402

SIDES = {
    "ref": SimpleNamespace(
        faults=j_faults, metrics=j_metrics, admission=j_admission,
        service=j_service, sessions=j_sessions, tenants=j_tenants,
        client=j_client, server=j_server, objects=j_objects,
        open=JOpen, close=JClose, tiers=j_tiers, svc_kw={}),
    "port": SimpleNamespace(
        faults=t_faults, metrics=t_metrics, admission=t_admission,
        service=t_service, sessions=t_sessions, tenants=t_tenants,
        client=t_client, server=t_server, objects=t_objects,
        open=TOpen, close=TClose, tiers=t_tiers, svc_kw={"device": "cpu"}),
}
PKGS = list(SIDES)


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    for side in SIDES.values():
        side.faults.reset()
        side.sessions.TENANT_QUARANTINE.reset()
        side.service.install(None)


def _svc(s, **kw):
    return s.service.TenantSolveService(**kw, **s.svc_kw)


def _request(s, seed: int, monkeypatch=None):
    """One seeded "t" tenant's request through the package's encoder
    (the uid counter restarted when ``monkeypatch`` is given, so both
    packages mint the same uids)."""
    if monkeypatch is not None:
        monkeypatch.setattr(s.objects, "_uid_counter", itertools.count(1))
    kw = {} if s is SIDES["ref"] else {"device": "cpu"}
    _, cache, _ = s.tenants._tenant_cluster(seed, **kw)
    ssn = s.open(cache, s.tiers())
    req, _ = s.client.build_snapshot(ssn)
    s.close(ssn)
    return req


def _wire(resp):
    """A response's bytes with solve_ms (a wall time) zeroed."""
    resp.solve_ms = 0.0
    return resp.SerializeToString()


# ---------------------------------------------------------------------
# sessions: the mirror-version scheme and quarantine
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_mirror_store_versions_are_monotonic_per_kind(pkg):
    s = SIDES[pkg].sessions
    store = s.MirrorStore()
    store.upload("nodes", 1, "n1")
    store.upload("nodes", 2, "n2")
    store.upload("ports", 1, "p1")     # kinds version independently
    assert store.get("nodes", 2) == "n2"
    assert store.latest("ports") == (1, "p1")
    for version in (2, 1):             # equal and lower: rejected
        with pytest.raises(s.StaleMirrorError):
            store.upload("nodes", version, "replay")
    with pytest.raises(s.StaleMirrorError):
        store.get("nodes", 1)          # out-of-sync read refused
    assert store.get("nodes", 2) == "n2"
    assert store.kinds() == ("nodes", "ports")
    assert store.version("absent") == -1


@pytest.mark.parametrize("pkg", PKGS)
def test_repeated_stale_uploads_quarantine_the_tenant(pkg):
    side = SIDES[pkg]
    q0 = side.metrics.tenant_counters().get("splitbrain", {}).get(
        "quarantined", 0)
    ssn = side.sessions.TenantSession("splitbrain")
    ssn.upload_mirror("nodes", 5, "v5")
    for _ in range(2):
        with pytest.raises(side.sessions.StaleMirrorError):
            ssn.upload_mirror("nodes", 3, "old")
    assert ssn.quarantined()
    assert side.metrics.tenant_counters()["splitbrain"]["quarantined"] \
        == q0 + 1
    side.sessions.TENANT_QUARANTINE.clear("splitbrain")
    ssn.upload_mirror("nodes", 6, "v6")
    assert not ssn.quarantined()


@pytest.mark.parametrize("pkg", PKGS)
def test_concurrent_conflicting_mirror_uploads_stay_isolated(pkg):
    s = SIDES[pkg].sessions
    registry = s.TenantRegistry()
    errors = []
    barrier = threading.Barrier(2)

    def tenant_worker(name, versions):
        ssn = registry.get(name)
        barrier.wait(timeout=10)
        for v in versions:
            try:
                ssn.upload_mirror("nodes", v, f"{name}-v{v}")
            except s.StaleMirrorError:
                errors.append((name, v))

    a = threading.Thread(target=tenant_worker, args=("a", [1, 2, 3, 2]))
    b = threading.Thread(target=tenant_worker, args=("b", [1, 2, 3, 1]))
    a.start()
    b.start()
    a.join(10)
    b.join(10)
    assert registry.get("a").mirrors.latest("nodes") == (3, "a-v3")
    assert registry.get("b").mirrors.latest("nodes") == (3, "b-v3")
    assert sorted(errors) == [("a", 2), ("b", 1)]
    assert registry.tenants() == ("a", "b")
    registry.drop("a")
    assert registry.get("a", create=False) is None


def test_upload_hooks_see_clean_uploads_only():
    seen = []

    def hook(session, kind, version, payload):
        seen.append((session.tenant, kind, version, payload))

    t_sessions.on_mirror_upload(hook)
    try:
        ssn = t_sessions.TenantSession("h")
        ssn.upload_mirror("decisions", 1, "d1")
        with pytest.raises(t_sessions.StaleMirrorError):
            ssn.upload_mirror("decisions", 1, "again")
    finally:
        t_sessions.remove_mirror_upload_hook(hook)
    assert seen == [("h", "decisions", 1, "d1")]


# ---------------------------------------------------------------------
# admission: lanes, weighted fairness, bounds
# ---------------------------------------------------------------------

def test_admission_lane_priority_and_weighted_fair_equal_the_reference():
    pulled = {}
    for pkg, side in SIDES.items():
        a = side.admission
        q = a.AdmissionQueue(depth=8)
        q.set_weight("heavy", 3.0)
        q.set_weight("light", 1.0)
        for i in range(6):
            q.submit(a.Item("heavy", "normal", f"h{i}"))
        for i in range(2):
            q.submit(a.Item("light", "normal", f"l{i}"))
        q.submit(a.Item("light", "latency", "urgent"))
        q.submit(a.Item("light", "batch", "later"))
        first = [it.req for it in q.pull(6)]
        assert first[0] == "urgent"       # the latency lane drains first
        normals = [r[0] for r in first[1:]]
        assert normals.count("h") >= 3 and normals.count("l") >= 1
        pulled[pkg] = first + [it.req for it in q.pull(8)]
        assert q.depth_total() == 0 and q.capacity() == 16
    assert pulled["port"] == pulled["ref"]
    assert pulled["port"][-1] == "later"


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_queue_bound_rejects_the_bursting_tenant(pkg):
    a = SIDES[pkg].admission
    q = a.AdmissionQueue(depth=2)
    q.submit(a.Item("t", "normal", 1))
    q.submit(a.Item("t", "normal", 2))
    with pytest.raises(a.QueueFullError):
        q.submit(a.Item("t", "normal", 3))
    # other lanes and other tenants are unaffected
    q.submit(a.Item("t", "batch", 4))
    q.submit(a.Item("other", "normal", 5))


def test_shed_ladder_walks_as_the_reference():
    """Escalation after shed_after overloaded admissions, recovery after
    recover_after calm ones past the cooldown: the same level after
    every step in both packages, and the shed_level gauge follows."""
    seq = [True] * 7 + [False] * 9 + [True, False] * 3 + [False] * 6
    levels = {}
    for pkg, side in SIDES.items():
        f = side.faults
        ladder = f.ShedLadder(policy=f.BackoffPolicy(cooldown=0.0),
                              shed_after=2, recover_after=2)
        assert ladder.mode() == "none"
        walk = []
        for over in seq:
            ladder.record_pressure(over)
            walk.append(ladder.level)
            assert side.metrics.shed_level() == ladder.level
        levels[pkg] = walk
        assert f.SHED_LEVELS == ("none", "serve-stale", "reject-lowest")
        ladder.reset()
        assert side.metrics.shed_level() == 0
    assert levels["port"] == levels["ref"]
    assert max(levels["port"]) == 2 and levels["port"][-1] == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_modes_serve_stale_then_reject_lowest(pkg):
    side = SIDES[pkg]
    svc = _svc(side)
    before = side.metrics.tenant_counters().get("t", {}).get(
        "stale_served", 0)
    shed0 = side.metrics.load_shed_total()
    svc.registry.get("t").mirrors.upload("decisions", 1, "cached-resp")
    side.faults.SHED.level = 1           # serve-stale
    try:
        item = svc.admit("t", "batch", object())
        assert item.done.is_set() and item.stale
        assert item.resp == "cached-resp"
        # the latency lane is never shed — it queues normally
        item = svc.admit("t", "latency", object())
        assert not item.done.is_set()
        side.faults.SHED.level = 2       # reject-lowest
        with pytest.raises(side.admission.ShedRejectError):
            svc.admit("t", "batch", object())
        # the normal lane now serves stale
        item = svc.admit("t", "normal", object())
        assert item.done.is_set() and item.stale
    finally:
        side.faults.SHED.level = 0
    per = side.metrics.tenant_counters()["t"]
    assert per["stale_served"] == before + 2
    shed = side.metrics.load_shed_total()
    assert shed["serve-stale"] - shed0.get("serve-stale", 0) == 2
    assert shed["reject-lowest"] - shed0.get("reject-lowest", 0) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_admission_fault_seam_rejects(pkg):
    side = SIDES[pkg]
    svc = _svc(side)
    side.faults.arm(side.faults.FaultPlan(counts={"rpc.admission": 1}))
    with pytest.raises(side.faults.FaultInjected) as ei:
        svc.admit("t", "normal", object())
    # the injected fault is ALSO an AdmissionError: the caller runs the
    # cycle in-process, as for any admission refusal
    assert isinstance(ei.value, side.admission.AdmissionError)
    assert isinstance(ei.value, side.service.InjectedAdmissionFault)
    svc.admit("t", "normal", object())   # the count is spent
    side.faults.disarm()


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_full_is_an_admission_refusal(pkg):
    side = SIDES[pkg]
    svc = _svc(side, registry=side.sessions.TenantRegistry(max_tenants=1))
    svc.admit("first", "normal", object())
    with pytest.raises(side.admission.RegistryFullError) as ei:
        svc.admit("second", "normal", object())
    assert isinstance(ei.value, side.admission.AdmissionError)
    svc.admit("first", "normal", object())


@pytest.mark.parametrize("pkg", PKGS)
def test_quarantined_tenant_and_full_queue_are_refused(pkg):
    side = SIDES[pkg]
    svc = _svc(side, depth=1)
    before = dict(side.metrics.tenant_counters().get("q", {}))
    svc.admit("q", "normal", object())
    with pytest.raises(side.admission.QueueFullError):
        svc.admit("q", "normal", object())
    side.sessions.TENANT_QUARANTINE.trip("q")
    with pytest.raises(side.admission.QuarantinedTenantError):
        svc.admit("q", "normal", object())
    per = side.metrics.tenant_counters()["q"]
    assert per["queue_full"] - before.get("queue_full", 0) == 1
    assert per["rejected"] - before.get("rejected", 0) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_cancelled_item_is_dropped_not_dispatched(pkg):
    side = SIDES[pkg]
    svc = _svc(side)
    item = svc.admit("t", "normal", _request(side, 0))
    item.cancelled = True              # what a timed-out waiter does
    before = side.metrics.tenant_counters().get("t", {}).get("solves", 0)
    with svc._leader:
        svc._drain()
    assert item.done.is_set()
    assert isinstance(item.error, TimeoutError)
    assert side.metrics.tenant_counters().get("t", {}).get(
        "solves", 0) == before
    assert svc.registry.get("t").mirrors.latest("decisions") is None


# ---------------------------------------------------------------------
# mega coalescing: bit-identity + one dispatch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("b", [2, 4, 8])
def test_mega_fused_plain_equals_the_reference_mega_kernel(b):
    """The reference's stacked lanes (b seeded tenants, one lane bucket)
    through its jitted _mega_fused and, carried over by
    interop.mega_lanes_from_numpy, through mega_fused on the CPU (the
    plain version): every output of every lane bitwise equal."""
    ref = SIDES["ref"]
    lanes = [j_server.fused_lane_args(_request(ref, s)) for s in range(b)]
    assert len({j_mega.lane_key(*lane) for lane in lanes}) == 1
    statics = lanes[0][1]
    stacked = j_mega._stack_lanes([args for args, _ in lanes], b)
    want = [np.asarray(x) for x in j_mega._mega()(*stacked, **statics)]
    got = mega_fused(*interop.mega_lanes_from_numpy(stacked, "cpu"),
                     **statics)
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        g = g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype
        assert w.tobytes() == g.tobytes()
    # the plain version is the single fused solve lane by lane
    plain = mega_fused_plain(*interop.mega_lanes_from_numpy(stacked,
                                                            "cpu"),
                             **statics)
    assert all(torch.equal(p, g) for p, g in zip(plain, got))


def test_mega_solve_one_dispatch_equals_dedicated_and_the_reference(
        monkeypatch):
    """Four same-bucket tenants through solve_many: one mega dispatch of
    four lanes, one counted copy, each answer equal to the dedicated
    solve's and, byte for byte, to the reference service's."""
    answers = {}
    for pkg, side in SIDES.items():
        reqs = [_request(side, s, monkeypatch) for s in range(4)]
        singles = [side.server.solve_snapshot(r, **side.svc_kw)
                   for r in reqs]
        assert all(len(r.decisions) == 32 for r in singles)
        svc = _svc(side)
        m0 = side.metrics.mega_dispatches_total()
        l0 = side.metrics.mega_lanes_total()
        rb0 = t_metrics.blocking_readbacks()
        resps = svc.solve_many([(f"t{i}", "normal", r)
                                for i, r in enumerate(reqs)])
        assert side.metrics.mega_dispatches_total() == m0 + 1
        assert side.metrics.mega_lanes_total() == l0 + 4
        if pkg == "port":
            assert t_metrics.blocking_readbacks() == rb0 + 1
        for a, r in zip(singles, resps):
            assert _wire(a) == _wire(r)
        per = side.metrics.tenant_counters()
        assert all(per[f"t{i}"].get("mega_solves", 0) >= 1
                   for i in range(4))
        assert [svc.registry.get(f"t{i}").mirrors.latest("decisions")[1]
                for i in range(4)] == resps
        answers[pkg] = [_wire(r) for r in resps]
    assert answers["port"] == answers["ref"]


def test_mega_groups_only_matching_lanes_and_a_batched_single(
        monkeypatch):
    """A batched-sized request does not coalesce: the service solves it
    singly through the round engine while the "t" lanes share one
    dispatch — the same answers as the reference service's."""
    from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS
    from kubebatch_tpu.sim import build_cluster as j_build
    from kubebatch_tpu_torch.sim import ClusterSpec as TSpec
    from kubebatch_tpu_torch.sim import build_cluster as t_build

    answers = {}
    for pkg, side in SIDES.items():
        reqs = [_request(side, s, monkeypatch) for s in range(3)]
        monkeypatch.setattr(side.objects, "_uid_counter",
                            itertools.count(1))
        if pkg == "ref":
            from kubebatch_tpu.cache import SchedulerCache
            sim = j_build(J_SPECS[2])
            cache = SchedulerCache(async_writeback=False)
        else:
            from kubebatch_tpu_torch.cache import SchedulerCache
            sim = t_build(TSpec(**vars(J_SPECS[2])))
            cache = SchedulerCache(async_writeback=False, device="cpu")
        sim.populate(cache)
        ssn = side.open(cache, side.tiers())
        big, _ = side.client.build_snapshot(ssn)
        side.close(ssn)
        assert side.server.fused_lane_args(big) is None
        svc = _svc(side)
        m0 = side.metrics.mega_dispatches_total()
        resps = svc.solve_many([(f"t{i}", "normal", r)
                                for i, r in enumerate(reqs + [big])])
        assert side.metrics.mega_dispatches_total() == m0 + 1
        answers[pkg] = [_wire(r) for r in resps]
    assert answers["port"] == answers["ref"]


def test_four_tenants_one_service_equal_dedicated_runs_of_both():
    """Four "t" tenants, one thread each, through one service on the CPU:
    every tenant's end state equals its dedicated in-process run, and
    the dedicated runs equal the reference's (task keys are
    namespace/name)."""
    rep = t_tenants.run_multi_tenant(n_tenants=4, cycles=2, device="cpu")
    assert rep.bit_identical, (rep.mismatched, rep.rpc_errors)
    assert all(v == 2 for v in rep.solves_by_tenant.values()), \
        rep.solves_by_tenant
    assert rep.mega_lanes >= 2 * rep.mega_dispatches
    for i in range(4):
        mine = t_tenants.drive_tenant_cycles(
            *t_tenants._tenant_cluster(i, device="cpu"), 2, mode="auto")
        theirs = j_tenants.drive_tenant_cycles(
            *j_tenants._tenant_cluster(i), 2, mode="auto")
        assert mine == theirs, i


def test_saturation_reports_capacity_and_overload_on_the_cpu():
    """The saturation run's phases on tiny durations: solves
    completed, no errors, every shed mode it saw counted."""
    svc = t_service.TenantSolveService(device="cpu", depth=2)
    rep = t_tenants.run_saturation(n_tenants=2, duration_s=0.3,
                                   device="cpu", svc=svc)
    assert rep.tenants == 2 and rep.capacity_solves > 0
    assert rep.capacity_solves_per_sec > 0 and rep.capacity_p50_ms > 0
    assert rep.overload_errors == 0
    assert rep.overload_offered_per_sec == pytest.approx(
        2 * max(1.0, rep.capacity_solves_per_sec))
    assert rep.overload_stale_served == rep.shed_modes_seen.get(
        "serve-stale", 0)


def test_counters_snapshot_tenant_section_equals_the_reference():
    """The same admissions and solves through both services move the
    same per-tenant counters, and counters_snapshot carries them in a
    "tenants" section with the reference's keys."""
    deltas = {}
    for pkg, side in SIDES.items():
        before = side.metrics.tenant_counters()
        shed0 = side.metrics.load_shed_total()
        svc = _svc(side)
        svc.solve_many([(f"snap-{i}", "normal", _request(side, i))
                        for i in range(2)])
        svc.solve("snap-0", "latency", _request(side, 2))
        side.faults.SHED.level = 1
        try:
            assert svc.admit("snap-1", "batch", object()).stale
        finally:
            side.faults.SHED.level = 0
        snap = side.metrics.counters_snapshot(include_rpc=False)
        assert snap["shed_level"] == 0
        tenants = snap["tenants"]
        deltas[pkg] = {
            t: {k: v - before.get(t, {}).get(k, 0) for k, v in per.items()}
            for t, per in tenants.items() if t.startswith("snap-")}
        deltas[pkg]["shed"] = {
            k: v - shed0.get(k, 0)
            for k, v in snap["load_shed_total"].items()
            if v - shed0.get(k, 0)}
        for key in ("mega_dispatches_total", "mega_lanes_total",
                    "load_shed_total", "shed_level"):
            assert key in snap
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"]["snap-0"] == {"solves": 2, "mega_solves": 1}
