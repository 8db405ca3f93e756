"""The port's solver wire (kubebatch_tpu_torch/rpc) against the reference
package's protobuf wire (kubebatch_tpu/rpc).

Both packages build the same seeded cluster (each with its own sim, the
process-wide uid counters of both restarted so task and job uids agree)
and encode one session each: the port's messages must serialize to the
bytes protoc's classes write, parse back to the same message, decode to
the same padded arrays and fused lane, group by lane key as the
reference groups, and solve (fused, batched and affinity routes, the
port on the CPU) to the same decisions. Tolerance 0 throughout.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import replace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.objects import PodPhase as JPhase  # noqa: E402
from kubebatch_tpu.rpc import client as j_client  # noqa: E402
from kubebatch_tpu.rpc import server as j_server  # noqa: E402
from kubebatch_tpu.rpc import solver_pb2 as pb  # noqa: E402
from kubebatch_tpu.rpc import victims_wire as j_vwire  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu.tenantsvc import megasolve as j_mega  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.objects import PodPhase as TPhase  # noqa: E402
from kubebatch_tpu_torch.rpc import client as t_client  # noqa: E402
from kubebatch_tpu_torch.rpc import server as t_server  # noqa: E402
from kubebatch_tpu_torch.rpc import wire  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402
from kubebatch_tpu_torch.tenantsvc import megasolve as t_mega  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    yield
    j_faults.reset()
    t_faults.reset()


class _Binder:
    def __init__(self):
        self.fresh = []

    def bind(self, pod, hostname):
        pod.node_name = hostname
        self.fresh.append(pod)

    def evict(self, pod):
        pod.deletion_timestamp = 1.0


def _reduced(name):
    if name == "3p-reduced":
        return replace(J_SPECS["3p"], n_nodes=100, n_groups=150)
    return J_SPECS[name]


def _session(monkeypatch, torch_side: bool, spec, steady: bool):
    """One package's cluster at ``spec``: cold, or after one cold auto
    cycle, a kubelet tick and a churn of 8 pods (``steady``). The uid
    counter restarts at 1, so both packages mint the same uids."""
    objects = t_objects if torch_side else j_objects
    monkeypatch.setattr(objects, "_uid_counter", itertools.count(1))
    binder = _Binder()
    if torch_side:
        sim = t_build(TSpec(**vars(spec)))
        cache = TCache(binder=binder, evictor=binder, async_writeback=False,
                       device="cpu")
        alloc, opn, close, tiers, phase = (TAllocate, TOpen, TClose,
                                           t_tiers, TPhase)
    else:
        sim = j_build(spec)
        cache = JCache(binder=binder, evictor=binder, async_writeback=False)
        alloc, opn, close, tiers, phase = (JAllocate, JOpen, JClose,
                                           j_tiers, JPhase)
    sim.populate(cache)
    if steady:
        ssn = opn(cache, tiers())
        alloc(mode="fused").execute(ssn)
        close(ssn)
        for pod in binder.fresh:
            pod.phase = phase.RUNNING
            cache.update_pod(pod, pod)
        sim.churn_tick(cache, 8)
    return opn(cache, tiers()), close


def _pair(monkeypatch, name, seed=0, steady=False):
    """(reference request, port request) for one seeded case."""
    spec = replace(_reduced(name), seed=seed)
    out = []
    for torch_side in (False, True):
        ssn, close = _session(monkeypatch, torch_side, spec, steady)
        enc = t_client if torch_side else j_client
        req, tasks = enc.build_snapshot(ssn)
        assert list(tasks) == list(req.tasks.uids)
        close(ssn)
        out.append(req)
    return out


#: (spec, steady): the fused route ("t" cold and steady, cfg2 steady),
#: the batched route (cfg2 cold) and the affinity route (2p, a cut 3p)
CASES = [("t", False), ("t", True), (2, False), (2, True), ("2p", False),
         ("3p-reduced", False)]
IDS = ["t-cold", "t-steady", "cfg2-cold", "cfg2-steady", "2p", "3p-reduced"]


@pytest.mark.parametrize("name,steady", CASES, ids=IDS)
def test_snapshot_bytes_decode_and_decisions_equal_the_reference(
        monkeypatch, name, steady):
    jreq, treq = _pair(monkeypatch, name, steady=steady)
    raw = jreq.SerializeToString()
    assert treq.SerializeToString() == raw
    # both parsers read the other's bytes back to the same message
    again = wire.SnapshotRequest.FromString(raw)
    assert again == treq and again.SerializeToString() == raw
    assert pb.SnapshotRequest.FromString(treq.SerializeToString()) == jreq
    if name in ("2p", "3p-reduced"):
        assert len(treq.affinity) == 13

    jw = j_server.decode_snapshot(jreq)
    tw = t_server.decode_snapshot(again)
    for f in jw.__dataclass_fields__:
        a, b = getattr(jw, f), getattr(tw, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        elif f == "affinity" and a is not None:
            for g in a.__dataclass_fields__:
                x, y = getattr(a, g), getattr(b, g)
                assert np.array_equal(np.asarray(x), np.asarray(y)), g
                assert np.asarray(x).dtype == np.asarray(y).dtype, g
        else:
            assert a == b, f
    jl = j_server.fused_lane_args(jreq, jw)
    tl = t_server.fused_lane_args(again, tw)
    assert (jl is None) == (tl is None) == tw.use_batched
    if jl is not None:
        assert jl[1] == tl[1]
        for a, b in zip(jl[0], tl[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    jresp = j_server.solve_snapshot(jreq)
    tresp = t_server.solve_snapshot(again, device="cpu")
    assert len(tresp.decisions) == len(jreq.tasks.uids)
    assert sum(d.kind in (1, 2, 3) for d in tresp.decisions) > 0
    assert tresp.iterations == jresp.iterations
    jresp.solve_ms = 0.0
    tresp.solve_ms = 0.0
    assert tresp.SerializeToString() == jresp.SerializeToString()


def test_lane_key_groups_as_the_reference(monkeypatch):
    """The "t" lanes of four seeds, a steady "t" lane and a batched-sized
    cfg2 request: the port's lane keys partition them as the
    reference's signature keys do."""
    reqs = [_pair(monkeypatch, "t", seed=s) for s in range(4)]
    reqs.append(_pair(monkeypatch, "t", seed=1, steady=True))
    reqs.append(_pair(monkeypatch, 2))
    parts = []
    for side, (srv, mega) in enumerate(((j_server, j_mega),
                                        (t_server, t_mega))):
        groups = {}
        for k, pair in enumerate(reqs):
            lane = srv.fused_lane_args(pair[side])
            key = None if lane is None else mega.lane_key(*lane)
            groups.setdefault(key, []).append(k)
        parts.append(sorted(groups.values()))
    assert parts[0] == parts[1]
    assert [0, 1, 2, 3] in parts[1] and [5] in parts[1]


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "float64",
                                   "int64", "uint8"])
def test_tensor_round_trip_equals_the_reference(dtype):
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((3, 5)) * 100).astype(dtype)
    if dtype == "float32":
        arr[0, 0] = -0.0
        arr[0, 1] = np.nan
    mine, theirs = wire.to_tensor(arr), j_vwire.to_tensor(arr)
    assert mine.SerializeToString() == theirs.SerializeToString()
    back = wire.from_tensor(wire.Tensor.FromString(
        theirs.SerializeToString()))
    ref = j_vwire.from_tensor(theirs)
    assert back.dtype == ref.dtype and back.shape == ref.shape
    assert back.tobytes() == ref.tobytes()


def test_scalar_and_packed_edges_equal_protoc():
    """Defaults left out, -0.0 and NaN written, negative int32s as ten
    bytes, empty strings kept in a repeated field, a submessage present
    once touched even with nothing in it; unknown fields skipped and
    unpacked repeated scalars read."""
    ints = np.array([0, 1, 127, 128, 300, 16384, -1, -2 ** 31, 2 ** 31 - 1],
                    np.int32)
    mine = wire.SnapshotRequest(gang_enabled=False, affinity_ip_weight=-0.0)
    theirs = pb.SnapshotRequest(gang_enabled=False, affinity_ip_weight=-0.0)
    mine.jobs.queue_index = ints
    theirs.jobs.queue_index.extend(ints.tolist())
    mine.nodes.names = ["", "n-é", ""]
    theirs.nodes.names.extend(["", "n-é", ""])
    mine.tasks.uids = []
    theirs.tasks.uids.extend([])
    mine.terms.least_requested_weight = 0.0
    theirs.terms.least_requested_weight = 0.0
    mine.cluster_total = [np.nan, np.inf, -np.inf]
    theirs.cluster_total.extend([np.nan, np.inf, -np.inf])
    mine.affinity.append(wire.Tensor(shape=[0], dtype=0))
    theirs.affinity.append(pb.Tensor(shape=[0], dtype=0))
    raw = theirs.SerializeToString()
    assert mine.SerializeToString() == raw
    assert not wire.SnapshotRequest().HasField("tasks")
    assert wire.SnapshotRequest.FromString(raw).HasField("tasks")
    assert wire.SnapshotRequest.FromString(raw).SerializeToString() == raw
    d = wire.Decision(task_uid="x", kind=0, order=-1)
    assert d.SerializeToString() == pb.Decision(
        task_uid="x", kind=0, order=-1).SerializeToString()
    # an unknown field (number 99, varint) is skipped, unpacked int32s
    # (field 4 of TaskTensors, one varint each) are read
    parsed = wire.SnapshotRequest.FromString(raw + b"\x98\x06\x05")
    assert parsed.SerializeToString() == raw
    loose = b"\x20\x05\x20\xfd\xff\xff\xff\x0f\x98\x06\x01"
    assert wire.TaskTensors.FromString(loose).job_index.tolist() == \
        list(pb.TaskTensors.FromString(loose).job_index) == [5, -3]
    with pytest.raises(wire.DecodeError):
        wire.SnapshotRequest.FromString(raw[:-1])
