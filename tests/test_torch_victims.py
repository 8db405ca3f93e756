"""The port's victim analysis against the reference package's, on the CPU.

Same inputs (seeded numpy, or the arrays the reference's victim solver
builds for a session) go through the reference's jitted functions and
the port's plain versions. Tolerance 0 throughout: the outputs are bool
and int32 masks and the float32 helpers repeat the reference's
operations in its order, so everything compares bit for bit.

- the in-kernel helpers (``_seg_excl_cumsum``'s scan tree, ``_share3``,
  ``_le_eps``) and the numpy node score the host chooser uses;
- ``VictimState`` word for word against the reference's on the same
  session (both caches non-incremental);
- ``wave_plain`` / ``visit_plain`` against ``_wave_kernel`` /
  ``_visit_kernel`` on arrays fed through
  ``interop.victim_inputs_from_numpy``.

The actions built on them are held against the reference in
tests/test_torch_victim_actions.py; the CUDA kernels against these plain
versions in tests/test_torch_cuda.py.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.api import TaskStatus as JStatus  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import victims as jv  # noqa: E402
from kubebatch_tpu.kernels.solver import \
    dynamic_node_score as j_dynamic_node_score  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.api import TaskStatus as TStatus  # noqa: E402
from kubebatch_tpu_torch.api.resource import VEC_EPS  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import victims as tv  # noqa: E402
from kubebatch_tpu_torch.kernels.solver import dynamic_node_score_np  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_cuda import World, contended_build, random_problem  # noqa: E402

GiB = 1024 ** 3
PREEMPT_TIERS = (("gang", "conformance"), ("drf",))
RECLAIM_TIERS = (("gang", "conformance"), ("proportion",))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _assert_bitwise(ref, got, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    bad = np.flatnonzero(_bits(ref) != _bits(got))
    assert bad.size == 0, (f"{what}: {bad.size} bytes differ, first at "
                           f"byte {bad[0]}")


# ---------------------------------------------------------------------
# twin worlds: one scenario built in either package's objects
# ---------------------------------------------------------------------

J_WORLD = World(j_objects)
T_WORLD = World(t_objects)


def twin_sessions(build):
    """(reference session, port session) on the same world; both caches
    take full snapshots, the port's on the CPU."""
    jc = JCache(async_writeback=False, incremental_snapshot=False)
    tc = TCache(async_writeback=False, device="cpu")
    build(jc, J_WORLD)
    build(tc, T_WORLD)
    return JOpen(jc, j_tiers()), TOpen(tc, t_tiers())


def sim_build(**spec):
    """A world from the sims' ClusterSpec (same spec and seed in both)."""
    def build(cache, w):
        sim = (j_build(JSpec(**spec)) if w is J_WORLD
               else t_build(TSpec(**spec)))
        sim.populate(cache)
    return build


def pending_of(ssn, status):
    return [t for j in ssn.jobs.values()
            for t in j.task_status_index.get(status.PENDING, {}).values()]


# ---------------------------------------------------------------------
# helpers against JAX
# ---------------------------------------------------------------------

@pytest.mark.parametrize("v", [1, 2, 7, 37, 4096, 20480])
def test_seg_excl_cumsum_matches_reference(v):
    rng = np.random.default_rng(v)
    vals = (rng.uniform(0, 4000, (v, 3))
            * rng.choice([1.0, 1e3, 1e-3], (v, 3))).astype(np.float32)
    head = rng.random(v) < 0.2
    head[0] = True
    want = np.asarray(jv._seg_excl_cumsum(jnp.asarray(vals),
                                          jnp.asarray(head)))
    got = tv._seg_excl_cumsum(torch.from_numpy(vals),
                              torch.from_numpy(head)).numpy()
    _assert_bitwise(want, got, f"_seg_excl_cumsum V={v}")
    # the lane-batched form the plain analysis uses ([V, L, 3])
    vals3 = np.stack([vals, vals[::-1]], axis=1)
    got3 = tv._seg_excl_cumsum(torch.from_numpy(vals3),
                               torch.from_numpy(head)).numpy()
    _assert_bitwise(want, got3[:, 0], f"_seg_excl_cumsum V={v} lane 0")


def test_share3_and_le_eps_match_reference():
    rng = np.random.default_rng(5)
    eps = VEC_EPS
    vec = rng.uniform(-50, 5000, (64, 3)).astype(np.float32)
    vec[::7] = 0.0
    tot = rng.uniform(1, 9000, (64, 3)).astype(np.float32)
    tot[::5] = 0.0
    tot[3, 1] = 0.0
    want = np.asarray(jv._share3(jnp.asarray(vec), jnp.asarray(tot)))
    got = tv._share3(torch.from_numpy(vec), torch.from_numpy(tot)).numpy()
    _assert_bitwise(want, got, "_share3")
    a = rng.uniform(0, 5000, (64, 3)).astype(np.float32)
    b = a + (np.asarray(eps)[None] * rng.choice(
        [-1.0, -0.5, 0.0, 0.5, 1.0, 2.0], (64, 3))).astype(np.float32)
    want = np.asarray(jv._le_eps(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(eps)))
    got = tv._le_eps(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(np.asarray(eps))).numpy()
    _assert_bitwise(want, got, "_le_eps")


def test_dynamic_node_score_np_matches_reference():
    rng = np.random.default_rng(9)
    n = 257
    cap = np.stack([rng.uniform(3200, 9600, n), rng.uniform(6554, 19661, n)],
                   axis=1).astype(np.float32)
    nz = (cap * rng.uniform(0.0, 1.1, (n, 2))).astype(np.float32)
    cap[0] = 0.0
    cap[1, 0] = 0.0
    t_nz = np.asarray([1000.0, 2048.0], np.float32)
    nz[3] = cap[3] - t_nz
    w = np.asarray([1.0, 2.0], np.float32)
    want = j_dynamic_node_score(nz, t_nz, cap, w, xp=np)
    got = dynamic_node_score_np(nz, t_nz, cap, w)
    assert got.dtype == np.float32
    _assert_bitwise(want, got, "dynamic_node_score_np")


# ---------------------------------------------------------------------
# VictimState word for word
# ---------------------------------------------------------------------

STATE_FIELDS = ("v_node", "v_job", "v_res", "v_critical", "v_live",
                "perm_nj", "nj_head", "perm_nq", "nq_head", "host_rank",
                "ready_cnt", "min_av", "j_alloc", "job_queue", "q_alloc",
                "q_deserved", "q_prop_ok", "nz_req", "n_tasks",
                "cluster_total", "node_ok", "max_task_num",
                "allocatable_cm")


@pytest.mark.parametrize("build", [
    contended_build(3),
    sim_build(n_nodes=70, n_groups=40, pods_per_group=4, min_member=2,
              running_fill=0.9, n_queues=3, queue_weights=(1, 2, 3),
              priority_classes=(("low", 10), ("high", 1000)),
              pod_cpu_millis=1000, pod_mem_bytes=2 * GiB, jitter=0.2),
], ids=["contended", "sim70"])
def test_victim_state_matches_reference(build):
    jss, tss = twin_sessions(build)
    jp, tp = pending_of(jss, JStatus), pending_of(tss, TStatus)
    for fns, dis, score in (("preemptable_fns", "preemptable_disabled",
                             True),
                            ("reclaimable_fns", "reclaimable_disabled",
                             False)):
        js = jv.build_victim_solver(jss, jp, fns, dis, score)
        ts = tv.build_victim_solver(tss, tp, fns, dis, score)
        a, b = js.state, ts.state
        for f in STATE_FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
            _assert_bitwise(x, y, f)
        assert a.j_index == b.j_index and a.q_index == b.q_index
        # pod uids come from per-package counters: compare task keys
        assert [t.key if t else None
                for t in a.victims.tasks[:len(a.v_node)]] \
            == [t.key if t else None for t in b.victims.tasks]
        assert (js.tiers, js.veto_critical, js.score_nodes, js.room_check) \
            == (ts.tiers, ts.veto_critical, ts.score_nodes, ts.room_check)
        for x, y in zip(js.host_static_arrays(), ts.host_static_arrays()):
            _assert_bitwise(x, y, "host_static_arrays")
        for x, y in zip(js.host_sig_arrays(), ts.host_sig_arrays()):
            _assert_bitwise(np.asarray(x).astype(np.asarray(y).dtype), y,
                            "host_sig_arrays")
    # the port lays rows out like the reference's fresh store: node slots
    # of k + max(1, k >> 3) rows in node-index order
    assert b.rows_used <= len(b.v_node)


# ---------------------------------------------------------------------
# the plain kernels against _wave_kernel / _visit_kernel
# ---------------------------------------------------------------------

#: (filter_kind, tiers, veto_critical, dyn_enabled, score_nodes,
#: room_check, guard_heavy): every filter kind, both tier stacks, veto,
#: dyn and scoring on and off, and a world where proportion's guard trips
WAVE_CASES = [
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False),
    ("intra_job", PREEMPT_TIERS, True, True, True, True, False),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, False),
    ("other_queue", RECLAIM_TIERS, False, False, False, False, True),
    ("inter_queue", PREEMPT_TIERS + RECLAIM_TIERS[1:], False, False, True,
     False, True),
    ("intra_job", (("drf", "proportion"), ("gang",)), True, True, False,
     True, False),
]


def _config(case):
    fk, tiers, veto, dyn, score, room, _ = case
    return dict(tiers=tiers, veto_critical=veto, filter_kind=fk,
                dyn_enabled=dyn, score_nodes=score, room_check=room)


@pytest.mark.parametrize("case", WAVE_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(WAVE_CASES)])
def test_wave_plain_matches_reference(case):
    static, mutable, sig, lanes = random_problem(
        len(case[1]) * 7 + WAVE_CASES.index(case), guard_heavy=case[6])
    cfg = _config(case)
    want = np.asarray(jv.run_wave_kernel(static, mutable, sig, *lanes,
                                         **cfg))
    kw = interop.victim_inputs_from_numpy(static, mutable, sig, lanes, "cpu")
    got = tv.victim_wave(**kw, **cfg)
    assert got.dtype == torch.bool
    _assert_bitwise(want, got.numpy(), f"wave {case[0]}")
    n_pad = static[0].shape[0]
    # the case exercises what it claims: pickable nodes and victims
    assert want[:, :n_pad].any() and want[:, 2 * n_pad:].any()
    if case[6]:
        assert want[:, n_pad:2 * n_pad].any(), "proportion guard never trips"


def test_wave_plain_matches_reference_at_v_pad_20480():
    """A row bucket past LARGE_BUCKET (a multiple of 4,096, not a power of
    two): the scan tree's odd level counts, as the card's cluster scan
    splits them into five tiles of 4,096."""
    case = WAVE_CASES[0]
    static, mutable, sig, lanes = random_problem(
        11, n_pad=1024, n_real=1000, v_pad=20480, n_jobs=60, lanes=2)
    cfg = _config(case)
    want = np.asarray(jv.run_wave_kernel(static, mutable, sig, *lanes,
                                         **cfg))
    kw = interop.victim_inputs_from_numpy(static, mutable, sig, lanes, "cpu")
    got = tv.victim_wave(**kw, **cfg)
    _assert_bitwise(want, got.numpy(), "wave at V_pad 20,480")
    assert want[:, 2 * 1024:].any()


@pytest.mark.parametrize("case", WAVE_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(WAVE_CASES)])
def test_visit_plain_matches_reference(case):
    static, mutable, sig, lanes = random_problem(
        100 + WAVE_CASES.index(case), lanes=6, guard_heavy=case[6])
    cfg = _config(case)
    n_pad = static[0].shape[0]
    rng = np.random.default_rng(WAVE_CASES.index(case))
    found = 0
    for i in range(6):
        visited = rng.random(n_pad) < 0.3
        if i == 3:
            visited[:] = True                    # a not-found visit
        lane = [a[i] for a in lanes]
        want = np.asarray(jv.run_visit_kernel(
            static, mutable, sig, lane[0], lane[1], lane[2],
            np.int32(lane[3]), np.int32(lane[4]), np.int32(lane[5]),
            visited, **cfg))
        kw = interop.victim_inputs_from_numpy(static, mutable, sig, lane,
                                              "cpu", visited=visited)
        got = tv.victim_visit(**kw, **cfg)
        assert got.dtype == torch.int32
        _assert_bitwise(want, got.numpy(), f"visit {case[0]} lane {i}")
        found += int(want[0])
        if i == 3:
            assert want[0] == 0
    assert found > 0


def test_session_wave_and_visit_match_reference():
    """The reference solver's own arrays on a contended session: both
    kernels on every pending task, every filter kind."""
    jss, tss = twin_sessions(contended_build(17))
    jp = pending_of(jss, JStatus)
    for fns, dis, score, kinds in (
            ("preemptable_fns", "preemptable_disabled", True,
             ("inter_queue", "intra_job")),
            ("reclaimable_fns", "reclaimable_disabled", False,
             ("other_queue",))):
        js = jv.build_victim_solver(jss, jp, fns, dis, score)
        st = js.state
        static = js.host_static_arrays()
        mutable = js.host_mutable_arrays()
        sig = js.host_sig_arrays()
        p = len(jp)
        lanes = [np.zeros((p, 3), np.float32), np.zeros((p, 3), np.float32),
                 np.zeros((p, 2), np.float32), np.zeros(p, np.int32),
                 np.full(p, -1, np.int32), np.full(p, -1, np.int32)]
        for i, t in enumerate(jp):
            lanes[0][i] = t.init_resreq.to_vec()
            lanes[1][i] = t.resreq.to_vec()
            lanes[2][i] = jv.nz_request_vec(t.resreq.to_vec())
            lanes[3][i] = js.terms.static.sig_of.get(t.uid, 0)
            ji = st.j_index.get(t.job, -1)
            lanes[4][i] = ji
            lanes[5][i] = st.job_queue[ji] if ji >= 0 else -1
        for fk in kinds:
            cfg = dict(tiers=js.tiers, veto_critical=js.veto_critical,
                       filter_kind=fk,
                       dyn_enabled=bool(js.dyn and js.dyn.enabled),
                       score_nodes=score, room_check=js.room_check)
            want = np.asarray(jv.run_wave_kernel(static, mutable, sig,
                                                 *lanes, **cfg))
            kw = interop.victim_inputs_from_numpy(static, mutable, sig,
                                                  lanes, "cpu")
            _assert_bitwise(want, tv.victim_wave(**kw, **cfg).numpy(),
                            f"session wave {fk}")
            visited = np.zeros(st.n_pad, bool)
            for i in range(0, p, 5):
                lane = [a[i] for a in lanes]
                want = np.asarray(jv.run_visit_kernel(
                    static, mutable, sig, lane[0], lane[1], lane[2],
                    np.int32(lane[3]), np.int32(lane[4]),
                    np.int32(lane[5]), visited, **cfg))
                kw = interop.victim_inputs_from_numpy(
                    static, mutable, sig, lane, "cpu", visited=visited)
                _assert_bitwise(want, tv.victim_visit(**kw, **cfg).numpy(),
                                f"session visit {fk} lane {i}")


def test_wrappers_refuse_bad_arguments():
    static, mutable, sig, lanes = random_problem(1, lanes=4)
    cfg = _config(WAVE_CASES[0])
    kw = interop.victim_inputs_from_numpy(static, mutable, sig, lanes, "cpu")
    with pytest.raises(ValueError, match="filter_kind"):
        tv.victim_wave(**kw, **dict(cfg, filter_kind="nope"))
    bad = dict(kw, v_res=kw["v_res"].double())
    with pytest.raises(ValueError, match="v_res"):
        tv.victim_wave(**bad, **cfg)
    with pytest.raises(ValueError, match="one lane"):
        tv.victim_visit(**kw, visited=torch.zeros(64, dtype=torch.bool),
                        **cfg)
