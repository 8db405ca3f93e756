"""The port's affinity vocabulary against the reference package's, on the
CPU, tolerance 0 (bitwise): these are scheduling decisions and
integer-valued carries.

- the encoder (``build_affinity_inputs``) field by field over
  ``WIRE_FIELDS`` with ``ip_enabled`` / ``ip_weight``, the vocabulary
  screens, and the victim path's ``SessionAffinityMasks``;
- each ``_aff_*`` helper and ``_ip_score`` of the round engine on random
  carries;
- the plain batched engine with affinity against ``_batched_packed`` on
  the reference's own packed inputs: the packed result, the node carry,
  the final [P,D] carry and ``port_claim``.

Scenario worlds are built twice, once in each package's objects. The
CUDA kernel is held against the plain engine in tests/test_torch_cuda.py.
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
from kubebatch_tpu.actions.cycle_inputs import \
    build_cycle_inputs as j_build_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import affinity as ja  # noqa: E402
from kubebatch_tpu.kernels import batched as jb  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.interop import (affinity_from_numpy,  # noqa: E402
                                         affinity_inputs_from_numpy,
                                         cycle_inputs_from_numpy,
                                         device_state_from_numpy)
from kubebatch_tpu_torch.kernels import affinity as ta  # noqa: E402
from kubebatch_tpu_torch.kernels import batched as tb  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_batched import STATIC_KEYS, _assert_bitwise  # noqa: E402
from .test_torch_cuda import (AffWorld, aff_compact_build,  # noqa: E402
                              aff_rollback_build)

GiB = 1024 ** 3

#: 5p's fractions (zones, selectors, taints, tolerations, both affinity
#: kinds, preferred scores, host ports) cut from 5,000 nodes and 1,250
#: gangs x 8 to 500 nodes and 125 gangs x 8, so the reference's CPU graph
#: stays small; the widths (8-pod gangs, 4 weighted queues, 16 apps and
#: zones) are 5p's own
REDUCED_5P = dict(vars(T_SPECS["5p"]), n_nodes=500, n_groups=125)


J_AW = AffWorld(j_objects)
T_AW = AffWorld(t_objects)


# ---- the targeted scenarios of tests/test_affinity_device.py ---------------

def _anti_spread(cache, w):
    w.hostname_nodes(cache, 6)
    cache.add_pod_group(w.group("web", 4))
    for p in range(4):
        cache.add_pod(w.pod(f"web-{p}", group="web", labels={"app": "web"},
                            affinity=w.anti({"app": "web"})))


def _excess_replica(cache, w):
    w.hostname_nodes(cache, 3)
    cache.add_pod_group(w.group("web", 2))
    for p in range(5):
        cache.add_pod(w.pod(f"web-{p}", req=(100, GiB // 4), group="web",
                            labels={"app": "web"},
                            affinity=w.anti({"app": "web"})))


def _colocate(cache, w):
    w.hostname_nodes(cache, 4)
    cache.add_pod_group(w.group("db", 1))
    cache.add_pod(w.pod("db-0", node="n2", group="db", labels={"app": "db"},
                        running=True))
    cache.add_pod_group(w.group("web", 2))
    for p in range(2):
        cache.add_pod(w.pod(f"web-{p}", group="web",
                            affinity=w.aff({"app": "db"})))


def _bootstrap_zone(cache, w):
    w.hostname_nodes(cache, 6, cpu=2000,
                     zone_of=lambda i: "east" if i < 3 else "west")
    cache.add_pod_group(w.group("ring", 4))
    for p in range(4):
        cache.add_pod(w.pod(f"ring-{p}", req=(900, GiB), group="ring",
                            labels={"app": "ring"},
                            affinity=w.aff({"app": "ring"}, "zone")))


def _symmetry(cache, w):
    w.hostname_nodes(cache, 2)
    cache.add_pod_group(w.group("lonely", 1))
    cache.add_pod(w.pod("lonely-0", node="n0", req=(100, GiB),
                        group="lonely", labels={"app": "lonely"},
                        affinity=w.anti({"app": "web"}), running=True))
    cache.add_pod_group(w.group("web", 2))
    for p in range(2):
        cache.add_pod(w.pod(f"web-{p}", group="web", labels={"app": "web"}))


def _port_conflict(cache, w):
    w.hostname_nodes(cache, 2)
    for p in range(3):
        cache.add_pod_group(w.group(f"hp{p}", 1))
        cache.add_pod(w.pod(f"hp{p}-0", group=f"hp{p}", ports=[8080]))


def _existing_port(cache, w):
    w.hostname_nodes(cache, 2)
    cache.add_pod_group(w.group("old", 1))
    cache.add_pod(w.pod("old-0", node="n0", req=(100, GiB), group="old",
                        ports=[443], running=True))
    cache.add_pod_group(w.group("new", 1))
    cache.add_pod(w.pod("new-0", req=(100, GiB), group="new", ports=[443]))


def _cross_job_wait(cache, w):
    w.hostname_nodes(cache, 4)
    cache.add_pod_group(w.group("a", 1))
    cache.add_pod(w.pod("a-0", req=(300, GiB), group="a",
                        affinity=w.aff({"app": "b"})))
    cache.add_pod_group(w.group("b", 1))
    cache.add_pod(w.pod("b-0", req=(300, GiB), group="b",
                        labels={"app": "b"}))


def _preferred_score(cache, w):
    w.hostname_nodes(cache, 4)
    cache.add_pod_group(w.group("db", 1))
    cache.add_pod(w.pod("db-0", node="n3", req=(100, GiB), group="db",
                        labels={"app": "db"}, running=True))
    cache.add_pod_group(w.group("web", 1))
    cache.add_pod(w.pod("web-0", req=(100, GiB), group="web",
                        affinity=w.pref(100, {"app": "db"})))


def _gang_all_or_nothing(cache, w):
    w.hostname_nodes(cache, 3)
    cache.add_pod_group(w.group("web", 4))
    for p in range(4):
        cache.add_pod(w.pod(f"web-{p}", req=(100, GiB), group="web",
                            labels={"app": "web"},
                            affinity=w.anti({"app": "web"})))


def _random_cluster(seed, n_nodes=8, n_jobs=10):
    """tests/test_affinity_device.py ``_random_cluster``."""
    def build(cache, w):
        rng = np.random.RandomState(seed)
        w.hostname_nodes(cache, n_nodes, cpu=16000,
                         zone_of=lambda i: f"z{i % 3}")
        apps = ["red", "blue", "green"]
        for j in range(n_jobs):
            app = apps[int(rng.randint(len(apps)))]
            size = int(rng.randint(1, 4))
            cache.add_pod_group(w.group(f"j{j}", size))
            for p in range(size):
                affinity, ports = None, ()
                roll = rng.rand()
                if roll < 0.25:
                    affinity = w.anti({"app": app})
                elif roll < 0.45:
                    target = apps[int(rng.randint(len(apps)))]
                    affinity = w.aff({"app": target}, "zone")
                elif roll < 0.55:
                    ports = [int(rng.choice([80, 443, 8080]))]
                cache.add_pod(w.pod(f"j{j}-{p}", req=(400, GiB // 2),
                                    group=f"j{j}", labels={"app": app},
                                    affinity=affinity, ports=ports))
    return build


TARGETED = {
    "anti_spread": _anti_spread, "excess_replica": _excess_replica,
    "colocate": _colocate, "bootstrap_zone": _bootstrap_zone,
    "symmetry": _symmetry, "port_conflict": _port_conflict,
    "existing_port": _existing_port, "cross_job_wait": _cross_job_wait,
    "preferred_score": _preferred_score,
    "gang_all_or_nothing": _gang_all_or_nothing,
}


def sim_world(spec_kw):
    def build(cache, w):
        sim = (t_build(TSpec(**spec_kw)) if w is T_AW
               else j_build(JSpec(**spec_kw)))
        sim.populate(cache)
    return build


def j_cache(build):
    cache = JCache(async_writeback=False, incremental_snapshot=False)
    cache.add_queue(J_AW.queue())
    build(cache, J_AW)
    return cache


def t_cache(build):
    cache = TCache(async_writeback=False, incremental_snapshot=False,
                   device="cpu")
    cache.add_queue(T_AW.queue())
    build(cache, T_AW)
    return cache


# ---- the engine ------------------------------------------------------------

def reference_affinity_solve(build, compact_bucket=None):
    """The reference's batched solve of one affinity session: the port's
    arguments as numpy (node, cycle and affinity arrays, statics) and
    the reference's packed result, node carry and final affinity carry."""
    ssn = JOpen(j_cache(build), j_tiers())
    inputs = j_build_inputs(ssn, allow_affinity=True)
    assert inputs is not None and inputs.affinity is not None
    args, statics = jb.prepare_batched(inputs.device, inputs,
                                       compact_bucket=compact_bucket)
    final, packed = jb._batched_packed(*args, **statics)
    arrays = {}
    for buf, lay in zip(args[:3], (statics["lay_f"], statics["lay_i"],
                                   statics["lay_b"])):
        buf = np.asarray(buf)
        for name, off, shape in lay:
            size = int(np.prod(shape)) if shape else 1
            arrays[name] = buf[off:off + size].reshape(shape)
    node = dict(zip(tb.NODE_ARGS, (np.asarray(x) for x in args[3:])))
    carry = [np.asarray(x) for x in (final.idle, final.releasing,
                                     final.n_tasks, final.nz_req)]
    aff_carry = {k: (None if getattr(final, k) is None
                     else np.asarray(getattr(final, k)))
                 for k in tb.AFF_OUT}
    return (node, arrays, {k: statics[k] for k in STATIC_KEYS},
            np.asarray(packed), carry, aff_carry)


def port_affinity_solve(node, arrays, statics):
    return tb.batched_allocate(
        **device_state_from_numpy(node, "cpu", engine="batched"),
        **cycle_inputs_from_numpy(arrays, "cpu", engine="batched"),
        aff=affinity_from_numpy(arrays, "cpu"), **statics)


def check_affinity_solve(build, compact_bucket=None):
    node, arrays, statics, ref_packed, ref_carry, ref_aff = \
        reference_affinity_solve(build, compact_bucket)
    got = port_affinity_solve(node, arrays, statics)
    _assert_bitwise(ref_packed, got[0].numpy(), "packed")
    for r, g, name in zip(ref_carry, got[1:5],
                          ("idle", "releasing", "n_tasks", "nz_req")):
        _assert_bitwise(r, g.numpy(), name)
    for name in tb.AFF_OUT:
        r, g = ref_aff[name], got[5][name]
        assert (r is None) == (g is None), name
        if r is not None:
            _assert_bitwise(r, g.numpy(), name)
    t_pad = arrays["task_valid"].shape[0]
    return statics, tb.unpack_result(ref_packed, t_pad), arrays


@pytest.mark.parametrize("name", sorted(TARGETED))
def test_engine_matches_reference_targeted(name):
    _, (state, _, _, rounds, _), _ = check_affinity_solve(TARGETED[name])
    assert rounds > 0


@pytest.mark.parametrize("seed", [3, 11, 42, 7])
def test_engine_matches_reference_random(seed):
    check_affinity_solve(_random_cluster(seed))


@pytest.mark.parametrize("spec", ["2p", "3p", "5p_reduced"])
def test_engine_matches_reference_cold(spec):
    kw = REDUCED_5P if spec == "5p_reduced" else vars(T_SPECS[spec])
    _, (state, _, _, _, _), arrays = check_affinity_solve(sim_world(kw))
    assert (state == 1).any()
    assert arrays["node_dom"].shape[0] > 1


def test_engine_matches_reference_stranded_rollback():
    _, (_, _, _, _, telem), _ = check_affinity_solve(aff_rollback_build)
    assert telem[14] > 0 or telem[15] > 0, \
        "the case did not reach the stranded-gang rollback"


def test_engine_matches_reference_compact_bucket(monkeypatch):
    widths = []
    rounds_loop = tb._rounds_loop

    def spy(state, a, *args, **kw):
        widths.append(a.task_valid.shape[0])
        return rounds_loop(state, a, *args, **kw)

    monkeypatch.setattr(tb, "_rounds_loop", spy)
    statics, (state, _, _, _, _), arrays = check_affinity_solve(
        aff_compact_build)
    t_pad = arrays["task_valid"].shape[0]
    assert 0 < statics["compact_bucket"] < t_pad
    assert statics["compact_bucket"] in widths, \
        "the rounds after round 0 did not run on the compact bucket"


# ---- the encoder and the vocabulary screens --------------------------------

def _twin_inputs(build):
    """Each package's build_cycle_inputs(allow_affinity=True) on its own
    copy of one world."""
    j_ssn = JOpen(j_cache(build), j_tiers())
    t_ssn = TOpen(t_cache(build), t_tiers())
    ji = j_build_inputs(j_ssn, allow_affinity=True)
    ti = _t_build_inputs(t_ssn, allow_affinity=True)
    return j_ssn, t_ssn, ji, ti


def _t_build_inputs(ssn, allow_affinity):
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    return build_cycle_inputs(ssn, allow_affinity=allow_affinity)


def _assert_same_affinity(ja_in, ta_in):
    assert (ja_in is None) == (ta_in is None)
    if ja_in is None:
        return
    for name in ja.WIRE_FIELDS:
        _assert_bitwise(getattr(ja_in, name), getattr(ta_in, name), name)
    assert ja_in.ip_enabled == ta_in.ip_enabled
    assert np.float32(ja_in.ip_weight) == np.float32(ta_in.ip_weight)
    assert type(ja_in.ip_weight) is type(ta_in.ip_weight)


ENCODER_WORLDS = dict(TARGETED, random_3=_random_cluster(3),
                      random_42=_random_cluster(42),
                      rollback=aff_rollback_build, compact=aff_compact_build,
                      **{"2p": sim_world(vars(T_SPECS["2p"])),
                         "3p": sim_world(vars(T_SPECS["3p"])),
                         "5p_reduced": sim_world(REDUCED_5P)})


@pytest.mark.parametrize("name", sorted(ENCODER_WORLDS))
def test_build_affinity_inputs_matches_reference(name):
    _, _, ji, ti = _twin_inputs(ENCODER_WORLDS[name])
    # (the sims name pods from a per-process counter: rows correspond by
    # position, names may not)
    assert len(ji.tasks) == len(ti.tasks)
    assert ji.affinity is not None
    _assert_same_affinity(ji.affinity, ti.affinity)
    # the reference's encoding carried into the port's AffinityInputs
    ref = affinity_inputs_from_numpy(vars(ji.affinity))
    assert isinstance(ref, ta.AffinityInputs)
    _assert_same_affinity(ref, ti.affinity)


def _vocab_world(kind):
    """Pending pods past the caps: ``distinct`` names MAX_PAIRS + 1
    distinct selectors (inside the raw window, refused after
    compaction), ``compacts`` MAX_PAIRS + 1 topology keys whose domain
    columns coincide (one pair after compaction), ``raw`` more than the
    raw window, ``ports`` MAX_PORTS + 1 distinct host ports on separate
    pods (refused after folding), ``ports_fold`` as many ports claimed
    together (one slot after folding)."""
    def build(cache, w):
        n_terms = {"raw": ja.RAW_PAIR_LIMIT + 1}.get(kind, ja.MAX_PAIRS + 1)
        labels = {f"t{i}": "x" for i in range(n_terms)} \
            if kind == "compacts" else {}
        for i in range(3):
            lab = dict(labels, **{"kubernetes.io/hostname": f"n{i}"})
            cache.add_node(w.node(f"n{i}", labels=lab))
        cache.add_pod_group(w.group("many", 1))
        if kind in ("ports", "ports_fold"):
            n_ports = ja.MAX_PORTS + 1
            for i in range(n_ports):
                cache.add_pod_group(w.group(f"hp{i}", 1))
                ports = ([7000 + i] if kind == "ports"
                         else list(range(7000, 7000 + n_ports)))
                cache.add_pod(w.pod(f"hp{i}-0", req=(10, GiB // 64),
                                    group=f"hp{i}", ports=ports))
            return
        if kind == "compacts":
            terms = [w.term({"app": "a"}, f"t{i}") for i in range(n_terms)]
        else:
            terms = [w.term({f"k{i}": "v"}) for i in range(n_terms)]
        cache.add_pod(w.pod("many-0", group="many", labels={"app": "a"},
                            affinity=w.m.Affinity(
                                pod_anti_affinity_required=terms)))
    return build


@pytest.mark.parametrize("kind", ["distinct", "compacts", "raw", "ports",
                                  "ports_fold"])
def test_vocabulary_screens_and_caps_match_reference(kind):
    build = _vocab_world(kind)
    j_ssn = JOpen(j_cache(build), j_tiers())
    t_ssn = TOpen(t_cache(build), t_tiers())
    pend_j = [t for job in j_ssn.jobs.values() for t in job.tasks.values()]
    pend_t = [t for job in t_ssn.jobs.values() for t in job.tasks.values()]
    within = ja.affinity_within_vocabulary(j_ssn, pend_j)
    assert within == ta.affinity_within_vocabulary(t_ssn, pend_t)
    assert within == (kind != "raw")
    assert ja.affinity_features_present(j_ssn, pend_j) \
        == ta.affinity_features_present(t_ssn, pend_t)
    ji = j_build_inputs(j_ssn, allow_affinity=True)
    ti = _t_build_inputs(t_ssn, allow_affinity=True)
    assert (ji is None) == (ti is None)
    assert (ti is None) == (kind in ("distinct", "raw", "ports"))
    if ti is not None:
        _assert_same_affinity(ji.affinity, ti.affinity)


# ---- the victim path's masks -----------------------------------------------

def _mask_world(seed):
    """Running pods with every term kind (anti, required, preferred, host
    ports) across hostname and zone domains, and pending pods with their
    own terms: the symmetric halves and the bootstrap rule engage."""
    def build(cache, w):
        rng = np.random.RandomState(seed)
        w.hostname_nodes(cache, 8, cpu=16000, zone_of=lambda i: f"z{i % 3}")
        apps = ["red", "blue", "green"]

        def roll(app):
            r, target = rng.rand(), apps[int(rng.randint(3))]
            if r < 0.2:
                return w.anti({"app": app}), ()
            if r < 0.35:
                return w.aff({"app": target}, "zone"), ()
            if r < 0.55:
                return w.m.Affinity(pod_affinity_preferred=[
                    (int(rng.randint(1, 50)), w.term({"app": target}))],
                    pod_anti_affinity_preferred=[
                    (int(rng.randint(1, 9)), w.term({"app": app},
                                                    "zone"))]), ()
            if r < 0.65:
                return None, [int(rng.choice([80, 443]))]
            return None, ()

        cache.add_pod_group(w.group("run", 1))
        for i in range(14):
            app = apps[int(rng.randint(3))]
            affinity, ports = roll(app)
            cache.add_pod(w.pod(f"run-{i}", node=f"n{int(rng.randint(8))}",
                                req=(200, GiB // 4), group="run",
                                labels={"app": app}, affinity=affinity,
                                ports=ports, running=True))
        for j in range(6):
            cache.add_pod_group(w.group(f"p{j}", 2))
            for p in range(2):
                app = apps[int(rng.randint(3))]
                affinity, ports = roll(app)
                cache.add_pod(w.pod(f"p{j}-{p}", req=(300, GiB // 4),
                                    group=f"p{j}", labels={"app": app},
                                    affinity=affinity, ports=ports))
    return build


@pytest.mark.parametrize("seed", [1, 2, 5])
@pytest.mark.parametrize("with_scores,with_predicates",
                         [(True, True), (False, True), (True, False)])
def test_session_affinity_masks_match_reference(seed, with_scores,
                                                with_predicates):
    from kubebatch_tpu.kernels.solver import \
        ensure_device_snapshot as j_snapshot
    from kubebatch_tpu_torch.kernels.solver import \
        ensure_device_snapshot as t_snapshot

    build = _mask_world(seed)
    j_ssn = JOpen(j_cache(build), j_tiers())
    t_ssn = TOpen(t_cache(build), t_tiers())
    pend_j = [t for job in j_ssn.jobs.values() for t in job.tasks.values()
              if not t.node_name]
    pend_t = [t for job in t_ssn.jobs.values() for t in job.tasks.values()
              if not t.node_name]
    jm = ja.SessionAffinityMasks(j_ssn, pend_j, with_scores=with_scores,
                                 with_predicates=with_predicates)
    tm = ta.SessionAffinityMasks(t_ssn, pend_t, with_scores=with_scores,
                                 with_predicates=with_predicates)
    jd, td = j_snapshot(j_ssn), t_snapshot(t_ssn)
    assert jm.supported and tm.supported
    n_scored = 0
    for jt, tt in zip(pend_j, pend_t):
        assert jt.uid == tt.uid
        for name in ("node_mask", "score_norm"):
            r = getattr(jm, name)(jt, jd)
            g = getattr(tm, name)(tt, td)
            assert (r is None) == (g is None), (name, jt.uid)
            if r is not None:
                _assert_bitwise(r, g, f"{name} {jt.uid}")
                n_scored += name == "score_norm"
    assert n_scored > 0 or not with_scores


# ---- the round engine's helpers on random carries --------------------------

def _random_round(seed, t=48, n=12, p=5, pt=3, d=12):
    """Random affinity arrays and carries of one round (the non-affinity
    fields the helpers do not read are zeros)."""
    rng = np.random.default_rng(seed)
    node_dom = rng.integers(-1, 4, (p, n)).astype(np.int32)
    node_ok = rng.random(n) < 0.85
    arr = dict(
        node_dom=node_dom,
        task_grp=rng.random((t, p)) < 0.3,
        task_req_aff=rng.random((t, p)) < 0.15,
        task_req_anti=rng.random((t, p)) < 0.15,
        task_self_ok=rng.random((t, p)) < 0.5,
        task_carry_w=(rng.integers(-3, 4, (t, p))
                      * (rng.random((t, p)) < 0.3)).astype(np.float32),
        task_pref_w=(rng.integers(-5, 6, (t, p))
                     * (rng.random((t, p)) < 0.2)).astype(np.float32),
        task_ports=rng.random((t, pt)) < 0.1,
        port_base=rng.random((n, pt)) < 0.2,
        ip_weight=np.float32(2.0),
        node_ok=node_ok,
        task_valid=rng.random(t) < 0.9)
    state = dict(
        aff_grp_cnt=rng.integers(0, 3, (p, d)).astype(np.float32),
        aff_anti_cnt=(rng.integers(0, 2, (p, d))
                      * (rng.random((p, d)) < 0.3)).astype(np.float32),
        aff_pref_w=rng.integers(-4, 5, (p, d)).astype(np.float32),
        aff_grp_total=(rng.integers(0, 3, p)).astype(np.float32),
        port_claim=rng.random((n, pt)) < 0.1,
        task_state=np.where(rng.random(t) < 0.7, 0,
                            rng.integers(1, 5, t)).astype(np.int32),
        task_node=rng.integers(-1, n, t).astype(np.int32))
    dyn = dict(accept=rng.random(t) < 0.6,
               proposal=rng.integers(0, n, t).astype(np.int32),
               rank=rng.permutation(t).astype(np.int32))
    return arr, state, dyn


def _j_round(arr, state):
    zf = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    zi = lambda *s: jnp.zeros(s, jnp.int32)  # noqa: E731
    t, n = arr["task_grp"].shape[0], arr["node_ok"].shape[0]
    a = jb.CycleArrays(
        backfilled=zf(n, 3), allocatable_cm=zf(n, 2), max_task_num=zi(n),
        node_ok=jnp.asarray(arr["node_ok"]), resreq=zf(t, 3),
        init_resreq=zf(t, 3), task_nz=zf(t, 2), task_job=zi(t),
        task_rank=zi(t), task_sig=zi(t), task_pair=zi(t),
        task_valid=jnp.asarray(arr["task_valid"]), sig_scores=zf(1, n),
        sig_pred=jnp.zeros((1, n), bool), pair_sig=zi(1), pair_nz=zf(1, 2),
        order_min_available=zi(1), job_queue=zi(1), job_priority=zf(1),
        job_create_rank=zi(1), job_valid=jnp.zeros(1, bool),
        q_deserved=zf(1, 3), q_create_rank=zi(1), cluster_total=zf(3),
        dyn_weights=zf(2),
        **{k: jnp.asarray(arr[k]) for k in (
            "node_dom", "task_grp", "task_req_aff", "task_req_anti",
            "task_self_ok", "task_carry_w", "task_pref_w", "task_ports",
            "port_base", "ip_weight")})
    s = jb.RoundState(
        idle=zf(n, 3), releasing=zf(n, 3), n_tasks=zi(n), nz_req=zf(n, 2),
        q_allocated=zf(1, 3), j_allocated=zf(1, 3), alloc_cnt=zi(1),
        job_alive=jnp.zeros(1, bool), task_seq=zi(t),
        **{k: jnp.asarray(state[k]) for k in (
            "task_state", "task_node", "aff_grp_cnt", "aff_anti_cnt",
            "aff_pref_w", "aff_grp_total", "port_claim")})
    return s, a


def _t_round(arr, state):
    from kubebatch_tpu_torch.interop import affinity_state_from_numpy
    t, n = arr["task_grp"].shape[0], arr["node_ok"].shape[0]
    ten = affinity_state_from_numpy(
        {k: v for k, v in {**arr, **state}.items()
         if k not in ("node_ok", "task_valid", "task_state", "task_node")},
        "cpu")
    zf = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    a = tb.CycleArrays(
        backfilled=zf(n, 3), allocatable_cm=zf(n, 2), max_task_num=zi(n),
        node_ok=torch.from_numpy(arr["node_ok"]), resreq=zf(t, 3),
        init_resreq=zf(t, 3), task_nz=zf(t, 2), task_job=zi(t),
        task_rank=zi(t), task_sig=zi(t), task_pair=zi(t),
        task_valid=torch.from_numpy(arr["task_valid"]),
        sig_scores=zf(1, n), sig_pred=torch.zeros((1, n), dtype=torch.bool),
        pair_sig=zi(1), pair_nz=zf(1, 2), order_min_available=zi(1),
        job_queue=zi(1), job_priority=zf(1), job_create_rank=zi(1),
        job_valid=torch.zeros(1, dtype=torch.bool), q_deserved=zf(1, 3),
        q_create_rank=zi(1), cluster_total=zf(3), dyn_weights=zf(2),
        **{k: ten[k] for k in (
            "node_dom", "task_grp", "task_req_aff", "task_req_anti",
            "task_self_ok", "task_carry_w", "task_pref_w", "task_ports",
            "port_base", "ip_weight")})
    s = tb.RoundState(
        idle=zf(n, 3), releasing=zf(n, 3), n_tasks=zi(n), nz_req=zf(n, 2),
        q_allocated=zf(1, 3), j_allocated=zf(1, 3), alloc_cnt=zi(1),
        job_alive=torch.zeros(1, dtype=torch.bool), task_seq=zi(t),
        task_state=torch.from_numpy(state["task_state"]),
        task_node=torch.from_numpy(state["task_node"]),
        **{k: ten[k] for k in ("aff_grp_cnt", "aff_anti_cnt", "aff_pref_w",
                               "aff_grp_total", "port_claim")})
    return s, a


@pytest.mark.parametrize("seed", range(6))
def test_round_affinity_helpers_match_reference(seed):
    import jax

    arr, state, dyn = _random_round(seed)
    js, ja_ = _j_round(arr, state)
    ts, ta_ = _t_round(arr, state)
    t = arr["task_grp"].shape[0]
    rows = torch.arange(t)
    aff = tb._AffRound(ts, ta_)

    ok, could_wait = jax.jit(jb._aff_eligibility)(js, ja_)
    _assert_bitwise(ok, aff.ok_rows(rows).numpy(), "eligibility")
    _assert_bitwise(could_wait, aff.could_wait.numpy(), "could_wait")
    term, scored = jax.jit(jb._ip_score)(js, ja_)
    got_term, got_scored = aff.ip_rows(rows)
    _assert_bitwise(term, got_term.numpy(), "ip term")
    _assert_bitwise(scored, got_scored.numpy(), "ip scored")
    prop = dyn["proposal"]
    cell = aff.cell_ok(torch.from_numpy(prop)).numpy()
    _assert_bitwise(np.asarray(ok)[np.arange(t), prop], cell, "cell")
    _assert_bitwise(jax.jit(jb._aff_involved)(js, ja_),
                    tb._aff_involved(ts, ta_).numpy(), "involved")
    acc = dyn["accept"]
    _assert_bitwise(
        jax.jit(jb._aff_serialize)(js, ja_, acc, prop, dyn["rank"]),
        tb._aff_serialize(ts, ta_, torch.from_numpy(acc),
                          torch.from_numpy(prop),
                          torch.from_numpy(dyn["rank"])).numpy(),
        "serialize")
    ref_c = jax.jit(jb._aff_commit)(js, ja_, acc, prop)
    got_c = tb._aff_commit(ts, ta_, torch.from_numpy(acc),
                           torch.from_numpy(prop))
    revert = acc & (state["task_node"] >= 0)
    ref_r = jax.jit(jb._aff_rollback)(js, ja_, revert)
    got_r = tb._aff_rollback(ts, ta_, torch.from_numpy(revert))
    for k in ref_c:
        _assert_bitwise(ref_c[k], got_c[k].numpy(), f"commit {k}")
        _assert_bitwise(ref_r[k], got_r[k].numpy(), f"rollback {k}")
