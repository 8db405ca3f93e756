"""The port's batched engine with the post-round-0 compaction against the
reference's, on the CPU: tests/test_batched.py's compact-continuation
shape through ``_batched_packed`` and the plain engine, at the automatic
bucket (0: full width) and at 512, tolerance 0.

Apart from tests/test_torch_batched.py, whose helpers it uses: this one
test is that file's longest, and a file of its own lets the test run's
``--dist loadfile`` put it on another worker.
"""
from __future__ import annotations

import numpy as np

from .fixtures import GiB, build_group, build_node, build_pod, rl
from .test_torch_batched import _check_solve, _fixture_cache


def _compact_shape():
    """tests/test_batched.py's compact-continuation shape: 80 jobs x 30
    pods on 6 nodes (2,400 tasks, T_pad 4096)."""
    rng = np.random.default_rng(7)
    nodes = [build_node(f"n{i}", rl(4000, 8 * GiB, pods=40))
             for i in range(6)]
    groups, pods = [], []
    for j in range(80):
        groups.append(build_group("ns", f"pg{j:03d}", 1, queue="q1",
                                  creation_timestamp=float(j)))
        for p in range(30):
            pods.append(build_pod(
                "ns", f"j{j:03d}-p{p}", "", "Pending",
                rl(int(rng.integers(1, 9)) * 100,
                   int(rng.integers(1, 5)) * GiB // 4),
                group=f"pg{j:03d}", creation_timestamp=float(p)))
    return nodes, groups, pods


def test_compact_bucket_matches_reference_and_full_width():
    """The post-round-0 compaction against the reference, and against the
    full-width loop (the same decisions either way)."""
    out = {}
    for bucket in (0, 512):
        statics, res, _ = _check_solve(_fixture_cache(*_compact_shape()),
                                       compact_bucket=bucket)
        assert statics["compact_bucket"] == bucket
        out[bucket] = res
    assert out[512][3] > 1, "the compact continuation did not engage"
    for k in range(3):
        np.testing.assert_array_equal(out[0][k], out[512][k])
