"""Float32 reductions and scans in a fixed order, and the binary search.

The round engine (kernels/batched.py) decides by comparing float32 sums
against capacities: ``searchsorted`` over cumulative node capacity, the
demand window's cumulative share, per-node segmented prefixes. At full
size those sums pass 2**24, so the order of the additions decides the
bits, and the bits decide placements. torch's own ``cumsum`` and ``sum``
accumulate in other orders (in double, or pairwise). The functions here
add in the order the reference package's compiled graph adds on the CPU,
and the CUDA kernel (csrc/batched_allocate.cu) repeats the same orders:

- :func:`tiled_cumsum` — ``jnp.cumsum`` lowers to a reduce-window that
  XLA rewrites into a scan of 16-wide tiles: a sequential inclusive scan
  inside each tile, the tile totals scanned the same way (recursively),
  and each tile's exclusive carry added to its elements.
- :func:`column_sum` — ``x.sum(axis=0)`` is split by XLA's tree
  reduction into windows of 32 (the pad split evenly before and after),
  each summed sequentially, until 32 or fewer rows remain; those are
  summed sequentially.
- :func:`associative_scan` — ``jax.lax.associative_scan``'s odd/even
  recursion, combination for combination.
- :func:`search_left` — ``jnp.searchsorted(side="left")``'s default
  method: a fixed number of binary-search halvings from (0, n).

Segment sums (``jax.ops.segment_sum``) add in update order, which is
``Tensor.index_add_`` on the CPU; the plain engine calls that directly.
The tests pin every helper against ``jnp`` at the shapes the round uses.

Multiply-adds are contracted per compiled graph: :data:`WEIGHTED_SUM_FMA`
records, for each reference graph, how it evaluates nodeorder's weighted
dynamic score ``least * w0 + balanced * w1`` (equal either way for
integer weights; the tests probe fractional ones at the edges).
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

#: per reference graph: True where XLA:CPU contracts nodeorder's weighted
#: sum into fma(balanced, w1, least * w0) (kernels/solver.py
#: scan_node_score_plain), False where both products are rounded before
#: the add (dynamic_node_score_plain). The two-level and active-set
#: graphs (``_hier_packed``, ``_activeset_packed``,
#: ``_activeset_audit_packed``) contract it in their coarse pass and in
#: their rounds alike, unlike the flat batched graph
#: (tests/test_torch_hier.py, tests/test_torch_activeset.py); so does the
#: two-level graph over the mesh (``_hier_sharded_entry``, probed on the
#: reference's 8-device CPU mesh: tests/test_torch_sharded.py).
WEIGHTED_SUM_FMA = {"batched": False, "allocate_scan": True, "hier": True,
                    "activeset": True, "hier_sharded": True}

#: tile width of the cumulative-sum rewrite
SCAN_TILE = 16
#: window of the tree reduction
REDUCE_WINDOW = 32


def _sequential_scan_dim1(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float scan along dim 1, one addition after another."""
    out = x.clone()
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
        out[:, i] = acc
    return out


def tiled_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along dim 0 in ``jnp.cumsum``'s order."""
    n = x.shape[0]
    if n <= SCAN_TILE:
        return _sequential_scan_dim1(x[None])[0]
    m = -(-n // SCAN_TILE)
    rest = tuple(x.shape[1:])
    pad = x.new_zeros((m * SCAN_TILE - n,) + rest)
    tiles = torch.cat([x, pad]).reshape((m, SCAN_TILE) + rest)
    within = _sequential_scan_dim1(tiles)
    carry = tiled_cumsum(within[:, SCAN_TILE - 1])
    excl = torch.cat([x.new_zeros((1,) + rest), carry[:-1]])
    out = within + excl[:, None]
    return out.reshape((m * SCAN_TILE,) + rest)[:n]


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in the order of ``x.sum(axis=0)``."""
    while x.shape[0] > REDUCE_WINDOW:
        n = x.shape[0]
        m = -(-n // REDUCE_WINDOW)
        rest = tuple(x.shape[1:])
        p = m * REDUCE_WINDOW - n
        lo = p // 2
        x = torch.cat([x.new_zeros((lo,) + rest), x,
                       x.new_zeros((p - lo,) + rest)])
        x = x.reshape((m, REDUCE_WINDOW) + rest)
        acc = x[:, 0]
        for i in range(1, REDUCE_WINDOW):
            acc = acc + x[:, i]
        x = acc
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


Combine = Callable[[List[torch.Tensor], List[torch.Tensor]],
                   List[torch.Tensor]]


def associative_scan(fn: Combine, elems: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """``jax.lax.associative_scan(fn, elems)`` along dim 0, with the same
    tree of combinations (jax/_src/lax/control_flow/loops.py): pairs
    (0,1), (2,3), ... combine, the halves scan recursively, and each
    even output combines the odd output before it with its element."""
    elems = list(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([o[:-1] for o in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        res = ev.new_empty((n,) + tuple(ev.shape[1:]))
        res[0::2] = ev
        res[1::2] = od
        out.append(res)
    return out


def search_left(sorted_arr: torch.Tensor, query: torch.Tensor
                ) -> torch.Tensor:
    """``jnp.searchsorted(sorted_arr, query, side="left")`` (int64): the
    default method's ceil(log2(n + 1)) halvings of (low, high) from
    (0, n), stepping left where ``query <= sorted_arr[mid]``."""
    n = sorted_arr.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = query <= sorted_arr[mid]
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                 high)
    return high
