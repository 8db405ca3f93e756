"""Narrow-dtype policy for the [S, N] score matrix.

Scores the engines read are integer-valued and small: the static sig
terms are host plugin scores (``floor(10 * x) * weight`` per nodeorder
plugin) and the dynamic least-requested / balanced-resource terms are
threshold counts (kernels/solver.dynamic_node_score), all exactly
representable in bfloat16's 8-bit mantissa up to 256. The reference
package stores the score matrix at bfloat16 past a size threshold, and
only when that round trip is exact, so its decisions are those of the
float32 matrix. This package keeps the matrix at float32 and takes the
same policy decision only for the solve's telemetry words (narrow,
narrow_gate).

The policy is auto-by-size: narrow engages when the [T, N] product
crosses ``NARROW_AUTO_CELLS`` or the node axis crosses
``NARROW_AUTO_NODES``, and the scores are bf16-exact. At cfg5
(16384 x 8192) neither threshold holds.
"""
from __future__ import annotations

__all__ = ["NARROW_AUTO_CELLS", "NARROW_AUTO_NODES", "narrow_enabled",
           "scores_bf16_exact"]

#: auto threshold on the [T, N] cell count: cfg5 (16384 x 8192 = 1.3e8)
#: stays f32; cfg6 (53248 x 53248 = 2.8e9) narrows.  2**29 ~= 5.4e8
#: cells == 2 GiB of f32 score matrix — past it the f32 layout is the
#: thing that breaks, so narrowing is the default, not an opt-in.
NARROW_AUTO_CELLS = 2 ** 29

#: auto threshold on the node axis ALONE: past the hier/cfg6 regime
#: every node-dimensioned store ([S, N] victim sig matrices, small-T
#: affinity cycles) narrows regardless of its other axis, so one
#: cluster runs one dtype policy across its engines.
NARROW_AUTO_NODES = 16384

#: bf16 represents every integer exactly up to this magnitude; past it
#: integer neighbors collapse and argmax ties break differently than
#: f32 — the decision-identity contract's hard boundary
BF16_EXACT_MAX = 256.0


def scores_bf16_exact(static_scores, dyn_weights=None,
                      ip_weight=0.0) -> bool:
    """True when every score the kernels materialize at [T, N] scale
    round-trips bf16 EXACTLY: the static matrix is integer-valued (the
    plugin floor-semantics guarantee — but NodeAffinity is a raw
    preferred-weight sum, so magnitude must be checked, not assumed)
    and the worst-case |static| + dynamic-term bound (<= 10 per unit
    weight) + interpod bound stays within bf16's exact-integer range.
    Host-side numpy on the [S, N] matrix — negligible at arg-build."""
    import numpy as np

    s = np.asarray(static_scores)
    if s.size and not np.array_equal(s, np.round(s)):
        return False
    bound = float(np.max(np.abs(s))) if s.size else 0.0
    if dyn_weights is not None:
        w = np.asarray(dyn_weights, np.float64)
        # fractional weights make the dynamic terms (integer counts x
        # weight) non-integral — not exactly representable, gate closed
        if not np.array_equal(w, np.round(w)):
            return False
        bound += 10.0 * float(np.sum(np.abs(w)))
    if ip_weight:
        if float(ip_weight) != round(float(ip_weight)):
            return False
        bound += 10.0 * abs(float(ip_weight))
    return bound <= BF16_EXACT_MAX


def narrow_enabled(n_pad: int, t_pad: int, static_scores=None,
                   dyn_weights=None, ip_weight=0.0) -> bool:
    """The policy decision for one (node bucket, other-axis bucket)
    pair — called at arg-build time (prepare_fused).

    When ``static_scores`` is given, narrowing additionally requires
    :func:`scores_bf16_exact` — a cycle whose score scale exceeds bf16's
    exact-integer range keeps f32."""
    if not (int(n_pad) >= NARROW_AUTO_NODES
            or int(n_pad) * int(t_pad) >= NARROW_AUTO_CELLS):
        return False
    if static_scores is None:
        return True
    return scores_bf16_exact(static_scores, dyn_weights, ip_weight)
