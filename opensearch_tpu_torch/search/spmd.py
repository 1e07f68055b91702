"""The hybrid bounds merge (the port's copy of
opensearch_tpu.search.spmd.merge_hybrid_bounds; the SPMD runner itself is
not ported yet)."""

from __future__ import annotations

from typing import List, Tuple


def merge_hybrid_bounds(per_shard_bounds: List[List[Tuple[float, float,
                                                          float, int]]],
                        n_sub: int) -> List[Tuple[float, float, float,
                                                  int]]:
    """Reduce per-shard per-sub-query hybrid score bounds to global bounds:
    min of mins, max of maxes, sum of the sums of squares and of the
    counts, so the normalization-processor normalizes over the union of
    every shard's windows, as the reference does."""
    out = []
    for i in range(n_sub):
        mn, mx, ssq, count = float("inf"), float("-inf"), 0.0, 0
        for bounds in per_shard_bounds:
            b_mn, b_mx, b_ssq, b_count = bounds[i]
            if b_count:
                mn = min(mn, b_mn)
                mx = max(mx, b_mx)
                ssq += b_ssq
                count += b_count
        out.append((mn, mx, ssq, count))
    return out
