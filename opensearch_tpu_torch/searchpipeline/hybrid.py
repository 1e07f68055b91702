"""Coordinator-side hybrid search: normalization and weighted combination
(the port's copy of opensearch_tpu.searchpipeline.hybrid).

The reduce half of the neural-search plugin's NormalizationProcessor:
every shard's fused hybrid query phase (search/executor.py
build_hybrid_query_phase) returns per-sub-query top-k windows and their
(min, max, sum of squares, count) bounds, computed on the device (K12).
The bounds merge across shards (search/spmd.py merge_hybrid_bounds), so
normalization uses global per-sub-query statistics, like the reference
normalizing over the union of every shard's TopDocs.

Semantics (tests/reference_impl.ref_hybrid_scores is the independent
oracle):
  min_max: (s - min) / (max - min); all-equal scores -> 1.0; an exact-0
           result is floored to 0.001 (MinMaxScoreNormalizationTechnique
           MIN_SCORE).
  l2:      s / sqrt(sum s^2) over every collected candidate of the
           sub-query; zero norm -> 0.
  arithmetic_mean: sum w_i s_i / sum w_i over ALL sub-queries (a doc
           missing from a sub-query's candidates contributes 0 with its
           weight still in the denominator).
  geometric_mean / harmonic_mean: only sub-queries with s_i > 0
           participate (numerator and denominator); no positive scores
           -> 0.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

from opensearch_tpu_torch.common.errors import IllegalArgumentError
from opensearch_tpu_torch.search import dsl

# neural-search MinMaxScoreNormalizationTechnique constants
MIN_SCORE = 0.001
SINGLE_RESULT_SCORE = 1.0

DEFAULT_SPEC = {"normalization": "min_max",
                "combination": "arithmetic_mean", "weights": None}

# body keys the hybrid flow serves; anything else is an explicit 400 —
# never a silently-wrong page (the reference's HybridQueryPhaseSearcher
# rejects most of these shapes too)
_HYBRID_UNSUPPORTED = ("aggs", "aggregations", "collapse", "rescore",
                       "search_after", "slice", "suggest", "highlight",
                       "script_fields", "docvalue_fields", "scroll", "pit")


def normalize_scores(values: List[float], bounds: Tuple[float, float,
                                                        float, int],
                     technique: str) -> List[float]:
    """Normalize one sub-query's candidate scores with its GLOBAL bounds."""
    mn, mx, ssq, count = bounds
    if technique == "l2":
        norm = math.sqrt(ssq)
        return [v / norm if norm > 0 else 0.0 for v in values]
    if technique != "min_max":
        raise IllegalArgumentError(
            f"unknown normalization technique [{technique}]")
    out = []
    for v in values:
        if count == 0:
            out.append(0.0)
        elif mx == mn:
            out.append(SINGLE_RESULT_SCORE)
        else:
            normalized = (v - mn) / (mx - mn)
            out.append(MIN_SCORE if normalized == 0.0 else normalized)
    return out


def combine_scores(scores: List[Optional[float]],
                   weights: Optional[List[float]],
                   technique: str) -> float:
    """Weighted combination of one doc's per-sub-query normalized scores
    (None = the doc was not in that sub-query's candidates)."""
    n = len(scores)
    ws = weights if weights is not None else [1.0] * n
    if technique == "arithmetic_mean":
        total = sum(ws[i] * (scores[i] or 0.0) for i in range(n))
        denom = sum(ws)
        return total / denom if denom > 0 else 0.0
    if technique == "geometric_mean":
        log_sum = 0.0
        denom = 0.0
        for i in range(n):
            s = scores[i]
            if s is not None and s > 0:
                log_sum += ws[i] * math.log(s)
                denom += ws[i]
        return math.exp(log_sum / denom) if denom > 0 else 0.0
    if technique == "harmonic_mean":
        num = 0.0
        denom = 0.0
        for i in range(n):
            s = scores[i]
            if s is not None and s > 0:
                num += ws[i]
                denom += ws[i] / s
        return num / denom if denom > 0 else 0.0
    raise IllegalArgumentError(
        f"unknown combination technique [{technique}]")


def _validate_body(body: dict, n_sub: int, spec: dict) -> None:
    for key in _HYBRID_UNSUPPORTED:
        if body.get(key):
            raise IllegalArgumentError(
                f"[{key}] is not supported with a [hybrid] query")
    sort = body.get("sort")
    if sort not in (None, "_score", ["_score"]):
        raise IllegalArgumentError(
            "[sort] is not supported with a [hybrid] query (hybrid "
            "results are ranked by the combined normalized score)")
    weights = spec.get("weights")
    if weights is not None and len(weights) != n_sub:
        raise IllegalArgumentError(
            f"number of weights [{len(weights)}] must match number of "
            f"sub-queries [{n_sub}] in hybrid query")


def resolve_spec(phase_spec: Optional[dict]) -> dict:
    spec = dict(DEFAULT_SPEC)
    if phase_spec:
        spec.update({k: v for k, v in phase_spec.items()
                     if v is not None})
    return spec


def validate_hybrid_request(body: dict, n_sub: int, spec: dict,
                            executors: List) -> Tuple[int, int, int]:
    """Shared request validation for the per-query and the batched
    msearch hybrid paths. Returns (size, from_, k)."""
    _validate_body(body, n_sub, spec)
    size = int(body.get("size", 10))
    from_ = int(body.get("from", 0))
    if size < 0 or from_ < 0:
        raise IllegalArgumentError(
            "[from] parameter cannot be negative" if from_ < 0
            else "[size] parameter cannot be negative")
    window = min((getattr(ex, "max_result_window", 10000)
                  for ex in executors), default=10000)
    if from_ + size > window:
        raise IllegalArgumentError(
            f"Result window is too large, from + size must be less than "
            f"or equal to: [{window}] but was [{from_ + size}]. See the "
            f"scroll api for a more efficient way to request large data "
            f"sets. This limit can be set by changing the "
            f"[index.max_result_window] index level setting.")
    return size, from_, max(from_ + size, 10)


def merge_and_render(executors: List, body: dict, shard_results: List,
                     spec: dict, start: float, n_sub: int) -> dict:
    """The hybrid reduce: global bounds (the collective-merge analog) ->
    normalize every candidate -> weighted combine -> page render. Shared
    by execute_hybrid_search and the batched _msearch hybrid wave."""
    from opensearch_tpu_torch.search import spmd

    size = int(body.get("size", 10))
    from_ = int(body.get("from", 0))
    global_bounds = spmd.merge_hybrid_bounds(
        [r.bounds for r in shard_results], n_sub)
    total = sum(r.total for r in shard_results)

    # doc key = (shard, seg, ord); values = per-sub normalized scores
    docs: Dict[Tuple[int, int, int], List[Optional[float]]] = {}
    for i in range(n_sub):
        raw: List[float] = []
        keys: List[Tuple[int, int, int]] = []
        for shard_i, r in enumerate(shard_results):
            for score, seg_i, ord_ in r.per_sub[i]:
                raw.append(score)
                keys.append((shard_i, seg_i, ord_))
        for key, ns in zip(keys, normalize_scores(
                raw, global_bounds[i], spec["normalization"])):
            docs.setdefault(key, [None] * n_sub)[i] = ns

    combined = [(combine_scores(subs, spec.get("weights"),
                                spec["combination"]), key)
                for key, subs in docs.items()]
    # combined-score desc; (shard, seg, doc) asc tie-break — the same
    # final order mergeTopDocs uses for equal scores
    combined.sort(key=lambda e: (-e[0], e[1]))

    page = combined[from_:from_ + size]
    max_score = combined[0][0] if combined else None

    hits = []
    for score, (shard_i, seg_i, ord_) in page:
        hits.append(executors[shard_i]._hit_dict(
            seg_i, ord_, float(score), body,
            shard_results[shard_i].segments))

    n_shards = len(executors)
    track_total = body.get("track_total_hits", True)
    hits_block: Dict[str, Any] = {"max_score": max_score, "hits": hits}
    if track_total is False:
        pass
    elif track_total is True:
        hits_block = {"total": {"value": total, "relation": "eq"},
                      **hits_block}
    else:
        threshold = int(track_total)
        if total > threshold:
            hits_block = {"total": {"value": threshold,
                                    "relation": "gte"}, **hits_block}
        else:
            hits_block = {"total": {"value": total, "relation": "eq"},
                          **hits_block}

    return {
        "took": int((time.monotonic() - start) * 1000),
        "timed_out": False,
        "_shards": {"total": n_shards, "successful": n_shards,
                    "skipped": 0, "failed": 0},
        "hits": hits_block,
    }


def execute_hybrid_search(executors: List, body: dict,
                          phase_spec: Optional[dict] = None) -> dict:
    """Hybrid query-then-fetch over shard executors: each shard's fused
    phase returns per-sub-query windows and bounds; the merge reduces the
    bounds globally, normalizes every candidate, combines them into one
    score per doc and renders the page. A shard's error raises."""
    start = time.monotonic()
    spec = resolve_spec(phase_spec)
    node = dsl.parse_query(body.get("query"))
    if not isinstance(node, dsl.HybridQuery):
        raise IllegalArgumentError("hybrid search requires a top-level "
                                   "[hybrid] query")
    n_sub = len(node.queries)
    _size, _from, k = validate_hybrid_request(body, n_sub, spec, executors)
    shard_results = [ex.execute_hybrid_query_phase(body, k)
                     for ex in executors]
    return merge_and_render(executors, body, shard_results, spec, start,
                            n_sub)
