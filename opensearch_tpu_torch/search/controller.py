"""The search controller (the subset of opensearch_tpu.search.controller
the port needs): query-then-fetch over the shard executors of every index
a request targets.

On one shard, a score-sorted plain body runs as the msearch envelope at
B=1, as the reference's does (opensearch_tpu/search/controller.py:
431-448), and a top-level `hybrid` query runs through the fused hybrid
phase and the normalization merge (searchpipeline/hybrid.py). Every other
body takes the general path, `_execute_search_impl`:
- validation: `SEARCH_BODY_KEYS`, `from` / `size` and the result window,
  the sort, `track_scores`, `search_after` (with `from` > 0 refused),
  `track_total_hits`;
- `search_type: dfs_query_then_fetch`: every shard's term statistics for
  the query, merged (compile.StaticStats), score every shard;
- the query phase: with 2-8 (shard, segment) rows of one structure, the
  multi-shard program (search/spmd.py: every row and the merge on the
  device, K21); else the host loop over the shards that can match
  (search/canmatch.py; the rest count in `_shards.skipped`), each shard's
  `SearchExecutor.execute_query_phase`; the candidates merged by exact
  sort values with missing values last, then (shard, segment, doc);
- `search_after`: the cursor filters the merged candidates; when it
  reaches past the fetched window, k grows 4x and the query phase runs
  again (up to 65,536);
- the page and the fetch phase (`_build_hit`: `_source`, `sort`,
  `highlight`, `explain`, `docvalue_fields`, `_version`, a nested
  query's `inner_hits`);
- the hits block (`track_total_hits` true, false or a threshold, the
  relation `gte` when block-max pruned lanes; `max_score` only when a
  score is wanted) and the `_shards` block.

Shard failures are isolated as the reference's are: a typed error of
status < 500 raises (every shard would fail alike); any other exception
in a shard's query or fetch records a `_shards.failures[]` entry and drops
that shard's candidates and hits. Every shard that ran failed: 503 "all
shards failed"; some failed and `allow_partial_search_results` is false:
503 "Partial shards failure"; otherwise a partial page. An untyped error
in the agg reduce or the pipelines is a 503 of phase `reduce`. When the
multi-shard program raises, the request takes the per-shard host loop
(logged, and counted in `spmd.HOST_FALLBACKS`). A fault of the card or a
kernel (`_build.is_device_fault`: a kernel that did not build or launch,
a CUDA runtime error) is none of these: it raises out of the request,
so no kernel's work moves to the host and no partial page hides it.

Body keys the reference acts on that the port does not serve yet answer
400 naming the key (`UNPORTED_BODY_KEYS`); keys the reference accepts and
ignores are ignored here too (the reference's `timeout` and fault hooks
are not ported).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError,
                                                ParsingError,
                                                SearchPhaseExecutionError,
                                                shard_failure_entry)
from opensearch_tpu_torch.ops._build import is_device_fault
from opensearch_tpu_torch.search import dsl, spmd
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
from opensearch_tpu_torch.search.aggs.pipeline import apply_pipelines
from opensearch_tpu_torch.search.aggs.reduce import reduce_aggs
from opensearch_tpu_torch.search.canmatch import shard_can_match
from opensearch_tpu_torch.search.compile import (StaticStats,
                                                 collect_query_term_stats,
                                                 merge_dfs_stats)
from opensearch_tpu_torch.search.executor import (_contains_hybrid,
                                                  _msearch_batchable,
                                                  _parse_sort,
                                                  sort_candidates)


def _cmp_values(a: Any, b: Any, order: str) -> int:
    """Compare two sort values in page order (-1: a first)."""
    if a is None and b is None:
        return 0
    if a is None:
        return 1
    if b is None:
        return -1
    try:
        lt = a < b
        gt = b < a
    except TypeError:
        a, b = str(a), str(b)
        lt, gt = a < b, b < a
    if not lt and not gt:
        return 0
    if order == "desc":
        return -1 if gt else 1
    return -1 if lt else 1


def _after_cursor(candidates, sort_specs, after_values):
    """Drop the candidates at or before the cursor position;
    `after_values` aligns with sort_specs."""
    if len(after_values) != len(sort_specs):
        raise IllegalArgumentError(
            f"search_after has {len(after_values)} value(s) but sort has "
            f"{len(sort_specs)} field(s)")
    out = []
    for c in candidates:
        rel = 0
        for i, ((field, order), av) in enumerate(zip(sort_specs,
                                                     after_values)):
            cv = c.score if field == "_score" else c.sort_values[i]
            rel = _cmp_values(cv, av, order)
            if rel != 0:
                break
        if rel > 0:
            out.append(c)
    return out


# the top-level keys SearchSourceBuilder's parser accepts: anything else is
# a parsing error (400), e.g. a query clause pasted at the top level
SEARCH_BODY_KEYS = frozenset({
    "query", "from", "size", "sort", "aggs", "aggregations", "_source",
    "fields", "stored_fields", "docvalue_fields", "script_fields",
    "track_total_hits", "track_scores", "min_score", "search_after",
    "highlight", "suggest", "rescore", "collapse", "post_filter",
    "explain", "version", "seq_no_primary_term", "slice", "pit",
    "profile", "timeout", "terminate_after", "indices_boost",
    "runtime_mappings", "search_type", "scroll", "scroll_id", "ext",
    "min_compatible_shard_node", "knn", "stats",
    "allow_partial_search_results",
    "_dfs",                       # internal: DFS-merged statistics
})

# body keys the reference acts on that the port does not serve yet (each
# a 400 naming it while set)
UNPORTED_BODY_KEYS = ("rescore", "collapse", "suggest", "profile",
                      "script_fields", "slice", "pit", "scroll", "timeout")

_LOG = logging.getLogger(__name__)

# shards whose query or fetch failed, process-wide (chip_smoke reads it)
SHARD_FAILURES = [0]


def _validate_search_body_keys(body: dict) -> None:
    for key in body:
        if key not in SEARCH_BODY_KEYS:
            raise ParsingError(f"unknown key [{key}] in the search body")


def _resolve_allow_partial(body: dict) -> bool:
    """allow_partial_search_results: the body's (or the URL's) value,
    else true, the reference's default."""
    raw = body.get("allow_partial_search_results")
    if raw is None:
        return True
    if isinstance(raw, str):
        return raw.strip().lower() != "false"
    return bool(raw)


def _shard_fault(exc: BaseException) -> bool:
    """Whether one shard absorbs an exception as a `failures[]` entry: not
    a request defect (a typed error of status < 500, which every shard
    would raise alike) and not a fault of the card or a kernel (the
    node's, which raises)."""
    if isinstance(exc, OpenSearchTpuError) and exc.status < 500:
        return False
    return not is_device_fault(exc)


def _refuse_unported(body: dict) -> None:
    for key in UNPORTED_BODY_KEYS:
        if body.get(key) not in (None, False):
            raise IllegalArgumentError(
                f"search body key [{key}] is not supported by "
                f"opensearch_tpu_torch yet")


def execute_search(executors: List, body: Optional[dict],
                   phase_spec: Optional[dict] = None,
                   allow_envelope: bool = False) -> dict:
    """Query-then-fetch over the shard executors (every shard of every
    target index, in resolve order). `phase_spec` is the search pipeline's
    normalization spec for a hybrid query (None: the defaults);
    `allow_envelope` (the top-level serving entry points) lets a plain
    score-sorted body on one shard run in the B=1 msearch envelope."""
    body = body or {}
    _validate_search_body_keys(body)
    if _contains_hybrid(body.get("query")):
        from opensearch_tpu_torch.searchpipeline.hybrid import \
            execute_hybrid_search
        return execute_hybrid_search(executors, body, phase_spec)
    if allow_envelope and len(executors) == 1 and _msearch_batchable(body):
        return executors[0].multi_search(
            [body], _raise_item_errors=True)["responses"][0]
    return _execute_search_impl(executors, body)


def _execute_search_impl(executors: List, body: dict) -> dict:
    _refuse_unported(body)
    start = time.monotonic()
    size = int(body.get("size", 10))
    from_ = int(body.get("from", 0))
    if size < 0 or from_ < 0:
        raise IllegalArgumentError(
            "[from] parameter cannot be negative" if from_ < 0
            else "[size] parameter cannot be negative")
    window = min((ex.max_result_window for ex in executors), default=10000)
    if from_ + size > window:
        raise IllegalArgumentError(
            f"Result window is too large, from + size must be less than "
            f"or equal to: [{window}] but was [{from_ + size}]. See the "
            f"scroll api for a more efficient way to request large data "
            f"sets. This limit can be set by changing the "
            f"[index.max_result_window] index level setting.")
    sort_specs = _parse_sort(body.get("sort"))
    score_sorted = sort_specs[0][0] == "_score"
    wants_score = score_sorted \
        or any(f == "_score" for f, _ in sort_specs) \
        or bool(body.get("track_scores", False))
    agg_nodes = parse_aggs(body.get("aggs") or body.get("aggregations"))
    after_values = body.get("search_after")
    if after_values is not None and from_ > 0:
        raise IllegalArgumentError(
            "`from` parameter must be set to 0 when `search_after` is used")
    track_total = body.get("track_total_hits", True)
    allow_partial = _resolve_allow_partial(body)
    k = max(from_ + size, 10)
    max_k = 1 << 16
    failures: Dict[int, dict] = {}      # shard -> its failures[] entry

    def record_failure(shard_i: int, exc: BaseException) -> None:
        if shard_i not in failures:
            SHARD_FAILURES[0] += 1
            failures[shard_i] = shard_failure_entry(
                shard_i, executors[shard_i].reader.index_name, exc)

    # DFS query-then-fetch: every shard's statistics for the query terms,
    # merged, pinned on every shard's compile (scores compare across
    # shards)
    dfs_overrides = None
    if body.get("search_type") == "dfs_query_then_fetch" and executors:
        qnode = dsl.parse_query(body.get("query"))
        parts = [collect_query_term_stats(qnode, ex.reader.mapper,
                                          ex.reader.stats_snapshot()[0])
                 for ex in executors]
        fields, term_df = merge_dfs_stats(parts)
        dfs_overrides = [StaticStats(ex.reader.stats_snapshot()[0], fields,
                                     term_df) for ex in executors]

    # can-match (computed once, only for the host loop): a shard whose
    # segment metadata proves emptiness is skipped; when every shard
    # would be, one still runs so the response is fully shaped
    flags_box: List = [None]
    skipped_box = [0]
    pruned_box = [0]    # block-max pruned lanes: total -> "gte"

    def can_match_flags():
        if flags_box[0] is None:
            flags = [shard_can_match(ex, body) for ex in executors]
            if flags and not any(flags):
                flags[0] = True
            flags_box[0] = flags
        return flags_box[0]

    def run_query_phase(k_eff):
        candidates, decoded_partials, total = [], [], 0
        pruned_box[0] = 0
        failures.clear()                # a k-growth retry runs it again
        rows = spmd.spmd_rows(executors)
        if spmd.eligible(executors, body, rows, sort_specs):
            try:
                out = spmd.spmd_query_phase(executors, body, k_eff, rows)
            except Exception as e:  # the program fails as a unit
                if is_device_fault(e):
                    raise       # a kernel's work never moves to the host
                # the per-shard host loop below isolates the failure; it
                # runs the same kernels shard by shard
                spmd.HOST_FALLBACKS[0] += 1
                _LOG.warning("multi-shard program raised %s: %s; the "
                             "request takes the per-shard host loop",
                             type(e).__name__, e)
                out = None
            if out is not None:
                candidates, decoded_partials, total, pruned_box[0] = out
                sort_candidates(candidates, sort_specs)
                return candidates, decoded_partials, total
        flags = can_match_flags()
        skipped_box[0] = len(executors) - sum(flags)
        for shard_i, ex in enumerate(executors):
            if not flags[shard_i]:
                continue                # provably empty: a skipped shard
            try:
                cands, decoded, shard_total = ex.execute_query_phase(
                    body, k_eff, stats_override=dfs_overrides[shard_i]
                    if dfs_overrides else None)
            except Exception as e:  # one shard's fault costs its slice
                if not _shard_fault(e):
                    raise
                record_failure(shard_i, e)
                continue
            for c in cands:
                c.shard_i = shard_i
            candidates.extend(cands)
            decoded_partials.extend(decoded)
            total += shard_total
        sort_candidates(candidates, sort_specs)
        return candidates, decoded_partials, total

    candidates, decoded_partials, total = run_query_phase(k)
    raw_count = len(candidates)
    if after_values is not None:
        filtered = _after_cursor(candidates, sort_specs, after_values)
        # the cursor may reach past the fetched window: grow k until the
        # page is full or every match is on the host
        while len(filtered) < from_ + size and raw_count >= k \
                and k < max_k and k < total:
            k = min(max_k, k * 4)
            candidates, decoded_partials, total = run_query_phase(k)
            raw_count = len(candidates)
            filtered = _after_cursor(candidates, sort_specs, after_values)
        candidates = filtered

    page = candidates[from_:from_ + size]
    max_score = None
    if wants_score:
        for c in candidates:
            if max_score is None or c.score > max_score:
                max_score = c.score

    query_node = dsl.parse_query(body.get("query"))
    from opensearch_tpu_torch.search import fetch as fetch_phase
    inner = (fetch_phase.collect_inner_hit_specs(query_node), {})
    built = []
    for c in page:
        try:
            built.append((c.shard_i, _build_hit(
                executors[c.shard_i], c, body,
                c.score if wants_score else None, query_node, score_sorted,
                inner)))
        except Exception as e:  # a fetch fault drops the shard's hits
            if not _shard_fault(e):
                raise
            record_failure(c.shard_i, e)
    hits = [h for shard_i, h in built if shard_i not in failures]

    n_shards = len(executors)
    hits_block: dict = {"max_score": max_score, "hits": hits}
    # block-max pruning: pruned blocks' docs were never counted
    exact_rel = "eq" if not pruned_box[0] else "gte"
    if track_total is True:
        hits_block = {"total": {"value": total, "relation": exact_rel},
                      **hits_block}
    elif track_total is not False:
        threshold = int(track_total)
        if total > threshold:
            hits_block = {"total": {"value": threshold, "relation": "gte"},
                          **hits_block}
        else:
            hits_block = {"total": {"value": total, "relation": exact_rel},
                          **hits_block}
    attempted = sum(flags_box[0]) if flags_box[0] is not None \
        else n_shards
    entries = list(failures.values())
    if failures and len(failures) >= max(attempted, 1):
        raise SearchPhaseExecutionError(
            "all shards failed", phase="query", grouped=True,
            failed_shards=entries)
    if failures and not allow_partial:
        raise SearchPhaseExecutionError(
            "Partial shards failure", phase="query", grouped=True,
            failed_shards=entries)
    shards_block = {"total": n_shards,
                    "successful": n_shards - len(failures),
                    "skipped": skipped_box[0], "failed": len(failures)}
    if failures:
        shards_block["failures"] = entries
    resp = {
        "took": 0,
        "timed_out": False,
        "_shards": shards_block,
        "hits": hits_block,
    }
    if agg_nodes:
        try:
            aggregations = reduce_aggs(decoded_partials)
            apply_pipelines(agg_nodes, aggregations)
        except Exception as e:  # no shard's slice to degrade to
            if isinstance(e, OpenSearchTpuError) or is_device_fault(e):
                raise
            raise SearchPhaseExecutionError(
                f"failed to reduce aggregations: {type(e).__name__}: {e}",
                phase="reduce")
        resp["aggregations"] = aggregations
    resp["took"] = int((time.monotonic() - start) * 1000)
    if page:
        # the position of the page's last hit (the REST layer drops it;
        # an _msearch item keeps it, as the reference's does)
        last = page[-1]
        resp["_page_cursor"] = {
            "values": [last.score if f == "_score" else last.sort_values[i]
                       for i, (f, _) in enumerate(sort_specs)],
            "tiebreak": (last.shard_i, last.seg_i, last.ord),
        }
    return resp


def _build_hit(ex, c, body: dict, score: Optional[float], query_node,
               score_sorted: bool, inner=((), None)) -> dict:
    """One page hit and its fetch subphases. `inner`: the request's
    nested queries with inner_hits and their evaluation cache."""
    from opensearch_tpu_torch.search import fetch as fetch_phase

    hit = ex._hit_dict(c.seg_i, c.ord, score, body)
    if not score_sorted or body.get("search_after") is not None:
        hit["sort"] = c.sort_values
    seg = ex.reader.segments[c.seg_i]
    mapper = ex.reader.mapper
    if body.get("highlight"):
        field_terms = fetch_phase.collect_field_terms(query_node, mapper)
        hl = fetch_phase.build_highlights(hit.get("_source"),
                                          body["highlight"], field_terms,
                                          mapper)
        if hl:
            hit["highlight"] = hl
    if body.get("explain"):
        hit["_explanation"] = fetch_phase.explain_hit(
            seg, c.ord, query_node, mapper, ex.reader.stats_snapshot()[0],
            score if score is not None else c.score)
    if body.get("docvalue_fields"):
        fields = fetch_phase.docvalue_fields(
            seg, c.ord, body["docvalue_fields"], mapper,
            prefetched=c.dv_page)
        if fields:
            hit["fields"] = fields
    if body.get("version"):
        # doc_meta carries the (version, seq_no, primary_term) of the write
        meta = seg.doc_meta.get(hit["_id"])
        hit["_version"] = meta[0] if meta else 1
    specs, cache = inner
    if specs:
        hit["inner_hits"] = fetch_phase.build_inner_hits(
            ex, c.seg_i, c.ord, specs, cache)
    return hit
