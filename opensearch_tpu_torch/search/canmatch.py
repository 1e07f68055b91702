"""Can-match pre-filtering (the port's copy of
opensearch_tpu.search.canmatch): skip shards that provably cannot match a
query, from segment metadata alone.

Numeric / date columns keep their sorted unique values (min = unique[0],
max = unique[-1]), keyword columns their sorted dictionaries and text
fields their term dictionaries. The walk is conservative: anything it
cannot reason about is a "maybe", and the shard executes. A skipped shard
contributes no hits, no aggregation partials and no failure; the response
counts it in `_shards.skipped`. Host only: no device work.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np

from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.search import dsl


def shard_can_match(executor, body: Optional[dict]) -> bool:
    """True if this shard might produce a hit for the request. A request
    with a `suggest` section or a `global` aggregation never skips."""
    body = body or {}
    if body.get("suggest"):
        return True
    if _has_global_agg(body.get("aggs") or body.get("aggregations")):
        return True      # global aggs count every doc whatever the query
    try:
        node = dsl.parse_query(body.get("query"))
    except OpenSearchTpuError:
        return True      # the query phase raises the error properly
    reader = executor.reader
    if not reader.segments:
        return False                    # no docs at all
    return any(_seg_can_match(node, seg, reader.mapper)
               for seg in reader.segments)


def _has_global_agg(aggs) -> bool:
    if not isinstance(aggs, dict):
        return False
    for spec in aggs.values():
        if not isinstance(spec, dict):
            continue
        if "global" in spec:
            return True
        if _has_global_agg(spec.get("aggs") or spec.get("aggregations")):
            return True
    return False


def _seg_can_match(node, seg, mapper) -> bool:
    """Conservative per-segment emptiness proof (False = provably empty)."""
    if isinstance(node, dsl.MatchNoneQuery):
        return False
    if isinstance(node, dsl.MatchAllQuery):
        return seg.live_doc_count > 0
    if isinstance(node, dsl.BoolQuery):
        for child in list(node.must) + list(node.filter):
            if not _seg_can_match(child, seg, mapper):
                return False
        if node.should and not node.must and not node.filter:
            # a pure-should bool needs one should to match
            return any(_seg_can_match(c, seg, mapper) for c in node.should)
        return True
    if isinstance(node, dsl.ConstantScoreQuery):
        return _seg_can_match(node.filter, seg, mapper)
    if isinstance(node, dsl.TermQuery):
        return _term_possible(seg, mapper, node.field, node.value,
                              node.case_insensitive)
    if isinstance(node, dsl.TermsQuery):
        return any(_term_possible(seg, mapper, node.field, v, False)
                   for v in node.values)
    if isinstance(node, dsl.RangeQuery):
        return _range_possible(seg, mapper, node)
    if isinstance(node, dsl.ExistsQuery):
        return _exists_possible(seg, mapper, node.field)
    if isinstance(node, dsl.IdsQuery):
        return any(seg.ord_of(str(v)) is not None for v in node.values)
    return True                         # unknown node: maybe


def _term_possible(seg, mapper, field: str, value, case_insensitive) -> bool:
    if case_insensitive:
        return True                     # dictionary probes are case-exact
    ft = mapper.get_field(field)
    if ft is None:
        return False                    # an unmapped field matches nothing
    if ft.is_keyword:
        col = seg.ordinal_dv.get(field)
        if col is not None:
            d = col.dictionary
            i = bisect.bisect_left(d, str(value))
            return i < len(d) and d[i] == str(value)
        return (field, str(value)) in seg.term_dict
    if ft.is_text:
        # term queries are not analyzed: probe the raw and lowercased
        # forms, so a lowercasing analyzer never skips a shard wrongly
        raw = str(value) if value is not None else ""
        return (field, raw) in seg.term_dict \
            or (field, raw.lower()) in seg.term_dict
    if field in seg.numeric_dv:
        col = seg.numeric_dv[field]
        if not len(col.unique):
            return False
        try:
            v = ft.to_comparable(value)
        except (OpenSearchTpuError, TypeError, ValueError):
            return True
        i = int(np.searchsorted(col.unique, v, "left"))
        return i < len(col.unique) and col.unique[i] == v
    return True


def _range_possible(seg, mapper, node: dsl.RangeQuery) -> bool:
    ft = mapper.get_field(node.field)
    if ft is None:
        return False
    if ft.is_keyword:
        col = seg.ordinal_dv.get(node.field)
        if col is None or not len(col.dictionary):
            return False
        lo, hi = col.dictionary[0], col.dictionary[-1]
        if node.gte is not None and str(node.gte) > str(hi):
            return False
        if node.gt is not None and str(node.gt) >= str(hi):
            return False
        if node.lte is not None and str(node.lte) < str(lo):
            return False
        if node.lt is not None and str(node.lt) <= str(lo):
            return False
        return True
    col = seg.numeric_dv.get(node.field)
    if col is None or not len(col.unique):
        return False
    seg_min = float(col.unique[0])
    seg_max = float(col.unique[-1])
    if ft.is_date and any(isinstance(v, str) and "now" in v
                          for v in (node.gte, node.gt, node.lte, node.lt)
                          if v is not None):
        # `now` resolves to another instant here than in the query phase:
        # never skip on a now-relative bound
        return True

    def bound(value, round_up):
        if ft.is_date and isinstance(value, str) and "||" in value:
            from opensearch_tpu_torch.search.compile import \
                _resolve_date_math
            value = _resolve_date_math(value, round_up=round_up)
        return ft.to_comparable(value)

    try:
        if node.gte is not None and bound(node.gte, False) > seg_max:
            return False
        if node.gt is not None and bound(node.gt, True) >= seg_max:
            return False
        if node.lte is not None and bound(node.lte, True) < seg_min:
            return False
        if node.lt is not None and bound(node.lt, False) <= seg_min:
            return False
    except (OpenSearchTpuError, TypeError, ValueError):
        return True      # an unparseable bound: maybe
    return True


def _exists_possible(seg, mapper, field: str) -> bool:
    if field in seg.numeric_dv or field in seg.ordinal_dv \
            or field in seg.vector_dv:
        return True
    return field in seg.norms
