"""Segment-level filter (query) cache (the port of
opensearch_tpu.indices.query_cache).

Filter-context sub-queries (`bool.filter` children) that recur cache their
per-segment match MASK, so later queries splice a precomputed mask into
the compiled plan instead of re-deriving the filter on the device. A
filter becomes cache-worthy only after repeated use (`min_uses`, 2), and
the cache is a process-wide LRU bounded by entry count (256) and bytes
(64 MiB of host masks).

Keys are (segment uid, filter fingerprint): segment uids are
process-unique and never reused, so entries of dropped segments age out
of the LRU. Cached masks exclude liveness: the query phase applies `live`
after plan evaluation, so a cached mask stays right across deletes.
Time-relative filters (date math containing "now") never cache.

The cache splices into the general path's per-segment loop only
(search/executor.py `_query_phase_uncached`); the msearch envelope groups
queries by plan structure and compiles without it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import fields as dc_fields
from typing import Dict, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.search import dsl

_CACHEABLE_LEAVES = (
    dsl.TermQuery, dsl.TermsQuery, dsl.RangeQuery, dsl.ExistsQuery,
    dsl.MatchQuery, dsl.MatchAllQuery, dsl.MatchNoneQuery,
)
_CACHEABLE_COMPOUND = (dsl.BoolQuery, dsl.NestedQuery)


def cacheable_node(node) -> bool:
    """Only deterministic, segment-pure filters may cache."""
    if isinstance(node, dsl.RangeQuery):
        for bound in (node.gte, node.gt, node.lte, node.lt):
            if isinstance(bound, str) and "now" in bound:
                return False            # time-relative: changes per query
        return True
    if isinstance(node, _CACHEABLE_LEAVES):
        return True
    if isinstance(node, _CACHEABLE_COMPOUND):
        for f in dc_fields(node):
            sub = getattr(node, f.name, None)
            if isinstance(sub, dsl.QueryNode) and not cacheable_node(sub):
                return False
            if isinstance(sub, (list, tuple)) and any(
                    isinstance(s, dsl.QueryNode) and not cacheable_node(s)
                    for s in sub):
                return False
        return True
    return False


def fingerprint(node) -> str:
    """The dataclass repr is deterministic and covers every field."""
    return repr(node)


class QueryCache:
    def __init__(self, max_entries: int = 256, min_uses: int = 2,
                 max_bytes: int = 64 << 20):
        self.max_entries = max_entries
        self.min_uses = min_uses
        self.max_bytes = max_bytes
        self._bytes = 0
        self._masks: "OrderedDict[Tuple[int, str], np.ndarray]" \
            = OrderedDict()
        self._uses: "OrderedDict[Tuple[int, str], int]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, seg_uid: int, fp: str) -> Optional[np.ndarray]:
        key = (seg_uid, fp)
        with self._lock:
            mask = self._masks.get(key)
            if mask is not None:
                self._masks.move_to_end(key)
                self.hits += 1
                return mask
            self.misses += 1
            return None

    def record_use(self, seg_uid: int, fp: str) -> bool:
        """Count a use; True once the filter crosses the caching threshold
        (fill now). The usage ledger is itself LRU-bounded."""
        key = (seg_uid, fp)
        with self._lock:
            count = self._uses.get(key, 0) + 1
            self._uses[key] = count
            self._uses.move_to_end(key)
            while len(self._uses) > self.max_entries * 4:
                self._uses.popitem(last=False)
            return count >= self.min_uses and key not in self._masks

    def put(self, seg_uid: int, fp: str, mask: np.ndarray):
        key = (seg_uid, fp)
        with self._lock:
            old = self._masks.get(key)
            if old is not None:
                self._bytes -= old.nbytes
            self._masks[key] = mask
            self._bytes += mask.nbytes
            self._masks.move_to_end(key)
            while self._masks and (len(self._masks) > self.max_entries
                                   or self._bytes > self.max_bytes):
                _, dropped = self._masks.popitem(last=False)
                self._bytes -= dropped.nbytes
                self.evictions += 1

    def clear(self):
        with self._lock:
            self._masks.clear()
            self._uses.clear()
            self._bytes = 0
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict:
        with self._lock:
            return {
                "hit_count": self.hits,
                "miss_count": self.misses,
                "cache_count": len(self._masks),
                "evictions": self.evictions,
                "memory_size_in_bytes": self._bytes,
            }


QUERY_CACHE = QueryCache()


class FilterCacheContext:
    """Per-segment splice point installed on the Compiler by the executor:
    cached filters compile to a precomputed-mask plan; uncached ones
    compile normally and, once used min_uses times, are evaluated alone
    on the device and cached."""

    def __init__(self, seg, arrays):
        self.seg = seg
        self.arrays = arrays

    def compile_filter(self, compiler, node, seg, meta):
        from opensearch_tpu_torch.search.compile import Plan
        if seg is not self.seg or not cacheable_node(node):
            return compiler.compile(node, seg, meta)
        fp = fingerprint(node)
        mask = QUERY_CACHE.lookup(seg.uid, fp)
        if mask is not None:
            return Plan("precomputed", inputs={"matches": mask})
        plan = compiler.compile(node, seg, meta)
        if QUERY_CACHE.record_use(seg.uid, fp):
            QUERY_CACHE.put(seg.uid, fp,
                            _eval_filter_mask(plan, self.arrays))
        return plan


def _eval_filter_mask(plan, arrays) -> np.ndarray:
    """Run ONLY the filter sub-plan on the segment's device (its text and
    doc-value leaves through K2 / K4) and copy its bool [Dp] match mask
    to the host, once per cache fill."""
    from opensearch_tpu_torch.search.executor import stage_single
    from opensearch_tpu_torch.search.plan_eval import _eval_plan
    dev = arrays["live"].device
    inputs, _ms = stage_single(plan.flatten_inputs([]), float("-inf"), dev)
    _, matches = _eval_plan(plan, arrays, inputs, [0], 1)
    return matches[0].cpu().numpy()
