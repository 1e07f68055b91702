"""Query compilation: DSL tree -> per-segment `Plan` (the subset of
opensearch_tpu.search.compile the port needs).

A plan's leaves carry host numpy inputs (posting block ids, idf weights,
clause scalars, rank bounds, rank masks); its structure (kind, static,
children) is what selects the kernels. Every node's evaluated scores are
zero where its matches are false, so combinators compose by plain
arithmetic. Numeric, date and boolean values become int32 ranks into the
column's sorted f64 `unique` table on the host (searchsorted), so the
device compares ranks only.
"""

from __future__ import annotations

import bisect
import datetime as _dt
import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from opensearch_tpu_torch.analysis.registry import analyze_query_text
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                QueryShardError)
from opensearch_tpu_torch.index.mapper import (MapperService,
                                               MappedFieldType,
                                               parse_date_millis)
from opensearch_tpu_torch.index.segment import (Segment, ident_pairs,
                                                pad_bucket)
from opensearch_tpu_torch.ops.bm25 import idf as bm25_idf
from opensearch_tpu_torch.ops.device_segment import DeviceSegmentMeta
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.dsl import parse_minimum_should_match

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75


@dataclass
class Plan:
    """One node of the compiled device program."""
    kind: str
    static: tuple = ()
    inputs: Dict[str, np.ndarray] = dc_field(default_factory=dict)
    children: List["Plan"] = dc_field(default_factory=list)

    def sig(self):
        """Structure and input shapes: two plans equal on this run the
        same kernels on same-shaped inputs."""
        return (self.kind, self.static,
                tuple(sorted((k, v.shape, str(v.dtype))
                             for k, v in self.inputs.items())),
                tuple(c.sig() for c in self.children))

    def flatten_inputs(self, out: List[Dict[str, np.ndarray]]):
        out.append(self.inputs)
        for c in self.children:
            c.flatten_inputs(out)
        return out


def plan_struct(p: Plan) -> tuple:
    """Shape-free structural signature (kind / static / children)."""
    return (p.kind, p.static, tuple(plan_struct(c) for c in p.children))


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


class ShardStats:
    """Shard-level (cross-segment) field and term statistics, so every
    segment scores with the same idf and avgdl (Lucene's per-shard
    CollectionStatistics / TermStatistics). Deleted docs still count, as
    in Lucene."""

    def __init__(self, segments: Sequence[Segment]):
        self.segments = list(segments)
        # per-snapshot memo of compiled (agg spec, segment) plans
        self.memo: Dict[Any, Any] = {}
        self._field: Dict[str, Tuple[int, int]] = {}
        self._idf: Dict[Tuple[str, str], float] = {}
        for seg in segments:
            for fname, st in seg.field_stats.items():
                dc, ttf = self._field.get(fname, (0, 0))
                self._field[fname] = (dc + st.doc_count,
                                      ttf + st.sum_total_term_freq)

    def field_stats(self, field: str) -> Tuple[int, int]:
        return self._field.get(field, (0, 0))

    def avgdl(self, field: str) -> float:
        dc, ttf = self.field_stats(field)
        return (ttf / dc) if dc > 0 else 1.0

    def df(self, field: str, term: str) -> int:
        return sum(m.doc_freq for seg in self.segments
                   if (m := seg.get_term(field, term)) is not None)

    def idf(self, field: str, term: str) -> float:
        key = (field, term)
        cached = self._idf.get(key)
        if cached is None:
            dc, _ = self.field_stats(field)
            df = self.df(field, term)
            cached = self._idf[key] = bm25_idf(dc, df) if df else 0.0
        return cached


MATCH_NONE = Plan("match_none")


def _match_all(boost: float) -> Plan:
    return Plan("match_all", inputs={"boost": _f32(boost)})


class Compiler:
    """Compiles one parsed query for one segment of a shard."""

    def __init__(self, mapper: MapperService, stats: ShardStats):
        self.mapper = mapper
        self.stats = stats
        # the segment filter cache's splice point
        # (indices/query_cache.FilterCacheContext), installed per segment
        # by the general path's query phase; None elsewhere
        self.filter_ctx = None

    def compile(self, node: dsl.QueryNode, seg: Segment,
                meta: DeviceSegmentMeta) -> Plan:
        method = getattr(self, f"_c_{type(node).__name__}", None)
        if method is None:
            raise QueryShardError(f"query type [{type(node).__name__}] "
                                  f"is not supported")
        return method(node, seg, meta)

    def _text_clause(self, seg: Segment, meta: DeviceSegmentMeta, field: str,
                     weighted_terms: List[Tuple[str, float]], min_hits: int,
                     boost: float, constant: bool, k1: float = DEFAULT_K1,
                     b: float = DEFAULT_B) -> Plan:
        """weighted_terms: (term, weight) with the weight folding idf, query
        boost and term multiplicity. min_hits: distinct term matches a doc
        needs. Lanes run term by term, each term's blocks in order."""
        ft = self.mapper.get_field(field)
        row = meta.norm_row(field)
        has_norms = ft is not None and ft.is_text and row is not None
        b_eff = b if has_norms else 0.0
        avgdl = self.stats.avgdl(field)
        ids, ws = [], []
        for term, w in weighted_terms:
            tm = seg.get_term(field, term)
            if tm is None:
                continue
            ids.extend(range(tm.start_block, tm.start_block + tm.num_blocks))
            ws.extend([w] * tm.num_blocks)
        qb = pad_bucket(max(len(ids), 1), minimum=8)
        pad = qb - len(ids)
        inputs = {
            "ids": _i32(ids + [-1] * pad),    # -1 = padding lane (no hit)
            "w": _f32(ws + [0.0] * pad),
            "row": _i32(row if has_norms else 0),
            "avgdl": _f32(avgdl if avgdl > 0 else 1.0),
            "b": _f32(b_eff),
            "k1": _f32(k1),
            "min_hits": _i32(min_hits),
            "boost": _f32(boost),
        }
        # static[1], the distinct-term count, bounds how many lanes one doc
        # can hold: the candidate kernel's run-sum window
        return Plan("text", static=(bool(constant), len(weighted_terms)),
                    inputs=inputs)

    def _analyze_query_terms(self, ft: MappedFieldType, text,
                             analyzer_override=None) -> List[str]:
        return analyze_query_text(self.mapper, ft, text, analyzer_override)

    def _weighted(self, field: str, terms: Sequence[str],
                  boost: float) -> Tuple[List[Tuple[str, float]], int]:
        """Fold duplicate terms into multiplicity-weighted idf entries."""
        counts: Dict[str, int] = {}
        for t in terms:
            counts[t] = counts.get(t, 0) + 1
        weighted = [(t, self.stats.idf(field, t) * boost * mult)
                    for t, mult in counts.items()]
        return weighted, len(counts)

    def _c_MatchQuery(self, node: dsl.MatchQuery, seg, meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        terms = self._analyze_query_terms(ft, node.query, node.analyzer)
        if not terms:
            return MATCH_NONE
        weighted, n_distinct = self._weighted(node.field, terms, node.boost)
        if node.operator == "and":
            min_hits = n_distinct
        else:
            min_hits = max(1, parse_minimum_should_match(
                node.minimum_should_match, n_distinct))
        return self._text_clause(seg, meta, node.field, weighted, min_hits,
                                 node.boost, constant=False)

    def _c_TermQuery(self, node: dsl.TermQuery, seg, meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        if ft.is_numeric or ft.is_date:
            return self._numeric_term(seg, node.field, ft, [node.value],
                                      node.boost)
        value = str(node.value)
        if ft.is_bool:
            value = "true" if node.value in (True, "true") else "false"
        weighted, _ = self._weighted(node.field, [value], node.boost)
        return self._text_clause(seg, meta, node.field, weighted, 1,
                                 node.boost, constant=False)

    def _c_TermsQuery(self, node: dsl.TermsQuery, seg, meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        if ft.is_numeric or ft.is_date:
            return self._numeric_term(seg, node.field, ft,
                                      list(node.values), node.boost)
        values = [("true" if v in (True, "true") else "false") if ft.is_bool
                  else str(v) for v in node.values]
        # terms is constant-score in the reference
        weighted = [(v, 1.0) for v in dict.fromkeys(values)]
        return self._text_clause(seg, meta, node.field, weighted, 1,
                                 node.boost, constant=True)

    def _numeric_term(self, seg: Segment, field: str, ft: MappedFieldType,
                      values: List[Any], boost: float) -> Plan:
        """Exact numeric / date match: a bool mask over the column's value
        ranks, built on the host."""
        col = seg.numeric_dv.get(field)
        if col is None or len(col.unique) == 0:
            return MATCH_NONE
        mask = np.zeros(pad_bucket(len(col.unique), 8), dtype=bool)
        for v in values:
            target = ft.to_comparable(v)
            i = int(np.searchsorted(col.unique, target))
            if i < len(col.unique) and col.unique[i] == target:
                mask[i] = True
        return Plan("num_terms", static=(field, ident_pairs(col)),
                    inputs={"mask": mask, "boost": _f32(boost)})

    def _c_RangeQuery(self, node: dsl.RangeQuery, seg, meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        if ft.is_keyword:
            col = seg.ordinal_dv.get(node.field)
            if col is None:
                return MATCH_NONE
            lo = 0 if node.gte is None and node.gt is None else (
                bisect.bisect_left(col.dictionary, str(node.gte))
                if node.gte is not None
                else bisect.bisect_right(col.dictionary, str(node.gt)))
            hi = len(col.dictionary) \
                if node.lte is None and node.lt is None else (
                    bisect.bisect_right(col.dictionary, str(node.lte))
                    if node.lte is not None
                    else bisect.bisect_left(col.dictionary, str(node.lt)))
            return Plan("range_ord", static=(node.field, ident_pairs(col)),
                        inputs={"lo": _i32(lo), "hi": _i32(hi),
                                "boost": _f32(node.boost)})
        col = seg.numeric_dv.get(node.field)
        if col is None:
            return MATCH_NONE

        def bound(value, round_up=False):
            if ft.is_date and isinstance(value, str) \
                    and ("now" in value or "||" in value):
                value = _resolve_date_math(value, round_up=round_up)
            return ft.to_comparable(value)

        lo_rank = 0
        hi_rank = len(col.unique)
        if node.gte is not None:
            lo_rank = int(np.searchsorted(col.unique, bound(node.gte),
                                          "left"))
        elif node.gt is not None:
            lo_rank = int(np.searchsorted(
                col.unique, bound(node.gt, round_up=True), "right"))
        if node.lte is not None:
            hi_rank = int(np.searchsorted(
                col.unique, bound(node.lte, round_up=True), "right"))
        elif node.lt is not None:
            hi_rank = int(np.searchsorted(col.unique, bound(node.lt),
                                          "left"))
        return Plan("range_num", static=(node.field, ident_pairs(col)),
                    inputs={"lo": _i32(lo_rank), "hi": _i32(hi_rank),
                            "boost": _f32(node.boost)})

    def _c_ExistsQuery(self, node: dsl.ExistsQuery, seg, meta) -> Plan:
        field = node.field
        if field in seg.numeric_dv:
            return Plan("exists", static=("numeric", field),
                        inputs={"boost": _f32(node.boost)})
        if field in seg.ordinal_dv:
            return Plan("exists", static=("ordinal", field),
                        inputs={"boost": _f32(node.boost)})
        if field in seg.vector_dv:
            return Plan("exists", static=("vector", field),
                        inputs={"boost": _f32(node.boost)})
        if field in seg.rank_vectors_dv:
            return Plan("exists", static=("rank_vectors", field),
                        inputs={"boost": _f32(node.boost)})
        row = meta.norm_row(field)
        if row is not None:
            return Plan("exists", static=("norms", row),
                        inputs={"boost": _f32(node.boost)})
        return MATCH_NONE

    def _c_KnnQuery(self, node: dsl.KnnQuery, seg, meta) -> Plan:
        """k-NN query -> the exact scan (K7) or the IVF probe (K8), then
        the k best eligible docs of the segment (the k-NN plugin's per-
        segment KNNQuery). A `filter` restricts eligibility before the
        top-k, and a filtered query always scans exactly, so its top-k
        stays exact."""
        ft = self.mapper.get_field(node.field)
        if ft is None or not ft.is_vector:
            raise QueryShardError(
                f"field [{node.field}] is not a knn_vector field")
        col = seg.vector_dv.get(node.field)
        if col is None:
            return MATCH_NONE
        q = np.asarray(list(node.vector), dtype=np.float32)
        if q.shape != (ft.dims,):
            raise IllegalArgumentError(
                f"query vector has dimension {q.shape[0]} but field "
                f"[{node.field}] expects {ft.dims}")
        use_ivf = col.ivf is not None and node.filter is None
        nprobe = (node.nprobe or col.ivf.nprobe) if use_ivf else 0
        children = []
        if node.filter is not None:
            children.append(self.compile(node.filter, seg, meta))
        return Plan("knn",
                    static=(node.field, int(node.k), ft.similarity_space,
                            "ivf" if use_ivf else "exact", int(nprobe)),
                    inputs={"query": q, "boost": _f32(node.boost)},
                    children=children)

    def _c_MaxSimQuery(self, node: dsl.MaxSimQuery, seg, meta) -> Plan:
        """Late-interaction MaxSim leaf -> the exact (K10) or PQ (K11)
        scan, then the k best eligible docs of the segment, as for knn; a
        `filter` restricts eligibility before the top-k. The query token
        matrix pads to a power-of-two token bucket (at least 4) with a
        qmask zeroing the padded lanes."""
        ft = self.mapper.get_field(node.field)
        if ft is None or not ft.is_rank_vectors:
            raise QueryShardError(
                f"field [{node.field}] is not a rank_vectors field")
        col = seg.rank_vectors_dv.get(node.field)
        if col is None:
            return MATCH_NONE
        q = np.asarray([list(t) for t in node.query_vectors],
                       dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != ft.dims:
            got = q.shape[1] if q.ndim == 2 else "ragged"
            raise IllegalArgumentError(
                f"query token vectors have dimension {got} but field "
                f"[{node.field}] expects {ft.dims}")
        if q.shape[0] > ft.max_tokens:
            raise IllegalArgumentError(
                f"query has {q.shape[0]} token vectors but field "
                f"[{node.field}] allows at most max_tokens={ft.max_tokens}")
        tq = pad_bucket(q.shape[0], minimum=4)
        qpad = np.zeros((tq, ft.dims), dtype=np.float32)
        qpad[:q.shape[0]] = q
        qmask = np.zeros(tq, dtype=np.float32)
        qmask[:q.shape[0]] = 1.0
        children = []
        if node.filter is not None:
            children.append(self.compile(node.filter, seg, meta))
        compression = "pq" if col.codes is not None else "none"
        return Plan("maxsim",
                    static=(node.field, int(node.k), compression),
                    inputs={"query": qpad, "qmask": qmask,
                            "boost": _f32(node.boost)},
                    children=children)

    def _c_HybridQuery(self, node: dsl.HybridQuery, seg, meta) -> Plan:
        """Hybrid runs as the fused hybrid query phase
        (search/executor.py), which compiles each sub-query on its own;
        reaching the generic compiler means it was nested in another
        clause, which the reference refuses too."""
        raise QueryShardError(
            "[hybrid] query must be a top-level query and cannot be wrapped "
            "into other queries")

    def _c_DisMaxQuery(self, node: dsl.DisMaxQuery, seg, meta) -> Plan:
        children = [self.compile(c, seg, meta) for c in node.queries]
        if not children:
            return MATCH_NONE
        return Plan("dis_max", inputs={"tie": _f32(node.tie_breaker),
                                       "boost": _f32(node.boost)},
                    children=children)

    def _c_MatchAllQuery(self, node, seg, meta) -> Plan:
        return _match_all(node.boost)

    def _c_MatchNoneQuery(self, node, seg, meta) -> Plan:
        return MATCH_NONE

    def _bool_plan(self, must, filter, should, must_not, msm: int,
                   boost: float) -> Plan:
        return Plan("bool",
                    static=(len(must), len(filter), len(should),
                            len(must_not)),
                    inputs={"msm": _i32(msm), "boost": _f32(boost)},
                    children=list(must) + list(filter) + list(should)
                    + list(must_not))

    def _compile_filter(self, node, seg, meta) -> Plan:
        """Filter-context compilation: consults the segment filter cache
        when the executor installed one."""
        if self.filter_ctx is not None:
            return self.filter_ctx.compile_filter(self, node, seg, meta)
        return self.compile(node, seg, meta)

    def _c_BoolQuery(self, node: dsl.BoolQuery, seg, meta) -> Plan:
        must = [self.compile(c, seg, meta) for c in node.must]
        filt = [self._compile_filter(c, seg, meta) for c in node.filter]
        should = [self.compile(c, seg, meta) for c in node.should]
        must_not = [self.compile(c, seg, meta) for c in node.must_not]
        if node.minimum_should_match is not None:
            msm = parse_minimum_should_match(node.minimum_should_match,
                                             len(should))
        elif should and not (node.must or node.filter):
            msm = 1
        else:
            msm = 0
        return self._bool_plan(must, filt, should, must_not, msm, node.boost)


def _resolve_date_math(expr: str, round_up: bool = False) -> Any:
    """Minimal date math: 'now', 'now-7d', 'now/d', '<date>||-1M/d'.
    `round_up` gives the END of the rounded unit (gt and lte bounds round
    up, gte and lt round down, as DateMathParser does)."""
    if "||" in expr:
        base_str, math = expr.split("||", 1)
        base = parse_date_millis(base_str)
    elif expr.startswith("now"):
        base = int(_dt.datetime.now(_dt.timezone.utc).timestamp() * 1000)
        math = expr[3:]
    else:
        return expr
    units_ms = {"s": 1000, "m": 60000, "h": 3600000, "H": 3600000,
                "d": 86400000, "w": 7 * 86400000, "M": 30 * 86400000,
                "y": 365 * 86400000}
    for m in re.finditer(r"([+\-/])(\d*)([smhHdwMy])", math):
        op, num, unit = m.groups()
        if op == "/":
            base = (base // units_ms[unit]) * units_ms[unit]
            if round_up:
                base += units_ms[unit] - 1
        else:
            delta = int(num or 1) * units_ms[unit]
            base = base + delta if op == "+" else base - delta
    return base
