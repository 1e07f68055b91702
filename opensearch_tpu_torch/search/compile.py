"""Query compilation: DSL tree -> per-segment `Plan` (the subset of
opensearch_tpu.search.compile the port needs).

A plan's leaves carry host numpy inputs (posting block ids, idf weights,
clause scalars, rank bounds, rank masks, precomputed planes); its
structure (kind, static, children) is what selects the kernels. Every
node's evaluated scores are zero where its matches are false, so
combinators compose by plain arithmetic. Numeric, date and boolean values
become int32 ranks into the column's sorted f64 `unique` table on the
host (searchsorted), so the device compares ranks only.

Multi-term queries (prefix, wildcard, regexp, fuzzy, match with
fuzziness) expand against the segment's term dictionary into one
constant-score text clause; phrases match on the host over the segment's
stored positions and enter the plan as a `precomputed` (scores, matches)
pair; query_string and simple_query_string rewrite into bool / match /
phrase / range trees. The scoring kinds (function_score, script_score,
terms_set, distance_feature, boosting) carry their per-query numbers as
f32 inputs and their structure (modes, function kinds, fields, script
sources) in `static`.
"""

from __future__ import annotations

import bisect
import datetime as _dt
import fnmatch
import re
from dataclasses import dataclass, field as dc_field, fields as dc_fields
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from opensearch_tpu_torch.analysis.registry import analyze_query_text
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ParsingError,
                                                QueryShardError)
from opensearch_tpu_torch.common.settings import parse_time_value
from opensearch_tpu_torch.index.mapper import (MapperService,
                                               MappedFieldType,
                                               parse_date_millis)
from opensearch_tpu_torch.index.segment import (LENGTH_TABLE, SEAL_B,
                                                SEAL_K1, Segment,
                                                ident_pairs, pad_bucket)
from opensearch_tpu_torch.ops.bm25 import idf as bm25_idf
from opensearch_tpu_torch.ops.device_segment import DeviceSegmentMeta
from opensearch_tpu_torch.ops.scoring import MAX_FUNCTIONS
from opensearch_tpu_torch.script.painless import compile_score_script
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.dsl import parse_minimum_should_match

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75
MAX_EXPANSIONS = 1024  # indices.query.bool.max_clause_count analog


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


class StaticStats:
    """Term and field statistics fixed by a DFS pre-phase
    (dfs_query_then_fetch): every shard scores with the global df and
    avgdl instead of its own, so scores compare across shards however the
    terms are spread. Terms the pre-phase did not collect fall back to the
    shard's own statistics."""

    def __init__(self, local: ShardStats,
                 field_stats: Dict[str, Tuple[int, int]],
                 term_df: Dict[str, Dict[str, int]]):
        self.segments = local.segments
        self._local = local
        self._fields = field_stats
        self._term_df = term_df
        self.memo: Dict[Any, Any] = {}       # per request (never shared)

    def field_stats(self, field: str) -> Tuple[int, int]:
        got = self._fields.get(field)
        return tuple(got) if got is not None else \
            self._local.field_stats(field)

    def avgdl(self, field: str) -> float:
        dc, ttf = self.field_stats(field)
        return (ttf / dc) if dc > 0 else 1.0

    def df(self, field: str, term: str) -> int:
        got = (self._term_df.get(field) or {}).get(term)
        return got if got is not None else self._local.df(field, term)

    def idf(self, field: str, term: str) -> float:
        df = self.df(field, term)
        if df == 0:
            return 0.0
        dc, _ = self.field_stats(field)
        return bm25_idf(dc, df)


def collect_query_term_stats(node: dsl.QueryNode, mapper: MapperService,
                             stats: ShardStats):
    """The shard-local half of the DFS phase: every (field, term) the
    query scores with, this shard's df for each, and the field-level
    (doc_count, sum_ttf). query_string / simple_query_string rewrite
    through the compiler's parser. Query shapes it does not recognize
    contribute nothing (they score with the shard's own statistics)."""
    fields: Dict[str, Tuple[int, int]] = {}
    term_df: Dict[str, Dict[str, int]] = {}

    def record(field: str, terms):
        if not terms:
            return
        fields[field] = stats.field_stats(field)
        bucket = term_df.setdefault(field, {})
        for t in terms:
            if t not in bucket:
                bucket[t] = stats.df(field, t)

    def analyze(field: str, text, analyzer=None):
        return analyze_query_text(mapper, mapper.get_field(field), text,
                                  analyzer)

    def walk(n):
        if isinstance(n, dsl.QueryStringQuery):
            walk(_parse_query_string(n.query, n.default_field or "*",
                                     list(n.fields), n.default_operator,
                                     mapper))
            return
        if isinstance(n, dsl.SimpleQueryStringQuery):
            walk(_parse_query_string(n.query, "*", list(n.fields),
                                     n.default_operator, mapper,
                                     simple=True))
            return
        if isinstance(n, (dsl.MatchQuery, dsl.MatchBoolPrefixQuery,
                          dsl.MatchPhraseQuery)):
            record(n.field, analyze(n.field, n.query, n.analyzer))
        elif isinstance(n, dsl.TermQuery):
            record(n.field, [str(n.value)])
        elif isinstance(n, dsl.TermsQuery):
            record(n.field, [str(v) for v in n.values])
        elif isinstance(n, dsl.MultiMatchQuery):
            for fspec in n.fields:
                fname = fspec.partition("^")[0]
                record(fname, analyze(fname, n.query))
        for f in dc_fields(n):
            sub = getattr(n, f.name, None)
            if isinstance(sub, dsl.QueryNode):
                walk(sub)
            elif isinstance(sub, (list, tuple)):
                for s in sub:
                    if isinstance(s, dsl.QueryNode):
                        walk(s)

    walk(node)
    return fields, term_df


def merge_dfs_stats(parts):
    """The coordinator's aggregateDfs: df and field statistics summed over
    the shards' contributions."""
    fields: Dict[str, Tuple[int, int]] = {}
    term_df: Dict[str, Dict[str, int]] = {}
    for f_part, t_part in parts:
        for field, (dc, ttf) in f_part.items():
            have = fields.get(field, (0, 0))
            fields[field] = (have[0] + dc, have[1] + ttf)
        for field, bucket in t_part.items():
            tgt = term_df.setdefault(field, {})
            for term, df in bucket.items():
                tgt[term] = tgt.get(term, 0) + df
    return fields, term_df


MATCH_NONE = Plan("match_none")


def _match_all(boost: float) -> Plan:
    return Plan("match_all", inputs={"boost": _f32(boost)})


class Compiler:
    """Compiles one parsed query for one segment of a shard."""

    def __init__(self, mapper: MapperService, stats: ShardStats,
                 blockmax: bool = False):
        self.mapper = mapper
        self.stats = stats
        # the node's `search.blockmax.enabled`: text clauses carry block-max
        # phase A's inputs (`tid`, `bscale`)
        self.blockmax = blockmax
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
        ids, ws, tids = [], [], []
        for t_i, (term, w) in enumerate(weighted_terms):
            tm = seg.get_term(field, term)
            if tm is None:
                continue
            ids.extend(range(tm.start_block, tm.start_block + tm.num_blocks))
            ws.extend([w] * tm.num_blocks)
            tids.extend([t_i] * tm.num_blocks)
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
        if self.blockmax:
            # block-max phase A (ops/bm25.blockmax_keep_mask): each lane's
            # clause-term index and the segment's bound scale
            inputs["tid"] = _i32(tids + [0] * pad)
            inputs["bscale"] = _f32(
                self._blockmax_scale(seg, field, k1, b_eff, avgdl))
        # static[1], the distinct-term count, bounds how many lanes one doc
        # can hold: the candidate kernel's run-sum window
        return Plan("text", static=(bool(constant), len(weighted_terms)),
                    inputs=inputs)

    def _blockmax_scale(self, seg: Segment, field: str, k1: float,
                        b_eff: float, avgdl: float) -> float:
        """A ceiling on g_query / g_seal over the doc lengths that occur in
        the segment's field, where g = tf / (tf + k1 * c(dl)): the seal-time
        bounds (SEAL_K1, SEAL_B, the segment's own avgdl) times this factor
        stay upper bounds under the query's k1, b and shard avgdl
        ((tf + A) / (tf + B) <= max(1, A / B) for tf >= 0)."""
        key = ("bms", seg.uid, field, k1, b_eff, avgdl)
        cached = self.stats.memo.get(key)
        if cached is not None:
            return cached
        norm = seg.norms.get(field)
        fstats = seg.field_stats.get(field)
        k1_q = max(k1, 1e-9)
        if norm is None or fstats is None or fstats.doc_count <= 0:
            # the seal used c = 1 for a norm-less field; the query's b is 0
            scale = max(1.0, SEAL_K1 / k1_q)
        else:
            avgdl_s = max(fstats.sum_total_term_freq / fstats.doc_count,
                          1e-9)
            occurring = np.flatnonzero(np.bincount(norm, minlength=256))
            dl = LENGTH_TABLE[occurring].astype(np.float64)
            c_s = 1.0 - SEAL_B + SEAL_B * dl / avgdl_s
            c_q = 1.0 - b_eff + b_eff * dl / (avgdl if avgdl > 0 else 1.0)
            ratio = (SEAL_K1 * c_s) / np.maximum(k1_q * c_q, 1e-9)
            scale = float(max(1.0, ratio.max()))
        self.stats.memo[key] = scale
        return scale

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
        if ft.is_numeric or ft.is_date or ft.is_bool:
            # match on a numeric-ish field degrades to an exact term match
            return self._numeric_term(seg, node.field, ft, [node.query],
                                      node.boost)
        terms = self._analyze_query_terms(ft, node.query, node.analyzer)
        if not terms:
            return MATCH_NONE
        if node.fuzziness is not None:
            # one fuzzy clause per token (Lucene's match with fuzziness)
            children = [self._c_FuzzyQuery(
                dsl.FuzzyQuery(field=node.field, value=t,
                               fuzziness=str(node.fuzziness)), seg, meta)
                for t in terms]
            if node.operator == "and":
                return self._bool_plan(children, [], [], [], 0, node.boost)
            msm = max(1, parse_minimum_should_match(
                node.minimum_should_match, len(children)))
            return self._bool_plan([], [], children, [], msm, node.boost)
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
        if node.case_insensitive:
            return self._expand_terms(
                seg, meta, node.field,
                lambda t: t.lower() == value.lower(), node.boost)
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

    # ------------------------------------------------------ ids / terms
    def _c_IdsQuery(self, node: dsl.IdsQuery, seg, meta) -> Plan:
        mask = np.zeros(seg.num_docs, dtype=bool)
        for doc_id in node.values:
            ord_ = seg._id_to_ord.get(str(doc_id))
            if ord_ is not None:
                mask[ord_] = True
        return self._precomputed_plan(
            seg, np.where(mask, np.float32(node.boost), np.float32(0.0)),
            mask)

    def _precomputed_plan(self, seg, scores: np.ndarray,
                          matches: np.ndarray) -> Plan:
        d_pad = pad_bucket(max(seg.num_docs, 1))
        sc = np.zeros(d_pad, dtype=np.float32)
        mk = np.zeros(d_pad, dtype=bool)
        sc[:seg.num_docs] = scores
        mk[:seg.num_docs] = matches
        return Plan("precomputed", inputs={"scores": sc, "matches": mk})

    def _multi_term_predicate(self, node):
        """The term-dictionary predicate of a multi-term query node."""
        if isinstance(node, dsl.PrefixQuery):
            value = node.value.lower() if node.case_insensitive \
                else node.value
            if node.case_insensitive:
                return lambda t: t.lower().startswith(value)
            return lambda t: t.startswith(value)
        if isinstance(node, dsl.WildcardQuery):
            pattern = node.value.lower() if node.case_insensitive \
                else node.value
            if node.case_insensitive:
                return lambda t: fnmatch.fnmatchcase(t.lower(), pattern)
            return lambda t: fnmatch.fnmatchcase(t, pattern)
        if isinstance(node, dsl.RegexpQuery):
            try:
                rx = re.compile(node.value, re.IGNORECASE
                                if node.case_insensitive else 0)
            except re.error as e:
                raise ParsingError(f"invalid regexp [{node.value}]: {e}")
            return lambda t: rx.fullmatch(t) is not None
        if isinstance(node, dsl.FuzzyQuery):
            max_edits = _fuzziness_to_edits(node.fuzziness, node.value)
            prefix = node.value[:node.prefix_length]
            return (lambda t: t.startswith(prefix)
                    and _levenshtein_le(t, node.value, max_edits))
        raise ParsingError(
            f"unsupported multi-term query {type(node).__name__}")

    def _expand_terms(self, seg, meta, field: str, predicate,
                      boost: float) -> Plan:
        """Constant-score rewrite of prefix / wildcard / regexp / fuzzy
        against this segment's term dictionary (MultiTermQuery's
        CONSTANT_SCORE_REWRITE)."""
        terms = [t for t in seg.terms_for_field(field) if predicate(t)]
        if len(terms) > MAX_EXPANSIONS:
            raise QueryShardError(
                f"field [{field}] expansion matches too many terms "
                f"(> {MAX_EXPANSIONS})")
        if not terms:
            return MATCH_NONE
        weighted = [(t, 1.0) for t in terms]
        return self._text_clause(seg, meta, field, weighted, 1, boost,
                                 constant=True)

    def _c_PrefixQuery(self, node, seg, meta) -> Plan:
        return self._expand_terms(seg, meta, node.field,
                                  self._multi_term_predicate(node),
                                  node.boost)

    _c_WildcardQuery = _c_PrefixQuery
    _c_RegexpQuery = _c_PrefixQuery
    _c_FuzzyQuery = _c_PrefixQuery

    # ------------------------------------------------------ phrases
    def _c_MatchPhraseQuery(self, node: dsl.MatchPhraseQuery, seg,
                            meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        terms = self._analyze_query_terms(ft, node.query, node.analyzer)
        if not terms:
            return MATCH_NONE
        if len(terms) == 1:
            weighted, _ = self._weighted(node.field, terms, node.boost)
            return self._text_clause(seg, meta, node.field, weighted, 1,
                                     node.boost, constant=False)
        scores, matches = phrase_eval(seg, self.stats, node.field, terms,
                                      node.slop, node.boost)
        return self._precomputed_plan(seg, scores, matches)

    def _c_MatchBoolPrefixQuery(self, node, seg, meta) -> Plan:
        ft = self.mapper.get_field(node.field)
        if ft is None:
            return MATCH_NONE
        terms = self._analyze_query_terms(ft, node.query, node.analyzer)
        if not terms:
            return MATCH_NONE
        children: List[Plan] = []
        for t in terms[:-1]:
            weighted, _ = self._weighted(node.field, [t], 1.0)
            children.append(self._text_clause(seg, meta, node.field,
                                              weighted, 1, 1.0,
                                              constant=False))
        children.append(self._c_PrefixQuery(
            dsl.PrefixQuery(field=node.field, value=terms[-1]), seg, meta))
        return self._bool_plan(must=[], filter=[], should=children,
                               must_not=[], msm=1, boost=node.boost)

    def _c_MatchPhrasePrefixQuery(self, node, seg, meta) -> Plan:
        """The trailing prefix expanded against the segment's terms, then a
        dis_max of the full phrases (MatchPhrasePrefixQuery)."""
        ft = self.mapper.get_field(node.field)
        if ft is None or not ft.is_text:
            return MATCH_NONE
        terms = self._analyze_query_terms(ft, node.query, node.analyzer)
        if not terms:
            return MATCH_NONE
        prefix = terms[-1]
        expansions = sorted(
            t for t in seg.terms_for_field(node.field)
            if t.startswith(prefix))[:node.max_expansions]
        if not expansions:
            return MATCH_NONE
        phrases = [dsl.MatchPhraseQuery(field=node.field,
                                        query=" ".join(terms[:-1] + [t]),
                                        slop=node.slop,
                                        analyzer=node.analyzer)
                   for t in expansions]
        return self.compile(dsl.DisMaxQuery(queries=phrases,
                                            boost=node.boost), seg, meta)

    def _c_MultiMatchQuery(self, node: dsl.MultiMatchQuery, seg,
                           meta) -> Plan:
        fields = self.mapper.expand_field_patterns(list(node.fields))
        if not fields:
            if any("*" in f for f in node.fields):
                return MATCH_NONE       # pattern matched no mapped field
            raise ParsingError("[multi_match] requires fields")
        subs = []
        for fspec in fields:
            fname, _, fboost = fspec.partition("^")
            boost = float(fboost) if fboost else 1.0
            if node.type == "phrase":
                q = dsl.MatchPhraseQuery(field=fname, query=node.query,
                                         boost=boost)
            else:
                q = dsl.MatchQuery(
                    field=fname, query=node.query, operator=node.operator,
                    minimum_should_match=node.minimum_should_match,
                    boost=boost)
            subs.append(self.compile(q, seg, meta))
        if node.type in ("most_fields", "cross_fields"):
            return self._bool_plan([], [], subs, [], msm=1,
                                   boost=node.boost)
        return Plan("dis_max", inputs={"tie": _f32(node.tie_breaker),
                                       "boost": _f32(node.boost)},
                    children=subs)

    def _c_QueryStringQuery(self, node: dsl.QueryStringQuery, seg,
                            meta) -> Plan:
        parsed = _parse_query_string(node.query, node.default_field or "*",
                                     list(node.fields),
                                     node.default_operator, self.mapper)
        parsed.boost = node.boost
        return self.compile(parsed, seg, meta)

    def _c_SimpleQueryStringQuery(self, node, seg, meta) -> Plan:
        parsed = _parse_query_string(node.query, "*", list(node.fields),
                                     node.default_operator, self.mapper,
                                     simple=True)
        parsed.boost = node.boost
        return self.compile(parsed, seg, meta)

    # ------------------------------------------------------ scoring kinds
    def _c_ConstantScoreQuery(self, node: dsl.ConstantScoreQuery, seg,
                              meta) -> Plan:
        child = self._compile_filter(node.filter, seg, meta)
        return Plan("const_score", inputs={"boost": _f32(node.boost)},
                    children=[child])

    def _c_BoostingQuery(self, node: dsl.BoostingQuery, seg, meta) -> Plan:
        pos = self.compile(node.positive, seg, meta)
        neg = self.compile(node.negative, seg, meta)
        return Plan("boosting", inputs={"nb": _f32(node.negative_boost),
                                        "boost": _f32(node.boost)},
                    children=[pos, neg])

    def _c_ScriptScoreQuery(self, node: dsl.ScriptScoreQuery, seg,
                            meta) -> Plan:
        """The script compiles to torch ops over dense doc-value columns
        (script/painless.py TorchScoreScript); numeric params travel as
        per-query f32 inputs, the others in the plan's static part."""
        script = compile_score_script(node.script_source)
        for f in script.fields:
            if f not in seg.numeric_dv:
                ft = self.mapper.get_field(f)
                kind = "missing from mapping" if ft is None else \
                    f"of type [{ft.type}] (device score scripts support " \
                    f"numeric doc values)"
                raise QueryShardError(f"script_score field [{f}] {kind}")
        child = self.compile(node.query, seg, meta)
        pkeys, static_params, num_params = _split_params(
            node.script_params)
        inputs = {"boost": _f32(node.boost)}
        for k in pkeys:
            inputs[f"p_{k}"] = _f32(num_params[k])
        return Plan("script_score",
                    static=(node.script_source, pkeys, static_params),
                    inputs=inputs, children=[child])

    def _c_FunctionScoreQuery(self, node: dsl.FunctionScoreQuery, seg,
                              meta) -> Plan:
        if len(node.functions) > MAX_FUNCTIONS:
            raise QueryShardError(
                f"[function_score] takes at most {MAX_FUNCTIONS} functions "
                f"in opensearch_tpu_torch, got {len(node.functions)}")
        child = self.compile(node.query, seg, meta)
        children = [child]
        fn_specs = []
        inputs: Dict[str, np.ndarray] = {"boost": _f32(node.boost),
                                         "max_boost": _f32(node.max_boost)}
        if node.min_score is not None:
            inputs["min_score"] = _f32(node.min_score)
        for i, fn in enumerate(node.functions):
            has_filter = fn.get("filter") is not None
            if has_filter:
                children.append(self.compile(fn["filter"], seg, meta))
            if "weight" in fn:
                inputs[f"f{i}_weight"] = _f32(fn["weight"])
            if "field_value_factor" in fn:
                fvf = fn["field_value_factor"]
                field = fvf.get("field")
                if field not in seg.numeric_dv and \
                        self.mapper.get_field(field) is None:
                    raise QueryShardError(
                        f"Unable to find a field mapper for field "
                        f"[{field}]")
                fn_specs.append(("fvf",
                                 field if field in seg.numeric_dv else None,
                                 str(fvf.get("modifier", "none")).lower(),
                                 has_filter))
                inputs[f"f{i}_factor"] = _f32(fvf.get("factor", 1.0))
                inputs[f"f{i}_missing"] = _f32(fvf.get("missing", 1.0))
            elif "random_score" in fn:
                seed = (fn["random_score"] or {}).get("seed", 42)
                fn_specs.append(("random", int(seed) & 0xFFFFFFFF,
                                 has_filter))
            elif "script_score" in fn:
                spec = fn["script_score"].get("script", {})
                if isinstance(spec, str):
                    spec = {"source": spec}
                source = spec.get("source", "")
                compile_score_script(source)  # validate early
                pkeys, static_params, num_params = _split_params(
                    spec.get("params"))
                for k in pkeys:
                    inputs[f"f{i}_p_{k}"] = _f32(num_params[k])
                fn_specs.append(("script", source, pkeys, static_params,
                                 has_filter))
            elif any(k in fn for k in ("gauss", "exp", "linear")):
                decay_kind = next(k for k in ("gauss", "exp", "linear")
                                  if k in fn)
                decay_body = fn[decay_kind]
                if len(decay_body) != 1:
                    raise QueryShardError(
                        f"[{decay_kind}] must have exactly one field")
                field, spec = next(iter(decay_body.items()))
                ft = self.mapper.get_field(field)
                origin = spec.get("origin")
                scale = spec.get("scale")
                if ft is not None and ft.is_date:
                    origin_v = float(parse_date_millis(origin)) \
                        if origin is not None else 0.0
                    scale_v = parse_time_value(scale, "scale") * 1000.0
                    offset_v = parse_time_value(
                        spec.get("offset", 0), "offset") * 1000.0
                else:
                    origin_v = float(origin)
                    scale_v = float(scale)
                    offset_v = float(spec.get("offset", 0.0))
                fn_specs.append(("decay", decay_kind,
                                 field if field in seg.numeric_dv else None,
                                 has_filter))
                inputs[f"f{i}_origin"] = _f32(origin_v)
                inputs[f"f{i}_scale"] = _f32(scale_v)
                inputs[f"f{i}_offset"] = _f32(offset_v)
                inputs[f"f{i}_decay"] = _f32(spec.get("decay", 0.5))
            else:
                fn_specs.append(("weight_only", has_filter))
                inputs.setdefault(f"f{i}_weight", _f32(1.0))
        return Plan("function_score",
                    static=(node.score_mode, node.boost_mode,
                            tuple(fn_specs)),
                    inputs=inputs, children=children)

    def _c_TermsSetQuery(self, node: dsl.TermsSetQuery, seg, meta) -> Plan:
        children = [self.compile(
            dsl.TermQuery(field=node.field, value=v), seg, meta)
            for v in node.terms]
        msm_field = node.minimum_should_match_field
        if msm_field is not None and msm_field not in seg.numeric_dv:
            if self.mapper.get_field(msm_field) is None:
                raise QueryShardError(
                    f"Unable to find a field mapper for field "
                    f"[{msm_field}]")
            return MATCH_NONE   # no doc in this segment has the field
        inputs = {"boost": _f32(node.boost)}
        if msm_field is None:
            inputs["msm"] = _i32(len(node.terms))
        return Plan("terms_set", static=(msm_field,), inputs=inputs,
                    children=children)

    def _c_DistanceFeatureQuery(self, node: dsl.DistanceFeatureQuery, seg,
                                meta) -> Plan:
        """distance_feature on a numeric or date column (the geo_point
        branch waits for the geo_point type)."""
        ft = self.mapper.get_field(node.field)
        if ft is None:
            raise QueryShardError(
                f"Can't load fielddata on [{node.field}] because the field "
                f"does not exist")
        if node.field not in seg.numeric_dv:
            return MATCH_NONE
        if ft.is_date:
            origin = float(parse_date_millis(node.origin))
            pivot = parse_time_value(node.pivot, "pivot") * 1000.0
        else:
            origin = float(node.origin)
            pivot = float(node.pivot)
        return Plan("distance_feature", static=(node.field,),
                    inputs={"origin": _f32(origin), "pivot": _f32(pivot),
                            "boost": _f32(node.boost)})


def _split_params(params) -> Tuple[tuple, tuple, dict]:
    """A script's params: the sorted numeric keys (per-query f32
    inputs), the other (key, value) pairs (static) and the numeric
    values."""
    params = params or {}
    num_params = {k: v for k, v in params.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)}
    static_params = tuple(sorted((k, v) for k, v in params.items()
                                 if k not in num_params))
    return tuple(sorted(num_params)), static_params, num_params


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


def _fuzziness_to_edits(fuzziness: str, term: str) -> int:
    f = str(fuzziness).upper()
    if f == "AUTO":
        n = len(term)
        return 0 if n <= 2 else (1 if n <= 5 else 2)
    return int(float(f))


def _levenshtein_le(a: str, b: str, limit: int) -> bool:
    """Damerau (restricted transposition) edit distance ≤ limit, matching
    Lucene's FuzzyQuery default transpositions=true."""
    if abs(len(a) - len(b)) > limit:
        return False
    prev2 = None
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        row_min = i
        for j, cb in enumerate(b, 1):
            cost = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            if (prev2 is not None and i > 1 and j > 1
                    and ca == b[j - 2] and a[i - 2] == cb):
                cost = min(cost, prev2[j - 2] + 1)
            cur[j] = cost
            row_min = min(row_min, cost)
        if row_min > limit:
            return False
        prev2, prev = prev, cur
    return prev[-1] <= limit


# positions fit 21 bits (max field length 2^21-1 tokens); (doc, position)
# packs into one int64 key for the vectorized window intersection
_POS_BITS = 21


def _sorted_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two SORTED unique int64 arrays via searchsorted —
    np.intersect1d re-sorts the concatenation and wastes the presorting."""
    if len(a) > len(b):
        a, b = b, a
    if len(b) == 0:
        return b
    idx = np.searchsorted(b, a)
    idx[idx == len(b)] = 0
    return a[b[idx] == a]


def _flat_positions(seg: Segment, field: str, term: str):
    """SORTED packed (doc << _POS_BITS) | position int64 keys across the
    term's postings, memoized per segment (segments are immutable
    post-seal). Sorted once here ⇒ phrase queries do NO per-query sort:
    subtracting a phrase offset keeps the order, and filtering a sorted
    array keeps it sorted."""
    key = (field, term)
    cache = getattr(seg, "_flat_pos_cache", None)
    if cache is None:
        cache = seg._flat_pos_cache = {}
    hit = cache.get(key, False)
    if hit is not False:
        return hit
    pos_lists = seg.positions.get(key)
    meta = seg.term_dict.get(key)
    if pos_lists is None or meta is None:
        cache[key] = None
        return None
    docs = seg.post_docs[
        meta.start_block:meta.start_block + meta.num_blocks].ravel()
    docs = docs[docs >= 0].astype(np.int64)
    lens = np.fromiter((len(p) for p in pos_lists), np.int64,
                       count=len(pos_lists))
    flat_docs = np.repeat(docs, lens[:len(docs)])
    flat_pos = (np.concatenate(pos_lists).astype(np.int64)
                if len(pos_lists) else np.zeros(0, np.int64))
    cache[key] = np.sort((flat_docs << _POS_BITS) | flat_pos)
    return cache[key]


def phrase_eval(seg: Segment, stats: ShardStats, field: str, terms: List[str],
                slop: int, boost: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side phrase matching over the segment's stored positions
    (Lucene's ExactPhraseMatcher / SloppyPhraseMatcher analog); the result
    enters the plan as a precomputed dense (scores, matches) pair.

    Exact phrases (slop 0) are vectorized: each term's (doc, position - i)
    pairs pack into sorted int64 keys and the phrase starts are an
    iterated sorted intersection. Sloppy matching walks the minimal
    windows of the (smaller) intersected doc set per candidate.
    """
    n = seg.num_docs
    scores = np.zeros(n, dtype=np.float32)
    matches = np.zeros(n, dtype=bool)
    flats = []
    for i, t in enumerate(terms):
        flat = _flat_positions(seg, field, t)
        if flat is None:
            return scores, matches
        flats.append(flat)

    sum_idf = sum(stats.idf(field, t) for t in set(terms))
    dc, ttf = stats.field_stats(field)
    avgdl = (ttf / dc) if dc else 1.0
    norms = seg.norms.get(field)

    def score_docs(doc_ords: np.ndarray, freqs: np.ndarray):
        if norms is not None:
            dl = LENGTH_TABLE[norms[doc_ords]].astype(np.float64)
            b_eff = DEFAULT_B
        else:
            dl = np.ones(len(doc_ords))
            b_eff = 0.0
        denom = freqs + DEFAULT_K1 * (1 - b_eff + b_eff * dl / avgdl)
        scores[doc_ords] = (boost * sum_idf * freqs * (DEFAULT_K1 + 1)
                            / denom).astype(np.float32)
        matches[doc_ords] = True

    pos_mask = (1 << _POS_BITS) - 1
    if slop == 0:
        inter = None
        for i, keys in enumerate(flats):
            if i:
                # phrase start for term i is position − i; positions < i
                # can't start a phrase. Both ops preserve sortedness.
                keys = keys[(keys & pos_mask) >= i] - i
            inter = keys if inter is None else _sorted_intersect(inter,
                                                                 keys)
            if len(inter) == 0:
                return scores, matches
        doc_ords, freqs = np.unique(inter >> _POS_BITS, return_counts=True)
        score_docs(doc_ords.astype(np.int64), freqs.astype(np.float64))
        return scores, matches

    # sloppy: intersect candidate DOCS vectorized, then per-candidate
    # minimal-window matching (Lucene SloppyPhraseMatcher approximation)
    cand = None
    for keys in flats:
        d = np.unique(keys >> _POS_BITS)
        cand = d if cand is None else _sorted_intersect(cand, d)
        if len(cand) == 0:
            return scores, matches
    per_term = [seg._positions_for(field, t) for t in terms]
    doc_list, freq_list = [], []
    for doc in cand.tolist():
        freq = _phrase_freq([per_term[i][doc] for i in range(len(terms))],
                            slop)
        if freq > 0:
            doc_list.append(doc)
            freq_list.append(freq)
    if doc_list:
        score_docs(np.asarray(doc_list, np.int64),
                   np.asarray(freq_list, np.float64))
    return scores, matches


def _phrase_freq(pos_lists: List[np.ndarray], slop: int) -> float:
    if slop == 0:
        # exact: count start positions p where term i appears at p + i
        base = set(int(p) for p in pos_lists[0])
        for i, plist in enumerate(pos_lists[1:], 1):
            base &= set(int(p) - i for p in plist)
        return float(len(base))
    # sloppy approximation: minimal windows containing all terms in order
    # within slop extra positions, weighted 1/(1+distance) like sloppyFreq
    freq = 0.0
    starts = [int(p) for p in pos_lists[0]]
    for s in starts:
        pos = s
        total_disp = 0
        ok = True
        for i, plist in enumerate(pos_lists[1:], 1):
            target = s + i
            later = plist[plist >= pos + 1] if len(plist) else plist
            if len(later) == 0:
                ok = False
                break
            nxt = int(later[0])
            total_disp += abs(nxt - target)
            pos = nxt
        if ok and total_disp <= slop:
            freq += 1.0 / (1.0 + total_disp)
    return freq


def _parse_query_string(query: str, default_field: str, fields: List[str],
                        default_operator: str, mapper: MapperService,
                        simple: bool = False) -> dsl.QueryNode:
    """Minimal Lucene-syntax parser: terms, "phrases", field:term,
    field:[a TO b] ranges, +required, -excluded, AND / OR / NOT
    (QueryStringQueryBuilder's syntax)."""
    # bracket ranges (field:[a TO b] / field:{a TO b}) span whitespace and
    # must tokenize as one unit
    tokens = re.findall(
        r'"[^"]*"|[+\-]?[\w.*]+:[\[{][^\]}]*[\]}]|\S+', query or "")
    must: List[dsl.QueryNode] = []
    should: List[dsl.QueryNode] = []
    must_not: List[dsl.QueryNode] = []
    conj = default_operator
    pending_and = False
    pending_not = False

    def target_fields() -> List[str]:
        if fields:
            return list(fields)
        if default_field and default_field != "*":
            return [default_field]
        return [name for name, ft in mapper.field_types.items() if ft.is_text]

    def leaf(text: str) -> dsl.QueryNode:
        phrase = text.startswith('"') and text.endswith('"') and len(text) >= 2
        body = text[1:-1] if phrase else text
        fnames = target_fields()
        subs: List[dsl.QueryNode] = []
        for f in fnames:
            if phrase:
                subs.append(dsl.MatchPhraseQuery(field=f, query=body))
            else:
                subs.append(dsl.MatchQuery(field=f, query=body))
        if len(subs) == 1:
            return subs[0]
        return dsl.DisMaxQuery(queries=subs)

    for raw in tokens:
        upper = raw.upper()
        if not simple and upper in ("AND", "&&"):
            pending_and = True
            continue
        if not simple and upper in ("OR", "||"):
            pending_and = False
            continue
        if not simple and upper == "NOT":
            pending_not = True
            continue
        neg = pending_not
        req = False
        text = raw
        if text.startswith("-"):
            neg, text = True, text[1:]
        elif text.startswith("+"):
            req, text = True, text[1:]
        if ":" in text and not text.startswith('"'):
            fname, _, rest = text.partition(":")
            range_m = re.fullmatch(
                r'([\[{])\s*(\S+)\s+TO\s+(\S+)\s*([\]}])', rest,
                flags=re.IGNORECASE)
            if range_m:
                lb, lo, hi, rb = range_m.groups()
                kwargs = {}
                if lo != "*":
                    kwargs["gte" if lb == "[" else "gt"] = lo
                if hi != "*":
                    kwargs["lte" if rb == "]" else "lt"] = hi
                node = dsl.RangeQuery(field=fname, **kwargs)
            elif rest.startswith('"'):
                node = dsl.MatchPhraseQuery(field=fname, query=rest[1:-1])
            else:
                node = dsl.MatchQuery(field=fname, query=rest)
        else:
            node = leaf(text)
        if neg:
            must_not.append(node)
        elif req or pending_and or default_operator == "and":
            must.append(node)
        else:
            should.append(node)
        pending_not = False
        pending_and = False
    if not must and not should and not must_not:
        return dsl.MatchAllQuery()
    return dsl.BoolQuery(must=must, should=should, must_not=must_not)
