"""Shared parity helpers for the tests that hold opensearch_tpu_torch against
opensearch_tpu (no tests here): the seeded corpora, the request bodies, and
the response comparison that ignores `took`.

Comparison contract for hits: doc ids, order, totals and `_source` exactly;
`_score` and `max_score` to rtol 1e-6 (the port computes every score with
the reference's operation order, so in practice they agree exactly).

Contract for aggregation outputs:
- exact: bucket keys, `key_as_string`, `doc_count`, bucket order,
  `sum_other_doc_count`, `doc_count_error_upper_bound`, `value_count`,
  `cardinality`, `min` / `max` (an f32 min or max does not depend on the
  order it is taken in) and `hits.total`;
- float sums (`sum`, `avg`, `stats.sum` / `stats.avg`) are f32 sums in the
  reference. Over a bin of n values v, any summation order lies within
  n * 2^-24 * sum|v| of the exact sum (`f32_sum_bound`); the port's value
  must lie within that bound of an f64 host sum of the same values. Where
  two f32 sums are compared with each other, each is within the bound of
  the exact sum, so they are within twice the bound of each other;
- in the test corpora every summed value is an integer and every partial
  sum stays below 2^24, so f32 sums are exact in any order: the tests
  demand equality with the reference (`assert_same_response` is exact
  unless it is handed per-path bounds).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

import torch

from opensearch_tpu_torch.utils.demo import query_terms, synth_docs

# the suite runs these files beside other test workers: one intra-op thread
# per worker keeps the port's small CPU tensors from oversubscribing cores
torch.set_num_threads(1)

SCORE_RTOL = 1e-6
VOCAB = 2000
N_DOCS = 1600

MAPPING = {"mappings": {"properties": {
    "passage": {"type": "text"},
    "pid": {"type": "keyword"},
    "tag": {"type": "keyword"},
}}}


def corpus(n_docs: int = N_DOCS, seed: int = 42) -> List[dict]:
    """Passages from the synthetic msmarco-shaped generator, as
    (passage text, pid keyword, tag keyword) documents."""
    return [{"passage": d["body"], "pid": f"p{i % 97}", "tag": d["tag"]}
            for i, d in enumerate(synth_docs(n_docs, VOCAB, 60, seed))]


def bulk_ndjson(index: str, docs: Dict[str, dict], deletes=()) -> str:
    lines = []
    for doc_id, src in docs.items():
        lines.append(json.dumps({"index": {"_index": index, "_id": doc_id}}))
        lines.append(json.dumps(src))
    for doc_id in deletes:
        lines.append(json.dumps({"delete": {"_index": index, "_id": doc_id}}))
    return "\n".join(lines) + "\n"


def load_index(node, index: str = "passages", n_docs: int = N_DOCS) -> None:
    """Two refreshes (two segments) with re-indexed docs and deletes in
    between, through the REST surface of either package."""
    docs = corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", f"/{index}", MAPPING)["_status"] == 200
    first = {f"d{i}": docs[i] for i in range(half)}
    res = node.request("POST", "/_bulk", bulk_ndjson(index, first))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")
    second = {f"d{i}": docs[i] for i in range(half, n_docs)}
    # a few first-segment docs are re-indexed with another doc's text
    second.update({f"d{i}": docs[i + 1] for i in range(3, half, 151)})
    deletes = [f"d{i}" for i in range(5, n_docs, 173)]
    res = node.request("POST", "/_bulk",
                       bulk_ndjson(index, second, deletes))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


def _terms(n: int, seed: int) -> str:
    return query_terms(1, VOCAB, seed=seed, terms_per_query=n)[0]


# name -> _search body; "dense" bodies must take the dense kernel class
SEARCH_BODIES: Dict[str, dict] = {
    "match_or": {"query": {"match": {"passage": _terms(2, 1)}}},
    "match_and": {"query": {"match": {"passage": {
        "query": "w00001 w00002", "operator": "and"}}}},
    "match_msm": {"query": {"match": {"passage": {
        "query": _terms(4, 3), "minimum_should_match": "50%"}}}},
    "match_boost_size": {"query": {"match": {"passage": {
        "query": _terms(3, 4), "boost": 2.5}}}, "size": 25},
    "term_keyword": {"query": {"term": {"tag": "cat3"}}, "size": 12},
    "terms_keyword": {"query": {"terms": {"tag": ["cat1", "cat5", "nope"]}},
                      "size": 30},
    "term_text": {"query": {"term": {"passage": "w00007"}}},
    "bool": {"query": {"bool": {
        "must": [{"match": {"passage": _terms(2, 5)}}],
        "filter": [{"terms": {"tag": ["cat2", "cat4", "cat6", "cat8"]}}],
        "should": [{"term": {"pid": "p3"}}, {"match": {"passage": "w00011"}}],
        "must_not": [{"term": {"tag": "cat4"}}]}}, "size": 20},
    "bool_should_msm": {"query": {"bool": {
        "should": [{"match": {"passage": "w00003"}},
                   {"match": {"passage": "w00009"}},
                   {"term": {"tag": "cat7"}}],
        "minimum_should_match": 2, "boost": 0.5}}},
    "match_all": {"query": {"match_all": {}}, "size": 15},
    "match_all_boost": {"query": {"match_all": {"boost": 3.0}}, "from": 1590,
                        "size": 20},
    "from_size": {"query": {"match": {"passage": _terms(2, 6)}},
                  "from": 5, "size": 7},
    "min_score": {"query": {"match": {"passage": _terms(3, 7)}},
                  "min_score": 3.0},
    "source_filter": {"query": {"match": {"passage": _terms(2, 8)}},
                      "_source": ["pid", "tag"]},
    "size_zero": {"query": {"match": {"passage": _terms(2, 9)}}, "size": 0},
    "no_such_term": {"query": {"match": {"passage": "zzzz"}}},
    "match_none": {"query": {"match_none": {}}},
    "dense_many_terms": {"query": {"match": {"passage": _terms(20, 10)}},
                         "size": 30},
}
DENSE_BODIES = ("dense_many_terms", "bool", "match_all")
CANDIDATE_BODIES = ("match_or", "term_keyword", "terms_keyword")

ERROR_BODIES: Dict[str, dict] = {
    "unknown_query": {"query": {"fuzzy_thing": {"passage": "x"}}},
    "negative_size": {"query": {"match_all": {}}, "size": -1},
    "window": {"query": {"match_all": {}}, "from": 9995, "size": 10},
}


def msearch_bodies(b: int = 32) -> List[dict]:
    """B bodies of mixed shapes: 1-4-term matches (candidate class) and
    some >16-term and bool bodies (dense class)."""
    out = []
    for i in range(b):
        if i % 8 == 7:
            out.append({"query": {"match": {"passage": _terms(18, 100 + i)}},
                        "size": 5})
        elif i % 8 == 3:
            out.append({"query": {"bool": {
                "must": [{"match": {"passage": _terms(2, 100 + i)}}],
                "must_not": [{"term": {"tag": "cat0"}}]}}})
        else:
            out.append({"query": {"match": {
                "passage": _terms(1 + i % 4, 100 + i)}},
                "size": 3 + i % 5})
    return out


def msearch_ndjson(index: str, bodies: List[dict]) -> str:
    lines = []
    for body in bodies:
        lines.append(json.dumps({"index": index}))
        lines.append(json.dumps(body))
    return "\n".join(lines) + "\n"


F32_SUM_EPS = 2.0 ** -24


def f32_sum_bound(n: int, abs_sum: float) -> float:
    """How far an f32 sum of n values, taken in any order, may lie from
    the exact sum: n * 2^-24 * sum|v|."""
    return n * F32_SUM_EPS * abs_sum


def assert_same_response(got: Any, want: Any, path: str = "",
                         agg_sum_tol: Optional[Dict[str, float]] = None
                         ) -> None:
    """Structural equality, `took` ignored, scores to SCORE_RTOL.
    agg_sum_tol maps the path of an aggregation's f32 sum or average (as
    this function spells paths, e.g. ".aggregations.t.buckets[0].a.value")
    to its absolute bound; every other value compares exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict), f"{path}: {got!r} is not a dict"
        keys = set(want) - {"took"}
        assert set(got) - {"took"} == keys, \
            f"{path}: keys {sorted(set(got))} != {sorted(set(want))}"
        for key in keys:
            assert_same_response(got[key], want[key], f"{path}.{key}",
                                 agg_sum_tol)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            f"{path}: {got!r} != {want!r}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_response(g, w, f"{path}[{i}]", agg_sum_tol)
        return
    if isinstance(want, float) and path.endswith(("_score", "max_score")):
        assert isinstance(got, float), f"{path}: {got!r} != {want!r}"
        assert math.isclose(got, want, rel_tol=SCORE_RTOL, abs_tol=0.0), \
            f"{path}: {got!r} != {want!r}"
        return
    if agg_sum_tol is not None and path in agg_sum_tol:
        assert isinstance(got, float) and isinstance(want, float), \
            f"{path}: {got!r} != {want!r}"
        assert abs(got - want) <= agg_sum_tol[path], \
            f"{path}: {got!r} and {want!r} differ by more than " \
            f"{agg_sum_tol[path]}"
        return
    assert got == want and type(got) is type(want), \
        f"{path}: {got!r} != {want!r}"


# ------------------------------------------------ the structured corpus

# the reference's DEMO_MAPPING: a text body and structured tag/views/ts
DOCS_MAPPING = {"mappings": {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "views": {"type": "integer"},
    "ts": {"type": "date"},
}}}
DOCS_N = 5000


def docs_corpus(n_docs: int = DOCS_N, seed: int = 42) -> List[dict]:
    """The demo corpus (synth_docs) with a few multi-valued `tag`s and a
    few docs without `views`, so the keyword and integer columns leave the
    identity layout."""
    docs = synth_docs(n_docs, VOCAB, 60, seed)
    for i in range(7, n_docs, 97):
        docs[i]["tag"] = [docs[i]["tag"], f"cat{(i // 97) % 16}",
                          "multi"]
    for i in range(11, n_docs, 89):
        del docs[i]["views"]
    return docs


def load_docs_index(node, index: str = "docs", n_docs: int = DOCS_N) -> None:
    """The structured corpus over two refreshes (two segments) with
    re-indexed docs and deletes in between, through either package's REST
    surface."""
    docs = docs_corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", f"/{index}", DOCS_MAPPING)["_status"] == 200
    first = {f"d{i}": docs[i] for i in range(half)}
    res = node.request("POST", "/_bulk", bulk_ndjson(index, first))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")
    second = {f"d{i}": docs[i] for i in range(half, n_docs)}
    second.update({f"d{i}": docs[i + 1] for i in range(3, half, 151)})
    deletes = [f"d{i}" for i in range(5, n_docs, 173)]
    res = node.request("POST", "/_bulk", bulk_ndjson(index, second, deletes))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


BASE_TS = 1700000000000
DAY_MS = 86400_000


def bench_agg_bodies(mode: str, n: int = 64) -> List[dict]:
    """bench.py's agg body families, from np.random.RandomState(13):
    `agg_terms` (a bool.filter range on views, then terms tag size 20 with
    an avg views sub-aggregation) and `date_hist` (a range on ts, then a
    1d date_histogram and a cardinality of tag)."""
    import numpy as np
    rng = np.random.RandomState(13)
    if mode == "agg_terms":
        bounds = rng.permutation(9000)[:n]
        return [{"size": 0,
                 "query": {"bool": {"filter": [
                     {"range": {"views": {"gte": int(b)}}}]}},
                 "aggs": {"by_tag": {"terms": {"field": "tag", "size": 20},
                                     "aggs": {"avg_v": {"avg": {
                                         "field": "views"}}}}}}
                for b in bounds]
    spans = 1 + 79 * rng.permutation(n) / max(n, 1)
    return [{"size": 0,
             "query": {"range": {"ts": {"lt": int(BASE_TS + s * DAY_MS)}}},
             "aggs": {"per_day": {"date_histogram": {
                 "field": "ts", "fixed_interval": "1d"}},
                 "uniq": {"cardinality": {"field": "tag"}}}}
            for s in spans]


# name -> _search body over the structured corpus; together they take
# every aggregation kind and every doc-value filter of the port
AGG_BODIES: Dict[str, dict] = {
    "bench_terms": bench_agg_bodies("agg_terms", 2)[0],
    "bench_date_hist": bench_agg_bodies("date_hist", 2)[1],
    "terms_metrics": {"size": 3, "query": {"match": {"body": "w00011"}},
                      "aggs": {"tags": {"terms": {"field": "tag",
                                                  "size": 5},
                                        "aggs": {
                          "st": {"stats": {"field": "views"}},
                          "mx": {"max": {"field": "ts"}},
                          "vc": {"value_count": {"field": "tag"}}}}}},
    "histogram_filter": {"size": 0,
                         "query": {"terms": {"tag": ["cat1", "cat2",
                                                     "multi"]}},
                         "aggs": {"h": {"histogram": {"field": "views",
                                                      "interval": 1000}},
                                  "f": {"filter": {"range": {"views": {
                                      "lt": 2000}}},
                                      "aggs": {"s": {"sum": {
                                          "field": "views"}}}},
                                  "mn": {"min": {"field": "views"}}}},
    "date_hist_sub": {"size": 0,
                      "query": {"range": {"ts": {
                          "gte": "2023-12-01||-1d/d",
                          "lt": "2024-01-01"}}},
                      "aggs": {"w": {"date_histogram": {
                          "field": "ts", "calendar_interval": "week"},
                          "aggs": {"u": {"cardinality": {
                              "field": "views"}},
                              "a": {"avg": {"field": "views"}}}}}},
    "missing_metric": {"size": 0, "query": {"exists": {"field": "views"}},
                       "aggs": {"m": {"avg": {"field": "views",
                                              "missing": 5}},
                                "t": {"terms": {"field": "views",
                                                "size": 3}},
                                "c": {"cardinality": {"field": "tag"}}}},
}


def agg_msearch_bodies(b: int = 32) -> List[dict]:
    """B agg bodies of mixed shapes for one _msearch: both bench families
    and the AGG_BODIES shapes."""
    fam = bench_agg_bodies("agg_terms", b) + bench_agg_bodies("date_hist", b)
    extra = list(AGG_BODIES.values())
    out = []
    for i in range(b):
        out.append(extra[i % len(extra)] if i % 4 == 3
                   else fam[(i * 7) % len(fam)])
    return out


def segment_arrays(seg) -> dict:
    """A sealed opensearch_tpu Segment as the plain numpy / Python dict
    that opensearch_tpu_torch.index.segment.segment_from_arrays takes."""
    return {
        "seg_id": seg.seg_id,
        "num_docs": seg.num_docs,
        "doc_ids": list(seg.doc_ids),
        "sources": list(seg.sources),
        "term_dict": {k: (tm.doc_freq, tm.total_term_freq, tm.start_block,
                          tm.num_blocks) for k, tm in seg.term_dict.items()},
        "post_docs": seg.post_docs,
        "post_tf": seg.post_tf,
        "norms": dict(seg.norms),
        "field_stats": {f: (st.doc_count, st.sum_total_term_freq,
                            st.sum_doc_freq)
                        for f, st in seg.field_stats.items()},
        "live": seg.live.copy(),
        "parent_ptr": seg.parent_ptr.copy(),
        "numeric_dv": {f: {"doc_ids": c.doc_ids, "values": c.values,
                           "exists": c.exists, "counts": c.counts,
                           "value_ords": c.value_ords, "unique": c.unique}
                       for f, c in seg.numeric_dv.items()},
        "ordinal_dv": {f: {"doc_ids": c.doc_ids, "ords": c.ords,
                           "exists": c.exists,
                           "dictionary": list(c.dictionary),
                           "ord_hashes": c.ord_hashes}
                       for f, c in seg.ordinal_dv.items()},
    }
