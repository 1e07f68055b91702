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
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensearch_tpu_torch.utils.demo import (TAXI_MAPPING, query_terms,
                                             synth_docs, taxi_docs)

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
                         agg_sum_tol: Optional[Dict[str, float]] = None,
                         score_rtol: float = SCORE_RTOL,
                         score_atol: float = 0.0,
                         score_sorts: Tuple[int, ...] = ()) -> None:
    """Structural equality, `took` ignored, scores (and the values of an
    `_explanation` tree) to `score_rtol` / `score_atol` (SCORE_RTOL and 0
    unless the caller states its own contract). `score_sorts`: the
    positions of `_score` in the request's sort, whose values in a hit's
    `sort` are scores too.
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
                                 agg_sum_tol, score_rtol, score_atol,
                                 score_sorts)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            f"{path}: {got!r} != {want!r}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_response(g, w, f"{path}[{i}]", agg_sum_tol,
                                 score_rtol, score_atol, score_sorts)
        return
    if isinstance(want, float) and (
            path.endswith(("_score", "max_score"))
            or ("._explanation" in path and path.endswith(".value"))
            or any(path.endswith(f".sort[{i}]") for i in score_sorts)):
        assert isinstance(got, float), f"{path}: {got!r} != {want!r}"
        assert math.isclose(got, want, rel_tol=score_rtol,
                            abs_tol=score_atol), \
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

SORT_N = 1500


def load_sorted_index(node, index: str = "sorted",
                      n_docs: int = SORT_N) -> None:
    """The structured corpus over three segments: load_docs_index's two,
    then 60 docs without `views` (a segment with no views column)."""
    load_docs_index(node, index, n_docs)
    extra = {}
    for i, d in enumerate(docs_corpus(60, seed=7)):
        d.pop("views", None)
        extra[f"x{i}"] = d
    res = node.request("POST", "/_bulk", bulk_ndjson(index, extra))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


# name -> field-sorted / general-path _search body over load_sorted_index
SORT_BODIES: Dict[str, dict] = {
    "views_asc": {"sort": [{"views": "asc"}], "size": 12},
    "views_desc": {"sort": [{"views": {"order": "desc"}}], "size": 12,
                   "query": {"match": {"body": "w00011 w00004"}}},
    "ts_asc": {"sort": [{"ts": "asc"}], "size": 9},
    "ts_desc": {"sort": [{"ts": "desc"}], "from": 4, "size": 9},
    "tag_asc": {"sort": [{"tag": "asc"}], "size": 15},
    "tag_desc": {"sort": [{"tag": "desc"}], "size": 15,
                 "query": {"range": {"views": {"lt": 3000}}}},
    "tag_ts": {"sort": [{"tag": "asc"}, {"ts": "desc"}], "size": 20},
    "score_then_views": {"query": {"match": {"body": "w00021"}},
                         "sort": ["_score", {"views": "asc"}], "size": 10},
    "doc_order": {"query": {"term": {"tag": "multi"}}, "sort": "_doc",
                  "size": 10},
    "absent_field": {"sort": [{"nope": "asc"}, {"views": "desc"}],
                     "size": 6},
    "missing_last": {"sort": [{"views": "asc"}], "from": 1490,
                     "size": 60},
    "min_score": {"query": {"match": {"body": "w00011"}},
                  "sort": [{"ts": "desc"}], "min_score": 1.0, "size": 8},
    "tth_false": {"sort": [{"views": "desc"}], "size": 3,
                  "track_total_hits": False},
    "tth_above": {"query": {"range": {"views": {"gte": 9000}}},
                  "sort": [{"views": "asc"}], "size": 3,
                  "track_total_hits": 100000},
    "tth_below": {"sort": [{"ts": "asc"}], "size": 3,
                  "track_total_hits": 50},
    "aggs": {"sort": [{"views": "desc"}], "size": 4,
             "aggs": {"t": {"terms": {"field": "tag", "size": 5}},
                      "m": {"max": {"field": "ts"}}}},
    "filter": {"query": {"bool": {"filter": [{"range": {"views": {
        "gte": 4000, "lt": 6000}}}]}}, "sort": [{"views": "desc"}],
        "size": 7},
    "dv_sorted": {"sort": [{"views": "desc"}], "size": 5,
                  "docvalue_fields": ["views", "ts", "tag"],
                  "version": True, "_source": ["tag"]},
}


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
        "path_ords": seg.path_ords.copy(),
        "nested_paths": list(seg.nested_paths),
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


# ------------------------------------------------------ the vector corpus

VECS_DIMS = 48
VECS_N = 5000
VECS_MAPPING = {"mappings": {"properties": {
    "v_l2": {"type": "knn_vector", "dimension": VECS_DIMS,
             "method": {"space_type": "l2"}},
    "v_cos": {"type": "knn_vector", "dimension": VECS_DIMS,
              "method": {"space_type": "cosinesimil"}},
    "v_ip": {"type": "dense_vector", "dims": VECS_DIMS,
             "space_type": "innerproduct"},
    "v_ivf": {"type": "knn_vector", "dimension": VECS_DIMS,
              "method": {"name": "hnsw", "space_type": "cosinesimil",
                         "parameters": {"nlist": 16, "nprobes": 4}}},
    "tag": {"type": "keyword"},
}}}


def vecs_corpus(n_docs: int = VECS_N):
    """Clustered vectors (64 centers) and 40 queries; every doc carries its
    vector in the four vector fields, except that every 50th has no
    `v_l2`."""
    from opensearch_tpu_torch.utils.demo import clustered_vectors
    vectors, queries = clustered_vectors(n_docs, VECS_DIMS, n_centers=64,
                                         seed=21, n_queries=40)
    docs = []
    for i, v in enumerate(vectors.tolist()):
        doc = {"v_cos": v, "v_ip": v, "v_ivf": v, "tag": f"t{i % 3}"}
        if i % 50:
            doc["v_l2"] = v
        docs.append(doc)
    return docs, queries


def load_vecs_index(node, index: str = "vecs", n_docs: int = VECS_N):
    """The vector corpus over two refreshes (two segments, each sealing an
    IVF index for `v_ivf`) with deletes in between."""
    docs, _q = vecs_corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", f"/{index}", VECS_MAPPING)["_status"] == 200
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"d{i}": docs[i] for i in range(half)}))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")
    deletes = [f"d{i}" for i in range(1, n_docs, 97)]
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"d{i}": docs[i] for i in range(half, n_docs)}, deletes))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


def knn_bodies() -> Dict[str, dict]:
    """name -> _search body over the vector corpus: exact in each space,
    IVF, a filtered and a boosted knn, and knn inside bool."""
    _docs, queries = vecs_corpus()
    q = [v.tolist() for v in queries]
    return {
        "exact_l2": {"query": {"knn": {"v_l2": {"vector": q[0], "k": 10}}},
                     "size": 10},
        "exact_cos": {"query": {"knn": {"v_cos": {"vector": q[1],
                                                  "k": 5}}}, "size": 8},
        "exact_ip": {"query": {"knn": {"v_ip": {"vector": q[2], "k": 12,
                                                "boost": 0.5}}}},
        "ivf": {"query": {"knn": {"v_ivf": {"vector": q[3], "k": 10}}},
                "size": 10},
        "ivf_nprobes": {"query": {"knn": {"v_ivf": {
            "vector": q[4], "k": 7,
            "method_parameters": {"nprobes": 9}}}}},
        "filtered": {"query": {"knn": {"v_l2": {
            "vector": q[5], "k": 6, "filter": {"term": {"tag": "t1"}}}}},
            "size": 20},
        "bool_knn": {"query": {"bool": {
            "must": [{"knn": {"v_cos": {"vector": q[6], "k": 20}}}],
            "filter": [{"term": {"tag": "t2"}}],
            "should": [{"exists": {"field": "v_l2"}}]}}, "size": 15},
    }


def knn_msearch_bodies(b: int = 32) -> List[dict]:
    """B knn bodies of mixed shapes for one _msearch."""
    _docs, queries = vecs_corpus()
    fields = ("v_l2", "v_cos", "v_ip", "v_ivf")
    out = []
    for i in range(b):
        spec = {"vector": queries[i % len(queries)].tolist(),
                "k": 10 if i % 3 else 4}
        if i % 8 == 5:
            spec["filter"] = {"term": {"tag": "t0"}}
        body = {"query": {"knn": {fields[i % 4]: spec}}, "size": 10}
        if i % 8 == 7:
            body = {"query": {"bool": {"must": [{"knn": {"v_l2": spec}}],
                                       "must_not": [{"term": {
                                           "tag": "t1"}}]}}}
        out.append(body)
    return out


# ------------------------------------- late interaction and hybrid corpora

MX_DIMS = 64
MX_N = 1000
MX_MAPPING = {"mappings": {"properties": {
    "tok": {"type": "rank_vectors", "dimension": MX_DIMS, "max_tokens": 16},
    "tokpq": {"type": "rank_vectors", "dimension": MX_DIMS,
              "max_tokens": 16, "compression": "pq", "pq_m": 8},
    "tag": {"type": "keyword"},
}}}


def mx_corpus(n_docs: int = MX_N):
    """ColBERT-shaped token matrices of 1..12 unit tokens (every 40th doc
    without the field) and 40 queries of 16 tokens, in both fields."""
    from opensearch_tpu_torch.utils.demo import clustered_tokens
    tokens, count, queries = clustered_tokens(
        n_docs, MX_DIMS, 1, 12, n_centers=64, seed=31, n_queries=40,
        query_tokens=16)
    docs = []
    for i in range(n_docs):
        doc = {"tag": f"t{i % 3}"}
        if i % 40:
            toks = tokens[i, :count[i]].tolist()
            doc["tok"] = toks
            doc["tokpq"] = toks
        docs.append(doc)
    return docs, queries


def load_mx_index(node, index: str = "mx", n_docs: int = MX_N):
    """The token corpus over two refreshes (two segments, each sealing
    its own PQ codebook) with deletes in between."""
    docs, _q = mx_corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", f"/{index}", MX_MAPPING)["_status"] == 200
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"d{i}": docs[i] for i in range(half)}))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")
    deletes = [f"d{i}" for i in range(1, n_docs, 97)]
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"d{i}": docs[i] for i in range(half, n_docs)}, deletes))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


def maxsim_bodies() -> Dict[str, dict]:
    """name -> _search body over the token corpus: exact and pq, query
    token counts 4..16, filtered, boosted, in bool, and exists."""
    _docs, queries = mx_corpus()
    q = [v.tolist() for v in queries]
    return {
        "maxsim_exact": {"query": {"maxsim": {"tok": {
            "query_vectors": q[0], "k": 10}}}, "size": 10},
        "maxsim_exact_4": {"query": {"maxsim": {"tok": {
            "query_vectors": q[1][:4], "k": 20}}}, "size": 15},
        "maxsim_pq": {"query": {"maxsim": {"tokpq": {
            "query_vectors": q[2], "k": 10}}}},
        "maxsim_pq_filtered": {"query": {"maxsim": {"tokpq": {
            "query_vectors": q[3][:9], "k": 8, "boost": 1.5,
            "filter": {"term": {"tag": "t1"}}}}}, "size": 20},
        "maxsim_bool": {"query": {"bool": {
            "must": [{"maxsim": {"tok": {"query_vectors": q[4][:16],
                                         "k": 25}}}],
            "filter": [{"term": {"tag": "t2"}}],
            "should": [{"exists": {"field": "tokpq"}}]}}, "size": 12},
    }


def maxsim_msearch_bodies(b: int = 32) -> List[dict]:
    """B maxsim bodies of mixed shapes for one _msearch."""
    _docs, queries = mx_corpus()
    out = []
    for i in range(b):
        spec = {"query_vectors": queries[i % len(queries)][
            :(4, 8, 16)[i % 3]].tolist(), "k": 10}
        if i % 8 == 5:
            spec["filter"] = {"term": {"tag": "t0"}}
        out.append({"query": {"maxsim": {("tok", "tokpq")[i % 2]: spec}},
                    "size": 10})
    return out


HYB_DIMS = 32
HYB_N = 3000
HYB_MAPPING = {"mappings": {"properties": {
    "passage": {"type": "text"},
    "tag": {"type": "keyword"},
    "emb": {"type": "knn_vector", "dimension": HYB_DIMS,
            "method": {"space_type": "l2"}},
}}}
# the normalization-processor example of OpenSearch's documentation
HYB_PIPELINE = {"description": "min_max + arithmetic_mean",
                "phase_results_processors": [{"normalization-processor": {
                    "normalization": {"technique": "min_max"},
                    "combination": {"technique": "arithmetic_mean",
                                    "parameters": {
                                        "weights": [0.3, 0.7]}}}}]}


def hyb_corpus(n_docs: int = HYB_N):
    """Passages with a clustered 32-d embedding each, and 40 (text,
    vector) queries."""
    from opensearch_tpu_torch.utils.demo import clustered_vectors
    vectors, qvecs = clustered_vectors(n_docs, HYB_DIMS, n_centers=64,
                                       seed=23, n_queries=40)
    docs = [{"passage": p["passage"], "tag": p["tag"], "emb": v}
            for p, v in zip(corpus(n_docs), vectors.tolist())]
    texts = [_terms(2 + i % 3, 400 + i) for i in range(40)]
    return docs, list(zip(texts, qvecs.tolist()))


def load_hyb_index(node, index: str = "hyb", n_docs: int = HYB_N):
    """The hybrid corpus over two refreshes with deletes, and the
    normalization pipeline `hyb_norm`."""
    docs, _q = hyb_corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", "/_search/pipeline/hyb_norm",
                        HYB_PIPELINE)["_status"] == 200
    assert node.request("PUT", f"/{index}", HYB_MAPPING)["_status"] == 200
    for part, deletes in ((range(half), ()), (range(half, n_docs),
                                              [f"d{i}" for i in
                                               range(2, n_docs, 89)])):
        res = node.request("POST", "/_bulk", bulk_ndjson(
            index, {f"d{i}": docs[i] for i in part}, deletes))
        assert res["_status"] == 200 and not res["errors"]
        node.request("POST", f"/{index}/_refresh")


def hybrid_body(text: str, vector, k: int = 20, size: int = 10,
                **extra) -> dict:
    return {"query": {"hybrid": {"queries": [
        {"match": {"passage": text}},
        {"knn": {"emb": {"vector": vector, "k": k}}}]}}, "size": size,
        **extra}


def hybrid_bodies() -> Dict[str, dict]:
    _docs, queries = hyb_corpus()
    return {f"hybrid_{i}": hybrid_body(t, v, k=10 + 5 * (i % 3),
                                       size=10 - i % 4)
            for i, (t, v) in enumerate(queries[:6])}


def hybrid_msearch_bodies(b: int = 32) -> List[dict]:
    _docs, queries = hyb_corpus()
    return [hybrid_body(*queries[i % len(queries)], k=10 + (i % 2) * 10)
            for i in range(b)]


BIG_DIMS = 8
BIG_N = 24000


def load_big_index(node, index: str = "big", n_docs: int = BIG_N):
    """24,000 8-d vectors in one segment: a knn with k past 16,384 needs
    more docs than that."""
    vectors = np.random.RandomState(7).randn(n_docs, BIG_DIMS).astype(
        np.float32)
    assert node.request("PUT", f"/{index}", {"mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": BIG_DIMS}}}})["_status"] \
        == 200
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"d{i}": {"v": v.tolist()} for i, v in enumerate(vectors)}))
    assert res["_status"] == 200 and not res["errors"]
    node.request("POST", f"/{index}/_refresh")


def big_knn_body() -> dict:
    q = np.random.RandomState(8).randn(BIG_DIMS).astype(np.float32)
    return {"query": {"knn": {"v": {"vector": q.tolist(), "k": 20000}}},
            "size": 25}


# ------------------------------------------ the remaining agg kinds

# utils/demo.taxi_docs (tag / views / ts plus a float `fare` in cents that
# ~2% of docs lack and an integer `passengers`) with a short text `body`
TAXI_N = 3000
TAXI_WORDS = [f"w{i}" for i in range(40)]
TAXI_INDEX_MAPPING = {"mappings": {"properties": {
    **TAXI_MAPPING["properties"], "body": {"type": "text"}}}}


def taxi_corpus(n_docs: int = TAXI_N):
    docs = taxi_docs(n_docs, seed=11)
    rng = np.random.default_rng(3)
    for d in docs:
        d["body"] = " ".join(rng.choice(TAXI_WORDS, 6))
    return docs


def load_taxi_index(node, index: str = "taxi", n_docs: int = TAXI_N):
    """Three refreshes (three segments); the later ones re-index docs of
    the first and delete some of every segment."""
    docs = taxi_corpus(n_docs)
    assert node.request("PUT", f"/{index}", TAXI_INDEX_MAPPING)["_status"] == 200
    cuts = [0, n_docs // 3, 2 * n_docs // 3, n_docs]
    for s in range(3):
        batch = {f"d{i}": docs[i] for i in range(cuts[s], cuts[s + 1])}
        deletes = []
        if s:
            batch.update({f"d{i}": docs[(i * 7) % n_docs]
                          for i in range(s, cuts[s], 131)})
            deletes = [f"d{i}" for i in range(s + 4, cuts[s], 97)]
        res = node.request("POST", "/_bulk",
                           bulk_ndjson(index, batch, deletes))
        assert res["_status"] == 200 and not res["errors"]
        node.request("POST", f"/{index}/_refresh")


# the slice's kinds, each a (name, agg body) that goes at the root, under
# `terms` and under `date_histogram`
AGG_KINDS = {
    "range": {"range": {"field": "fare", "ranges": [
        {"to": 500}, {"from": 500, "to": 1500}, {"from": 1200, "to": 3000},
        {"from": 3000}, {"key": "cheap", "to": 800}]}},
    "range_sub": {"range": {"field": "views", "ranges": [
        {"to": 5000}, {"from": 5000}]},
        "aggs": {"p": {"max": {"field": "passengers"}}}},
    "date_range": {"date_range": {"field": "ts", "ranges": [
        {"to": BASE_TS + 20 * DAY_MS},
        {"from": "2023-12-15", "to": "2024-01-10"},
        {"from": BASE_TS + 60 * DAY_MS}]}},
    "filters_keyed": {"filters": {"filters": {
        "w1": {"match": {"body": "w1"}},
        "big": {"range": {"fare": {"gte": 2000}}}}},
        "aggs": {"s": {"sum": {"field": "passengers"}}}},
    "filters_anon": {"filters": {"filters": [
        {"term": {"tag": "cat3"}}, {"match": {"body": "w7 w8"}}]}},
    "global": {"global": {}, "aggs": {
        "c": {"value_count": {"field": "fare"}}}},
    "missing": {"missing": {"field": "fare"},
                "aggs": {"v": {"max": {"field": "views"}}}},
    "missing_unmapped": {"missing": {"field": "ghost"}},
    "percentiles": {"percentiles": {"field": "fare"}},
    "percentiles_some": {"percentiles": {"field": "views",
                                         "percents": [10, 50, 99.9]}},
    "percentile_ranks": {"percentile_ranks": {"field": "fare",
                                              "values": [500, 1000, 4000]}},
    "mad": {"median_absolute_deviation": {"field": "passengers"}},
    "weighted_avg": {"weighted_avg": {"value": {"field": "fare"},
                                      "weight": {"field": "passengers"}}},
    "composite": {"composite": {"size": 7, "sources": [
        {"t": {"terms": {"field": "tag"}}},
        {"p": {"terms": {"field": "passengers"}}}]}},
    "composite_after": {"composite": {
        "size": 5, "after": {"t": "cat12", "d": BASE_TS + 30 * DAY_MS},
        "sources": [{"t": {"terms": {"field": "tag"}}},
                    {"d": {"date_histogram": {"field": "ts",
                                              "fixed_interval": "1d"}}}]},
        "aggs": {"f": {"avg": {"field": "fare"}}}},
    "multi_terms": {"multi_terms": {"terms": [{"field": "tag"},
                                              {"field": "passengers"}],
                                    "size": 6}},
    "auto_date_histogram": {"auto_date_histogram": {"field": "ts",
                                                    "buckets": 20}},
    "significant_terms": {"significant_terms": {"field": "tag",
                                                "min_doc_count": 1}},
    "adjacency_matrix": {"adjacency_matrix": {"filters": {
        "a": {"term": {"passengers": 1}}, "b": {"match": {"body": "w2"}},
        "c": {"range": {"fare": {"lt": 700}}},
        "d": {"term": {"tag": "cat5"}}}}},
    "matrix_stats": {"matrix_stats": {"fields": ["fare", "views",
                                                 "passengers"]}},
}

AGG_PLACES = ("root", "terms", "date_histogram")


def kind_body(kind: str, place: str) -> dict:
    agg = json.loads(json.dumps(AGG_KINDS[kind]))
    if place == "root":
        aggs = {"k": agg}
    elif place == "terms":
        aggs = {"t": {"terms": {"field": "tag", "size": 4},
                      "aggs": {"k": agg}}}
    else:
        aggs = {"h": {"date_histogram": {"field": "ts",
                                         "fixed_interval": "30d"},
                      "aggs": {"k": agg}}}
    return {"size": 0, "query": {"range": {"views": {"gte": 300}}},
            "aggs": aggs}


# one body per pipeline type
PIPELINE_BODIES = {
    "derivative": {"h": {"date_histogram": {"field": "ts",
                                            "fixed_interval": "7d"},
                         "aggs": {"s": {"sum": {"field": "fare"}},
                                  "d": {"derivative": {
                                      "buckets_path": "s"}}}}},
    "cumulative_sum": {"h": {"histogram": {"field": "views",
                                           "interval": 1000},
                             "aggs": {"c": {"cumulative_sum": {
                                 "buckets_path": "_count"}}}}},
    "bucket_script": {"t": {"terms": {"field": "tag", "size": 5},
                            "aggs": {"f": {"sum": {"field": "fare"}},
                                     "p": {"sum": {"field": "passengers"}},
                                     "r": {"bucket_script": {
                                         "buckets_path": {"f": "f",
                                                          "p": "p"},
                                         "script": "params.f / params.p"}}}}},
    "bucket_selector": {"t": {"terms": {"field": "tag", "size": 16},
                              "aggs": {"v": {"avg": {"field": "views"}},
                                       "keep": {"bucket_selector": {
                                           "buckets_path": {"v": "v"},
                                           "script": "params.v > 5000"}}}}},
    "bucket_sort": {"t": {"terms": {"field": "tag", "size": 16},
                          "aggs": {"f": {"max": {"field": "fare"}},
                                   "o": {"bucket_sort": {
                                       "sort": [{"f": {"order": "desc"}}],
                                       "size": 3, "from": 1}}}}},
    "serial_diff": {"h": {"date_histogram": {"field": "ts",
                                             "fixed_interval": "7d"},
                          "aggs": {"sd": {"serial_diff": {
                              "buckets_path": "_count", "lag": 2}}}}},
    "moving_avg": {"h": {"histogram": {"field": "views", "interval": 500},
                         "aggs": {"m": {"max": {"field": "passengers"}},
                                  "ma": {"moving_avg": {
                                      "buckets_path": "m", "window": 3}}}}},
    "moving_fn": {"h": {"histogram": {"field": "views", "interval": 500},
                        "aggs": {"mf": {"moving_fn": {
                            "buckets_path": "_count", "window": 4,
                            "script": "values_max - values_min"}}}}},
    "avg_bucket": {"t": {"terms": {"field": "tag", "size": 16}},
                   "ab": {"avg_bucket": {"buckets_path": "t>_count"}}},
    "max_bucket": {"h": {"date_histogram": {"field": "ts",
                                            "fixed_interval": "1d"},
                         "aggs": {"f": {"sum": {"field": "passengers"}}}},
                   "mb": {"max_bucket": {"buckets_path": "h>f"}}},
    "min_bucket": {"t": {"terms": {"field": "tag", "size": 16},
                         "aggs": {"f": {"min": {"field": "fare"}}}},
                   "mb": {"min_bucket": {"buckets_path": "t>f"}}},
    "sum_bucket": {"t": {"terms": {"field": "passengers"}},
                   "sb": {"sum_bucket": {"buckets_path": "t>_count"}}},
    "stats_bucket": {"t": {"terms": {"field": "tag", "size": 16},
                           "aggs": {"v": {"max": {"field": "views"}}}},
                     "sb": {"stats_bucket": {"buckets_path": "t>v"}}},
    "extended_stats_bucket": {
        "t": {"terms": {"field": "passengers"}},
        "sb": {"extended_stats_bucket": {"buckets_path": "t>_count"}}},
    "percentiles_bucket": {
        "t": {"terms": {"field": "tag", "size": 16}},
        "pb": {"percentiles_bucket": {"buckets_path": "t>_count",
                                      "percents": [25, 50, 90]}}},
}


def pipeline_body(name: str) -> dict:
    return {"size": 0, "query": {"match": {"body": "w3 w4 w5"}},
            "aggs": json.loads(json.dumps(PIPELINE_BODIES[name]))}


AGG_KIND_BODIES = {f"{k}@{p}": kind_body(k, p)
                   for k in AGG_KINDS for p in AGG_PLACES}
AGG_KIND_BODIES.update({f"pipeline_{n}": pipeline_body(n)
                        for n in PIPELINE_BODIES})
# 33 filters, past the 32 of one K17 launch (the card takes one launch per
# pair of filter blocks): overlapping views bands, passengers and fare.
# At the root only: the reference compiles one scatter-add per cell, 561
# here, which takes it a long while.
ADJACENCY_33 = {"adjacency_matrix": {"filters": dict(
    [(f"v{i:02d}", {"range": {"views": {"gte": 300 * i,
                                        "lt": 300 * i + 700}}})
     for i in range(30)]
    + [("p1", {"term": {"passengers": 1}}),
       ("p56", {"terms": {"passengers": [5, 6]}}),
       ("cheap", {"range": {"fare": {"lt": 700}}})])}}
AGG_KIND_BODIES["adjacency_matrix_33@root"] = {
    "size": 0, "query": {"range": {"views": {"gte": 300}}},
    "aggs": {"k": ADJACENCY_33}}


# matrix_stats sums powers up to v^4, which round: each f32 sum lies within
# n * 2^-24 * sum|term| of its exact value, below 9e-5 of sum|term| for
# bins of at most ~1,500 docs (1,500 * 2^-24 < 9e-5), so two packages' sums
# lie within MATRIX_SUM_REL of sum|term| of each other; each derived value
# holds to that error carried through its formula (matrix_stats_tol), times
# MATRIX_PROPAGATION for the errors of its denominator
MATRIX_SUM_REL = 2e-4
MATRIX_PROPAGATION = 4.0


def _matrix_entry_tol(e: dict, by_name: dict, path: str, out: dict,
                      sum_rel: float):
    """Bounds for one matrix_stats field entry. Its values derive from raw
    sums s_k = sum v^k (and sum xy) that each lie within `sum_rel` of
    their exact value (every column of the taxi corpus is >= 0, so |s_k|
    = sum |v|^k); a derived value moves by at most `sum_rel` times the
    magnitudes of the raw terms in its formula, over its denominator,
    times MATRIX_PROPAGATION for the denominator's own error."""
    n = e["count"]
    mu = abs(e["mean"])
    var = e["variance"] * (n - 1) / n if n > 1 else e["variance"]
    sd = math.sqrt(var) if var > 0 else 0.0
    m2 = var + mu * mu                                    # s2 / n
    m3 = e["skewness"] * sd ** 3 + 3 * mu * m2 - 2 * mu ** 3
    m4 = (e["kurtosis"] * var * var + 4 * mu * abs(m3) - 6 * mu * mu * m2
          + 3 * mu ** 4)
    eps = sum_rel * MATRIX_PROPAGATION

    def put(key, scale, denom):
        out[f"{path}.{key}"] = eps * scale / denom if denom > 0 else eps

    put("mean", mu, 1.0)
    put("variance", m2 + mu * mu, 1.0)
    put("skewness", abs(m3) + 3 * mu * m2 + 2 * mu ** 3, max(sd, 1e-300) ** 3)
    put("kurtosis", abs(m4) + 4 * mu * abs(m3) + 6 * mu * mu * m2
        + 3 * mu ** 4, max(var, 1e-300) ** 2)
    for other, cov in e["covariance"].items():
        o = by_name[other]
        mo = abs(o["mean"])
        vo = o["variance"] * (o["count"] - 1) / max(o["count"], 1)
        scale = abs(cov) + 2 * mu * mo
        put(f"covariance.{other}", scale, 1.0)
        put(f"correlation.{other}", scale + abs(e["correlation"][other])
            * (m2 + mu * mu + vo + 2 * mo * mo),
            math.sqrt(max(var * vo, 1e-300)))


def matrix_stats_tol(resp, path: str = "", out=None,
                     sum_rel: float = MATRIX_SUM_REL):
    """agg_sum_tol bounds for every float of each matrix_stats result in
    a response: each raw sum within `sum_rel` of sum|term| (MATRIX_SUM_REL
    for the test corpora), carried through _matrix_entry_tol."""
    out = {} if out is None else out
    if isinstance(resp, dict):
        if "fields" in resp and "doc_count" in resp \
                and isinstance(resp["fields"], list):
            by_name = {e["name"]: e for e in resp["fields"]}
            for i, e in enumerate(resp["fields"]):
                _matrix_entry_tol(e, by_name, f"{path}.fields[{i}]", out,
                                  sum_rel)
            return out
        for k, v in resp.items():
            matrix_stats_tol(v, f"{path}.{k}", out, sum_rel)
    elif isinstance(resp, list):
        for i, v in enumerate(resp):
            matrix_stats_tol(v, f"{path}[{i}]", out, sum_rel)
    return out


# ------------------------------------- the scoring and lexical query corpus

# a small word list with stems (running / runs / ran), phrases and
# accented forms, so that phrases, multi-term expansion, the english and a
# custom analyzer all find something
REL_WORDS = ("quick brown fox jumps jumped jumping over the lazy dog dogs "
             "running runs ran runner connection connected connecting "
             "search engine engines relevance tuning café naïve résumé "
             "alpha beta gamma delta and of a").split()
REL_N = 600
REL_MAPPING = {"mappings": {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "likes": {"type": "long"},
    "published": {"type": "date"},
    "price": {"type": "double"},
    "req": {"type": "integer"},
}}}
# a custom analyzer chain from settings.analysis, and another at search
# time
REL_CUSTOM_INDEX = {
    "settings": {"analysis": {
        "filter": {"short_stop": {"type": "stop",
                                  "stopwords": ["the", "a", "of"]}},
        "analyzer": {
            "folded": {"type": "custom", "tokenizer": "standard",
                       "filter": ["lowercase", "asciifolding",
                                  "short_stop", "porter_stem"]},
            "folded_search": {"tokenizer": "whitespace",
                              "filter": ["lowercase", "asciifolding",
                                         "porter_stem"]}}}},
    "mappings": {"properties": {
        "body": {"type": "text", "analyzer": "folded",
                 "search_analyzer": "folded_search"},
        "tag": {"type": "keyword"}}}}
REL_BASE = 1700000000000


def rel_corpus(n_docs: int = REL_N, seed: int = 11) -> List[dict]:
    """Documents of the scoring corpus from a numpy seed: body and title
    over REL_WORDS, tag, likes (lognormal, absent on every tenth doc),
    published (90 days of millis), price (absent on every third, some
    negative) and req (1-3)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        doc = {"body": " ".join(rng.choice(REL_WORDS, rng.integers(3, 14))),
               "title": " ".join(rng.choice(REL_WORDS, rng.integers(2, 6))),
               "tag": f"t{i % 7}",
               "published": int(REL_BASE + rng.integers(0, 90) * DAY_MS
                                + rng.integers(0, DAY_MS)),
               "req": int(rng.integers(1, 4))}
        if i % 10:
            doc["likes"] = int(rng.lognormal(3.0, 1.5))
        if i % 3:
            doc["price"] = round(float(rng.uniform(-5, 50)), 2)
        docs.append(doc)
    return docs


def load_rel_index(node, index: str = "rel", n_docs: int = REL_N,
                   body: Optional[dict] = None) -> None:
    """Two refreshes (two segments), re-indexed docs and deletes."""
    docs = rel_corpus(n_docs)
    half = n_docs // 2
    assert node.request("PUT", f"/{index}",
                        body or REL_MAPPING)["_status"] == 200
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, {f"r{i}": docs[i] for i in range(half)}))
    assert res["_status"] == 200 and not res["errors"], res
    node.request("POST", f"/{index}/_refresh")
    second = {f"r{i}": docs[i] for i in range(half, n_docs)}
    second.update({f"r{i}": docs[i + 1] for i in range(4, half, 97)})
    res = node.request("POST", "/_bulk", bulk_ndjson(
        index, second, [f"r{i}" for i in range(7, n_docs, 61)]))
    assert res["_status"] == 200 and not res["errors"], res
    node.request("POST", f"/{index}/_refresh")


def load_rel_custom_index(node, index: str = "relc") -> None:
    load_rel_index(node, index, 300, REL_CUSTOM_INDEX)


_DATE_DECAY = {"origin": "2023-12-01", "scale": "10d", "offset": "2d",
               "decay": 0.5}
# function_score's functions, one of each kind (and a filtered weight, a
# function on a field with no values, modifiers that give NaN / -inf)
REL_FUNCTIONS = {
    "weight": [{"filter": {"term": {"tag": "t2"}}, "weight": 3}],
    "fvf_log1p": [{"field_value_factor": {"field": "likes", "factor": 1.2,
                                          "modifier": "log1p",
                                          "missing": 1}}],
    "fvf_sqrt_weight": [{"field_value_factor": {
        "field": "likes", "modifier": "sqrt"}, "weight": 0.5}],
    "fvf_log_nan": [{"field_value_factor": {"field": "price",
                                            "modifier": "log"}}],
    "fvf_ln_missing": [{"field_value_factor": {
        "field": "price", "modifier": "ln", "missing": 0}}],
    "fvf_reciprocal": [{"field_value_factor": {
        "field": "price", "modifier": "reciprocal", "missing": 2}}],
    "random": [{"random_score": {"seed": 17}}],
    "script": [{"script_score": {"script": {
        "source": "params.a * _score + doc['req'].value",
        "params": {"a": 0.5}}}}],
    "gauss_date": [{"gauss": {"published": _DATE_DECAY}}],
    "exp_num": [{"exp": {"likes": {"origin": 30, "scale": 20}},
                 "weight": 2}],
    "linear_num": [{"linear": {"price": {"origin": 10, "scale": 15,
                                         "offset": 1, "decay": 0.3}}}],
    "mixed": [
        {"filter": {"range": {"likes": {"gte": 20}}}, "weight": 2},
        {"filter": {"match": {"body": "fox"}},
         "field_value_factor": {"field": "likes", "modifier": "ln2p",
                                "missing": 3}},
        {"random_score": {"seed": 5}},
        {"filter": {"term": {"tag": "t1"}},
         "exp": {"published": {"origin": "2023-12-20", "scale": "5d"}}},
        {"linear": {"price": {"origin": 0, "scale": 30}}, "weight": 1.5}],
}
SCORE_MODES = ("multiply", "sum", "avg", "max", "min", "first")
BOOST_MODES = ("multiply", "replace", "sum", "avg", "max", "min")


def function_score_body(functions, score_mode: str = "multiply",
                        boost_mode: str = "multiply", **extra) -> dict:
    fs = {"query": {"match": {"body": "quick fox running"}},
          "functions": functions, "score_mode": score_mode,
          "boost_mode": boost_mode}
    fs.update(extra)
    return {"query": {"function_score": fs}, "size": 15}


SCORING_BODIES: Dict[str, dict] = {
    **{f"fs_{name}": function_score_body(fns)
       for name, fns in REL_FUNCTIONS.items()},
    **{f"fs_mixed_{sm}_{bm}": function_score_body(
        REL_FUNCTIONS["mixed"], sm, bm)
       for sm, bm in zip(SCORE_MODES, BOOST_MODES)},
    **{f"fs_mixed_{sm}_{bm}": function_score_body(
        REL_FUNCTIONS["mixed"], sm, bm)
       for sm, bm in zip(SCORE_MODES, BOOST_MODES[3:] + BOOST_MODES[:3])},
    "fs_min_score_max_boost": function_score_body(
        REL_FUNCTIONS["mixed"], "sum", "sum", max_boost=4.0, min_score=6.0,
        boost=1.5),
    "fs_short_form": {"query": {"function_score": {
        "query": {"match": {"title": "running dogs"}},
        "field_value_factor": {"field": "likes", "modifier": "square",
                               "factor": 0.1}, "boost_mode": "replace"}}},
    "fs_no_functions": {"query": {"function_score": {
        "query": {"term": {"tag": "t4"}}, "functions": [],
        "boost": 2.0}}},
    "fs_decay_unmapped_segment": function_score_body(
        [{"gauss": {"req": {"origin": 2, "scale": 1}}}], "sum", "avg"),
    "script_score": {"query": {"script_score": {
        "query": {"match": {"body": "fox dog"}},
        "script": {"source": "_score * Math.log(2 + doc['likes'].value)"},
        "boost": 1.5}}},
    "script_score_params": {"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"source": "doc['likes'].empty ? params.d : "
                             "Math.sqrt(doc['likes'].value) * params.f "
                             "+ doc['likes'].size() % 2",
                   "params": {"f": 0.5, "d": 1.25, "label": "x"}}}},
        "size": 20},
    "boosting": {"query": {"boosting": {
        "positive": {"match": {"body": "fox running"}},
        "negative": {"term": {"body": "lazy"}}, "negative_boost": 0.25}}},
    "terms_set_param": {"query": {"terms_set": {"body": {
        "terms": ["fox", "dog", "quick"]}}}},
    "terms_set_field": {"query": {"terms_set": {"body": {
        "terms": ["fox", "dog", "quick", "lazy"],
        "minimum_should_match_field": "req", "boost": 2.0}}}},
    "distance_feature_num": {"query": {"distance_feature": {
        "field": "likes", "origin": 20, "pivot": 10}}},
    "distance_feature_date": {"query": {"bool": {
        "must": [{"match": {"body": "engine"}}],
        "should": [{"distance_feature": {
            "field": "published", "origin": "2023-12-10",
            "pivot": "7d", "boost": 3.0}}]}}},
    "constant_score": {"query": {"constant_score": {
        "filter": {"range": {"likes": {"gte": 10, "lt": 100}}},
        "boost": 2.5}}, "size": 12},
}

QUERY_KIND_BODIES: Dict[str, dict] = {
    "ids": {"query": {"ids": {"values": ["r1", "r350", "nope", "r7"]}}},
    "ids_boost_bool": {"query": {"bool": {
        "should": [{"ids": {"values": ["r3", "r4"], "boost": 4.0}},
                   {"match": {"body": "fox"}}]}}},
    "prefix": {"query": {"prefix": {"body": "conn"}}},
    "prefix_ci": {"query": {"prefix": {"tag": {"value": "T1",
                                               "case_insensitive": True}}}},
    "wildcard": {"query": {"wildcard": {"body": {"value": "jump*g"}}}},
    "regexp": {"query": {"regexp": {"body": "eng.*s?"}}},
    "fuzzy": {"query": {"fuzzy": {"body": {"value": "dgo"}}}},
    "fuzzy_prefix": {"query": {"fuzzy": {"body": {
        "value": "runer", "fuzziness": 2, "prefix_length": 2}}}},
    "match_fuzziness": {"query": {"match": {"body": {
        "query": "quikc browm", "fuzziness": "AUTO"}}}},
    "match_fuzziness_and": {"query": {"match": {"body": {
        "query": "lazi dgo", "fuzziness": 1, "operator": "and"}}}},
    "term_ci": {"query": {"term": {"tag": {"value": "T3",
                                           "case_insensitive": True}}}},
    "match_numeric": {"query": {"match": {"req": 2}}, "size": 5},
    "phrase": {"query": {"match_phrase": {"body": "quick brown"}}},
    "phrase_slop2": {"query": {"match_phrase": {"body": {
        "query": "quick fox", "slop": 2}}}},
    "phrase_one_term": {"query": {"match_phrase": {"body": "lazy"}}},
    "phrase_prefix": {"query": {"match_phrase_prefix": {
        "body": "the la"}}},
    "bool_prefix": {"query": {"match_bool_prefix": {"body": "brown ju"}}},
    "mm_best": {"query": {"multi_match": {
        "query": "running dogs", "fields": ["body", "title^2"],
        "tie_breaker": 0.3}}},
    "mm_most": {"query": {"multi_match": {
        "query": "running dogs", "fields": ["body", "title"],
        "type": "most_fields"}}},
    "mm_cross": {"query": {"multi_match": {
        "query": "connected engines", "fields": ["t*", "body"],
        "type": "cross_fields", "operator": "and"}}},
    "mm_phrase": {"query": {"multi_match": {
        "query": "brown fox", "fields": ["body", "title"],
        "type": "phrase"}}},
    "query_string": {"query": {"query_string": {
        "query": "quick AND (fox OR dog) -lazy title:running"}}},
    "query_string_fields": {"query": {"query_string": {
        "query": "\"brown fox\" likes:[10 TO 100] +engine",
        "default_field": "body"}}},
    "query_string_and": {"query": {"query_string": {
        "query": "search relevance", "fields": ["body", "title"],
        "default_operator": "AND"}}},
    "simple_query_string": {"query": {"simple_query_string": {
        "query": "quick +brown -dog", "fields": ["body"]}}},
    "english": {"query": {"match": {"title": "jumps running dogs"}}},
    "english_phrase": {"query": {"match_phrase": {"title": "lazy dogs"}}},
    "highlight_explain": {
        "query": {"bool": {"must": [
            {"match_phrase": {"body": "brown fox"}},
            {"constant_score": {"filter": {"prefix": {"body": "ju"}}}}],
            "should": [{"multi_match": {"query": "dog engine",
                                        "fields": ["body", "title"]}}]}},
        "highlight": {"fields": {"body": {}, "title": {}}},
        "explain": True, "size": 5},
}
# the custom analyzer's index (`relc`): folding, stop words and stems at
# index time, whitespace + folding + stems at search time
CUSTOM_BODIES: Dict[str, dict] = {
    "custom_match": {"query": {"match": {"body": "Cafe Resumes RUNNING"}}},
    "custom_phrase": {"query": {"match_phrase": {"body": "naive cafe"}}},
    "custom_override": {"query": {"match": {"body": {
        "query": "the café", "analyzer": "folded"}}}},
}
# the query types the port leaves out answer a 400 naming them
NOT_PORTED_BODIES: Dict[str, dict] = {
    "nested": {"query": {"nested": {"path": "x", "query": {
        "match_all": {}}}}},
    "has_child": {"query": {"has_child": {"type": "c", "query": {
        "match_all": {}}}}},
    "more_like_this": {"query": {"more_like_this": {"like": "fox"}}},
    "span_term": {"query": {"span_term": {"body": "fox"}}},
    "intervals": {"query": {"intervals": {"body": {"match": {
        "query": "fox"}}}}},
    "rank_feature": {"query": {"rank_feature": {"field": "likes"}}},
    "geo_distance": {"query": {"geo_distance": {"distance": "1km",
                                                "loc": [0, 0]}}},
}


# ----------------------------------- multi-shard indices and block-max

def create_index(node, index: str, mapping: dict, shards: int,
                 **settings) -> None:
    """An index of `shards` shards (and further index settings)."""
    body = json.loads(json.dumps(mapping))
    body["settings"] = {"number_of_shards": shards, **settings}
    res = node.request("PUT", f"/{index}", body)
    assert res["_status"] == 200, res


def bulk_refresh(node, index: str, docs: Dict[str, dict],
                 deletes=()) -> None:
    res = node.request("POST", "/_bulk", bulk_ndjson(index, docs, deletes))
    assert res["_status"] == 200 and not res["errors"], res
    node.request("POST", f"/{index}/_refresh")


def load_sharded_index(node, index: str, shards: int, n_docs: int = 1200,
                       two_refreshes: bool = True) -> None:
    """The structured corpus on a multi-shard index: with two refreshes
    (re-indexed docs and deletes between them) every shard holds two
    segments, else one."""
    docs = docs_corpus(n_docs)
    create_index(node, index, DOCS_MAPPING, shards)
    if not two_refreshes:
        bulk_refresh(node, index, {f"d{i}": d for i, d in enumerate(docs)})
        return
    half = n_docs // 2
    bulk_refresh(node, index, {f"d{i}": docs[i] for i in range(half)})
    second = {f"d{i}": docs[i] for i in range(half, n_docs)}
    second.update({f"d{i}": docs[i + 1] for i in range(3, half, 151)})
    bulk_refresh(node, index, second, [f"d{i}" for i in range(5, n_docs, 173)])


LOGS = ("logs-0", "logs-1", "logs-2", "logs-3")


def load_logs_indices(node, n_docs: int = 1200) -> None:
    """The structured corpus split by day over four one-shard indices
    `logs-0..3` (http_logs' daily indices behind `logs-*`)."""
    docs = docs_corpus(n_docs)
    by_day = sorted(range(n_docs), key=lambda i: docs[i]["ts"])
    quarter = n_docs // 4
    for j, index in enumerate(LOGS):
        create_index(node, index, DOCS_MAPPING, 1)
        bulk_refresh(node, index, {f"d{i}": docs[i] for i in
                                   by_day[j * quarter:(j + 1) * quarter]})


ZIPF_MAPPING = {"mappings": {"properties": {"body": {"type": "text"},
                                            "n": {"type": "integer"}}}}
ZIPF_QUERIES = ("w4", "w4 w0", "w1 w2", "w4 w1 w7", "w3 w4 w5 w6 w8")


def zipf_docs(n: int = 3000, burst: int = 60, seed: int = 7) -> List[dict]:
    """The block-max corpus of the reference's suite: a zipf-ish 50-word
    vocabulary and a doc-id-clustered high-tf burst (the first `burst`
    docs repeat w4 40 times), so a few blocks' bounds stand far above the
    rest."""
    import random
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(50)]
    weights = [1.0 / (j + 1) for j in range(50)]
    out = []
    for i in range(n):
        words = rng.choices(vocab, weights=weights, k=30)
        if i < burst:
            words = words + ["w4"] * 40
        out.append({"body": " ".join(words), "n": i})
    return out


def load_zipf_index(node, index: str, shards: int, deleted=()) -> None:
    create_index(node, index, ZIPF_MAPPING, shards)
    bulk_refresh(node, index, {f"d{i}": d for i, d in enumerate(zipf_docs())})
    if deleted:
        bulk_refresh(node, index, {}, deleted)


def zipf_bodies(sizes=(1, 10, 100)) -> List[dict]:
    return [{"query": {"match": {"body": q}}, "size": s}
            for s in sizes for q in ZIPF_QUERIES]


# bodies over the multi-shard structured indices: the program's score and
# numeric sorts, the host loop's date and keyword sorts, aggregations
SHARD_BODIES: Dict[str, dict] = {
    "match": {"query": {"match": {"body": "w00011 w00004"}}, "size": 12},
    "bool_filters": {"query": {"bool": {
        "must": [{"match": {"body": "w00021 w00005"}}],
        "filter": [{"range": {"views": {"gte": 1000, "lt": 7000}}},
                   {"terms": {"tag": ["cat1", "cat2", "cat3", "multi"]}}],
        "must_not": [{"term": {"tag": "cat2"}}]}}, "size": 15},
    "views_desc": {"query": {"match": {"body": "w00011 w00004"}},
                   "sort": [{"views": "desc"}], "size": 10},
    "ts_desc": {"sort": [{"ts": "desc"}], "size": 9},
    "tag_keyword": {"sort": [{"tag": "asc"}], "size": 11,
                    "query": {"range": {"views": {"lt": 3000}}}},
    "date_histogram": {"query": {"match": {"body": "w00011"}}, "aggs": {
        "d": {"date_histogram": {"field": "ts", "fixed_interval": "1d"}}}},
    "dfs": {"query": {"match": {"body": "w00011 w00004"}},
            "search_type": "dfs_query_then_fetch", "size": 10},
}


# ----------------------------------------- nested documents (Q&A corpus)

# after rally-tracks' `nested` track: questions with their answers as
# nested objects
QA_MAPPING = {"mappings": {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "votes": {"type": "integer"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "long"},
        "date": {"type": "date"},
        "score": {"type": "integer"},
        "text": {"type": "text"}}}}}}
QA_N = 360
QA_BASE = 1262304000000          # 2010-01-01
QA_WORDS = [f"q{i}" for i in range(30)]
QA_TAGS = [f"tag{i}" for i in range(12)]


def qa_corpus(n: int = QA_N, seed: int = 9) -> List[dict]:
    """Seeded questions: a title, a zipf `tag`, a `creationDate` over two
    years, `votes`, and 0-8 answers (mean about 2.5), each a zipf `user`
    of 60, a `date` after the question, an integer `score` and a text."""
    rng = np.random.default_rng(seed)
    tag_p = 1.0 / np.arange(1, len(QA_TAGS) + 1)
    tag_p /= tag_p.sum()
    user_p = 1.0 / np.arange(1, 61) ** 1.1
    user_p /= user_p.sum()
    out = []
    for i in range(n):
        created = QA_BASE + int(rng.integers(0, 730)) * 86400_000 \
            + int(rng.integers(0, 86400)) * 1000
        q = {"title": " ".join(rng.choice(QA_WORDS, 4)),
             "tag": str(rng.choice(QA_TAGS, p=tag_p)),
             "creationDate": created, "votes": int(rng.integers(0, 50))}
        n_ans = int(min(rng.geometric(0.3) - 1, 8))
        if n_ans:
            q["answers"] = [{
                "user": int(rng.choice(60, p=user_p)),
                "date": created + int(rng.integers(1, 400)) * 3600_000,
                "score": int(rng.integers(-2, 30)),
                "text": " ".join(rng.choice(QA_WORDS, 5))}
                for _ in range(n_ans)]
        out.append(q)
    return out


def load_qa_index(node, index: str = "qa", n: int = QA_N,
                  shards: int = 1, two_refreshes: bool = True) -> None:
    """The Q&A corpus over two refreshes: the second re-indexes a few
    questions (their blocks replaced) and deletes others (their blocks
    killed, in a sealed segment and in the buffer). With one refresh each
    shard holds one segment."""
    docs = qa_corpus(n)
    create_index(node, index, QA_MAPPING, shards)
    if not two_refreshes:
        bulk_refresh(node, index, {f"q{i}": d for i, d in enumerate(docs)})
        return
    half = n // 2
    bulk_refresh(node, index, {f"q{i}": docs[i] for i in range(half)})
    second = {f"q{i}": docs[i] for i in range(half, n)}
    second.update({f"q{i}": docs[(i * 7) % n] for i in range(3, half, 41)})
    deletes = [f"q{i}" for i in range(5, n, 37)]
    bulk_refresh(node, index, second, deletes)


def qa_match_body(user: int, day: int, mode: str, inner=None,
                  size: int = 10) -> dict:
    """The nested cell's query family: answers by a user after a date,
    scored by the answer text, in one score mode."""
    nested = {"path": "answers", "score_mode": mode, "query": {"bool": {
        "must": [{"match": {"answers.text": "q1 q3 q7"}}],
        "filter": [{"term": {"answers.user": user}},
                   {"range": {"answers.date": {
                       "gte": QA_BASE + day * 86400_000}}}]}}}
    if inner is not None:
        nested["inner_hits"] = inner
    return {"query": {"nested": nested}, "size": size}


NESTED_MODES = ("avg", "sum", "max", "min", "none")

# aggregations under `nested` and `reverse_nested`: every kind the port
# evaluates under a static parent, on the dynamic context
NESTED_AGG_BODIES: Dict[str, dict] = {
    "terms_user": {"nested": {"path": "answers"}, "aggs": {
        "u": {"terms": {"field": "answers.user", "size": 10}}}},
    "tree": {"nested": {"path": "answers"}, "aggs": {
        "m": {"date_histogram": {"field": "answers.date",
                                 "calendar_interval": "month"},
              "aggs": {"back": {"reverse_nested": {}, "aggs": {
                  "t": {"terms": {"field": "tag"}}}}}}}},
    "metrics": {"nested": {"path": "answers"}, "aggs": {
        "st": {"stats": {"field": "answers.score"}},
        "ex": {"extended_stats": {"field": "answers.score"}},
        "mn": {"min": {"field": "answers.score"}},
        "mx": {"max": {"field": "answers.date"}},
        "vc": {"value_count": {"field": "answers.user"}},
        "card": {"cardinality": {"field": "answers.user"}},
        "pc": {"percentiles": {"field": "answers.score",
                               "percents": [10, 50, 90]}},
        "miss": {"avg": {"field": "answers.score", "missing": 3}},
        "wa": {"weighted_avg": {"value": {"field": "answers.score"},
                                "weight": {"field": "answers.user"}}}}},
    "buckets": {"nested": {"path": "answers"}, "aggs": {
        "h": {"histogram": {"field": "answers.score", "interval": 5},
              "aggs": {"s": {"sum": {"field": "answers.score"}}}},
        "r": {"range": {"field": "answers.score", "ranges": [
            {"to": 0}, {"from": 0, "to": 10}, {"from": 10}]}},
        "f": {"filter": {"range": {"answers.score": {"gte": 10}}},
              "aggs": {"u": {"terms": {"field": "answers.user",
                                       "size": 5}}}},
        "fs": {"filters": {"filters": {
            "hi": {"range": {"answers.score": {"gte": 20}}},
            "txt": {"match": {"answers.text": "q2"}}}}},
        "ms": {"missing": {"field": "answers.text"}},
        "g": {"global": {}, "aggs": {"c": {"value_count": {
            "field": "votes"}}}}}},
    "dense": {"nested": {"path": "answers"}, "aggs": {
        "cp": {"composite": {"size": 20, "sources": [
            {"u": {"terms": {"field": "answers.user"}}},
            {"s": {"histogram": {"field": "answers.score",
                                 "interval": 10}}}]}},
        "mt": {"multi_terms": {"terms": [{"field": "answers.user"},
                                         {"field": "answers.score"}],
                               "size": 5}},
        "adj": {"adjacency_matrix": {"filters": {
            "a": {"range": {"answers.score": {"gte": 10}}},
            "b": {"range": {"answers.user": {"lt": 5}}}}}},
        "mst": {"matrix_stats": {"fields": ["answers.score",
                                            "answers.user"]}}}},
    "under_terms": {"terms": {"field": "tag", "size": 4}, "aggs": {
        "a": {"nested": {"path": "answers"}, "aggs": {
            "top": {"max": {"field": "answers.score"}},
            "back": {"reverse_nested": {}, "aggs": {
                "v": {"sum": {"field": "votes"}}}}}}}},
}


# -------------------------------------------- geo_point and rank_feature

# after rally-tracks' `geonames` track: places with a location, a
# population (a rank_feature here) and a country code
GEO_MAPPING = {"mappings": {"properties": {
    "name": {"type": "text"},
    "location": {"type": "geo_point"},
    "population": {"type": "rank_feature"},
    "country_code": {"type": "keyword"},
    "elev": {"type": "integer"}}}}
GEO_N = 600
# seeded city centres (lat, lon), two of them by the dateline
GEO_CENTRES = [(52.52, 13.405), (48.86, 2.35), (40.71, -74.0),
               (35.68, 139.69), (-33.87, 151.21), (-17.7, 178.4),
               (64.2, -179.3), (19.43, -99.13), (-23.55, -46.63),
               (1.35, 103.82)]


# geo_distance bodies: (centre, radius) on `location`
GEO_DISTANCE = {"berlin_150km": ((52.52, 13.405), "150km"),
                "paris_1200km": ((48.86, 2.35), "1200km"),
                "fiji_300km": ((-17.7, 178.4), "300km"),
                "tokyo_95km": ((35.68, 139.69), 95000)}


def geo_points(n: int = GEO_N, seed: int = 5):
    """Each place's points (lat, lon), seeded around GEO_CENTRES: one
    point mostly, two for every 37th place, none for every 53rd."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 53 == 52:
            out.append([])
            continue
        pts = []
        for _ in range(2 if i % 37 == 36 else 1):
            c = GEO_CENTRES[int(rng.integers(0, len(GEO_CENTRES)))]
            lat = float(np.clip(c[0] + rng.normal(0, 1.5), -89.9, 89.9))
            lon = float(c[1] + rng.normal(0, 2.0))
            lon = (lon + 180.0) % 360.0 - 180.0
            pts.append((round(lat, 6), round(lon, 6)))
        out.append(pts)
    return out


def geo_corpus(n: int = GEO_N, seed: int = 5) -> List[dict]:
    """Places whose locations rotate through the geo_point wire shapes:
    {"lat", "lon"}, "lat,lon" and [lon, lat] (a list of those for two
    points); a lognormal `population` (missing for every 29th)."""
    rng = np.random.default_rng(seed + 1)
    docs = []
    for i, pts in enumerate(geo_points(n, seed)):
        d = {"name": f"place {i % 17}", "elev": int(rng.integers(0, 3000)),
             "country_code": f"c{i % 10}"}
        if i % 29 != 0:
            d["population"] = float(round(rng.lognormal(8, 1.5), 2))
        shape = i % 3
        enc = [({"lat": la, "lon": lo} if shape == 0 else
                f"{la},{lo}" if shape == 1 else [lo, la]) for la, lo in pts]
        if len(enc) == 1:
            d["location"] = enc[0]
        elif len(enc) > 1:
            d["location"] = enc
        docs.append(d)
    # one place on each GEO_DISTANCE circle, due north of its centre
    for (lat, lon), dist in GEO_DISTANCE.values():
        metres = float(str(dist).rstrip("km")) * (
            1000.0 if str(dist).endswith("km") else 1.0)
        docs.append({"name": "edge", "country_code": "c0", "elev": 0,
                     "location": {"lat": lat + math.degrees(
                         metres / 6371008.7714), "lon": lon}})
    return docs


def load_geo_index(node, index: str = "geo", n: int = GEO_N) -> None:
    """The places over two refreshes (two segments), a few deleted."""
    docs = geo_corpus(n)
    create_index(node, index, GEO_MAPPING, 1)
    half = n // 2
    bulk_refresh(node, index, {f"p{i}": docs[i] for i in range(half)})
    bulk_refresh(node, index, {f"p{i}": docs[i]
                               for i in range(half, len(docs))},
                 [f"p{i}" for i in range(4, n, 61)])


GEO_QUERY_BODIES: Dict[str, dict] = {
    "bbox": {"query": {"bool": {"filter": [{"geo_bounding_box": {
        "location": {"top_left": {"lat": 55.0, "lon": 0.0},
                     "bottom_right": {"lat": 45.0, "lon": 15.0}}}}]}},
        "size": 100},
    "bbox_dateline": {"query": {"geo_bounding_box": {"location": {
        "top": 70.0, "left": 170.0, "bottom": -30.0, "right": -170.0}}},
        "size": 100},
    "distance_feature": {"query": {"bool": {
        "must": [{"match_all": {}}],
        "should": [{"distance_feature": {
            "field": "location", "origin": "48.86,2.35",
            "pivot": "50km"}}]}}, "size": 30},
    "distance_feature_array": {"query": {"distance_feature": {
        "field": "location", "origin": [151.21, -33.87], "pivot": "300km",
        "boost": 2.0}}, "size": 30},
    "saturation": {"query": {"rank_feature": {
        "field": "population", "saturation": {"pivot": 3000}}}, "size": 30},
    "saturation_default": {"query": {"rank_feature": {
        "field": "population"}}, "size": 30},
    "log": {"query": {"rank_feature": {
        "field": "population", "log": {"scaling_factor": 2}}}, "size": 30},
    "sigmoid": {"query": {"rank_feature": {
        "field": "population", "sigmoid": {"pivot": 2000,
                                           "exponent": 0.6}}}, "size": 30},
    "linear": {"query": {"rank_feature": {
        "field": "population", "linear": {}, "boost": 0.5}}, "size": 30},
    "rank_in_radius": {"query": {"bool": {
        "filter": [{"geo_distance": {"distance": "200km",
                                     "location": [2.35, 48.86]}}],
        "should": [{"rank_feature": {"field": "population",
                                     "saturation": {"pivot": 3000}}}]}},
        "size": 30},
}



def geo_distance_body(name: str) -> dict:
    (lat, lon), dist = GEO_DISTANCE[name]
    return {"query": {"bool": {"filter": [{"geo_distance": {
        "distance": dist, "location": {"lat": lat, "lon": lon}}}]}},
        "size": 1000}


GEO_AGG_BODIES: Dict[str, dict] = {
    "bounds_centroid": {"gb": {"geo_bounds": {"field": "location"}},
                        "gc": {"geo_centroid": {"field": "location"}}},
    "by_country": {"cc": {"terms": {"field": "country_code", "size": 20},
                          "aggs": {"gb": {"geo_bounds": {
                              "field": "location"}},
                              "gc": {"geo_centroid": {
                                  "field": "location"}}}}},
    "geohash": {"gh": {"geohash_grid": {"field": "location",
                                        "precision": 3}}},
    "geotile": {"gt": {"geotile_grid": {"field": "location",
                                        "precision": 6}}},
    "grid_under_terms": {"cc": {"terms": {"field": "country_code"},
                                "aggs": {"cells": {"geohash_grid": {
                                    "field": "location",
                                    "precision": 1}}}}},
    "grid_sub": {"gt": {"geotile_grid": {"field": "location",
                                         "precision": 3},
                        "aggs": {"e": {"max": {"field": "elev"}}}}},
    "filtered_centroid": {"f": {"filter": {"range": {"elev": {
        "gte": 1000}}}, "aggs": {"gc": {"geo_centroid": {
            "field": "location"}}}}},
}


def centroid_tol(resp: dict, path: str = "", out=None) -> Dict[str, float]:
    """geo_centroid's bound per coordinate path: each side's f32 sum of
    `count` coordinates lies within count * 2^-24 * sum|v| of the exact
    sum (|v| <= 180), so two sides' means lie within twice that over the
    count."""
    out = {} if out is None else out
    if isinstance(resp, dict):
        if "location" in resp and "count" in resp:
            cnt = resp["count"]
            for axis in ("lat", "lon"):
                out[f"{path}.location.{axis}"] = \
                    2 * f32_sum_bound(cnt, 180.0 * cnt) / cnt
        for k, v in resp.items():
            centroid_tol(v, f"{path}.{k}", out)
    elif isinstance(resp, list):
        for i, v in enumerate(resp):
            centroid_tol(v, f"{path}[{i}]", out)
    return out
