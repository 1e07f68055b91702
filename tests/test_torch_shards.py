"""Multi-shard and multi-index search of opensearch_tpu_torch held against
opensearch_tpu: the same documents through both Nodes' REST surface on
2-, 3- and 5-shard indices and on expressions over several indices
(`a,b`, `logs-*`, `_all`, `-` exclusions), with `assert_same_response`'s
contract (ids, order, totals, `_shards` and aggregations exactly; scores
to rtol 1e-6). Each request also takes the same route in both packages:
the multi-shard program (search/spmd.py) or the host loop.

The reference runs on 8 virtual CPU devices, where it packs up to 64 rows
into its program; the port runs on one card and packs up to 8. Every
index here keeps 8 rows or fewer, so the two caps never differ.
"""

import json

import pytest

from opensearch_tpu.indices.request_cache import REQUEST_CACHE
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import spmd as jspmd

from opensearch_tpu_torch.cluster.routing import generate_shard_id
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import spmd as tspmd

from test_torch_common import (AGG_BODIES, BASE_TS, DAY_MS, DOCS_MAPPING,
                               HYB_MAPPING, HYB_PIPELINE, VECS_MAPPING,
                               assert_same_response, bulk_refresh,
                               create_index, docs_corpus, hyb_corpus,
                               hybrid_body, knn_bodies, load_logs_indices,
                               load_sharded_index, msearch_ndjson,
                               vecs_corpus)

N_DOCS = 1200


def _load(node):
    """s2: 2 shards over two refreshes with re-indexed docs and deletes
    (4 rows); s3: 3 shards, the same (6 rows); s5: 5 shards, one refresh
    (5 rows); logs-0..3: one shard each, the corpus split by day, so a
    range on `ts` proves three of them empty."""
    load_sharded_index(node, "s2", 2, N_DOCS)
    load_sharded_index(node, "s3", 3, N_DOCS)
    load_sharded_index(node, "s5", 5, N_DOCS, two_refreshes=False)
    load_logs_indices(node, N_DOCS)


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    _load(jn)
    _load(tn)
    return jn, tn


def _spmd_counts():
    return jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]


def _cursors(resp):
    """Pop the internal page cursors an `_msearch` item keeps (the last
    hit's sort values and its (shard, segment, doc))."""
    return [r.pop("_page_cursor", None) for r in resp.get("responses", [])]


def _same(jn, tn, method, path, body, same_route=True, **params):
    """Both Nodes' responses equal, and (with `same_route`) the request
    took the same route. An `_msearch` item's page cursor compares its
    tie-break exactly and its values as scores (rtol 1e-6: the one-ulp
    BM25 difference of XLA's fused multiply-add, ROADMAP queue 3)."""
    # the reference's request cache (not ported) would answer a repeated
    # size-0 body without running its program
    REQUEST_CACHE.clear()
    j0, t0 = _spmd_counts()
    want = jn.request(method, path, body, **params)
    j1, t1 = _spmd_counts()
    got = tn.request(method, path, body, **params)
    t2 = _spmd_counts()[1]
    assert want["_status"] == 200, want
    for g, w in zip(_cursors(got), _cursors(want)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g["tiebreak"] == list(w["tiebreak"]) \
                or tuple(g["tiebreak"]) == tuple(w["tiebreak"])
            assert g["values"] == pytest.approx(w["values"], rel=1e-6)
    assert_same_response(got, want, path)
    assert not same_route or (t2 - t1) == (j1 - j0), \
        f"{path}: the port took {t2 - t1} program runs, the reference " \
        f"{j1 - j0}"
    return want, j1 - j0


QUERY_BODIES = {
    "match": {"query": {"match": {"body": "w00011 w00004"}}, "size": 12},
    "match_and": {"query": {"match": {"body": {
        "query": "w00003 w00007", "operator": "and"}}}},
    "bool_filters": {"query": {"bool": {
        "must": [{"match": {"body": "w00021 w00005"}}],
        "filter": [{"range": {"views": {"gte": 1000, "lt": 7000}}},
                   {"terms": {"tag": ["cat1", "cat2", "cat3", "multi"]}}],
        "must_not": [{"term": {"tag": "cat2"}}]}}, "size": 15},
    "range_only": {"query": {"range": {"views": {"gte": 8000}}},
                   "size": 7},
    "match_all_from": {"query": {"match_all": {}}, "from": 20, "size": 9},
    "min_score": {"query": {"match": {"body": "w00011 w00004 w00002"}},
                  "min_score": 2.0, "size": 30},
    "size_zero": {"query": {"match": {"body": "w00011"}}, "size": 0},
    "many_terms": {"query": {"match": {"body": " ".join(
        f"w{i:05d}" for i in range(2, 22))}}, "size": 10},
}

SORT_BODIES = {
    "views_desc": {"query": {"match": {"body": "w00011 w00004"}},
                   "sort": [{"views": "desc"}], "size": 10},
    "views_asc_track_scores": {"query": {"match": {"body": "w00006"}},
                               "sort": [{"views": "asc"}], "size": 8,
                               "track_scores": True},
    "ts_desc": {"sort": [{"ts": "desc"}], "size": 9},
    "tag_keyword": {"sort": [{"tag": "asc"}], "size": 11,
                    "query": {"range": {"views": {"lt": 3000}}}},
    "tag_then_views": {"sort": [{"tag": "desc"}, {"views": "asc"}],
                       "size": 10},
    "score_track": {"query": {"match": {"body": "w00009"}}, "size": 5,
                    "track_scores": True, "sort": ["_score"]},
    "after_views": {"sort": [{"views": "desc"}], "size": 6,
                    "search_after": [5000]},
    "after_ts": {"sort": [{"ts": "asc"}], "size": 6,
                 "search_after": [BASE_TS + 20 * DAY_MS]},
    "track_total_false": {"query": {"match": {"body": "w00011"}},
                          "sort": [{"views": "desc"}], "size": 3,
                          "track_total_hits": False},
}

AGG_CASES = {
    **AGG_BODIES,
    "composite": {"size": 0, "aggs": {"c": {"composite": {
        "size": 6, "sources": [{"t": {"terms": {"field": "tag"}}},
                               {"h": {"histogram": {"field": "views",
                                                    "interval": 2500}}}]}}}},
    "terms_sorted_page": {"size": 4, "sort": [{"views": "asc"}],
                          "query": {"match": {"body": "w00011"}},
                          "aggs": {"t": {"terms": {"field": "tag",
                                                   "size": 4}}}},
}


@pytest.mark.parametrize("index", ["s2", "s3", "s5"])
@pytest.mark.parametrize("name", sorted(QUERY_BODIES))
def test_query_bodies(nodes, index, name):
    _same(*nodes, "POST", f"/{index}/_search", QUERY_BODIES[name])


@pytest.mark.parametrize("index", ["s2", "s3", "s5"])
@pytest.mark.parametrize("name", sorted(SORT_BODIES))
def test_sorts_and_search_after(nodes, index, name):
    _same(*nodes, "POST", f"/{index}/_search", SORT_BODIES[name])


@pytest.mark.parametrize("index", ["s3", "s5", "logs-*"])
@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_aggregations(nodes, index, name):
    _same(*nodes, "POST", f"/{index}/_search", AGG_CASES[name])


def test_routes_are_taken(nodes):
    """A plain match on a multi-shard index runs the program; a keyword or
    epoch-millis sort runs the host loop, in both packages."""
    _, n = _same(*nodes, "POST", "/s3/_search", QUERY_BODIES["match"])
    assert n == 1
    _, n = _same(*nodes, "POST", "/s3/_search", SORT_BODIES["views_desc"])
    assert n == 1
    for name in ("ts_desc", "tag_keyword"):
        _, n = _same(*nodes, "POST", "/s3/_search", SORT_BODIES[name])
        assert n == 0


@pytest.mark.parametrize("path", ["/logs-0,logs-1/_search",
                                  "/logs-*/_search", "/_all/_search",
                                  "/_search", "/*,-s3,-s5/_search",
                                  "/logs-*,-logs-2/_search"])
@pytest.mark.parametrize("name", ["match", "bool_filters", "size_zero"])
def test_index_expressions(nodes, path, name):
    """Expressions over several indices: every shard of every resolved
    index, in resolve order. `_all` reaches 19 rows, past the port's cap
    of 8 and within the reference's 64: the port takes its host loop,
    whose score-sorted page without track_scores is the program's."""
    every = path in ("/_all/_search", "/_search")
    _same(*nodes, "POST", path, QUERY_BODIES[name], same_route=not every)


@pytest.mark.parametrize("name", ["views_desc", "ts_desc", "tag_keyword"])
def test_index_expression_sorts(nodes, name):
    _same(*nodes, "POST", "/logs-*/_search", SORT_BODIES[name])


def test_can_match_skips_shards(nodes):
    """An epoch-millis sort takes the host loop, where can-match skips the
    indices whose `ts` range cannot match: `_shards.skipped` counts
    them."""
    body = {"query": {"range": {"ts": {"lt": BASE_TS + 3 * DAY_MS}}},
            "sort": [{"ts": "desc"}], "size": 5}
    want, n = _same(*nodes, "POST", "/logs-*/_search", body)
    assert n == 0
    assert want["_shards"] == {"total": 4, "successful": 4, "skipped": 3,
                               "failed": 0}
    # every shard provably empty: one still runs, so the response is whole
    body = {"query": {"range": {"views": {"gt": 10 ** 9}}},
            "sort": [{"ts": "desc"}]}
    want, _ = _same(*nodes, "POST", "/logs-*/_search", body)
    assert want["_shards"]["skipped"] == 3


def test_msearch(nodes):
    """_msearch on a multi-shard index (each body through search()) and
    over expressions, with a per-item error."""
    bodies = [QUERY_BODIES["match"], SORT_BODIES["views_desc"],
              AGG_CASES["bench_terms"], {"query": {"nope": {}}},
              QUERY_BODIES["bool_filters"]]
    for path, index in (("/_msearch", "s3"), ("/s5/_msearch", "s5"),
                        ("/_msearch", "logs-*")):
        _same(*nodes, "POST", path, msearch_ndjson(index, bodies))


@pytest.mark.parametrize("name", ["exact_l2", "exact_cos", "filtered",
                                  "bool_knn", "ivf"])
def test_knn_over_shards(name):
    """knn bodies on a 3-shard vector index (one segment per shard)."""
    docs, _q = vecs_corpus(900)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        create_index(node, "vs", VECS_MAPPING, 3)
        bulk_refresh(node, "vs", {f"d{i}": d for i, d in enumerate(docs)})
    REQUEST_CACHE.clear()
    j0, t0 = _spmd_counts()
    want = jn.request("POST", "/vs/_search", knn_bodies()[name])
    j1, t1 = _spmd_counts()
    got = tn.request("POST", "/vs/_search", knn_bodies()[name])
    # the k-NN contract of tests/test_torch_knn.py: dot products summed in
    # dim order against XLA's blocked matmuls
    assert_same_response(got, want, score_rtol=1e-5, score_atol=1e-5)
    assert _spmd_counts()[1] - t1 == j1 - j0


def test_hybrid_over_shards():
    """Hybrid under the normalization pipeline on a 2-shard index: the
    per-shard windows reduce with the global bounds."""
    docs, queries = hyb_corpus(800)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        assert node.request("PUT", "/_search/pipeline/hyb_norm",
                            HYB_PIPELINE)["_status"] == 200
        create_index(node, "hy", HYB_MAPPING, 2)
        bulk_refresh(node, "hy", {f"d{i}": d for i, d in enumerate(docs)})
    for text, vec in queries[:3]:
        want = jn.request("POST", "/hy/_search", hybrid_body(text, vec),
                          search_pipeline="hyb_norm")
        got = tn.request("POST", "/hy/_search", hybrid_body(text, vec),
                         search_pipeline="hyb_norm")
        assert want["_shards"]["total"] == 2
        assert_same_response(got, want, score_rtol=1e-5, score_atol=1e-6)


def _ids_for_shards(n_shards, per_shard):
    buckets = {s: [] for s in range(n_shards)}
    i = 0
    while any(len(b) < per_shard for b in buckets.values()):
        sid = generate_shard_id(f"sk-{i}", n_shards)
        if len(buckets[sid]) < per_shard:
            buckets[sid].append(f"sk-{i}")
        i += 1
    return buckets


def _skewed(node):
    """Two shards with a skewed df for `rare` (the reference's DFS test
    corpus): shard 0 holds it in every doc, shard 1 in one."""
    node.request("PUT", "/skew", {
        "settings": {"number_of_shards": 2, "number_of_replicas": 0},
        "mappings": {"properties": {"body": {"type": "text"}}}})
    buckets = _ids_for_shards(2, 4)
    for did in buckets[0]:
        node.request("PUT", f"/skew/_doc/{did}", {"body": "rare word"})
    for j, did in enumerate(buckets[1]):
        node.request("PUT", f"/skew/_doc/{did}",
                     {"body": "rare word" if j == 0 else "common word"})
    node.request("POST", "/skew/_refresh")
    return buckets


def test_dfs_query_then_fetch():
    """DFS merges the shards' term statistics, so equal-tf docs score
    equally across shards (the body key and the URL parameter); without
    it the lone shard-1 hit outscores shard 0's."""
    jn, tn = JNode(), TNode(device="cpu")
    buckets = _skewed(jn)
    assert _skewed(tn) == buckets
    body = {"query": {"match": {"body": "rare"}}, "size": 10}
    plain, _ = _same(jn, tn, "POST", "/skew/_search", body)
    by_id = {h["_id"]: h["_score"] for h in plain["hits"]["hits"]}
    assert all(by_id[buckets[1][0]] > by_id[d] + 1e-6 for d in buckets[0])
    dfs_body = {**body, "search_type": "dfs_query_then_fetch"}
    dfs, n = _same(jn, tn, "POST", "/skew/_search", dfs_body)
    assert n == 0
    scores = {h["_id"]: h["_score"] for h in dfs["hits"]["hits"]}
    assert scores[buckets[1][0]] == pytest.approx(scores[buckets[0][0]],
                                                  rel=1e-5)
    _same(jn, tn, "POST", "/skew/_search", body,
          search_type="dfs_query_then_fetch")
    _same(jn, tn, "POST", "/skew/_search",
          {**dfs_body, "query": {"bool": {"should": [
              {"match": {"body": "rare common"}},
              {"term": {"body": "word"}}]}}})


def test_routed_writes():
    """Writes with `routing` (URL parameter and `_bulk` header, as
    `routing` and `_routing`), `number_of_routing_shards` and
    `routing_partition_size` land on the same shards in both packages,
    and searches over them agree."""
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        create_index(node, "r4", DOCS_MAPPING, 4, number_of_routing_shards=8)
        create_index(node, "rp", DOCS_MAPPING, 4, routing_partition_size=2)
        docs = docs_corpus(200)
        lines = []
        for i, d in enumerate(docs):
            meta = {"_index": "r4" if i % 2 else "rp", "_id": f"d{i}"}
            if i % 3 == 0:
                meta["routing"] = f"user{i % 7}"
            elif i % 3 == 1:
                meta["_routing"] = f"user{i % 5}"
            lines.append(json.dumps({"index": meta}))
            lines.append(json.dumps(d))
        res = node.request("POST", "/_bulk", "\n".join(lines) + "\n")
        assert res["_status"] == 200 and not res["errors"]
        for i in range(200, 230):
            res = node.request("PUT", f"/rp/_doc/x{i}", docs[i - 200],
                               routing=f"user{i % 4}")
            assert res["_status"] == 201
        res = node.request("DELETE", "/rp/_doc/x201", routing="user1")
        assert res["_status"] == 200
        for index in ("r4", "rp"):
            node.request("POST", f"/{index}/_refresh")
    for index in ("r4", "rp"):
        jsvc, tsvc = jn.indices.get(index), tn.indices.get(index)
        for js, ts in zip(jsvc.shards, tsvc.shards):
            want = sorted(d for seg in js.reader.segments
                          for d, live in zip(seg.doc_ids, seg.live) if live)
            got = sorted(d for seg in ts.reader.segments
                         for d, live in zip(seg.doc_ids, seg.live) if live)
            assert got == want
        _same(jn, tn, "POST", f"/{index}/_search", QUERY_BODIES["match"])
        _same(jn, tn, "POST", f"/{index}/_search", SORT_BODIES["views_desc"])


@pytest.mark.parametrize("settings", [
    {"number_of_shards": 3, "number_of_routing_shards": 4},
    {"number_of_shards": 3, "number_of_routing_shards": 2},
    {"number_of_shards": 2, "routing_partition_size": 2},
    {"number_of_shards": 0},
], ids=["not_multiple", "fewer", "partition", "zero"])
def test_shard_settings_errors(settings):
    """The reference's validation messages for invalid shard settings."""
    jn, tn = JNode(), TNode(device="cpu")
    body = {"settings": settings, "mappings": DOCS_MAPPING["mappings"]}
    want = jn.request("PUT", "/bad", body)
    got = tn.request("PUT", "/bad", body)
    assert want["_status"] == got["_status"] == 400
    assert got["error"]["reason"] == want["error"]["reason"]
