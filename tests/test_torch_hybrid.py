"""Hybrid search of opensearch_tpu_torch held against opensearch_tpu: the
normalization and combination techniques, search-pipeline CRUD and its
errors, hybrid pages (match + knn, match + maxsim, three sub-queries,
`min_score`, `from`/`size`, `track_total_hits`) through every route the
REST surface has (`_search` with a `search_pipeline` parameter, an inline
pipeline, the index's `index.search.default_pipeline`, and both `_msearch`
routes), the hybrid error bodies, and the fused hybrid row (K3 windows and
K12's plain version) against the reference's `build_hybrid_query_phase`.

Contract: ids, order, totals and error bodies exactly; `_score` within
rtol 1e-5 plus atol 1e-6. A knn or maxsim sub-score differs from the
reference's by a few ulps (rtol ~1e-7), and min_max normalization
(s - min) / (max - min) turns that into an absolute error of about
ulp(s) / (max - min): near a window's min the relative error of the
normalized score grows without bound, its absolute error does not. The
reference is held at its single-search path: its batched hybrid pages
differ from its own single pages by an ulp (its vmapped dot sums in
another order). The port's batched pages equal its single pages bit for
bit."""

import math

import numpy as np
import pytest
import torch

from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import compile as jcompile
from opensearch_tpu.search import executor as jexecutor
from opensearch_tpu.searchpipeline import hybrid as jhyb

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import compile as tcompile
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search import executor as texecutor
from opensearch_tpu_torch.searchpipeline import hybrid as thyb

from reference_impl import ref_hybrid_scores
from test_torch_common import (assert_same_response, bulk_ndjson,
                               msearch_ndjson)

RTOL = 1e-5
ATOL = 1e-6
VDIMS = 4
TDIMS = 8
WORDS = ["red", "fox", "dog", "cat", "blue", "bird", "green", "quick"]
MAPPING = {"properties": {
    "title": {"type": "text"},
    "tag": {"type": "keyword"},
    "vec": {"type": "knn_vector", "dimension": VDIMS},
    "tok": {"type": "rank_vectors", "dimension": TDIMS, "max_tokens": 8},
}}
PIPELINES = {
    "minmax_arith": {"phase_results_processors": [{"normalization-processor": {
        "normalization": {"technique": "min_max"},
        "combination": {"technique": "arithmetic_mean",
                        "parameters": {"weights": [0.3, 0.7]}}}}]},
    "l2_geo": {"description": "l2 + geometric",
               "phase_results_processors": [{"normalization-processor": {
                   "normalization": {"technique": "l2"},
                   "combination": {"technique": "geometric_mean"}}}]},
    "minmax_harm3": {"phase_results_processors": [{"normalization-processor": {
        "combination": {"technique": "harmonic_mean",
                        "parameters": {"weights": [0.2, 0.3, 0.5]}}}}]},
}
DELETED = ("d5", "d77", "d131")


# ------------------------------------------------- normalize / combine

SHARD_CANDIDATES = [
    [{"a": 3.0, "b": 1.5, "c": 0.25}, {"b": 0.9, "d": 0.4}],
    [{"e": 2.0, "f": 2.0}, {"e": 0.0, "g": 0.7, "h": 1.2}],
]


@pytest.mark.parametrize("technique", ["min_max", "l2"])
def test_normalize_scores_equal_the_reference(technique):
    for bounds in ((0.25, 3.0, 11.5, 3), (2.0, 2.0, 8.0, 2),
                   (float("inf"), float("-inf"), 0.0, 0), (0.0, 1.2, 2.4, 4)):
        values = [0.0, 0.25, 1.2, 2.0, 3.0]
        assert thyb.normalize_scores(values, bounds, technique) == \
            jhyb.normalize_scores(values, bounds, technique)


@pytest.mark.parametrize("technique", ["arithmetic_mean", "geometric_mean",
                                       "harmonic_mean"])
@pytest.mark.parametrize("weights", [None, [0.3, 0.7]])
def test_combine_scores_equal_the_reference(technique, weights):
    for scores in ([0.5, 0.25], [None, 0.8], [0.0, 0.6], [None, None],
                   [1.0, 0.001]):
        assert thyb.combine_scores(scores, weights, technique) == \
            jhyb.combine_scores(scores, weights, technique)


@pytest.mark.parametrize("normalization", ["min_max", "l2"])
@pytest.mark.parametrize("combination", ["arithmetic_mean", "geometric_mean",
                                         "harmonic_mean"])
def test_merge_equals_the_oracle(normalization, combination):
    """The bounds merge, normalization and combination of two shards'
    windows equal tests/reference_impl.ref_hybrid_scores."""
    from opensearch_tpu_torch.search.spmd import merge_hybrid_bounds
    n_sub = 2
    per_shard = []
    for shard in SHARD_CANDIDATES:
        bounds = []
        for cands in shard:
            vals = list(cands.values())
            bounds.append((min(vals), max(vals),
                           sum(v * v for v in vals), len(vals)))
        per_shard.append(bounds)
    glob = merge_hybrid_bounds(per_shard, n_sub)
    weights = [0.4, 0.6]
    docs = {}
    for i in range(n_sub):
        keys = [k for shard in SHARD_CANDIDATES for k in shard[i]]
        raw = [shard[i][k] for shard in SHARD_CANDIDATES for k in shard[i]]
        for key, ns in zip(keys, thyb.normalize_scores(raw, glob[i],
                                                       normalization)):
            docs.setdefault(key, [None] * n_sub)[i] = ns
    got = {k: thyb.combine_scores(v, weights, combination)
           for k, v in docs.items()}
    want = ref_hybrid_scores(SHARD_CANDIDATES, normalization, combination,
                             weights)
    assert got.keys() == want.keys()
    for k in got:
        assert math.isclose(got[k], want[k], rel_tol=1e-12, abs_tol=1e-12)


# ------------------------------------------------------------ the nodes

def _docs(n, seed):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(n):
        doc = {"title": " ".join(rng.choice(WORDS, 1 + i % 4)),
               "tag": ["even", "odd"][i % 2],
               "vec": rng.randn(VDIMS).round(3).tolist()}
        if i % 9:
            doc["tok"] = rng.randn(1 + i % 6, TDIMS).round(3).tolist()
        docs.append(doc)
    return docs


def _load(node, index, docs, settings=None):
    body = {"mappings": MAPPING}
    if settings:
        body["settings"] = settings
    assert node.request("PUT", f"/{index}", body)["_status"] == 200
    half = len(docs) // 2
    for part, deletes in ((range(half), ()),
                          (range(half, len(docs)), DELETED)):
        res = node.request("POST", "/_bulk", bulk_ndjson(
            index, {f"d{i}": docs[i] for i in part}, deletes))
        assert res["_status"] == 200 and not res["errors"], res
        node.request("POST", f"/{index}/_refresh")


@pytest.fixture(scope="module")
def nodes():
    docs = _docs(160, seed=3)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        for pid, body in PIPELINES.items():
            assert node.request("PUT", f"/_search/pipeline/{pid}",
                                body)["_status"] == 200
        _load(node, "hyb", docs)
        _load(node, "hyb_default", docs, {"index": {"search": {
            "default_pipeline": "minmax_arith"}}})
    return jn, tn


def _qvec(seed):
    return np.random.RandomState(seed).randn(VDIMS).round(3).tolist()


def _qtok(seed, n=3):
    return np.random.RandomState(seed).randn(n, TDIMS).round(3).tolist()


def _bodies():
    return {
        "match_knn": {"query": {"hybrid": {"queries": [
            {"match": {"title": "red fox"}},
            {"knn": {"vec": {"vector": _qvec(1), "k": 12}}}]}}},
        "match_maxsim_from_size": {"query": {"hybrid": {"queries": [
            {"match": {"title": "blue bird"}},
            {"maxsim": {"tok": {"query_vectors": _qtok(2), "k": 8}}}]}},
            "size": 5, "from": 2},
        "knn_filtered_untracked": {"query": {"hybrid": {"queries": [
            {"match": {"title": "dog"}},
            {"knn": {"vec": {"vector": _qvec(3), "k": 6,
                             "filter": {"term": {"tag": "odd"}}}}}]}},
            "track_total_hits": False, "size": 8},
        "min_score_tracked_7": {"query": {"hybrid": {"queries": [
            {"match": {"title": "quick green cat"}},
            {"knn": {"vec": {"vector": _qvec(4), "k": 10}}}]}},
            "min_score": 0.3, "track_total_hits": 7},
        "empty_sub_query": {"query": {"hybrid": {"queries": [
            {"match": {"title": "zebra"}},
            {"knn": {"vec": {"vector": _qvec(5), "k": 4}}}]}}},
    }


THREE = {"query": {"hybrid": {"queries": [
    {"match": {"title": "red dog"}},
    {"knn": {"vec": {"vector": _qvec(6), "k": 10}}},
    {"maxsim": {"tok": {"query_vectors": _qtok(7, 2), "k": 10}}}]}},
    "size": 12}


def _check(got, want, what):
    assert want["_status"] == 200 and want["hits"]["hits"], (what, want)
    assert_same_response(got, want, what, score_rtol=RTOL,
                         score_atol=ATOL)


@pytest.mark.parametrize("name", sorted(_bodies()))
@pytest.mark.parametrize("pipeline", [None, "minmax_arith", "l2_geo"])
def test_search_with_pipeline_param_equals_the_reference(nodes, name,
                                                         pipeline):
    jn, tn = nodes
    body = _bodies()[name]
    params = {} if pipeline is None else {"search_pipeline": pipeline}
    if name == "empty_sub_query" and pipeline == "l2_geo":
        params = {"search_pipeline": "_none"}
    want = jn.request("POST", "/hyb/_search", body, **params)
    got = tn.request("POST", "/hyb/_search", body, **params)
    _check(got, want, f"{name}/{pipeline}")


def test_three_sub_queries_equal_the_reference(nodes):
    jn, tn = nodes
    for params in ({}, {"search_pipeline": "minmax_harm3"}):
        want = jn.request("POST", "/hyb/_search", THREE, **params)
        got = tn.request("POST", "/hyb/_search", THREE, **params)
        _check(got, want, str(params))


@pytest.mark.parametrize("name", ["match_knn", "match_maxsim_from_size"])
def test_inline_and_index_default_pipelines_equal_the_reference(nodes,
                                                                name):
    jn, tn = nodes
    body = _bodies()[name]
    inline = {**body, "search_pipeline": PIPELINES["l2_geo"]}
    _check(tn.request("POST", "/hyb/_search", inline),
           jn.request("POST", "/hyb/_search", inline), "inline")
    _check(tn.request("POST", "/hyb_default/_search", body),
           jn.request("POST", "/hyb_default/_search", body), "default")
    # the index default differs from the defaults: it is really applied
    assert tn.request("POST", "/hyb_default/_search", body)["hits"] != \
        tn.request("POST", "/hyb/_search", body)["hits"]


def _msearch_bodies(b):
    out = []
    for i in range(b):
        subs = [{"match": {"title": " ".join(WORDS[i % 8:i % 8 + 2])}},
                {"knn": {"vec": {"vector": _qvec(10 + i), "k": 5 + i % 3}}}]
        if i % 4 == 3:
            subs[1] = {"maxsim": {"tok": {"query_vectors": _qtok(i, 2),
                                          "k": 6}}}
        body = {"query": {"hybrid": {"queries": subs}}, "size": 6}
        if i % 5 == 2:
            body["min_score"] = 0.2
        out.append(body)
    return out


@pytest.mark.parametrize("b", [1, 32])
def test_msearch_wave_equals_the_ports_single_searches(nodes, b):
    """The batched hybrid wave (one index, no pipeline: the default spec)
    gives each body the bits of the port's own `_search`, and the
    reference's single-search page within the contract."""
    jn, tn = nodes
    bodies = _msearch_bodies(b)
    got = tn.request("POST", "/_msearch", msearch_ndjson("hyb", bodies))
    for i, body in enumerate(bodies):
        item = got["responses"][i]
        one = tn.request("POST", "/hyb/_search", body)
        assert item["status"] == 200
        assert [(h["_id"], h["_score"]) for h in item["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in one["hits"]["hits"]]
        assert item["hits"]["total"] == one["hits"]["total"]
        _check(one, jn.request("POST", "/hyb/_search", body), f"[{i}]")


def test_msearch_pipeline_items_equal_the_reference(nodes):
    """Items that name a pipeline, and any item on an index with a default
    pipeline, take the per-item search path: the reference's responses,
    items in order, a plain body beside them."""
    jn, tn = nodes
    bodies = _msearch_bodies(4)
    bodies[1] = {**bodies[1], "search_pipeline": "l2_geo"}
    bodies[2] = {"query": {"match": {"title": "red"}}, "size": 3}
    for index in ("hyb", "hyb_default"):
        payload = msearch_ndjson(index, bodies)
        want = jn.request("POST", "/_msearch", payload)
        got = tn.request("POST", "/_msearch", payload)
        assert len(got["responses"]) == 4
        assert_same_response(got, want, index, score_rtol=RTOL,
                         score_atol=ATOL)


# ------------------------------------------------------------- errors

ERROR_BODIES = {
    "nested": {"query": {"bool": {"must": [
        {"hybrid": {"queries": [{"match_all": {}}]}}]}}},
    "sort": {"query": {"hybrid": {"queries": [{"match_all": {}}]}},
             "sort": [{"tag": "asc"}]},
    "aggs": {"query": {"hybrid": {"queries": [{"match_all": {}}]}},
             "aggs": {"t": {"terms": {"field": "tag"}}}},
    "empty": {"query": {"hybrid": {"queries": []}}},
    "too_many": {"query": {"hybrid": {"queries": [{"match_all": {}}] * 6}}},
    "unknown_key": {"query": {"hybrid": {"queries": [{"match_all": {}}],
                                         "pagination_depth": 3}}},
    "window": {"query": {"hybrid": {"queries": [{"match_all": {}}]}},
               "from": 9995, "size": 10},
}


@pytest.mark.parametrize("name", sorted(ERROR_BODIES))
def test_error_bodies_equal_the_reference(nodes, name):
    jn, tn = nodes
    body = ERROR_BODIES[name]
    want = jn.request("POST", "/hyb/_search", body)
    got = tn.request("POST", "/hyb/_search", body)
    assert want["_status"] == 400, want
    assert got == want


def test_weights_count_mismatch_equals_the_reference(nodes):
    jn, tn = nodes
    body = _bodies()["match_knn"]
    want = jn.request("POST", "/hyb/_search", body,
                      search_pipeline="minmax_harm3")
    got = tn.request("POST", "/hyb/_search", body,
                     search_pipeline="minmax_harm3")
    assert want["_status"] == 400 and got == want


PIPELINE_ERRORS = {
    "unknown_technique": {"phase_results_processors": [
        {"normalization-processor": {"normalization": {
            "technique": "zscore"}}}]},
    "unknown_combination": {"phase_results_processors": [
        {"normalization-processor": {"combination": {
            "technique": "max"}}}]},
    "negative_weight": {"phase_results_processors": [
        {"normalization-processor": {"combination": {
            "parameters": {"weights": [0.5, -1]}}}}]},
    "unknown_key": {"weird_key": []},
    "unknown_processor": {"phase_results_processors": [{"nope": {}}]},
    "not_single_key": {"phase_results_processors": [{"a": {}, "b": {}}]},
}


@pytest.mark.parametrize("name", sorted(PIPELINE_ERRORS))
def test_pipeline_errors_equal_the_reference(name):
    body = PIPELINE_ERRORS[name]
    want = JNode().request("PUT", "/_search/pipeline/bad", body)
    got = TNode(device="cpu").request("PUT", "/_search/pipeline/bad", body)
    assert want["_status"] == 400, want
    assert got == want


def test_pipeline_crud_equals_the_reference():
    out = []
    for node in (JNode(), TNode(device="cpu")):
        steps = [node.request("PUT", "/_search/pipeline/p1",
                              PIPELINES["l2_geo"]),
                 node.request("PUT", "/_search/pipeline/p2",
                              PIPELINES["minmax_arith"]),
                 node.request("GET", "/_search/pipeline/p1"),
                 node.request("GET", "/_search/pipeline"),
                 node.request("GET", "/_search/pipeline/p*"),
                 node.request("GET", "/_search/pipeline/nope"),
                 node.request("DELETE", "/_search/pipeline/p1"),
                 node.request("GET", "/_search/pipeline/p1"),
                 node.request("DELETE", "/_search/pipeline/p1")]
        node.request("PUT", "/i", {"mappings": MAPPING})
        steps.append(node.request("POST", "/i/_search", {},
                                  search_pipeline="nope"))
        out.append(steps)
    want, got = out
    assert [s["_status"] for s in want] == [200, 200, 200, 200, 200, 404,
                                           200, 404, 404, 404]
    assert got == want


# ---------------------------------------------------- the fused row

def test_fused_row_equals_the_references():
    """One segment's fused hybrid row, the port's (K3 windows, K12's plain
    version) against the reference's build_hybrid_query_phase on the same
    documents: ords, counts and the union total exactly; min and max to
    rtol 1e-6; the sum of squares within (k * 2^-24 + 2e-6) * sum s^2
    (the reference's reduction order is not fixed, and each knn score may
    differ from the reference's by an ulp or so)."""
    docs = _docs(120, seed=8)
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        node.request("PUT", "/one", {"mappings": MAPPING})
        node.request("POST", "/_bulk", bulk_ndjson(
            "one", {f"d{i}": d for i, d in enumerate(docs)}, ("d4",)))
        node.request("POST", "/one/_refresh")
    body = _bodies()["match_knn"]["query"]
    k = 16
    rows = []
    for node, comp_mod, parse in (
            (jn, jcompile, None), (tn, tcompile, tdsl.parse_query)):
        ex = node.indices.get("one").shards[0].executor
        stats, segs, device = ex.reader.stats_snapshot()
        arrays, meta = device[0]
        if parse is None:
            from opensearch_tpu.search import dsl as jdsl
            hq = jdsl.parse_query(body)
            plans = [comp_mod.Compiler(ex.reader.mapper, stats).compile(
                q, segs[0], meta) for q in hq.queries]
            flat = []
            for p in plans:
                p.flatten_inputs(flat)
            row = jexecutor.build_hybrid_query_phase(plans, meta, k)(
                arrays, flat, np.float32(-np.inf))
            rows.append(np.asarray(row))
            continue
        hq = parse(body)
        plans = [comp_mod.Compiler(ex.reader.mapper, stats).compile(
            q, segs[0], meta) for q in hq.queries]
        flat = []
        for p in plans:
            p.flatten_inputs(flat)
        stacked, treedef = texecutor.stack_flat_inputs([flat])
        leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in stacked]
        inputs = texecutor.unflatten_inputs(treedef, leaves)
        row = texecutor.build_hybrid_query_phase(plans, meta, k)(
            arrays, inputs, torch.tensor([float("-inf")]))
        rows.append(row[0].numpy())
    want, got = rows
    assert got.shape == want.shape == (2 * (2 * k + 4) + 1,)
    for i in range(2):
        off = i * (2 * k + 4)
        gs, ws = got[off:off + k], want[off:off + k]
        assert np.array_equal(got[off + k:off + 2 * k].view(np.int32),
                              want[off + k:off + 2 * k].view(np.int32))
        np.testing.assert_allclose(gs, ws, rtol=1e-6)
        cnt = got[off + 2 * k:off + 2 * k + 1].view(np.int32)[0]
        assert cnt == want[off + 2 * k:off + 2 * k + 1].view(np.int32)[0]
        assert cnt > 0
        np.testing.assert_allclose(got[off + 2 * k + 1:off + 2 * k + 3],
                                   want[off + 2 * k + 1:off + 2 * k + 3],
                                   rtol=1e-6)
        ssq = float(want[off + 2 * k + 3])
        assert abs(float(got[off + 2 * k + 3]) - ssq) <= \
            (k * 2.0 ** -24 + 2e-6) * ssq
    assert got[-1:].view(np.int32)[0] == want[-1:].view(np.int32)[0]
