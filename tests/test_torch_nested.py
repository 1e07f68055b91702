"""Nested documents in opensearch_tpu_torch held against opensearch_tpu:
the block join (`nested`, every score mode, boost, ignore_unmapped, no
leakage across objects, inside a bool beside a root field), block deletes
before and after a refresh, `inner_hits` (size, from, name, two sections),
the `nested` / `reverse_nested` aggregations with every kind under them,
`_msearch`, and a 5-shard index taking the reference's route. Then the
plain versions of K22 (nested_join), K23 (nested_aggs) and K24
(binned_scatter) against the reference's own functions on seeded inputs.

Contract: ids, order, totals and counts exactly; scores to rtol 2e-6
(K22 folds a root's rows in the reference's row order, so in practice they
agree exactly); every summed value in the corpora is an integer with
partial sums below 2^24, so sums are exact in any order and compare
exactly too."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.indices.request_cache import REQUEST_CACHE
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import spmd as jspmd
from opensearch_tpu.search.aggs import engine as jengine
from opensearch_tpu.search.compile import Plan as JPlan
from opensearch_tpu.search.plan_eval import _eval_plan as j_eval_plan

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import binned, nested
from opensearch_tpu_torch.ops.device_segment import root_child_csr
from opensearch_tpu_torch.search import spmd as tspmd

from test_torch_common import (NESTED_AGG_BODIES, NESTED_MODES, QA_BASE,
                               assert_same_response, bulk_ndjson,
                               f32_sum_bound, load_qa_index,
                               matrix_stats_tol, qa_corpus, qa_match_body)

RTOL = 2e-6

BLOG_MAPPING = {"mappings": {"properties": {
    "title": {"type": "text"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"},
        "stars": {"type": "integer"},
        "text": {"type": "text"}}}}}}
BLOG_DOCS = {
    "1": {"title": "jax on tpus", "comments": [
        {"author": "alice", "stars": 5, "text": "great post"},
        {"author": "bob", "stars": 1, "text": "meh"},
        {"author": "carol", "stars": 4, "text": "great insight"}]},
    "2": {"title": "columnar formats", "comments": [
        {"author": "alice", "stars": 1, "text": "needs work"},
        {"author": "bob", "stars": 5, "text": "great thread"}]},
    "3": {"title": "no comments here"},
    "4": {"title": "jax again", "comments": {"author": "dave", "stars": 3,
                                            "text": "great great"}},
}


def _load_blog(node, deletes_before=(), deletes_after=()):
    assert node.request("PUT", "/blog", BLOG_MAPPING)["_status"] == 200
    res = node.request("POST", "/_bulk",
                       bulk_ndjson("blog", BLOG_DOCS, deletes_before))
    assert not res["errors"], res
    node.request("POST", "/blog/_refresh")
    if deletes_after:
        node.request("POST", "/_bulk",
                     bulk_ndjson("blog", {}, deletes_after))
        node.request("POST", "/blog/_refresh")


@pytest.fixture(scope="module")
def blog():
    jn, tn = JNode(), TNode(device="cpu")
    for n in (jn, tn):
        _load_blog(n)
    return jn, tn


@pytest.fixture(scope="module")
def qa():
    jn, tn = JNode(), TNode(device="cpu")
    for n in (jn, tn):
        load_qa_index(n)
    return jn, tn


def _same(nodes, body, path="/blog/_search", **kw):
    jn, tn = nodes
    REQUEST_CACHE.clear()
    want = jn.request("POST", path, body)
    got = tn.request("POST", path, body)
    assert want["_status"] == 200, want
    assert_same_response(got, want, score_rtol=RTOL,
                         agg_sum_tol=matrix_stats_tol(want), **kw)
    return want


def test_match_all_counts_only_roots(blog):
    want = _same(blog, {"query": {"match_all": {}}, "size": 10})
    assert want["hits"]["total"]["value"] == 4


@pytest.mark.parametrize("mode", NESTED_MODES)
def test_score_modes(blog, mode):
    want = _same(blog, {"query": {"nested": {
        "path": "comments", "score_mode": mode, "boost": 1.5,
        "query": {"match": {"comments.text": "great post"}}}}})
    assert {h["_id"] for h in want["hits"]["hits"]} == {"1", "2", "4"}


def test_no_leakage_across_objects(blog):
    """alice and stars <= 1 co-occur across two comments of doc 1 only in
    different objects: only doc 2 matches."""
    want = _same(blog, {"query": {"nested": {"path": "comments", "query": {
        "bool": {"must": [{"term": {"comments.author": "alice"}},
                          {"range": {"comments.stars": {"lte": 1}}}]}}}}})
    assert [h["_id"] for h in want["hits"]["hits"]] == ["2"]


def test_nested_in_bool_with_root_field(blog):
    want = _same(blog, {"query": {"bool": {
        "must": [{"match": {"title": "jax"}}],
        "filter": [{"nested": {"path": "comments", "query": {
            "range": {"comments.stars": {"gte": 5}}}}}]}}})
    assert [h["_id"] for h in want["hits"]["hits"]] == ["1"]


@pytest.mark.parametrize("body", [
    {"query": {"term": {"comments.author": "alice"}}},
    {"query": {"nested": {"path": "nope", "ignore_unmapped": True,
                          "query": {"match_all": {}}}}},
    {"query": {"nested": {"path": "nope", "query": {"match_all": {}}}}},
    {"query": {"nested": {"path": "comments", "score_mode": "median",
                          "query": {"match_all": {}}}}},
    {"query": {"nested": {"path": "comments", "query": {"nested": {
        "path": "comments", "query": {"match_all": {}}}}}}},
], ids=["flat_subfield", "ignore_unmapped", "unmapped", "bad_mode",
        "nested_in_nested"])
def test_edges_and_errors(blog, body):
    jn, tn = blog
    want = jn.request("POST", "/blog/_search", body)
    got = tn.request("POST", "/blog/_search", body)
    assert got["_status"] == want["_status"]
    if want["_status"] == 200:
        assert_same_response(got, want, score_rtol=RTOL)
    else:
        assert got["error"]["type"] == want["error"]["type"]


@pytest.mark.parametrize("when", ["before_refresh", "after_refresh"])
def test_delete_kills_the_block(when):
    """A deleted root takes its nested rows with it, in the buffer and in
    a sealed segment."""
    nodes = JNode(), TNode(device="cpu")
    for n in nodes:
        if when == "before_refresh":
            _load_blog(n, deletes_before=["1"])
        else:
            _load_blog(n, deletes_after=["1"])
    for body in ({"query": {"nested": {"path": "comments", "query": {
                     "term": {"comments.author": "bob"}}}}},
                 {"size": 0, "aggs": {"c": {"nested": {"path": "comments"},
                                            "aggs": {"a": {"terms": {
                                                "field": "comments.author"
                                            }}}}}},
                 {"query": {"match_all": {}}}):
        _same(nodes, body)


@pytest.mark.parametrize("inner", [
    {}, {"size": 1, "name": "top_comment"}, {"from": 1, "size": 2},
    {"size": 0}], ids=["default", "size_name", "from", "size0"])
def test_inner_hits(blog, inner):
    want = _same(blog, {"query": {"nested": {
        "path": "comments", "query": {"match": {"comments.text": "great"}},
        "inner_hits": inner}}})
    name = inner.get("name", "comments")
    assert all(name in h["inner_hits"] for h in want["hits"]["hits"])


def test_inner_hits_two_sections_and_duplicate_names(blog):
    body = {"query": {"bool": {"should": [
        {"nested": {"path": "comments", "inner_hits": {"name": "good"},
                    "query": {"range": {"comments.stars": {"gte": 4}}}}},
        {"nested": {"path": "comments", "inner_hits": {"name": "bad"},
                    "query": {"range": {"comments.stars": {"lte": 1}}}}}]}}}
    _same(blog, body)
    for q in body["query"]["bool"]["should"]:
        q["nested"]["inner_hits"] = {"name": "same"}
    jn, tn = blog
    want = jn.request("POST", "/blog/_search", body)
    got = tn.request("POST", "/blog/_search", body)
    assert got["_status"] == want["_status"] == 400
    assert got["error"]["type"] == want["error"]["type"]


def test_no_inner_hits_key_without_request(blog):
    want = _same(blog, {"query": {"nested": {
        "path": "comments", "query": {"match": {"comments.text": "great"}}}}})
    assert all("inner_hits" not in h for h in want["hits"]["hits"])


def test_blog_aggregations(blog):
    _same(blog, {"size": 0, "aggs": {"c": {
        "nested": {"path": "comments"},
        "aggs": {"by_author": {"terms": {"field": "comments.author"},
                               "aggs": {"roots": {"reverse_nested": {}}}},
                 "avg_stars": {"avg": {"field": "comments.stars"}}}}}})
    _same(blog, {"size": 0, "query": {"match": {"title": "jax"}},
                 "aggs": {"c": {"nested": {"path": "comments"}, "aggs": {
                     "mx": {"max": {"field": "comments.stars"}}}}}})


# ------------------------------------------------------- the Q&A corpus

@pytest.mark.parametrize("mode", NESTED_MODES)
def test_qa_score_modes(qa, mode):
    for user, day in ((0, 0), (1, 200), (3, 400)):
        _same(qa, qa_match_body(user, day, mode), "/qa/_search")


@pytest.mark.parametrize("inner", [{"size": 3}, {"size": 2, "from": 1,
                                                 "name": "ans"}])
def test_qa_inner_hits(qa, inner):
    for user in (0, 2):
        _same(qa, qa_match_body(user, 100, "avg", inner, size=20),
              "/qa/_search")


@pytest.mark.parametrize("name", sorted(NESTED_AGG_BODIES))
def test_qa_aggregations(qa, name):
    """Each body alone and under a query on a root field."""
    aggs = {"n": NESTED_AGG_BODIES[name]}
    _same(qa, {"size": 0, "aggs": aggs}, "/qa/_search")
    _same(qa, {"size": 0, "query": {"range": {"votes": {"gte": 20}}},
               "aggs": aggs}, "/qa/_search")


def test_qa_msearch(qa):
    """One batch of nested bodies (the envelope) and an inner_hits item
    (the general path)."""
    jn, tn = qa
    bodies = [qa_match_body(u, 30 * u, NESTED_MODES[u % 5])
              for u in range(6)]
    bodies.append(qa_match_body(0, 0, "max", {"size": 2}))
    bodies.append({"size": 0, "aggs": {"n": NESTED_AGG_BODIES["tree"]}})
    lines = "".join(json.dumps({"index": "qa"}) + "\n" + json.dumps(b)
                    + "\n" for b in bodies)
    REQUEST_CACHE.clear()
    want = jn.request("POST", "/_msearch", lines)
    got = tn.request("POST", "/_msearch", lines)
    for r in want["responses"] + got["responses"]:
        r.pop("_page_cursor", None)
    assert_same_response(got, want, score_rtol=RTOL)


def test_five_shards_take_the_reference_route():
    """A nested query and a nested aggregation on a 5-shard index: the
    same responses and the same route (the multi-shard program where the
    rows agree, else the host loop) as the reference."""
    nodes = JNode(), TNode(device="cpu")
    for n in nodes:
        # one segment a shard: 5 rows, under both packages' row caps
        load_qa_index(n, "qa5", shards=5, two_refreshes=False)
    routes = []
    for body in (qa_match_body(0, 0, "sum"),
                 qa_match_body(1, 50, "avg", {"size": 2}),
                 {"size": 0, "aggs": {"n": NESTED_AGG_BODIES["terms_user"]}}):
        j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        _same(nodes, body, "/qa5/_search")
        assert tspmd.SPMD_QUERIES[0] - t0 == jspmd.SPMD_QUERIES.value - j0
        routes.append(jspmd.SPMD_QUERIES.value - j0)
    # the program serves the rows that agree (the query bodies)
    assert routes[0] == 1


# ------------------------------- the plain versions against the reference

def _blocks(rng, d_pad, n_roots):
    parent = np.full(d_pad, -1, np.int32)
    paths = np.full(d_pad, -1, np.int32)
    perm = rng.permutation(d_pad)
    free = list(perm[n_roots:])
    for r in sorted(perm[:n_roots]):
        for _ in range(int(rng.integers(0, 6))):
            if free:
                c = free.pop()
                parent[c] = r
                paths[c] = int(rng.integers(0, 2))
    live = rng.random(d_pad) < 0.9
    return parent, paths, live


@pytest.mark.parametrize("mode", NESTED_MODES)
def test_nested_join_plain_against_reference(mode):
    """K22's plain version against the reference's `nested` branch of
    _eval_plan, one query at a time: matches exactly, scores to RTOL."""
    rng = np.random.default_rng(22)
    bsz, d_pad = 4, 512
    parent, paths, live = _blocks(rng, d_pad, 120)
    start, rows = root_child_csr(parent, d_pad)
    child_s = (rng.random((bsz, d_pad)) * 5).astype(np.float32)
    child_m = rng.random((bsz, d_pad)) < 0.6
    path_ord = np.array([0, 1, -1, 0], np.int32)
    boost = np.array([1.0, 2.5, 1.0, 0.75], np.float32)
    got_s, got_m = nested.nested_join_plain(
        torch.from_numpy(child_s), torch.from_numpy(child_m),
        torch.from_numpy(live), torch.from_numpy(paths),
        torch.from_numpy(parent), torch.from_numpy(start),
        torch.from_numpy(rows), torch.from_numpy(path_ord),
        torch.from_numpy(boost), mode)
    seg = {"live": jnp.asarray(live), "nested_path": jnp.asarray(paths),
           "parent_ptr": jnp.asarray(parent)}
    plan = JPlan("nested", static=(mode,), children=[JPlan("precomputed")])
    for b in range(bsz):
        inputs = [{"path_ord": jnp.asarray(path_ord[b]),
                   "boost": jnp.asarray(boost[b])},
                  {"scores": jnp.asarray(child_s[b]),
                   "matches": jnp.asarray(child_m[b])}]
        want_s, want_m = j_eval_plan(plan, seg, inputs, [0])
        np.testing.assert_array_equal(got_m[b].numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_s[b].numpy(), np.asarray(want_s),
                                   rtol=RTOL, atol=0)


def test_nested_aggs_plain_against_reference():
    """K23's plain versions against the reference's nested /
    reverse_nested kinds (their counts, the root buckets through a
    sub-aggregation) on a dynamic parent context."""
    rng = np.random.default_rng(23)
    bsz, d_pad, card = 3, 640, 9
    parent, paths, live = _blocks(rng, d_pad, 150)
    mask = rng.random((bsz, d_pad)) < 0.8
    peff = rng.integers(-1, card, (bsz, d_pad)).astype(np.int32)
    path_ord = np.array([0, 1, 0], np.int32)
    t = {k: torch.from_numpy(v) for k, v in (
        ("live", live), ("paths", paths), ("parent", parent))}
    own, child_eff, counts = nested.nested_agg_plain(
        torch.from_numpy(mask), torch.from_numpy(peff), t["live"],
        t["paths"], t["parent"], torch.from_numpy(path_ord), card)
    r_own, r_eff, r_counts = nested.reverse_nested_agg_plain(
        torch.from_numpy(mask), torch.from_numpy(peff), t["parent"], card)
    seg = {"live": jnp.asarray(live), "nested_path": jnp.asarray(paths),
           "parent_ptr": jnp.asarray(parent)}
    for b in range(bsz):
        ctx = (jnp.asarray(peff[b]), None, card, False)
        outs = []
        jengine._eval_agg(jengine.AggPlan(
            "n", "nested", inputs={"path_ord": path_ord[b]}), seg,
            [{"path_ord": jnp.asarray(path_ord[b])}], [0],
            jnp.asarray(mask[b]), ctx, outs)
        jengine._eval_agg(jengine.AggPlan("r", "reverse_nested"), seg,
                          [{}], [0], jnp.asarray(mask[b]), ctx, outs)
        np.testing.assert_array_equal(counts[b].numpy(),
                                      np.asarray(outs[0]["counts"]))
        np.testing.assert_array_equal(r_counts[b].numpy(),
                                      np.asarray(outs[1]["counts"]))
        # the reference's own / child_eff / root_eff, written out
        safe = np.where(parent >= 0, parent, 0)
        want_own = ((paths == path_ord[b]) & (path_ord[b] >= 0) & live
                    & (parent >= 0) & mask[b][safe] & (peff[b][safe] >= 0))
        np.testing.assert_array_equal(own[b].numpy(), want_own)
        np.testing.assert_array_equal(
            child_eff[b].numpy(), np.where(want_own, peff[b][safe], -1))
        sel = mask[b] & (peff[b] >= 0) & (parent >= 0)
        want_root = np.full(d_pad + 1, -1)
        np.maximum.at(want_root, np.where(sel, parent, d_pad),
                      np.where(sel, peff[b], -1))
        np.testing.assert_array_equal(r_eff[b].numpy(), want_root[:d_pad])
        np.testing.assert_array_equal(r_own[b].numpy(), want_root[:d_pad] >= 0)


def test_binned_scatter_plain_against_reference():
    """K24's plain version against the reference's _binned_sums on its
    scatter branch (dynamic bins): counts exactly; f32 sums within twice
    the bound n * 2^-24 * sum|v| (two orders of one sum); min / max
    exactly against the reference's .at[].min / max."""
    rng = np.random.default_rng(24)
    bsz, n, total = 3, 3000, 11
    lanes = rng.integers(-1, total + 1, (bsz, n)).astype(np.int32)
    values = (rng.standard_normal(n) * 50).astype(np.float32)
    got = binned.binned_scatter_plain(torch.from_numpy(lanes), total,
                                      torch.from_numpy(values),
                                      ("cnt", "sum", "sumsq", "min", "max"))
    for b in range(bsz):
        ok = (lanes[b] >= 0) & (lanes[b] < total)
        bl = jnp.asarray(lanes[b])
        cnt, s, s2 = jengine._binned_sums(
            bl, total, [(jnp.asarray(ok), jnp.int32),
                        (jnp.asarray(np.where(ok, values, 0.0)),
                         jnp.float32),
                        (jnp.asarray(np.where(ok, values * values, 0.0)),
                         jnp.float32)], False)
        np.testing.assert_array_equal(got["cnt"][b].numpy(), np.asarray(cnt))
        for key, want, v in (("sum", s, values),
                             ("sumsq", s2, values * values)):
            mag = np.zeros(total + 1)
            np.add.at(mag, np.where(ok, lanes[b], total), np.abs(v))
            bound = 2 * f32_sum_bound(1, 1) * np.asarray(cnt) * mag[:total]
            assert np.all(np.abs(got[key][b].numpy().astype(np.float64)
                                 - np.asarray(want)) <= bound + 1e-30), key
        eff = jnp.where(jnp.asarray(ok), bl, total)
        mn = jnp.full(total, jnp.inf, jnp.float32).at[eff].min(
            jnp.asarray(values), mode="drop")
        mx = jnp.full(total, -jnp.inf, jnp.float32).at[eff].max(
            jnp.asarray(values), mode="drop")
        np.testing.assert_array_equal(got["min"][b].numpy(), np.asarray(mn))
        np.testing.assert_array_equal(got["max"][b].numpy(), np.asarray(mx))


def test_qa_corpus_shape():
    docs = qa_corpus()
    n_ans = [len(d.get("answers", [])) for d in docs]
    assert max(n_ans) <= 8 and 1.5 < np.mean(n_ans) < 3.5
    assert all(a["date"] > QA_BASE for d in docs for a in d.get("answers", []))
