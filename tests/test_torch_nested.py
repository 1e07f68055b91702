"""Nested documents in opensearch_tpu_torch held against opensearch_tpu:
the block join (`nested`, every score mode, boost, ignore_unmapped, no
leakage across objects, inside a bool beside a root field), block deletes
before and after a refresh, `inner_hits` (size, from, name, two sections),
the `nested` / `reverse_nested` aggregations with every kind under them,
`_msearch`, and a 5-shard index taking the reference's route. Then the
plain versions of K22 (nested_join), K23 (nested_aggs) and K24
(binned_scatter) against the reference's own functions on seeded inputs,
and K23's reverse_nested walk of the static root CSR (the CUDA kernel's
steps, mirrored in numpy) against the reference's reverse_nested kind.

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
                               assert_same_response, blocked_layout,
                               bulk_ndjson,
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


# ------------------------- K23 reverse_nested's CSR walk, mirrored in numpy

def reverse_walk_mirror(mask, peff, start, rows, card,
                        window=nested.REVERSE_BITMAP_BUCKETS):
    """K23's reverse_nested walk (ops/csrc/nested_aggs.cu) step by step:
    each row d walks its CSR rows child_start[d] .. child_start[d + 1];
    up to REVERSE_HEAVY_ROWS rows one thread does, its distinct buckets a
    64-bit set (card <= REVERSE_BITSET_CARD) or a test of each selected
    row's bucket against the root's earlier selected rows; a bigger root
    the CTA does, through a bitmap of `window` buckets at a time. Returns
    (own, root_eff, counts) and the routes' root counts."""
    bsz, d_pad = mask.shape
    root_eff = np.full((bsz, d_pad), -1, np.int32)
    counts = np.zeros((bsz, card), np.int32)
    routes = {"bitset": 0, "earlier": 0, "heavy": 0, "windows": 0}
    for b in range(bsz):
        for d in np.nonzero(start[1:] > start[:-1])[0]:
            walk = rows[start[d]:start[d + 1]]
            buckets = np.where(mask[b, walk], peff[b, walk], -1)
            sel = buckets[buckets >= 0]
            best = int(sel.max()) if len(sel) else -1
            if len(walk) > nested.REVERSE_HEAVY_ROWS:
                routes["heavy"] += 1
                for w0 in range(0, card, window):
                    routes["windows"] += 1
                    bitmap = np.zeros(min(card - w0, window), bool)
                    for e in sel:
                        if w0 <= e < w0 + len(bitmap) and not bitmap[e - w0]:
                            bitmap[e - w0] = True
                            counts[b, e] += 1
            elif card <= nested.REVERSE_BITSET_CARD:
                routes["bitset"] += 1
                seen = 0
                for e in sel:
                    if e < card and not (seen >> int(e)) & 1:
                        seen |= 1 << int(e)
                        counts[b, e] += 1
            else:
                routes["earlier"] += 1
                for i, e in enumerate(buckets):
                    if 0 <= e < card and not np.any(buckets[:i] == e):
                        counts[b, e] += 1
            root_eff[b, d] = best
    return root_eff >= 0, root_eff, counts, routes


def _walk_blocks(rng, d_pad, n_roots, heavy_rows):
    """_blocks plus one root of `heavy_rows` nested rows and the walk's
    edges: roots of REVERSE_HEAVY_ROWS rows and one more, and of 9-16 rows
    (a second batch of the thread's walk); then whole blocks deleted."""
    parent, paths, _live = _blocks(rng, d_pad, n_roots)
    roots = np.nonzero((parent < 0) & (np.bincount(
        parent[parent >= 0], minlength=d_pad) == 0))[0]
    free = list(rng.permutation(np.nonzero((parent < 0) & ~np.isin(
        np.arange(d_pad), parent[parent >= 0]))[0]))
    free = [r for r in free if r not in set(roots[:4].tolist())]
    for root, k in zip(roots[:4], (heavy_rows, nested.REVERSE_HEAVY_ROWS,
                                   nested.REVERSE_HEAVY_ROWS + 1, 13)):
        for _ in range(k):
            c = free.pop()
            parent[c] = root
            paths[c] = int(rng.integers(0, 2))
    # deleted blocks: a root and its rows not live
    live = np.ones(d_pad, bool)
    for root in rng.choice(np.unique(parent[parent >= 0]), 20,
                           replace=False):
        live[root] = False
        live[parent == root] = False
    return parent, paths, live


@pytest.fixture(scope="module")
def walk_layout():
    rng = np.random.default_rng(230)
    d_pad = 16384
    parent, paths, live = _walk_blocks(rng, d_pad, 1200, 10000)
    start, rows = root_child_csr(parent, d_pad)
    return parent, paths, live, start, rows


@pytest.mark.parametrize("card", [9, 64, 65, 300])
@pytest.mark.parametrize("window", ["kernel", 64])
def test_reverse_nested_walk_mirror_against_reference(walk_layout, card,
                                                      window):
    """K23's CSR walk, mirrored, against the reference's reverse_nested
    kind (its counts) and its root buckets written out, exactly, on
    blocks of two paths with a 10,000-row root, deleted blocks, roots with
    no selected row and an all-false query; at the kernel's bitmap window
    and at 64 buckets a window (several windows where card > 64)."""
    parent, paths, live, start, rows = walk_layout
    d_pad = parent.shape[0]
    rng = np.random.default_rng(card)
    bsz = 4
    mask = (rng.random((bsz, d_pad)) < 0.6) & live
    mask[3] = False                                  # an all-false query
    peff = rng.integers(-1, card, (bsz, d_pad)).astype(np.int32)
    win = nested.REVERSE_BITMAP_BUCKETS if window == "kernel" else window
    own, root_eff, counts, routes = reverse_walk_mirror(
        mask, peff, start, rows, card, win)
    assert routes["heavy"] == 2 * bsz               # 10,000 rows and 33
    assert routes["windows"] == 2 * bsz * -(-card // win)
    assert routes["bitset" if card <= 64 else "earlier"] > 0
    p_own, p_eff, p_counts = nested.reverse_nested_agg_plain(
        torch.from_numpy(mask), torch.from_numpy(peff),
        torch.from_numpy(parent), card)
    np.testing.assert_array_equal(p_counts.numpy(), counts)
    np.testing.assert_array_equal(p_eff.numpy(), root_eff)
    np.testing.assert_array_equal(p_own.numpy(), own)
    seg = {"live": jnp.asarray(live), "nested_path": jnp.asarray(paths),
           "parent_ptr": jnp.asarray(parent)}
    for b in range(bsz):
        ctx = (jnp.asarray(peff[b]), None, card, False)
        outs = []
        jengine._eval_agg(jengine.AggPlan("r", "reverse_nested"), seg,
                          [{}], [0], jnp.asarray(mask[b]), ctx, outs)
        np.testing.assert_array_equal(counts[b],
                                      np.asarray(outs[0]["counts"]))
        sel = mask[b] & (peff[b] >= 0) & (parent >= 0)
        want_root = np.full(d_pad + 1, -1)
        np.maximum.at(want_root, np.where(sel, parent, d_pad),
                      np.where(sel, peff[b], -1))
        np.testing.assert_array_equal(root_eff[b], want_root[:d_pad])
    assert not counts[3].any() and (root_eff[3] == -1).all()
    heavy = np.argmax(np.diff(start))
    assert np.diff(start)[heavy] == 10000 and own[:3, heavy].all()


def test_reverse_nested_walk_thresholds_match_the_kernel():
    """The mirror's thresholds are the kernel's own constants."""
    import re
    from pathlib import Path
    src = (Path(nested.__file__).parent / "csrc" / "nested_aggs.cu") \
        .read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("HEAVY_ROWS") == nested.REVERSE_HEAVY_ROWS
    assert const("BITSET_CARD") == nested.REVERSE_BITSET_CARD
    assert const("BITMAP_WORDS") * 32 == nested.REVERSE_BITMAP_BUCKETS
    assert "key_sort.cuh" not in src


# ------------------- K23 nested's and K22's row tiles, mirrored in numpy

KERNEL_TILES = {"threads": 256, "agg_tile": nested.NESTED_TILE_ROWS,
                "agg_stage": nested.NESTED_STAGE_ROWS,
                "agg_group": nested.NESTED_QUERY_GROUP,
                "cnt_cap": nested.NESTED_CNT_CAP,
                "join_tile": nested.JOIN_TILE_ROWS,
                "join_stage": nested.JOIN_STAGE_ROWS,
                "pos_cap": nested.JOIN_POS_CAP,
                "heavy_rows": nested.JOIN_HEAVY_ROWS,
                "chunk": nested.JOIN_CHUNK,
                "join_group": nested.JOIN_QUERY_GROUP}
# the same walks at small constants: many tiles, query groups, windows
# past the stage and heavy roots at a test's size
SMALL_TILES = {"threads": 32, "agg_tile": 256, "agg_stage": 320,
               "agg_group": 3, "cnt_cap": 16, "join_tile": 256,
               "join_stage": 320, "pos_cap": 300, "heavy_rows": 8,
               "chunk": 16, "join_group": 3}


def _window(keep_rows, tile_rows, vec):
    """A tile's row window over the rows it needs (aligned to 16 rows
    where the kernel copies 16 bytes at a time): (a0, span)."""
    if not len(keep_rows):
        return 0, 0
    lo, hi = int(keep_rows.min()), int(keep_rows.max())
    a0 = lo & ~15 if vec else lo
    return a0, (((hi + 16) & ~15) if vec else hi + 1) - a0


def nested_tile_mirror(mask, peff, live, paths, parent, path_ord, card,
                       c=KERNEL_TILES, vec=True):
    """K23's nested_agg (ops/csrc/nested_aggs.cu nested_kernel) step by
    step: a CTA a (tile of c["agg_tile"] rows, group of c["agg_group"]
    queries); thread t's rows the two quads d0 + g * 4 threads + 4 t + i;
    the tile's static rows once; its parent window staged per query where
    it spans at most c["agg_stage"] rows (each row reads its root from the
    window), else gathered; counts by one warp reduction where the warp's
    rows took one bucket, else each thread's runs of equal buckets, into
    the CTA's counters up to c["cnt_cap"] buckets (one global atomic per
    (CTA, query, nonzero bucket)), past it straight to the counts. Returns
    (own, child_eff, counts, stats)."""
    bsz, d_pad = mask.shape
    nt, tile = c["threads"], c["agg_tile"]
    own = np.zeros((bsz, d_pad), bool)
    child_eff = np.full((bsz, d_pad), -1, np.int32)
    counts = np.zeros((bsz, card), np.int64)
    stats = dict.fromkeys(("staged", "gathered", "empty", "skipped",
                           "reductions", "runs", "global_atomics"), 0)
    t = np.arange(nt)
    for d0 in range(0, d_pad, tile):
        # [thread, 8] rows: quad g, row i
        rows = np.stack([d0 + g * 4 * nt + 4 * t + i for g in range(2)
                         for i in range(4)], 1)
        inside = rows < d_pad
        safe = np.where(inside, rows, 0)
        p = np.where(inside & live[safe], parent[safe], -1)
        path = np.where(inside, paths[safe], -1)
        a0, span = _window(p[p >= 0], tile, vec)
        staged = (p >= 0).any() and span <= c["agg_stage"]
        stats["staged" if staged else "gathered" if (p >= 0).any()
              else "empty"] += 1
        for q0 in range(0, bsz, c["agg_group"]):
            for b in range(q0, min(q0 + c["agg_group"], bsz)):
                po = int(path_ord[b])
                if po < 0:
                    stats["skipped"] += 1
                if staged and po >= 0:
                    win_m = mask[b, a0:a0 + span]
                    win_e = peff[b, a0:a0 + span]
                    assert len(win_m) == span     # the copy stays in Dp
                ce = np.full(p.shape, -1, np.int64)
                on = (po >= 0) & (p >= 0) & (path == po)
                if on.any():
                    roots = p[on]
                    if staged:
                        m, e = win_m[roots - a0], win_e[roots - a0]
                    else:
                        m, e = mask[b, roots], peff[b, roots]
                    e = np.where(m, e, -1)
                    ce[on] = np.where((e >= 0) & (e < card), e, -1)
                keep = inside
                own[b, rows[keep]] = ce[keep] >= 0
                child_eff[b, rows[keep]] = ce[keep]
                priv = card <= c["cnt_cap"]
                s_cnt = np.zeros(card, np.int64)
                sink = s_cnt if priv else counts[b]
                for w in range(0, nt, 32):
                    blk = ce[w:w + 32]
                    ok = blk >= 0
                    if not ok.any():
                        continue
                    if blk[ok].min() == blk[ok].max():
                        stats["reductions"] += 1
                        sink[blk[ok][0]] += int(ok.sum())
                        stats["global_atomics"] += 0 if priv else 1
                        continue
                    # each thread's runs of equal buckets, one add a run
                    start = np.ones(blk.shape, bool)
                    start[:, 1:] = blk[:, 1:] != blk[:, :-1]
                    n_runs = int((start & ok).sum())
                    stats["runs"] += n_runs
                    stats["global_atomics"] += 0 if priv else n_runs
                    np.add.at(sink, blk[ok], 1)
                if priv:
                    counts[b] += s_cnt
                    stats["global_atomics"] += int((s_cnt != 0).sum())
    return own, child_eff, counts.astype(np.int32), stats


def _fold_ranks(acc, cnt, anyv, vals, sels, mode):
    """One rounding per operation: fold position k of every root (a
    root's positions in CSR order, in float32) into its accumulators."""
    anyv |= sels
    if mode == "max":
        acc[...] = np.maximum(acc, np.where(sels, vals, np.float32(-np.inf)))
    elif mode == "min":
        acc[...] = np.minimum(acc, np.where(sels, vals, np.float32(np.inf)))
    elif mode != "none":
        acc[...] = (acc + np.where(sels, vals, np.float32(0))) \
            .astype(np.float32)
        cnt[...] = (cnt + sels.astype(np.float32)).astype(np.float32)


def _finish(acc, cnt, anyv, mode, boost):
    if mode == "avg":
        acc = (acc / np.maximum(cnt, np.float32(1))).astype(np.float32)
    out = (acc * np.float32(boost)).astype(np.float32)
    return np.where(anyv & (mode != "none"), out, np.float32(0))


def join_tile_mirror(child_s, child_m, live, paths, start, rows, path_ord,
                     boost, mode, c=KERNEL_TILES, vec=True):
    """K22's nested_join (ops/csrc/nested_join.cu) step by step: a CTA a
    (tile of c["join_tile"] roots, group of c["join_group"] queries); the
    tile's CSR positions (row, key = path where live else -2) staged once;
    a light tile (at most c["pos_cap"] positions, no root of more than
    c["heavy_rows"]) reads each query's window of child rows (at most
    c["join_stage"]) where it fits, else gathers, and each root folds its
    positions in CSR order; a heavy tile gathers its light roots and walks
    each heavy root in chunks of c["chunk"] positions staged for every
    query of the group, each query's fold carried from chunk to chunk. A
    query with path_ord < 0 reads nothing. Returns (out_s, out_m,
    stats)."""
    bsz, d_pad = child_s.shape
    tile = c["join_tile"]
    init = {"max": -np.inf, "min": np.inf}.get(mode, 0.0)
    out_s = np.zeros((bsz, d_pad), np.float32)
    out_m = np.zeros((bsz, d_pad), bool)
    stats = dict.fromkeys(("staged", "gathered", "heavy_tiles",
                           "heavy_roots", "chunks", "skipped"), 0)
    for d0 in range(0, d_pad, tile):
        d1 = min(d0 + tile, d_pad)
        cs = start[d0:d1 + 1]
        p0, npos = int(cs[0]), int(cs[-1] - cs[0])
        n_of = np.diff(cs)
        heavy = npos > c["pos_cap"] or n_of.max(initial=0) > c["heavy_rows"]
        pos_row = rows[p0:p0 + npos]
        key = np.where(live[pos_row], paths[pos_row], -2)
        if heavy:
            stats["heavy_tiles"] += 1
            light = n_of <= c["heavy_rows"]
        else:
            light = np.ones(d1 - d0, bool)
            a0, span = _window(pos_row[key >= 0], tile, vec)
            staged = (key >= 0).any() and span <= c["join_stage"]
            stats["staged" if staged else "gathered"] += 1
        # the light roots' positions by rank inside their root
        rel = np.arange(npos) - (cs[np.searchsorted(cs, np.arange(npos) + p0,
                                                    side="right") - 1] - p0)
        owner = np.searchsorted(cs, np.arange(npos) + p0, side="right") - 1
        for q0 in range(0, bsz, c["join_group"]):
            group = range(q0, min(q0 + c["join_group"], bsz))
            for b in group:
                po = int(path_ord[b])
                if po < 0:
                    stats["skipped"] += 1
                    continue
                acc = np.full(d1 - d0, init, np.float32)
                cnt = np.zeros(d1 - d0, np.float32)
                anyv = np.zeros(d1 - d0, bool)
                if not heavy and staged:
                    win_s = child_s[b, a0:a0 + span]
                    win_m = child_m[b, a0:a0 + span]
                    assert len(win_m) == span
                for k in range(int(n_of.max(initial=0))):
                    at = (rel == k) & light[owner]
                    if not at.any():
                        continue
                    r = pos_row[at]
                    sel = key[at] == po
                    if not heavy and staged:
                        m = np.where(sel, win_m[np.where(sel, r - a0, 0)],
                                     False)
                        v = win_s[np.where(sel, r - a0, 0)]
                    else:
                        m = sel & child_m[b, r]
                        v = child_s[b, r]
                    sub = owner[at]
                    a, n_, y = acc[sub], cnt[sub], anyv[sub]
                    _fold_ranks(a, n_, y, v, m, mode)
                    acc[sub], cnt[sub], anyv[sub] = a, n_, y
                done = light
                out_s[b, d0:d1][done] = _finish(acc, cnt, anyv, mode,
                                                boost[b])[done]
                out_m[b, d0:d1][done] = anyv[done]
            if not heavy:
                continue
            # each heavy root: chunks staged for the group, query q's fold
            # carried by its own accumulators
            for i in np.nonzero(~light)[0]:
                stats["heavy_roots"] += 1
                lo, hi = int(cs[i]), int(cs[i + 1])
                acc = np.full(len(group), init, np.float32)
                cnt = np.zeros(len(group), np.float32)
                anyv = np.zeros(len(group), bool)
                pos = np.array([int(path_ord[b]) for b in group])
                for c0 in range(lo, hi, c["chunk"]):
                    stats["chunks"] += 1
                    r = rows[c0:min(c0 + c["chunk"], hi)]
                    k_ = np.where(live[r], paths[r], -2)
                    sel = (pos[:, None] >= 0) & (k_[None, :] == pos[:, None]) \
                        & child_m[list(group)][:, r]
                    v = np.where(sel, child_s[list(group)][:, r],
                                 np.float32(0))
                    for j in range(len(r)):
                        _fold_ranks(acc, cnt, anyv, v[:, j], sel[:, j], mode)
                for qi, b in enumerate(group):
                    out_s[b, d0 + i] = _finish(acc[qi:qi + 1],
                                               cnt[qi:qi + 1],
                                               anyv[qi:qi + 1], mode,
                                               boost[b])[0]
                    out_m[b, d0 + i] = anyv[qi]
    return out_s, out_m, stats


def _crosses_tile(parent, tile):
    """Whether some block has nested rows before a tile boundary and its
    root at or past it."""
    kids = np.nonzero(parent >= 0)[0]
    return bool(np.any(kids // tile != parent[kids] // tile))


def _tile_layout(kind, consts):
    """(parent, paths, live, root) of a mirror test: the blocked layout
    over several tiles (with a trailing all-padding tile, a 10,000-row
    root at the kernel's constants, rows moved far from their root) or
    _walk_blocks' scattered one."""
    rng = np.random.default_rng(180)
    if kind == "scattered":
        parent, paths, live = _walk_blocks(rng, 8192, 800, 300)
        return parent, paths, live, (parent < 0) & live
    big = consts is KERNEL_TILES
    tile = consts["join_tile"]
    d_pad = 14 * tile if big else 24 * tile
    return blocked_layout(rng, d_pad, heavy=10000 if big else 40, far=20,
                           pad=tile + 64)


@pytest.mark.parametrize("consts", ["kernel", "small"])
@pytest.mark.parametrize("layout", ["blocked", "scattered"])
@pytest.mark.parametrize("mode", NESTED_MODES)
def test_nested_join_tile_mirror_against_reference(mode, layout, consts):
    """K22's tile walk, mirrored, against its plain version (scores bit
    for bit, matches exactly) and against the reference's `nested` branch
    of _eval_plan (matches exactly, scores to RTOL), on the blocked layout
    (windows staged, a root across a tile's end, rows far from their root,
    a heavy root in chunks, an all-padding tile) and the scattered one
    (every window past the stage: gathers), at the kernel's constants and
    at small ones; one query off every path, a query group not full."""
    c = KERNEL_TILES if consts == "kernel" else SMALL_TILES
    parent, paths, live, _root = _tile_layout(layout, c)
    d_pad = parent.shape[0]
    start, rows = root_child_csr(parent, d_pad)
    rng = np.random.default_rng(181)
    bsz = 5
    child_s = (rng.random((bsz, d_pad)) * 5).astype(np.float32)
    child_m = rng.random((bsz, d_pad)) < 0.6
    path_ord = np.array([0, 1, -1, 0, 1], np.int32)
    boost = np.array([1.0, 2.5, 1.0, 0.75, 1.5], np.float32)
    got_s, got_m, stats = join_tile_mirror(child_s, child_m, live, paths,
                                           start, rows, path_ord, boost,
                                           mode, c)
    p_s, p_m = nested.nested_join_plain(
        *(torch.from_numpy(x) for x in (child_s, child_m, live, paths,
                                        parent, start, rows, path_ord,
                                        boost)), mode)
    np.testing.assert_array_equal(got_m, p_m.numpy())
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  p_s.numpy().view(np.int32))
    assert stats["skipped"] == -(-d_pad // c["join_tile"])
    if layout == "scattered":
        assert stats["staged"] == 0 and stats["gathered"] > 0
    else:
        assert _crosses_tile(parent, c["join_tile"])
        assert stats["staged"] > 0 and stats["gathered"] > 0
        n_of = np.diff(start)
        big = n_of[n_of > c["heavy_rows"]]
        groups = -(-bsz // c["join_group"])
        assert n_of.max() == (10000 if consts == "kernel" else 40)
        assert stats["heavy_roots"] == groups * len(big)
        assert stats["chunks"] == groups * int((-(-big // c["chunk"])).sum())
        assert not got_m[:, -c["join_tile"]:].any()   # the padding tile
    seg = {"live": jnp.asarray(live), "nested_path": jnp.asarray(paths),
           "parent_ptr": jnp.asarray(parent)}
    plan = JPlan("nested", static=(mode,), children=[JPlan("precomputed")])
    for b in range(bsz):
        inputs = [{"path_ord": jnp.asarray(path_ord[b]),
                   "boost": jnp.asarray(boost[b])},
                  {"scores": jnp.asarray(child_s[b]),
                   "matches": jnp.asarray(child_m[b])}]
        want_s, want_m = j_eval_plan(plan, seg, inputs, [0])
        np.testing.assert_array_equal(got_m[b], np.asarray(want_m))
        np.testing.assert_allclose(got_s[b], np.asarray(want_s), rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("consts", ["kernel", "small"])
@pytest.mark.parametrize("layout", ["blocked", "scattered"])
@pytest.mark.parametrize("card", ["one", "few", "past_cap"])
def test_nested_agg_tile_mirror_against_reference(card, layout, consts):
    """K23 nested's tile walk, mirrored, against its plain version and the
    reference's nested kind (own rows, buckets and counts exactly) on a
    parent context of the roots (each live root's bucket drawn once; one
    query's mask empty): the root context's single bucket (warp
    reductions), 64 buckets, and past the CTA-private counters' cap
    (global adds); at the kernel's constants and small ones."""
    c = KERNEL_TILES if consts == "kernel" else SMALL_TILES
    parent, paths, live, root = _tile_layout(layout, c)
    d_pad = parent.shape[0]
    card = {"one": 1, "few": 64, "past_cap": c["cnt_cap"] + 3}[card]
    rng = np.random.default_rng(182)
    bsz = 5
    mask = (rng.random((bsz, d_pad)) < 0.9) & root & live
    mask[4] = False
    bucket = rng.integers(0, card, d_pad).astype(np.int32)
    peff = np.where(mask, bucket, -1).astype(np.int32)
    path_ord = np.array([0, 1, -1, 1, 0], np.int32)
    own, child_eff, counts, stats = nested_tile_mirror(
        mask, peff, live, paths, parent, path_ord, card, c)
    p_own, p_eff, p_counts = nested.nested_agg_plain(
        *(torch.from_numpy(x) for x in (mask, peff, live, paths, parent,
                                        path_ord)), card)
    np.testing.assert_array_equal(own, p_own.numpy())
    np.testing.assert_array_equal(child_eff, p_eff.numpy())
    np.testing.assert_array_equal(counts, p_counts.numpy())
    tiles = -(-d_pad // c["agg_tile"])
    assert stats["skipped"] == tiles
    assert counts[:2].sum() > 0 and not counts[2].any() \
        and not counts[4].any()
    if card == 1:
        assert stats["reductions"] > 0 and stats["runs"] == 0
    if card <= c["cnt_cap"]:
        assert stats["global_atomics"] <= tiles * bsz * card
    else:
        assert stats["global_atomics"] == stats["reductions"] + stats["runs"]
    if layout == "scattered":
        assert stats["staged"] == 0 and stats["gathered"] > 0
    else:
        assert stats["staged"] > 0 and stats["gathered"] > 0
    seg = {"live": jnp.asarray(live), "nested_path": jnp.asarray(paths),
           "parent_ptr": jnp.asarray(parent)}
    for b in range(bsz):
        ctx = (jnp.asarray(peff[b]), None, card, False)
        outs = []
        jengine._eval_agg(jengine.AggPlan(
            "n", "nested", inputs={"path_ord": path_ord[b]}), seg,
            [{"path_ord": jnp.asarray(path_ord[b])}], [0],
            jnp.asarray(mask[b]), ctx, outs)
        np.testing.assert_array_equal(counts[b],
                                      np.asarray(outs[0]["counts"]))


@pytest.mark.parametrize("vec", [True, False])
def test_nested_agg_tile_mirror_counts_one_atomic_per_bucket(vec):
    """Under the cap, the CTA makes one global atomic per (tile, query,
    nonzero bucket): the mirror's count equals the distinct buckets each
    (tile, query) touched; an all-padding tile writes 0 / -1 and reads
    nothing; the element path (vec False) takes the same windows unaligned."""
    c = SMALL_TILES
    rng = np.random.default_rng(183)
    parent, paths, live, root = blocked_layout(rng, 10 * c["agg_tile"],
                                                pad=2 * c["agg_tile"])
    d_pad = parent.shape[0]
    bsz, card = 4, 7
    mask = root & live & (rng.random((bsz, d_pad)) < 0.8)
    peff = np.where(mask, rng.integers(0, card, d_pad), -1).astype(np.int32)
    path_ord = np.array([0, 1, 0, 1], np.int32)
    own, child_eff, counts, stats = nested_tile_mirror(
        mask, peff, live, paths, parent, path_ord, card, c, vec=vec)
    want = 0
    for d0 in range(0, d_pad, c["agg_tile"]):
        for b in range(bsz):
            e = child_eff[b, d0:d0 + c["agg_tile"]]
            want += len(np.unique(e[e >= 0]))
    assert stats["global_atomics"] == want
    assert stats["empty"] >= 1 and stats["staged"] > 0
    assert not own[:, -c["agg_tile"]:].any()
    assert (child_eff[:, -c["agg_tile"]:] == -1).all()
    p_own, p_eff, p_counts = nested.nested_agg_plain(
        *(torch.from_numpy(x) for x in (mask, peff, live, paths, parent,
                                        path_ord)), card)
    np.testing.assert_array_equal(counts, p_counts.numpy())
    np.testing.assert_array_equal(child_eff, p_eff.numpy())


def test_nested_tiles_match_the_kernels():
    """The mirrors' constants are the kernels' own."""
    import re
    from pathlib import Path
    csrc = Path(nested.__file__).parent / "csrc"
    aggs = (csrc / "nested_aggs.cu").read_text()
    join = (csrc / "nested_join.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const(aggs, "THREADS") == const(join, "THREADS") \
        == KERNEL_TILES["threads"]
    for name, key in (("AGG_TILE_ROWS", "agg_tile"),
                      ("AGG_STAGE_ROWS", "agg_stage"),
                      ("AGG_QUERY_GROUP", "agg_group"),
                      ("CNT_CAP", "cnt_cap")):
        assert const(aggs, name) == KERNEL_TILES[key], name
    for name, key in (("JOIN_TILE_ROWS", "join_tile"),
                      ("JOIN_STAGE_ROWS", "join_stage"),
                      ("JOIN_POS_CAP", "pos_cap"),
                      ("JOIN_HEAVY_ROWS", "heavy_rows"),
                      ("JOIN_CHUNK", "chunk"),
                      ("JOIN_QUERY_GROUP", "join_group")):
        assert const(join, name) == KERNEL_TILES[key], name
    # two quads of 4 rows a thread
    assert KERNEL_TILES["agg_tile"] == KERNEL_TILES["join_tile"] \
        == 8 * KERNEL_TILES["threads"]


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
