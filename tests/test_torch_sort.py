"""Field-sorted search and search_after of opensearch_tpu_torch held against
opensearch_tpu: the same structured documents over three segments (the
third without a `views` column) through both Nodes' `_search` and
`_msearch`, with the result page off and on
(`search.result_page.enabled`). Responses equal the reference's with
`took` ignored: ids, totals, relations and `sort` values exactly, scores
to rtol 1e-6. Plus the general path's plain versions against the JAX
functions they replace: K13 (`_build_sort_key`) bit for bit, K3's keyed
entry against `build_query_phase(..., "field")`, and K14 against the int32
page of the reference's `_page_merger`. The keyed entry also on sort keys
that stress the kernels' radix select (shared high bits, runs of equal
keys, signed zeros and NaNs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops.device_segment import upload_segment as j_upload
from opensearch_tpu.search import dsl as jdsl
from opensearch_tpu.search import executor as jex
from opensearch_tpu.search import spmd as jspmd
from opensearch_tpu.search.compile import Compiler as JCompiler
from opensearch_tpu.search.compile import ShardStats as JStats

from opensearch_tpu_torch.index.segment import segment_from_arrays
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import page, sort_key, topk
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search import executor as tex
from opensearch_tpu_torch.search import spmd as tspmd
from opensearch_tpu_torch.search.compile import Compiler as TCompiler
from opensearch_tpu_torch.search.compile import ShardStats as TStats
from opensearch_tpu_torch.search.executor import stage_single
from opensearch_tpu_torch.search.plan_eval import _eval_plan

from test_torch_common import (DOCS_MAPPING, SORT_BODIES,
                               assert_same_response, bulk_ndjson,
                               docs_corpus, load_sorted_index,
                               msearch_ndjson, segment_arrays)

INDEX = "sorted"


@pytest.fixture(scope="module")
def nodes():
    """The reference, the port, and the port with the result page on."""
    jn = JNode()
    tn = TNode(device="cpu")
    tp = TNode(device="cpu",
               settings={"search.result_page.enabled": "true"})
    for n in (jn, tn, tp):
        load_sorted_index(n, INDEX)
    assert tp.result_page and not tn.result_page
    return jn, tn, tp


@pytest.fixture
def page_calls(monkeypatch):
    """Counts the result page's K14 calls (its plain version on the CPU)."""
    calls = []
    real = tex.page_merge

    def spy(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)
    monkeypatch.setattr(tex, "page_merge", spy)
    return calls


def _search(node, body, **params):
    return node.request("POST", f"/{INDEX}/_search", body, **params)


@pytest.mark.parametrize("name", sorted(SORT_BODIES))
def test_sorted_search_matches_reference(nodes, name):
    jn, tn, tp = nodes
    want = _search(jn, SORT_BODIES[name])
    assert want["_status"] == 200, want
    assert_same_response(_search(tn, SORT_BODIES[name]), want, name)
    assert_same_response(_search(tp, SORT_BODIES[name]), want, name)


def test_missing_values_sort_last_and_are_kept(nodes):
    """Docs without `views` are eligible with the missing key and come
    after every doc with a value, in doc order; none is dropped."""
    _jn, tn, _tp = nodes
    hits = _search(tn, SORT_BODIES["missing_last"])["hits"]["hits"]
    sorts = [h["sort"][0] for h in hits]
    first_missing = sorts.index(None)
    assert all(v is not None for v in sorts[:first_missing])
    assert all(v is None for v in sorts[first_missing:])
    assert any(h["_id"].startswith("x") for h in hits[first_missing:])


def test_uri_sort_and_source(nodes):
    jn, tn, tp = nodes
    params = {"sort": "views:desc,ts", "_source_includes": "tag,views",
              "size": "4"}
    want = _search(jn, {}, **params)
    assert want["hits"]["hits"][0]["sort"][0] >= \
        want["hits"]["hits"][1]["sort"][0]
    for node in (tn, tp):
        assert_same_response(_search(node, {}, **params), want)


def test_track_scores(nodes):
    """track_scores renders every hit's score and max_score. The reference
    takes max_score over the merged candidate pool: its host loop's pool
    is k + 128 winners per segment, its SPMD path's (taken for several
    segments on a virtual mesh) exactly k, so on a pool of fewer matches
    than k both paths see every match and agree."""
    jn, tn, tp = nodes
    body = {"query": {"match": {"body": "w00299"}},
            "sort": [{"ts": "desc"}], "track_scores": True, "size": 40}
    want = _search(jn, body)
    assert 0 < want["hits"]["total"]["value"] <= 40
    assert want["hits"]["max_score"] is not None
    for node in (tn, tp):
        assert_same_response(_search(node, body), want)


def test_result_page_routes(nodes, page_calls):
    """A single numeric sort (and a score sort) rides the page; an
    epoch-millis `ts` sort does not pass f32_sortable and takes the host
    merge; a keyword sort and a multi-key sort never ask for a page. The
    page lives on the host loop: on this index every body takes it in
    both packages, since the third segment has no `views` column (the
    layout check of the multi-shard program, the reference's
    canonical_meta), and under force_host_loop() it takes it anyway."""
    jn, tn, tp = nodes
    for name, field_page in (("views_asc", "asc"), ("dv_sorted", "desc")):
        page_calls.clear()
        j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        assert_same_response(_search(tp, SORT_BODIES[name]),
                             _search(jn, SORT_BODIES[name]))
        assert page_calls == [field_page]
        assert (jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]) == (j0, t0)
        page_calls.clear()
        with tspmd.force_host_loop():
            assert_same_response(_search(tp, SORT_BODIES[name]),
                                 _search(jn, SORT_BODIES[name]))
        assert page_calls == [field_page]
    score_body = {"query": {"match": {"body": "w00011"}}, "size": 5,
                  "highlight": {"fields": {"body": {}}}}
    page_calls.clear()
    assert_same_response(_search(tp, score_body), _search(jn, score_body))
    assert page_calls == [None]
    for name in ("ts_asc", "tag_asc", "tag_ts"):
        page_calls.clear()
        assert_same_response(_search(tp, SORT_BODIES[name]),
                             _search(jn, SORT_BODIES[name]))
        assert page_calls == []
    page_calls.clear()
    _search(tn, SORT_BODIES["views_asc"])
    assert page_calls == []


def _page_through(node, body, pages):
    """`pages` pages of `body`, each after the previous page's last sort
    values; returns the hit ids and sort values page by page."""
    out, after = [], None
    for _ in range(pages):
        b = dict(body)
        if after is not None:
            b["search_after"] = after
        res = _search(node, b)
        hits = res["hits"]["hits"]
        out.append(res)
        if not hits:
            break
        # a score-sorted first page renders no `sort`: its cursor is the
        # last score
        after = hits[-1].get("sort") or [hits[-1]["_score"]]
    return out


@pytest.mark.parametrize("body", [
    {"sort": [{"views": "desc"}, {"ts": "asc"}], "size": 200},
    {"query": {"match": {"body": "w00006 w00011"}}, "size": 150,
     "sort": ["_score"]},
], ids=["field", "score"])
def test_search_after_pages_through_the_index(nodes, body):
    """Each node pages with its own cursors; a score cursor's values are
    scores (rtol 1e-6)."""
    jn, tn, tp = nodes
    want = _page_through(jn, body, 9)
    assert len(want) > 3 and not want[-1]["hits"]["hits"]
    for node in (tn, tp):
        got = _page_through(node, body, 9)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_response(g, w, score_sorts=(0,))


def test_search_after_beside_a_segment_of_missing_values(nodes,
                                                          monkeypatch):
    """The reference's two routes disagree here and the port follows each:
    on the host merge, each segment fetches its own k + 128 window and
    the third segment's docs (no views: missing, after every cursor)
    fill the page at once; the result page merges one global window by
    value, which holds no missing doc until the values run out, so k
    grows and the page holds the values past the cursor."""
    jn, tn, tp = nodes
    body = {"sort": [{"views": "asc"}], "size": 20, "search_after": [7000]}
    want_host = _search(jn, body)
    monkeypatch.setattr(jex, "RESULT_PAGE", True)
    want_page = _search(jn, body)
    monkeypatch.setattr(jex, "RESULT_PAGE", False)
    assert want_host["hits"]["hits"][0]["sort"] == [None]
    assert want_page["hits"]["hits"][0]["sort"][0] > 7000
    assert_same_response(_search(tn, body), want_host)
    assert_same_response(_search(tp, body), want_page)


@pytest.mark.parametrize("body,reason", [
    ({"sort": [{"views": "asc"}], "search_after": [10], "from": 5},
     "`from` parameter must be set to 0 when `search_after` is used"),
    ({"sort": [{"views": "asc"}, {"ts": "asc"}], "search_after": [10]},
     "search_after has 1 value(s) but sort has 2 field(s)"),
    ({"sort": [{"views": "asc"}], "bogus_key": 1},
     "unknown key [bogus_key] in the search body"),
], ids=["from", "arity", "unknown_key"])
def test_errors_match_reference(nodes, body, reason):
    jn, tn, tp = nodes
    want = _search(jn, body)
    assert want["_status"] == 400 and want["error"]["reason"] == reason
    for node in (tn, tp):
        assert_same_response(_search(node, body), want)


@pytest.mark.parametrize("key,value", [
    ("rescore", {"query": {"rescore_query": {"match_all": {}}}}),
    ("collapse", {"field": "tag"}),
    ("suggest", {"s": {"text": "w0001", "term": {"field": "body"}}}),
    ("profile", True),
    ("script_fields", {"f": {"script": "1"}}),
    ("slice", {"id": 0, "max": 2}),
    ("pit", {"id": "x"}),
    ("scroll", "1m"),
    ("timeout", "10s"),
    ("allow_partial_search_results", True),
    ("search_type", "dfs_query_then_fetch"),
])
def test_unported_keys_answer_400(nodes, key, value):
    jn, tn, _tp = nodes
    body = {"sort": [{"views": "asc"}], key: value}
    if key in ("search_type", "allow_partial_search_results"):
        # dfs_query_then_fetch is served since the multi-shard slice and
        # allow_partial_search_results since the shard failure isolation
        # (each answered 400 before): the reference's response
        assert_same_response(_search(tn, body), _search(jn, body))
        return
    res = _search(tn, body)
    assert res["_status"] == 400
    assert f"[{key}]" in res["error"]["reason"]
    assert "not supported by opensearch_tpu_torch" in res["error"]["reason"]


def test_ignored_keys_are_ignored(nodes):
    """Keys the reference accepts and ignores change nothing."""
    jn, tn, _tp = nodes
    body = {"sort": [{"views": "asc"}], "size": 3, "profile": False,
            "stored_fields": ["tag"], "terminate_after": 5,
            "search_type": "query_then_fetch", "seq_no_primary_term": True}
    assert_same_response(_search(tn, body), _search(jn, body))


def test_msearch_mixed_batch_matches_reference(nodes):
    """Score-sorted items batch in the envelope; field-sorted, fetch and
    search_after items run one by one on the general path; a bad item is
    an item error."""
    jn, tn, tp = nodes
    bodies = [SORT_BODIES["views_asc"],
              {"query": {"match": {"body": "w00011"}}, "size": 4},
              SORT_BODIES["tag_ts"],
              {"sort": [{"views": "asc"}], "bogus": 1},
              {"query": {"match": {"body": "w00021"}}, "size": 3,
               "explain": True},
              {"sort": [{"ts": "desc"}], "size": 5,
               "search_after": [1705000000000]},
              {"query": {"match_all": {}}, "sort": "_score", "size": 2},
              {"sort": [{"views": "asc"}], "from": 9995, "size": 10}]
    payload = msearch_ndjson(INDEX, bodies)
    want = jn.request("POST", "/_msearch", payload)
    assert [r["status"] for r in want["responses"]] == \
        [200, 200, 200, 400, 200, 200, 200, 400]
    for node in (tn, tp):
        assert_same_response(node.request("POST", "/_msearch", payload),
                             want)


# ------------------------------------ a cursor past K3's in-CTA sort limit

DEEP_N = 17000
DEEP_MAPPING = {"mappings": {"properties": {"n": {"type": "integer"},
                                            "g": {"type": "keyword"}}}}


@pytest.fixture(scope="module")
def deep():
    rng = np.random.default_rng(3)
    docs = {f"d{i}": {"n": int(rng.integers(0, 5000)),
                      "g": f"g{int(rng.integers(0, 50)):02d}"}
            for i in range(DEEP_N)}
    out = []
    for node in (JNode(), TNode(device="cpu")):
        node.request("PUT", "/deep", DEEP_MAPPING)
        res = node.request("POST", "/_bulk", bulk_ndjson("deep", docs))
        assert not res["errors"]
        node.request("POST", "/deep/_refresh")
        out.append(node)
    return out


def test_deep_cursor_grows_k_past_the_sort_limit(deep, monkeypatch):
    """A cursor ~14,000 hits deep: k grows 10 -> 40,960 (k_fetch 41,088,
    past MAX_K = 16,384) and the page equals the reference's."""
    jn, tn = deep
    ks = []
    ex = tn.indices.get("deep").shards[0].executor
    real = ex.execute_query_phase

    def spy(body, k, **kw):
        ks.append(k)
        return real(body, k, **kw)
    monkeypatch.setattr(ex, "execute_query_phase", spy)
    body = {"sort": [{"n": "desc"}], "size": 10, "search_after": [900]}
    want = jn.request("POST", "/deep/_search", body)
    got = tn.request("POST", "/deep/_search", body)
    assert_same_response(got, want)
    assert ks[-1] == 40960 and min(ks[-1] + 128, 1 << 16) > topk.MAX_K
    assert [h["sort"][0] for h in got["hits"]["hits"]][0] == 899


# ------------------------------------------ plain versions vs the JAX ones

@pytest.fixture(scope="module")
def images():
    """One structured segment sealed by the reference, carried across with
    segment_from_arrays, uploaded by both packages. A few docs lack
    `views` and some carry several `tag`s (the pairs layout)."""
    docs = docs_corpus(900, seed=5)
    mapper = JMapper(DOCS_MAPPING["mappings"])
    builder = JBuilder(mapper)
    for i, d in enumerate(docs):
        builder.add(mapper.parse_document(f"d{i}", d))
    seg = builder.seal()
    tseg = segment_from_arrays(segment_arrays(seg))
    jarrays, jmeta = j_upload(seg)
    tarrays, tmeta = upload_segment(tseg, torch.device("cpu"))
    return mapper, seg, jarrays, jmeta, tseg, tarrays, tmeta


@pytest.mark.parametrize("field", ["views", "ts", "tag", "nope"])
@pytest.mark.parametrize("order", ["asc", "desc"])
def test_sort_key_plain_equals_reference(images, field, order):
    _m, _s, jarrays, _jm, _ts, tarrays, _tm = images
    want = np.asarray(jex._build_sort_key(jarrays, (field, order)))
    got = sort_key.build_sort_key(tarrays, (field, order)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _both_plans(images, query):
    mapper, seg, jarrays, jmeta, tseg, tarrays, tmeta = images
    jplan = JCompiler(mapper, JStats([seg])).compile(
        jdsl.parse_query(query), seg, jmeta)
    from opensearch_tpu_torch.index.mapper import MapperService as TMapper
    tplan = TCompiler(TMapper(DOCS_MAPPING["mappings"]),
                      TStats([tseg])).compile(tdsl.parse_query(query), tseg,
                                              tmeta)
    return jplan, tplan


@pytest.mark.parametrize("k", [10, 700])
@pytest.mark.parametrize("sort", [("views", "desc"), ("tag", "asc"), None])
def test_keyed_topk_plain_equals_build_query_phase(images, k, sort):
    """Many tied keys, min_score cutting some matches, and at k 700 more
    lanes than eligible docs (the -inf tail in index order)."""
    _m, _s, jarrays, jmeta, _ts, tarrays, tmeta = images
    query = {"match": {"body": "w00003 w00011 w00021"}}
    jplan, tplan = _both_plans(images, query)
    mode = "score" if sort is None else "field"
    fn = jax.jit(jex.build_query_phase(jplan, jmeta, k, mode))
    jkey = jex._build_sort_key(jarrays, sort)
    flat = jax.tree_util.tree_map(jnp.asarray, jplan.flatten_inputs([]))
    wk, ws, wi, wt, _ = fn(jarrays, flat, jkey, jnp.float32(0.5))
    inputs, ms = stage_single(tplan.flatten_inputs([]), 0.5,
                              torch.device("cpu"))
    scores, matches = _eval_plan(tplan, tarrays, inputs, [0], 1)
    tkey = sort_key.build_sort_key(tarrays, sort)
    row = topk.masked_topk_keyed_plain(
        scores.contiguous(), matches.contiguous(), tarrays["live"],
        tarrays["root"], tmeta.num_docs, ms, tkey, min(k, tmeta.d_pad))
    gk, gs, gi, gt = topk.unpack_keyed_rows(row.numpy(), k)
    assert int(gt[0]) == int(wt)
    assert np.array_equal(gi[0], np.asarray(wi))
    np.testing.assert_allclose(gs[0], np.asarray(ws), rtol=1e-6)
    if sort is None:    # the keys are the scores
        np.testing.assert_allclose(gk[0], np.asarray(wk), rtol=1e-6)
    else:
        assert np.array_equal(gk[0].view(np.int32),
                              np.asarray(wk).view(np.int32))


def _select_key(kind: str, d_pad: int) -> np.ndarray:
    """A [Dp] sort key of a kind that stresses the kernels' radix select."""
    rng = np.random.default_rng(len(kind))
    if kind == "ranks_2_23":        # K13's ranks: top 20+ bits shared
        return (2.0 ** 23 + rng.integers(0, 64, d_pad)).astype(np.float32)
    if kind == "epoch_ms":          # 2^17 ms steps: long runs of ties
        return (1.7e12 + rng.integers(0, 86400_000, d_pad)).astype(
            np.float32)
    if kind == "equal":
        return np.full(d_pad, 7.0, np.float32)
    pool = np.array([np.nan, -np.nan, 0.0, -0.0, -1e30, 1e30, np.inf,
                     -np.inf, 2.0, -2.0], np.float32)
    return rng.choice(pool, d_pad)


@pytest.mark.parametrize("k", [10, 700])
@pytest.mark.parametrize("kind", ["ranks_2_23", "epoch_ms", "equal",
                                  "signed_zero_nan"])
def test_keyed_topk_plain_equals_build_query_phase_on_select_keys(
        images, kind, k):
    """The keyed plain version against build_query_phase(..., "field")
    with the same sort key handed to both: keys that share their high
    bits, runs of equal keys, NaNs of both signs, +-0.0, -1e30 and +-inf
    (the total order of the keys' bits), with min_score cutting matches
    and, at k 700, the -inf tail in index order."""
    _m, _s, jarrays, jmeta, _ts, tarrays, tmeta = images
    jplan, tplan = _both_plans(images, {"match": {"body": "w00003 w00011"}})
    key = _select_key(kind, tmeta.d_pad)
    fn = jax.jit(jex.build_query_phase(jplan, jmeta, k, "field"))
    flat = jax.tree_util.tree_map(jnp.asarray, jplan.flatten_inputs([]))
    wk, ws, wi, wt, _ = fn(jarrays, flat, jnp.asarray(key), jnp.float32(0.5))
    inputs, ms = stage_single(tplan.flatten_inputs([]), 0.5,
                              torch.device("cpu"))
    scores, matches = _eval_plan(tplan, tarrays, inputs, [0], 1)
    row = topk.masked_topk_keyed_plain(
        scores.contiguous(), matches.contiguous(), tarrays["live"],
        tarrays["root"], tmeta.num_docs, ms, torch.from_numpy(key),
        min(k, tmeta.d_pad))
    gk, gs, gi, gt = topk.unpack_keyed_rows(row.numpy(), k)
    assert int(gt[0]) == int(wt)
    assert np.array_equal(gi[0], np.asarray(wi))
    assert np.array_equal(gk[0].view(np.int32), np.asarray(wk).view(np.int32))
    np.testing.assert_allclose(gs[0], np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("mode", [("score",), ("field", "views", "asc"),
                                  ("field", "views", "desc")])
def test_page_merge_plain_equals_reference_page(mode):
    """Three segments (one without `views`), each segment's keyed rows
    from the reference's build_query_phase carried to the port as they
    are; the page with a fused docvalue field (ts) and one absent from
    every segment."""
    docs = docs_corpus(1300, seed=9)
    for d in docs[800:]:
        d.pop("views", None)
    mapper = JMapper({"properties": {**DOCS_MAPPING["mappings"][
        "properties"], "gone": {"type": "long"}}})
    segs = []
    for lo, hi in ((0, 500), (500, 800), (800, 1300)):
        b = JBuilder(mapper)
        for i in range(lo, hi):
            b.add(mapper.parse_document(f"d{i}", docs[i]))
        segs.append(b.seal())
    stats = JStats(segs)
    query = jdsl.parse_query({"match": {"body": "w00004 w00009"}})
    dv_fields = ("ts", "gone")
    order = mode[2] if mode[0] == "field" else None
    sort = None if order is None else ("views", order)
    k = 64
    rows_j, rows_t, statics, sort_cols, dv_cols = [], [], [], [], []
    for seg in segs:
        arrays, meta = j_upload(seg)
        plan = JCompiler(mapper, stats).compile(query, seg, meta)
        fn = jax.jit(jex.build_query_phase(
            plan, meta, k, "score" if order is None else "field"))
        flat = jax.tree_util.tree_map(jnp.asarray, plan.flatten_inputs([]))
        keys, scores, idx, total, _ = fn(
            arrays, flat, jex._build_sort_key(arrays, sort),
            jnp.float32(-np.inf))
        col = arrays["numeric"].get("views")
        arg = {"keys": keys, "scores": scores, "idx": idx, "total": total}
        if col is not None and order is not None:
            arg["sort_col"] = col
        states = tuple("col" if f in arrays["numeric"] else "absent"
                       for f in dv_fields)
        dv = {f: arrays["numeric"][f] for f, st in zip(dv_fields, states)
              if st == "col"}
        if dv:
            arg["dv"] = dv
        rows_j.append(arg)
        statics.append((k, meta.d_pad, "sort_col" in arg, states))
        rows_t.append(torch.cat([
            torch.from_numpy(np.array(keys)),
            torch.from_numpy(np.array(scores)),
            torch.from_numpy(np.array(idx)).view(torch.float32),
            torch.tensor([int(total)], dtype=torch.int32).view(
                torch.float32)]))

        def tcol(c):
            return None if c is None else {
                key: torch.from_numpy(np.array(v)) for key, v in c.items()}
        sort_cols.append(tcol(col) if order is not None else None)
        dv_cols.append([tcol(dv.get(f)) for f in dv_fields])
    stride = max(s[1] for s in statics)
    k_page = 100
    sig = ("page-test", mode, k_page, stride, tuple(statics), dv_fields)
    want = np.asarray(jex._page_merger(sig, mode, k_page, stride,
                                       tuple(statics), dv_fields)(rows_j))
    got = page.page_merge_plain(rows_t, order, sort_cols, dv_cols, k_page,
                                stride).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
