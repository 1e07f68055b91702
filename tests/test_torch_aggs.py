"""Aggregations of opensearch_tpu_torch held against opensearch_tpu, under
the agg contract of test_torch_common (every summed value here is an
integer, so responses must be equal):

- the tests/test_aggs.py MAPPING and DOCS at splits (7,), (3, 4) and
  (2, 2, 3), with the bodies of its terms, metrics, histogram,
  date_histogram, filter, cardinality, stats-under-date_histogram and
  unmapped-field tests, served as `_search` and as `_msearch` at B=1 and
  B=8;
- bench.py's two body families and the structured bodies over the
  5,000-doc corpus (two segments, multi-valued tags, docs without views),
  through both Nodes;
- K5's and K6's plain versions against the reference's `_binned_sums`,
  and the port's agg-out layout against the reference's `_agg_out_layout`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search.aggs import engine as jengine
from opensearch_tpu.search.aggs.parse import parse_aggs as j_parse_aggs
from opensearch_tpu.search.compile import Compiler as JCompiler
from opensearch_tpu.search.executor import SearchExecutor as JExecutor
from opensearch_tpu.search.executor import ShardReader as JReader
from opensearch_tpu.search.executor import _agg_out_layout as j_layout
from opensearch_tpu.search import dsl as jdsl

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import SegmentBuilder as TBuilder
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import binned
from opensearch_tpu_torch.search.aggs import engine as tengine
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
from opensearch_tpu_torch.search.compile import Compiler as TCompiler
from opensearch_tpu_torch.search.executor import SearchExecutor as TExecutor
from opensearch_tpu_torch.search.executor import ShardReader as TReader

from test_aggs import DOCS, MAPPING
from test_torch_common import (AGG_BODIES, DOCS_N, agg_msearch_bodies,
                               assert_same_response, bench_agg_bodies,
                               f32_sum_bound, load_docs_index,
                               load_sorted_index, msearch_ndjson)

# the bodies of tests/test_aggs.py's terms, metrics, histogram,
# date_histogram, filter, cardinality, stats-under-date_histogram and
# unmapped-field tests
SMALL_BODIES = {
    "terms_basic": {"aggs": {"cats": {"terms": {"field": "cat"}}}},
    "terms_size": {"aggs": {"cats": {"terms": {"field": "cat",
                                               "size": 1}}}},
    "terms_key_order": {"aggs": {"cats": {"terms": {
        "field": "cat", "order": {"_key": "asc"}}}}},
    "terms_query_filter": {"query": {"match": {"desc": "red"}},
                           "aggs": {"cats": {"terms": {"field": "cat"}}}},
    "terms_numeric": {"aggs": {"qtys": {"terms": {"field": "qty",
                                                  "size": 20}}}},
    "terms_sub_metric": {"aggs": {"cats": {
        "terms": {"field": "cat"},
        "aggs": {"avg_price": {"avg": {"field": "price"}}}}}},
    "terms_sub_terms": {"aggs": {"cats": {
        "terms": {"field": "cat"},
        "aggs": {"brands": {"terms": {"field": "brand"}}}}}},
    "metrics": {"aggs": {
        "mn": {"min": {"field": "price"}}, "mx": {"max": {"field": "price"}},
        "sm": {"sum": {"field": "price"}}, "av": {"avg": {"field": "price"}},
        "vc": {"value_count": {"field": "price"}},
        "st": {"stats": {"field": "price"}},
        "xs": {"extended_stats": {"field": "price"}}}},
    "histogram": {"aggs": {"h": {"histogram": {"field": "price",
                                               "interval": 25}}}},
    "histogram_filled": {"query": {"terms": {"qty": [1, 7]}},
                         "aggs": {"h": {"histogram": {"field": "qty",
                                                      "interval": 2}}}},
    "date_histogram_month": {"aggs": {"m": {"date_histogram": {
        "field": "day", "calendar_interval": "month"}}}},
    "date_histogram_fixed": {"aggs": {"w": {"date_histogram": {
        "field": "day", "fixed_interval": "30d"}}}},
    "filter": {"aggs": {"red": {"filter": {"match": {"desc": "red"}},
                                "aggs": {"mx": {"max": {
                                    "field": "price"}}}}}},
    "cardinality": {"aggs": {"c": {"cardinality": {"field": "cat"}},
                             "n": {"cardinality": {"field": "qty"}}}},
    "cardinality_under_terms": {"aggs": {"cats": {
        "terms": {"field": "cat"},
        "aggs": {"brands": {"cardinality": {"field": "brand"}}}}}},
    "stats_under_date_histogram": {"aggs": {"m": {
        "date_histogram": {"field": "day", "calendar_interval": "month"},
        "aggs": {"s": {"stats": {"field": "price"}}}}}},
    "unmapped": {"aggs": {"x": {"terms": {"field": "ghost"}},
                          "y": {"sum": {"field": "ghost"}}}},
    # further options of the ported kinds
    "terms_order_key_desc_min_count": {"aggs": {"b": {"terms": {
        "field": "brand", "order": {"_key": "desc"}, "min_doc_count": 2}}}},
    "histogram_bounds_offset": {"aggs": {"h": {"histogram": {
        "field": "price", "interval": 20, "offset": 5, "min_doc_count": 0,
        "extended_bounds": {"min": -40, "max": 120}}}}},
    "date_histogram_tz_offset": {"query": {"range": {"price": {"gte": 20}}},
                                 "aggs": {"d": {"date_histogram": {
                                     "field": "day", "fixed_interval": "7d",
                                     "time_zone": "-05:00",
                                     "offset": "+6h"}}}},
    "date_histogram_year_sub": {"aggs": {"y": {"date_histogram": {
        "field": "day", "calendar_interval": "year"},
        "aggs": {"q": {"sum": {"field": "qty"}}}}}},
    "metrics_dates_and_keywords": {"aggs": {
        "first": {"min": {"field": "day"}}, "last": {"max": {"field": "day"}},
        "cats": {"value_count": {"field": "cat"}},
        "ghost_avg": {"avg": {"field": "ghost", "missing": 3}},
        "price_missing": {"stats": {"field": "price", "missing": 100}}}},
    "filter_nested_terms": {"aggs": {"cheap": {
        "filter": {"range": {"price": {"lt": 45}}},
        "aggs": {"cats": {"terms": {"field": "cat"}, "aggs": {
            "q": {"max": {"field": "qty"}}}}}}}},
    "terms_under_histogram": {"aggs": {"h": {
        "histogram": {"field": "qty", "interval": 3},
        "aggs": {"c": {"terms": {"field": "cat"}},
                 "u": {"cardinality": {"field": "brand"}}}}}},
    "size_and_hits": {"size": 3, "query": {"match": {"desc": "cat dog"}},
                      "aggs": {"c": {"terms": {"field": "cat"}}}},
}
for _body in SMALL_BODIES.values():
    _body.setdefault("size", 0)


def _executors(split):
    """The reference's and the port's executor over the same segments."""
    jm, tm = JMapper(MAPPING), TMapper(MAPPING)
    jsegs, tsegs = [], []
    i = 0
    for si, n in enumerate(split):
        jb, tb = JBuilder(jm, f"s{si}"), TBuilder(tm, f"s{si}")
        for d in DOCS[i:i + n]:
            jb.add(jm.parse_document(f"d{i}", d))
            tb.add(tm.parse_document(f"d{i}", d))
            i += 1
        jsegs.append(jb.seal())
        tsegs.append(tb.seal())
    reader = TReader(tm, torch.device("cpu"))
    for seg in tsegs:
        reader.add_segment(seg)
    return JExecutor(JReader(jm, jsegs)), TExecutor(reader)


@pytest.fixture(scope="module", params=[(7,), (3, 4), (2, 2, 3)],
                ids=["1seg", "2seg", "3seg"])
def small(request):
    jex, tex = _executors(list(request.param))
    want = {n: jex.search(b) for n, b in SMALL_BODIES.items()}
    return tex, want


@pytest.mark.parametrize("name", sorted(SMALL_BODIES))
def test_small_search_matches_reference(small, name):
    tex, want = small
    assert_same_response(tex.search(SMALL_BODIES[name]), want[name], name)


@pytest.mark.parametrize("bsz", [1, 8])
def test_small_msearch_matches_reference(small, bsz):
    tex, want = small
    names = sorted(SMALL_BODIES)
    for lo in range(0, len(names), bsz):
        chunk = names[lo:lo + bsz]
        got = tex.multi_search([SMALL_BODIES[n] for n in chunk])
        for n, resp in zip(chunk, got["responses"]):
            assert_same_response(resp, want[n], f"msearch[{n}]")


def test_small_values_are_the_documented_ones(small):
    """A few absolute values, so parity cannot hide a shared fault."""
    tex, _want = small
    out = tex.search(SMALL_BODIES["metrics"])["aggregations"]
    assert (out["mn"]["value"], out["mx"]["value"], out["sm"]["value"],
            out["vc"]["value"]) == (10.0, 60.0, 210.0, 6)
    out = tex.search(SMALL_BODIES["cardinality_under_terms"])["aggregations"]
    assert {b["key"]: b["brands"]["value"]
            for b in out["cats"]["buckets"]} == {"a": 2, "b": 2, "c": 0}


# --------------------------------------------- the structured corpus

@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    load_docs_index(jn, n_docs=DOCS_N)
    load_docs_index(tn, n_docs=DOCS_N)
    return jn, tn


CORPUS_BODIES = dict(AGG_BODIES)
CORPUS_BODIES.update({f"agg_terms_{i}": b for i, b in
                      enumerate(bench_agg_bodies("agg_terms", 3))})
CORPUS_BODIES.update({f"date_hist_{i}": b for i, b in
                      enumerate(bench_agg_bodies("date_hist", 3))})


@pytest.mark.parametrize("name", sorted(CORPUS_BODIES))
def test_corpus_search_matches_reference(nodes, name):
    jn, tn = nodes
    body = CORPUS_BODIES[name]
    want = jn.request("POST", "/docs/_search", body)
    assert want["_status"] == 200
    assert_same_response(tn.request("POST", "/docs/_search", body), want,
                         name)


@pytest.mark.parametrize("bsz", [1, 8])
def test_corpus_msearch_matches_reference(nodes, bsz):
    jn, tn = nodes
    bodies = agg_msearch_bodies(8)
    for lo in range(0, len(bodies), bsz):
        payload = msearch_ndjson("docs", bodies[lo:lo + bsz])
        want = jn.request("POST", "/_msearch", payload)
        assert_same_response(tn.request("POST", "/_msearch", payload), want,
                             f"msearch[{lo}]")


def test_fused_and_pairs_kinds_are_compiled(nodes):
    """The bench families compile to the fused popcount kinds (a leaf
    date_histogram and cardinality) and to the pairs kinds (terms with a
    metric sub-aggregation)."""
    _jn, tn = nodes
    ex = tn.indices.get("docs").shards[0].executor
    stats, segments, device = ex.reader.stats_snapshot()
    comp = TCompiler(ex.reader.mapper, stats)
    kinds = set()
    for mode in ("agg_terms", "date_hist"):
        body = bench_agg_bodies(mode, 1)[0]
        for seg, (_arrays, meta) in zip(segments, device):
            plans = tengine.compile_aggs(parse_aggs(body["aggs"]),
                                         ex.reader.mapper, seg, meta, comp)
            stack = list(plans)
            while stack:
                p = stack.pop()
                kinds.add(p.kind)
                stack.extend(p.children)
    assert {"bucket_bits", "presence_bits", "bucket_ord",
            "metric_num"} <= kinds


# ------------------------------------------- K5 / K6 against _binned_sums

@pytest.mark.parametrize("total", [1, 16, 256, 300])
@pytest.mark.parametrize("contrib", ["bool", "f32"])
def test_binned_plain_versions_equal_reference(total, contrib):
    """Counts through K5 (popcount route, total <= 256) or K6 (total 300),
    f32 sums through K6, against the reference's routes; the f32 values are
    integers, so every order gives the same sums."""
    rng = np.random.default_rng(total)
    n, bsz = 2048, 3
    lanes = rng.integers(-1, total + 2, n).astype(np.int32)
    ok = rng.random((bsz, n)) < 0.6
    vals = rng.integers(-50, 1000, n).astype(np.float32)
    bins = tengine._Bins(torch.from_numpy(lanes), total)
    mask = torch.from_numpy(ok)
    need = "cnt" if contrib == "bool" else "sum"
    got = tengine._binned_sums(bins, mask, None, None, (need,),
                               values=torch.from_numpy(vals))[need]
    route = tengine.binned_route(n, total, need)
    assert route == ("scatter" if total > 256
                     else "popcount" if contrib == "bool" else "gemm")
    for b in range(bsz):
        c = ok[b] if contrib == "bool" else np.where(ok[b], vals, 0.0)
        dt = jnp.int32 if contrib == "bool" else jnp.float32
        (want,) = jengine._binned_sums(jnp.asarray(lanes), total,
                                       [(jnp.asarray(c), dt)], True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_binned_reduce_plain_min_max_and_bound():
    """K6's plain min / max equal a masked numpy reduction exactly, and its
    f32 sums of non-integer values lie within the contract's bound of the
    f64 sums."""
    rng = np.random.default_rng(9)
    n, total, bsz = 4096, 37, 2
    lanes = rng.integers(-1, total, n).astype(np.int32)
    ok = rng.random((bsz, n)) < 0.5
    vals = (rng.standard_normal(n) * 1e3).astype(np.float32)
    csr = binned.bin_csr(torch.from_numpy(lanes), total)
    got = binned.binned_reduce(csr, torch.from_numpy(ok), None, None,
                               torch.from_numpy(vals), 0.0,
                               ("cnt", "sum", "min", "max"), bsz)
    for b in range(bsz):
        for k in range(total):
            sel = ok[b] & (lanes == k)
            v = vals[sel]
            assert int(got["cnt"][b, k]) == sel.sum()
            assert float(got["min"][b, k]) == (v.min() if len(v) else np.inf)
            assert float(got["max"][b, k]) == (v.max() if len(v)
                                               else -np.inf)
            exact = float(np.sum(v.astype(np.float64)))
            bound = len(v) * 2.0 ** -24 * float(np.abs(v).sum())
            assert abs(float(got["sum"][b, k]) - exact) <= bound


def test_popcount_plain_packs_like_the_reference():
    rng = np.random.default_rng(5)
    ok = rng.random((2, 256)) < 0.5
    words = binned.pack_bits(torch.from_numpy(ok)).numpy()
    want = np.asarray(jengine._pack_bits(jnp.asarray(ok)))
    np.testing.assert_array_equal(words.astype(np.uint32), want)
    lanes = rng.integers(-1, 9, 256).astype(np.int32)
    bits = binned.lane_bits(torch.from_numpy(lanes), 8).numpy()
    want_bits = jengine._pack_lane_bits(lanes.astype(np.int64), 8, 256)
    np.testing.assert_array_equal(bits.view(np.uint32), want_bits)


# ------------------------------------------------------ out layout

@pytest.mark.parametrize("name", ["terms_sub_metric", "metrics",
                                  "cardinality_under_terms", "filter",
                                  "stats_under_date_histogram", "unmapped",
                                  "date_histogram_fixed", "cardinality"])
def test_agg_out_layout_equals_reference(name):
    body = SMALL_BODIES[name]
    jm, tm = JMapper(MAPPING), TMapper(MAPPING)
    jb, tb = JBuilder(jm, "s0"), TBuilder(tm, "s0")
    for i, d in enumerate(DOCS):
        jb.add(jm.parse_document(f"d{i}", d))
        tb.add(tm.parse_document(f"d{i}", d))
    jseg, tseg = jb.seal(), tb.seal()
    jreader = JReader(jm, [jseg])
    jstats, jsegs, jdev = jreader.stats_snapshot()
    arrays, jmeta = jdev[0]
    jcomp = JCompiler(jm, jstats)
    qplan = jcomp.compile(jdsl.parse_query(body.get("query")), jseg, jmeta)
    jaggs = jengine.compile_aggs(j_parse_aggs(body["aggs"]), jm, jseg, jmeta,
                                 jcomp)
    flat = qplan.flatten_inputs([])
    for ap in jaggs:
        ap.flatten_inputs(flat)
    want, want_w = j_layout(qplan, jmeta, jaggs, arrays, flat,
                            np.float32(0))
    treader = TReader(tm, torch.device("cpu"))
    treader.add_segment(tseg)
    tstats, tsegs, tdev = treader.stats_snapshot()
    taggs = tengine.compile_aggs(parse_aggs(body["aggs"]), tm, tsegs[0],
                                 tdev[0][1], TCompiler(tm, tstats))
    got, got_w = tengine.agg_out_layout(taggs)
    assert got == want and got_w == want_w


@pytest.mark.parametrize("body", [
    {"aggs": {"n": {"nested": {"path": "x"}}}},
    {"aggs": {"t": {"terms": {"field": "k"}, "aggs": {
        "r": {"reverse_nested": {}}}}}},
    {"aggs": {"g": {"geo_bounds": {"field": "n"}}}},
    {"aggs": {"g": {"geohash_grid": {"field": "n"}}}},
    {"aggs": {"i": {"ip_range": {"field": "n",
                                 "ranges": [{"to": "10.0.0.5"}]}}}}],
    ids=["nested", "reverse_nested", "geo_bounds", "geohash_grid",
         "ip_range"])
def test_unported_agg_types_answer_400(body):
    """ip_range still answers 400; nested, reverse_nested, geo_bounds and
    geohash_grid are served since the nested and geo slice and answer as
    the reference does (an unmapped path, a field without points)."""
    tn = TNode(device="cpu")
    tn.request("PUT", "/e", {"mappings": {"properties": {
        "k": {"type": "keyword"}, "n": {"type": "long"}}}})
    got = tn.request("POST", "/e/_search", body)
    if "i" not in body["aggs"]:
        jn = JNode()
        jn.request("PUT", "/e", {"mappings": {"properties": {
            "k": {"type": "keyword"}, "n": {"type": "long"}}}})
        assert_same_response(got, jn.request("POST", "/e/_search", body))
        return
    assert got["_status"] == 400
    assert got["error"]["type"] == "query_shard_exception"
    assert "is not supported" in got["error"]["reason"]


def test_empty_index_aggs_match_reference():
    body = {"size": 0, "aggs": {"t": {"terms": {"field": "k"}},
                                "m": {"avg": {"field": "n"}}}}
    out = []
    for node in (JNode(), TNode(device="cpu")):
        node.request("PUT", "/e", {"mappings": {"properties": {
            "k": {"type": "keyword"}, "n": {"type": "long"}}}})
        out.append(node.request("POST", "/e/_search", body))
    assert_same_response(out[1], out[0], "empty")


def test_extended_stats_sums_hold_the_f64_bound():
    """extended_stats and a stats sub-aggregation of histogram over
    load_sorted_index's views, whose squares pass 2^24: both packages
    within n * 2^-24 * sum|v| of the f64 sums, and the port's
    sum_of_squares no further from the f64 sum than 4x the reference's
    (K6's plain version sums in K6's two levels, chunk partials first)."""
    body = {"size": 0, "aggs": {
        "x": {"extended_stats": {"field": "views"}},
        "h": {"histogram": {"field": "views", "interval": 2500},
              "aggs": {"s": {"stats": {"field": "views"}}}}}}
    out = []
    for node in (JNode(), TNode(device="cpu")):
        load_sorted_index(node)
        out.append(node.request("POST", "/sorted/_search", body))
    docs = node.request("POST", "/sorted/_search",
                        {"size": 5000, "_source": ["views"]})["hits"]["hits"]
    v = np.array([h["_source"]["views"] for h in docs
                  if "views" in h["_source"]], dtype=np.float64)
    n = len(v)
    dist = []
    for resp in out:
        x = resp["aggregations"]["x"]
        assert x["count"] == n
        assert abs(x["sum"] - v.sum()) <= f32_sum_bound(n, v.sum())
        d = abs(x["sum_of_squares"] - (v * v).sum())
        assert d <= f32_sum_bound(n, (v * v).sum())
        dist.append(d)
        for b in resp["aggregations"]["h"]["buckets"]:
            sel = v[(v >= b["key"]) & (v < b["key"] + 2500)]
            assert b["s"]["count"] == len(sel)
            assert abs(b["s"]["sum"] - sel.sum()) \
                <= f32_sum_bound(len(sel), sel.sum())
    print(f"sum_of_squares distance from f64: reference {dist[0]}, "
          f"port {dist[1]}")
    assert dist[1] <= 4 * dist[0]
