"""The remaining aggregation kinds of opensearch_tpu_torch held against
opensearch_tpu on the same corpus: utils/demo.taxi_docs (the structured
tag / views / ts fields plus a float `fare` in cents that ~2% of docs lack
and an integer `passengers`) with a short text `body`, 3,000 docs over
three segments with re-indexed and deleted docs, through both Nodes.

- every kind of the slice (range, date_range, filters keyed and anonymous,
  global, missing, percentiles, percentile_ranks,
  median_absolute_deviation, weighted_avg, composite with `after`,
  multi_terms, auto_date_histogram, significant_terms, adjacency_matrix,
  matrix_stats) at the root, under `terms` and under `date_histogram`;
- every pipeline type;
- `_search`, and `_msearch` at B=1 and B=8.

Contract: responses equal, except where a value comes from f32 sums that
may round in another order. Every value here is an integer and a
segment's sums of fare, views, passengers and fare * passengers stay
below 2^24, so sums are exact and equal too. matrix_stats sums powers up
to v^4, which round: each f32 sum lies within n * 2^-24 * sum|term| of
its exact value, below 9e-5 of sum|term| here (n <= 1,500 docs a
segment), so the two packages' sums lie within MATRIX_SUM_REL = 2e-4 of
each other, and each derived value (mean, variance, skewness, kurtosis,
covariance, correlation) holds to that error carried through its formula
(test_torch_common's matrix_stats_tol), times MATRIX_PROPAGATION = 4 for
the errors of its denominator.

Beside them, the plain versions of the slice's kernels against the
reference's device functions: K15 bit for bit against
opensearch_tpu.search.plan_eval.dense_numeric, K16 against the
reference's matrix_stats partials (counts exactly, sums within n * 2^-24
* sum|term| of the f64 sums), K17 exactly against its adjacency
partials.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import plan_eval as jplan_eval
from opensearch_tpu.search.aggs import engine as jengine
from opensearch_tpu.search.aggs.parse import parse_aggs as j_parse_aggs
from opensearch_tpu.search.compile import Compiler as JCompiler

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import agg_kernels
from opensearch_tpu_torch.search.aggs import engine as tengine
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
from opensearch_tpu_torch.search.compile import Compiler as TCompiler

from test_torch_common import (AGG_KIND_BODIES as BODIES,
                               AGG_KINDS as KINDS, TAXI_N as N_DOCS,
                               assert_same_response, load_taxi_index,
                               matrix_stats_tol, taxi_corpus)


def assert_same(got, want, path):
    assert_same_response(got, want, path,
                         agg_sum_tol=matrix_stats_tol(want, path))


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    load_taxi_index(jn)
    load_taxi_index(tn)
    return jn, tn


@pytest.fixture(scope="module")
def want(nodes):
    jn, _tn = nodes
    out = {}
    for name, body in BODIES.items():
        res = jn.request("POST", "/taxi/_search", body)
        assert res["_status"] == 200, (name, res)
        out[name] = res
    return out


@pytest.mark.parametrize("name", sorted(BODIES))
def test_kind_search_matches_reference(nodes, want, name):
    _jn, tn = nodes
    got = tn.request("POST", "/taxi/_search", BODIES[name])
    assert_same(got, want[name], name)


@pytest.mark.parametrize("bsz", [1, 8])
def test_kind_msearch_matches_reference(nodes, want, bsz):
    _jn, tn = nodes
    names = sorted(BODIES)
    for lo in range(0, len(names), bsz):
        chunk = names[lo:lo + bsz]
        lines = []
        for n in chunk:
            lines += [{"index": "taxi"}, BODIES[n]]
        got = tn.request("POST", "/_msearch", lines)
        assert got["_status"] == 200
        for n, resp in zip(chunk, got["responses"]):
            resp = dict(resp)
            assert resp.pop("status") == 200, (n, resp)
            want_n = {k: v for k, v in want[n].items() if k != "_status"}
            assert_same(resp, want_n, f"msearch[{n}]")


def test_general_path_serves_the_new_kinds(nodes):
    """A field-sorted body (the general path) with the new kinds and a
    sibling pipeline."""
    jn, tn = nodes
    body = {"size": 5, "sort": [{"fare": "desc"}],
            "query": {"range": {"passengers": {"gte": 3}}},
            "aggs": {"r": KINDS["range"], "c": KINDS["composite"],
                     "p": KINDS["percentiles"], "m": KINDS["matrix_stats"],
                     "t": {"terms": {"field": "tag"}},
                     "mb": {"max_bucket": {"buckets_path": "t>_count"}}}}
    want = jn.request("POST", "/taxi/_search", body)
    assert want["_status"] == 200
    assert_same(tn.request("POST", "/taxi/_search", body), want, "general")


def test_kinds_compile_to_their_device_kinds(nodes):
    """The slice's kinds take the device kinds they port."""
    _jn, tn = nodes
    ex = tn.indices.get("taxi").shards[0].executor
    stats, segments, device = ex.reader.stats_snapshot()
    comp = TCompiler(ex.reader.mapper, stats)
    kinds = set()
    for name, body in BODIES.items():
        plans = tengine.compile_aggs(
            tengine.device_nodes(parse_aggs(body["aggs"])), ex.reader.mapper,
            segments[0], device[0][1], comp)
        stack = list(plans)
        while stack:
            p = stack.pop()
            kinds.add(p.kind)
            stack.extend(p.children)
    assert {"multi", "global", "missing", "bucket_dense", "value_hist",
            "weighted_avg", "adjacency", "matrix_stats",
            "bucket_bits"} <= kinds


def test_unsupported_aggs_names_only_the_waiting_types():
    for t, body in (("ip_range", {"field": "ip", "ranges": [{"to": "1"}]}),
                    ("top_hits", {}), ("scripted_metric", {})):
        assert tengine.unsupported_aggs(parse_aggs({"a": {t: body}})) == t
    # served since the nested and geo slice
    for t, body in (("nested", {"path": "x"}), ("reverse_nested", {}),
                    ("geo_bounds", {"field": "g"}),
                    ("geo_centroid", {"field": "g"}),
                    ("geohash_grid", {"field": "g"}),
                    ("geotile_grid", {"field": "g"})):
        assert tengine.unsupported_aggs(parse_aggs({"a": {t: body}})) is None
    for body in list(BODIES.values()):
        assert tengine.unsupported_aggs(parse_aggs(body["aggs"])) is None


def test_values_are_the_documented_ones(nodes):
    """A few absolute values against numpy, so parity cannot hide a fault
    both packages share."""
    _jn, tn = nodes
    docs = {}
    for i, d in enumerate(taxi_corpus()):
        docs[f"d{i}"] = d
    cuts = [0, N_DOCS // 3, 2 * N_DOCS // 3, N_DOCS]
    for s in (1, 2):
        for i in range(s, cuts[s], 131):
            docs[f"d{i}"] = taxi_corpus()[(i * 7) % N_DOCS]
        for i in range(s + 4, cuts[s], 97):
            docs.pop(f"d{i}", None)
    fares = np.array([d["fare"] for d in docs.values() if "fare" in d])
    body = {"size": 0, "aggs": {
        "p": {"percentiles": {"field": "fare", "percents": [50]}},
        "m": {"missing": {"field": "fare"}},
        "g": {"global": {}}}}
    out = tn.request("POST", "/taxi/_search", body)["aggregations"]
    assert out["p"]["values"]["50.0"] == float(np.percentile(fares, 50))
    assert out["m"]["doc_count"] == len(docs) - len(fares)
    assert out["g"]["doc_count"] == len(docs)


# ------------------------------------------ plain versions vs reference

def _images(node_pair):
    """The reference's and the port's device images of the first segment
    of `taxi`, with a compiler each."""
    jn, tn = node_pair
    jex = jn.indices.get("taxi").shards[0].executor
    tex = tn.indices.get("taxi").shards[0].executor
    jstats, jsegs, jdev = jex.reader.stats_snapshot()
    tstats, tsegs, tdev = tex.reader.stats_snapshot()
    return ((jex.reader.mapper, jsegs[0], jdev[0], JCompiler(
        jex.reader.mapper, jstats)),
        (tex.reader.mapper, tsegs[0], tdev[0], TCompiler(
            tex.reader.mapper, tstats)))


@pytest.mark.parametrize("field", ["fare", "views", "passengers"])
def test_dense_numeric_plain_equals_reference(nodes, field):
    """K15's plain version bit for bit against the reference's
    dense_numeric (value, exists and count)."""
    (_jm, _js, (jarr, jmeta), _jc), (_tm, _ts, (tarr, tmeta), _tc) = \
        _images(nodes)
    want = jplan_eval.dense_numeric(jarr, field, jmeta.d_pad, -3.0)
    col = tarr["numeric"][field]
    got = agg_kernels.dense_numeric_plain(col["doc_ids"], col["values_f32"],
                                          tmeta.d_pad, -3.0)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(want[0]).view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))


def _eval_both(node_pair, aggs: dict, bsz: int = 3):
    """One segment's agg partials of both packages for `bsz` random
    eligibility masks: (reference outs per query, port outs)."""
    (jm, jseg, (jarr, jmeta), jcomp), (tm, tseg, (tarr, tmeta), tcomp) = \
        _images(node_pair)
    jplans = jengine.compile_aggs(j_parse_aggs(aggs), jm, jseg, jmeta, jcomp)
    tplans = tengine.compile_aggs(parse_aggs(aggs), tm, tseg, tmeta, tcomp)
    rng = np.random.default_rng(17)
    masks = rng.random((bsz, jmeta.d_pad)) < 0.7
    masks &= np.asarray(jarr["live"])[None, :]
    want = []
    for b in range(bsz):
        flat = []
        for p in jplans:
            p.flatten_inputs(flat)
        outs = []
        jengine.eval_aggs(jplans, jarr, [{k: jnp.asarray(v)
                                          for k, v in d.items()}
                                         for d in flat], [0],
                          jnp.asarray(masks[b]), outs)
        want.append(outs)
    flat = []
    for p in tplans:
        p.flatten_inputs(flat)
    inputs = [{k: torch.from_numpy(np.stack([v] * bsz))
               for k, v in d.items()} for d in flat]
    outs = []
    tengine.eval_aggs(tplans, tarr, inputs, [0], torch.from_numpy(masks),
                      outs, tengine.agg_statics(tseg, tplans, "cpu"))
    return want, outs, masks


def test_matrix_moments_plain_matches_reference_partials(nodes):
    """K16's plain version against the reference's matrix_stats partials,
    at the root and under terms: counts exactly; each side's sums lie
    within n * 2^-24 * sum|term| of the f64 sums of the f32 terms, so the
    two within twice that."""
    aggs = {"m": KINDS["matrix_stats"],
            "t": {"terms": {"field": "tag"},
                  "aggs": {"m": KINDS["matrix_stats"]}}}
    want, got, masks = _eval_both(nodes, aggs)
    (_jm, _js, (jarr, _), _jc), _ = _images(nodes)
    for node_i in (0, 2):
        for key, arr in got[node_i].items():
            for b in range(len(want)):
                w = np.asarray(want[b][node_i][key])
                g = arr[b].numpy()
                if key.endswith("::cnt"):
                    np.testing.assert_array_equal(g, w, err_msg=key)
                else:
                    # each side within the bound of the exact sum
                    bound = _moment_bound(jarr, masks[b], key, node_i, got,
                                          b)
                    assert np.all(np.abs(g.astype(np.float64) - w)
                                  <= 2.0 * bound), key


def _moment_bound(jarr, mask, key, node_i, got, b):
    """n * 2^-24 * sum|term| per bin for one matrix_stats partial."""
    name, part = key.split("::")
    cnt_key = f"{name}::cnt"
    n = got[node_i][cnt_key][b].numpy().astype(np.float64)
    fields = name.split("*")
    vals = []
    for f in fields:
        v, e, _c = jplan_eval.dense_numeric(jarr, f, mask.shape[0])
        vals.append((np.asarray(v).astype(np.float32), np.asarray(e)))
    own = mask.copy()
    for _v, e in vals:
        own &= e
    x = vals[0][0]
    y = vals[-1][0]
    x2 = x * x
    term = {"sum": x, "sum2": x2, "sum3": x2 * x, "sum4": x2 * x2,
            "sumxy": x * y, "sumx": x, "sumy": y}[part]
    t = np.abs(np.where(own, term, 0.0).astype(np.float64))
    if node_i == 0:
        return n * 2.0 ** -24 * t.sum()
    # under terms: per tag bin (the doc's tag ordinal)
    col = jarr["ordinal"]["tag"]
    doc_ids = np.asarray(col["doc_ids"])
    ords = np.asarray(col["ords"])
    per = np.zeros(n.shape[0])
    ok = doc_ids >= 0
    np.add.at(per, ords[ok], t[doc_ids[ok]])
    return n * 2.0 ** -24 * per


def test_adjacency_plain_equals_reference_partials(nodes):
    """K17's plain version exactly against the reference's adjacency
    partials, at the root and under terms."""
    aggs = {"a": KINDS["adjacency_matrix"],
            "t": {"terms": {"field": "tag"},
                  "aggs": {"a": KINDS["adjacency_matrix"]}}}
    want, got, _masks = _eval_both(nodes, aggs)
    for node_i in (0, 2):
        assert sorted(got[node_i]) == sorted(want[0][node_i])
        for key, arr in got[node_i].items():
            for b in range(len(want)):
                np.testing.assert_array_equal(
                    arr[b].numpy(), np.asarray(want[b][node_i][key]),
                    err_msg=key)


@pytest.mark.parametrize("n,card", [(5, 1), (33, 1), (50, 7)])
def test_adjacency_blocks_cover_every_pair(n, card):
    """K17's launches past 32 filters (one per pair of filter blocks),
    rehearsed with its plain version as the launch: no launch takes more
    than 32 filters and every cell equals the one-call count exactly."""
    gen = torch.Generator().manual_seed(n)
    d_pad, bsz = 512, 3
    masks = [torch.rand(bsz, d_pad, generator=gen) < 0.4 for _ in range(n)]
    mask = torch.rand(bsz, d_pad, generator=gen) < 0.7
    pbin = None if card == 1 else torch.randint(
        -1, card, (d_pad,), generator=gen, dtype=torch.int32)
    calls = []

    def launch(sub):
        assert len(sub) <= agg_kernels.ADJACENCY_MAX_FILTERS
        calls.append(len(sub))
        return agg_kernels.adjacency_counts_plain(sub, mask, None, pbin,
                                                  card)
    got = agg_kernels.adjacency_blocked(masks, launch)
    assert len(calls) == len(agg_kernels.adjacency_blocks(n))
    assert (len(calls) == 1) == (n <= agg_kernels.ADJACENCY_MAX_FILTERS)
    assert torch.equal(got, agg_kernels.adjacency_counts_plain(
        masks, mask, None, pbin, card))


@pytest.mark.parametrize("after", [{"t": "cat3", "p": "2"},
                                   {"t": 3, "p": 2}],
                         ids=["number_as_string", "tag_as_number"])
def test_composite_after_of_another_type(nodes, after):
    """An `after` key whose type is not its source's (a string for a
    number, a number for a keyword) pages as the reference orders mixed
    keys: numbers before strings."""
    jn, tn = nodes
    body = {"size": 0, "aggs": {"c": {"composite": {
        "size": 5, "after": after, "sources": [
            {"t": {"terms": {"field": "tag"}}},
            {"p": {"terms": {"field": "passengers"}}}]}}}}
    want = jn.request("POST", "/taxi/_search", body)
    assert want["_status"] == 200
    assert_same(tn.request("POST", "/taxi/_search", body), want, "after")


def test_global_follows_deletes_after_a_query():
    """`global` counts the live docs: deletes that a refresh publishes
    after the aggregation's static side was built change its count."""
    body = {"size": 0, "query": {"range": {"views": {"gte": 5000}}},
            "aggs": {"g": {"global": {}, "aggs": {
                "m": {"missing": {"field": "fare"}}}}}}
    out = []
    for node in (JNode(), TNode(device="cpu")):
        load_taxi_index(node, n_docs=600)
        first = node.request("POST", "/taxi/_search", body)
        lines = "".join(json.dumps({"delete": {"_index": "taxi",
                                               "_id": f"d{i}"}}) + "\n"
                        for i in range(0, 600, 7))
        assert not node.request("POST", "/_bulk", lines)["errors"]
        node.request("POST", "/taxi/_refresh")
        out.append((first, node.request("POST", "/taxi/_search", body)))
    (want1, want2), (got1, got2) = out
    assert want2["aggregations"]["g"]["doc_count"] \
        < want1["aggregations"]["g"]["doc_count"]
    assert_same(got1, want1, "before")
    assert_same(got2, want2, "after")
