"""Block-max pruning (K20) of opensearch_tpu_torch held against
opensearch_tpu: the plain `blockmax_keep_mask` against the reference's on
the same segment and plan inputs (keep masks and pruned counts exactly),
and pages with the node setting `search.blockmax.enabled` on, through
both Nodes' REST surface, on the envelope's candidate kernel (one shard)
and on the multi-shard program (two shards).

The contract, as tests/test_blockmax.py holds the reference to it: the
gate-on page is byte-identical to the gate-off page; the total is a lower
bound with relation `gte` exactly when lanes were pruned; a caller's
min_score, a bool / filter composition and a sort disable pruning. Both
packages prune the same lanes, so their gate-on responses (totals and
relations included) are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.indices.request_cache import REQUEST_CACHE
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import dsl as jdsl
from opensearch_tpu.search import spmd as jspmd
from opensearch_tpu.search.compile import Compiler as JCompiler

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search import spmd as tspmd
from opensearch_tpu_torch.search.compile import Compiler as TCompiler

from test_torch_common import (ZIPF_QUERIES, assert_same_response,
                               load_zipf_index, zipf_bodies)

DELETED = [f"d{i}" for i in range(0, 30)] + ["d100", "d200"]


def _nodes():
    """Reference and port Nodes: zipf (one shard), zipf2 (two shards) and
    zdel (one shard, the burst docs deleted); the port once with the gate
    on and once off."""
    jn = JNode()
    tn = TNode(device="cpu", settings={"search.blockmax.enabled": "true"})
    off = TNode(device="cpu")
    for node in (jn, tn, off):
        load_zipf_index(node, "zipf", 1)
        load_zipf_index(node, "zipf2", 2)
        load_zipf_index(node, "zdel", 1, DELETED)
    return jn, tn, off


@pytest.fixture(scope="module")
def nodes():
    return _nodes()


@pytest.fixture
def gate(monkeypatch):
    """The reference's gate is a module global: on for this test."""
    monkeypatch.setattr(jbm25, "BLOCKMAX", True)


def _page(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


# ------------------------------------------- K20's plain version vs JAX

@pytest.mark.parametrize("k", [1, 10, 100, 1024])
@pytest.mark.parametrize("index", ["zipf", "zdel"])
def test_keep_mask_plain_equals_reference(nodes, gate, index, k):
    """Per query: the compiled phase-A inputs (`tid`, `bscale`) agree, and
    the plain keep mask and pruned count equal the reference's exactly,
    with and without a caller's min_score."""
    jn, tn, _off = nodes
    jshard = jn.indices.get(index).shards[0]
    tshard = tn.indices.get(index).shards[0]
    jstats, jsegs, jdev = jshard.reader.stats_snapshot()
    tstats, tsegs, tdev = tshard.reader.stats_snapshot()
    jarrays, jmeta = jdev[-1]
    tarrays, tmeta = tdev[-1]
    checked = 0
    for q in ZIPF_QUERIES:
        jplan = JCompiler(jshard.reader.mapper, jstats).compile(
            jdsl.parse_query({"match": {"body": q}}), jsegs[-1], jmeta)
        tplan = TCompiler(tshard.reader.mapper, tstats,
                          blockmax=True).compile(
            tdsl.parse_query({"match": {"body": q}}), tsegs[-1], tmeta)
        assert tplan.kind == jplan.kind == "text"
        for key in ("ids", "w", "tid", "bscale", "row", "avgdl", "b", "k1",
                    "min_hits"):
            assert np.array_equal(tplan.inputs[key], jplan.inputs[key]), key
        if tplan.inputs["ids"].shape[-1] < tbm25.BLOCKMAX_MIN_BLOCKS:
            continue
        n_terms = tplan.static[1]
        blk = {key: torch.from_numpy(np.asarray(v)[None])
               for key, v in tplan.inputs.items()}
        for min_score in (float("-inf"), 2.0):
            want_keep, want_pruned = jbm25.blockmax_keep_mask(
                jarrays, {key: jnp.asarray(v)
                          for key, v in jplan.inputs.items()},
                jnp.asarray(jplan.inputs["k1"]), n_terms, k,
                jnp.float32(min_score))
            keep, pruned = tbm25.blockmax_keep_mask(
                tarrays, blk, n_terms, k,
                torch.tensor([min_score], dtype=torch.float32))
            assert np.array_equal(keep[0].numpy(), np.asarray(want_keep))
            assert int(pruned[0]) == int(want_pruned)
            checked += 1
    assert checked >= 4


def test_keep_entries_of_k1_and_k2(nodes):
    """K1 and K2 with a keep mask score exactly what they score on the
    kept lanes alone, and K1's row gains the pruned lane."""
    _jn, tn, _off = nodes
    shard = tn.indices.get("zipf").shards[0]
    stats, segs, dev = shard.reader.stats_snapshot()
    arrays, meta = dev[0]
    plan = TCompiler(shard.reader.mapper, stats, blockmax=True).compile(
        tdsl.parse_query({"match": {"body": "w4 w0"}}), segs[0], meta)
    blk = {key: torch.from_numpy(np.asarray(v)[None])
           for key, v in plan.inputs.items()}
    ms = torch.tensor([float("-inf")])
    keep, pruned = tbm25.blockmax_keep_mask(arrays, blk, plan.static[1], 10,
                                            ms)
    assert int(pruned[0]) > 0
    kept = dict(blk, ids=torch.where(keep, blk["ids"], -1))
    s_keep, h_keep = tbm25.score_text_clause(arrays, blk, block_keep=keep)
    s_ref, h_ref = tbm25.score_text_clause(arrays, kept)
    assert torch.equal(s_keep, s_ref) and torch.equal(h_keep, h_ref)
    row = tbm25.bm25_candidate(arrays, blk, plan.static[1], False, 10, ms,
                               block_keep=keep, pruned=pruned)
    ref = tbm25.bm25_candidate(arrays, kept, plan.static[1], False, 10, ms)
    assert row.shape[1] == ref.shape[1] + 1
    assert torch.equal(row[:, :-1], ref)
    assert int(row[0, -1:].view(torch.int32)[0]) == int(pruned[0])


# ----------------------------------------------------- pages through REST

@pytest.mark.parametrize("index", ["zipf", "zipf2", "zdel"])
def test_gate_on_pages_equal_gate_off_and_reference(nodes, gate, index):
    """The envelope (zipf, zdel) and the multi-shard program (zipf2):
    gate-on pages byte-identical to the gate-off node's, totals lower
    bounds with `gte` exactly where pruned, and the reference's gate-on
    responses equal (totals and relations too)."""
    jn, tn, off = nodes
    pruned_any = False
    for body in zipf_bodies():
        REQUEST_CACHE.clear()
        j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        want = jn.request("POST", f"/{index}/_search", body)
        j1, t1 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        got = tn.request("POST", f"/{index}/_search", body)
        assert tspmd.SPMD_QUERIES[0] - t1 == j1 - j0 == (
            1 if index == "zipf2" else 0)
        assert_same_response(got, want)
        plain = off.request("POST", f"/{index}/_search", body)
        assert _page(got) == _page(plain)
        total, plain_total = got["hits"]["total"], plain["hits"]["total"]
        assert plain_total["relation"] == "eq"
        if total["relation"] == "gte":
            pruned_any = True
            assert total["value"] <= plain_total["value"]
        else:
            assert total == plain_total
    assert pruned_any, "the clustered-burst corpus must prune"
    if index == "zdel":
        for body in zipf_bodies((10,)):
            ids = {i for i, _ in _page(tn.request(
                "POST", "/zdel/_search", body))}
            assert not ids & set(DELETED)


def test_msearch_gate_on(nodes, gate):
    """A B=15 `_msearch` on the envelope: every item equals the
    reference's gate-on item and the gate-off node's page."""
    jn, tn, off = nodes
    lines = []
    for body in zipf_bodies():
        lines += [{"index": "zipf"}, body]
    want = jn.request("POST", "/_msearch", bulk_text(lines))
    got = tn.request("POST", "/_msearch", bulk_text(lines))
    plain = off.request("POST", "/_msearch", bulk_text(lines))
    assert_same_response(got, want)
    assert [_page(r) for r in got["responses"]] == \
        [_page(r) for r in plain["responses"]]
    assert any(r["hits"]["total"]["relation"] == "gte"
               for r in got["responses"])


def bulk_text(lines):
    import json
    return "".join(json.dumps(x) + "\n" for x in lines)


@pytest.mark.parametrize("index", ["zipf", "zipf2"])
@pytest.mark.parametrize("case", ["min_score", "filter", "sort",
                                  "constant"])
def test_pruning_disabled(nodes, gate, index, case):
    """A caller's min_score, a bool with a filter, a field sort and a
    constant-score clause never prune: the gate-on response equals the
    gate-off one exactly (relation `eq`) and the reference's."""
    jn, tn, off = nodes
    body = {"query": {"match": {"body": "w4 w0"}}, "size": 10}
    if case == "min_score":
        body["min_score"] = 1.0
    elif case == "filter":
        body["query"] = {"bool": {"must": [body["query"]], "filter": [
            {"range": {"n": {"gte": 100}}}]}}
    elif case == "sort":
        body["sort"] = [{"n": "desc"}]
    else:
        body["query"] = {"constant_score": {"filter": {"match": {
            "body": "w4 w0"}}}}
    REQUEST_CACHE.clear()
    want = jn.request("POST", f"/{index}/_search", body)
    got = tn.request("POST", f"/{index}/_search", body)
    assert_same_response(got, want)
    assert_same_response(got, off.request("POST", f"/{index}/_search", body))
    assert got["hits"]["total"]["relation"] == "eq"


def test_gate_is_a_node_start_setting():
    """Off by default; `search.blockmax.enabled` at node start turns the
    compiler's phase-A inputs on for every index of the node, and a bad
    value is the reference's settings error."""
    assert TNode(device="cpu").blockmax is False
    node = TNode(device="cpu", settings={"search.blockmax.enabled": True})
    assert node.blockmax is True
    from opensearch_tpu_torch.common.errors import SettingsError
    with pytest.raises(SettingsError):
        TNode(device="cpu", settings={"search.blockmax.enabled": "maybe"})
