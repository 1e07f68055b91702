"""Structured filters of opensearch_tpu_torch held against opensearch_tpu:
`range` (numeric, date with a format and `||` date math, keyword), numeric
/ date / boolean `term` and `terms`, `exists` and `dis_max`, alone and in
`bool`, through both Nodes' `_search` and `_msearch` on the structured
corpus (two segments, multi-valued tags, docs without views). Plus K4's
plain version against the reference's range_match_on_ranks and
ordinal_terms_match on the identity and the pairs layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops.bm25 import ordinal_terms_match as j_terms
from opensearch_tpu.ops.bm25 import range_match_on_ranks as j_range

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops import bm25

from test_torch_common import (BASE_TS, DAY_MS, assert_same_response,
                               load_docs_index, msearch_ndjson)

INDEX = "docs"
N_DOCS = 1500

FILTER_BODIES = {
    "range_int": {"query": {"range": {"views": {"gte": 1200, "lt": 1900}}},
                  "size": 12},
    "range_gt_lte": {"query": {"range": {"views": {"gt": 9000,
                                                   "lte": 9500}}}},
    "range_legacy": {"query": {"range": {"views": {
        "from": 100, "to": 300, "include_upper": False}}}, "size": 4},
    "range_date_math": {"query": {"range": {"ts": {
        "gte": "2023-12-01||-1d/d", "lt": "2023-12-20||/d"}}},
        "size": 7},
    "range_date_format": {"query": {"range": {"ts": {
        "gt": "2024-01-10", "format": "yyyy-MM-dd",
        "time_zone": "+00:00"}}}},
    "range_date_millis": {"query": {"range": {"ts": {
        "lte": BASE_TS + 3 * DAY_MS}}}, "size": 20},
    "range_keyword": {"query": {"range": {"tag": {"gte": "cat12",
                                                  "lt": "cat3"}}}},
    "range_keyword_open": {"query": {"range": {"tag": {"gt": "cat8"}}},
                           "size": 3},
    "term_int": {"query": {"term": {"views": 4870}}},
    "term_int_string": {"query": {"term": {"views": {"value": "3438",
                                                     "boost": 2.0}}}},
    "terms_int": {"query": {"terms": {"views": [310, 4123, 9668, 77, -5]}}},
    "term_date": {"query": {"term": {"ts": "2023-12-01T12:40:51.038Z"}}},
    "terms_date": {"query": {"terms": {"ts": [1702034628623,
                                              "2023-11-20T00:00:00Z"]}}},
    "exists_numeric": {"query": {"exists": {"field": "views"}},
                       "size": 15},
    "exists_keyword": {"query": {"exists": {"field": "tag"}}, "size": 3},
    "missing_numeric": {"query": {"bool": {"must_not": [
        {"exists": {"field": "views"}}]}}},
    "exists_text": {"query": {"exists": {"field": "body", "boost": 3}}},
    "exists_none": {"query": {"exists": {"field": "nope"}}},
    "dis_max": {"query": {"dis_max": {"queries": [
        {"match": {"body": "w00011 w00004"}},
        {"term": {"tag": "multi"}},
        {"range": {"views": {"lt": 30}}}], "tie_breaker": 0.3}},
        "size": 25},
    "dis_max_empty": {"query": {"dis_max": {"queries": []}}},
    "bool_filters": {"query": {"bool": {
        "must": [{"match": {"body": "w00021"}}],
        "filter": [{"range": {"views": {"gte": 2000}}},
                   {"terms": {"tag": ["cat1", "cat4", "multi"]}}],
        "must_not": [{"range": {"ts": {"lt": BASE_TS + 10 * DAY_MS}}}]}},
        "size": 30},
    "should_ranges": {"query": {"bool": {"should": [
        {"range": {"views": {"lt": 200}}},
        {"range": {"views": {"gte": 9800}}},
        {"term": {"views": 5000}}], "minimum_should_match": 1}},
        "from": 3, "size": 10},
}

BOOL_MAPPING = {"mappings": {"properties": {"flag": {"type": "boolean"},
                                            "n": {"type": "long"}}}}
BOOL_DOCS = [{"flag": True, "n": 1}, {"flag": False, "n": 2},
             {"flag": [True, False], "n": 3}, {"n": 4},
             {"flag": "true", "n": [5, 6]}, {"flag": "false"}]
BOOL_BODIES = {
    "term_bool": {"query": {"term": {"flag": True}}},
    "term_bool_string": {"query": {"term": {"flag": "false"}}},
    "terms_bool": {"query": {"terms": {"flag": [False]}}},
    "exists_bool": {"query": {"exists": {"field": "flag"}}},
    "range_long": {"query": {"range": {"n": {"gte": 2, "lte": 5}}}},
}


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        load_docs_index(node, INDEX, n_docs=N_DOCS)
        assert node.request("PUT", "/flags", BOOL_MAPPING)["_status"] == 200
        for i, doc in enumerate(BOOL_DOCS):
            node.request("PUT", f"/flags/_doc/{i}", doc)
            if i == 2:
                node.request("POST", "/flags/_refresh")
        node.request("POST", "/flags/_refresh")
    return jn, tn


@pytest.mark.parametrize("name", sorted(FILTER_BODIES))
def test_filter_search_matches_reference(nodes, name):
    jn, tn = nodes
    body = FILTER_BODIES[name]
    want = jn.request("POST", f"/{INDEX}/_search", body)
    got = tn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 200
    assert_same_response(got, want, name)


@pytest.mark.parametrize("name", sorted(BOOL_BODIES))
def test_boolean_and_long_filters_match_reference(nodes, name):
    jn, tn = nodes
    body = BOOL_BODIES[name]
    want = jn.request("POST", "/flags/_search", body)
    assert want["_status"] == 200 and want["hits"]["total"]["value"] > 0
    assert_same_response(tn.request("POST", "/flags/_search", body), want,
                         name)


def test_filter_msearch_matches_reference(nodes):
    jn, tn = nodes
    payload = msearch_ndjson(INDEX, [FILTER_BODIES[n]
                                     for n in sorted(FILTER_BODIES)])
    want = jn.request("POST", "/_msearch", payload)
    assert_same_response(tn.request("POST", "/_msearch", payload), want,
                         "msearch")


def _columns(ident: bool, seed: int):
    """A value-pair column (doc ids, ranks) on the identity layout or a
    sorted multi-valued one with missing docs, padded to NVp."""
    rng = np.random.default_rng(seed)
    n_docs = 300
    if ident:
        nv = 260
        doc_ids = np.arange(nv, dtype=np.int32)
    else:
        per_doc = rng.integers(0, 4, n_docs)
        doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), per_doc)
        nv = len(doc_ids)
    nv_pad = 1 << int(np.ceil(np.log2(nv)))
    d = np.full(nv_pad, -1, np.int32)
    d[:nv] = doc_ids
    o = np.zeros(nv_pad, np.int32)
    o[:nv] = rng.integers(0, 40, nv)
    return d, o, 512


@pytest.mark.parametrize("ident", [True, False])
def test_pairs_match_plain_equals_reference(ident):
    d, o, d_pad = _columns(ident, 3)
    rng = np.random.default_rng(4)
    lo = rng.integers(-2, 40, 6).astype(np.int32)
    hi = (lo + rng.integers(0, 20, 6)).astype(np.int32)
    mask = rng.random((6, 64)) < 0.3
    got_r = bm25.range_match_on_ranks(torch.from_numpy(d), torch.from_numpy(o),
                                      torch.from_numpy(lo),
                                      torch.from_numpy(hi), d_pad, ident)
    got_t = bm25.ordinal_terms_match(torch.from_numpy(d), torch.from_numpy(o),
                                     torch.from_numpy(mask), d_pad, ident)
    for b in range(6):
        want_r = np.asarray(j_range(jnp.asarray(d), jnp.asarray(o),
                                    int(lo[b]), int(hi[b]), d_pad, ident))
        want_t = np.asarray(j_terms(jnp.asarray(d), jnp.asarray(o),
                                    jnp.asarray(mask[b]), d_pad, ident))
        np.testing.assert_array_equal(got_r[b].numpy(), want_r)
        np.testing.assert_array_equal(got_t[b].numpy(), want_t)
    assert got_r.shape == (6, d_pad) and got_r.dtype == torch.bool
