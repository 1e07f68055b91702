"""The segment filter cache of opensearch_tpu_torch (indices/query_cache.py)
held against opensearch_tpu's: a repeated `bool.filter` on the general path
gives the reference's pages on its first (no caching: one use), second
(fills the mask of every segment) and third (served from the masks) run;
deletes after caching stay right (cached masks exclude liveness); a range
with `now` never caches; and the mask the cache fills equals the
reference's `_eval_filter_mask` on the same segment."""

import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.indices import query_cache as jqc
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops.device_segment import upload_segment as j_upload
from opensearch_tpu.search import dsl as jdsl
from opensearch_tpu.search.compile import Compiler as JCompiler
from opensearch_tpu.search.compile import ShardStats as JStats

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import segment_from_arrays
from opensearch_tpu_torch.indices import query_cache as tqc
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search.compile import Compiler as TCompiler
from opensearch_tpu_torch.search.compile import ShardStats as TStats

from test_torch_common import (DOCS_MAPPING, assert_same_response,
                               docs_corpus, load_sorted_index,
                               segment_arrays)

INDEX = "cached"
N_DOCS = 900
FILTERED = {"query": {"bool": {
    "must": [{"match": {"body": "w00011 w00004"}}],
    "filter": [{"range": {"views": {"gte": 2000, "lt": 7000}}},
               {"terms": {"tag": ["cat1", "cat2", "cat5", "multi"]}}]}},
    "sort": [{"views": "desc"}], "size": 15}


@pytest.fixture
def nodes():
    jqc.QUERY_CACHE.clear()
    tqc.QUERY_CACHE.clear()
    jn, tn = JNode(), TNode(device="cpu")
    for n in (jn, tn):
        load_sorted_index(n, INDEX, N_DOCS)
    yield jn, tn
    jqc.QUERY_CACHE.clear()
    tqc.QUERY_CACHE.clear()


def _same(jn, tn, body):
    want = jn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 200 and want["hits"]["hits"]
    assert_same_response(tn.request("POST", f"/{INDEX}/_search", body), want)


def test_repeated_filter_fills_then_serves_the_cache(nodes):
    jn, tn = nodes
    n_segs = len(tn.indices.get(INDEX).shards[0].reader.segments)
    _same(jn, tn, FILTERED)        # one use: nothing cached
    assert tqc.QUERY_CACHE.stats()["cache_count"] == 0
    _same(jn, tn, FILTERED)        # second use: both filters, every segment
    assert tqc.QUERY_CACHE.stats()["cache_count"] == 2 * n_segs
    hits = tqc.QUERY_CACHE.stats()["hit_count"]
    _same(jn, tn, FILTERED)        # served from the masks
    assert tqc.QUERY_CACHE.stats()["hit_count"] == hits + 2 * n_segs


def test_deletes_after_caching_stay_right(nodes):
    jn, tn = nodes
    for _ in range(2):
        _same(jn, tn, FILTERED)
    first = tn.request("POST", f"/{INDEX}/_search", FILTERED)
    gone = [h["_id"] for h in first["hits"]["hits"][:4]]
    for n in (jn, tn):
        for doc_id in gone:
            assert n.request("DELETE", f"/{INDEX}/_doc/{doc_id}")[
                "_status"] == 200
        n.request("POST", f"/{INDEX}/_refresh")
    count = tqc.QUERY_CACHE.stats()["cache_count"]
    _same(jn, tn, FILTERED)
    assert tqc.QUERY_CACHE.stats()["cache_count"] == count
    after = tn.request("POST", f"/{INDEX}/_search", FILTERED)
    assert not set(gone) & {h["_id"] for h in after["hits"]["hits"]}
    assert after["hits"]["total"]["value"] == \
        first["hits"]["total"]["value"] - len(gone)


def test_now_range_never_caches(nodes):
    jn, tn = nodes
    body = {"query": {"bool": {"filter": [{"range": {"ts": {
        "gte": "now-36500d"}}}]}}, "sort": [{"ts": "asc"}], "size": 5}
    for _ in range(3):
        _same(jn, tn, body)
    assert tqc.QUERY_CACHE.stats()["cache_count"] == 0


@pytest.mark.parametrize("query", [
    {"range": {"views": {"gte": 1500, "lte": 8000}}},
    {"terms": {"tag": ["cat3", "multi"]}},
    {"match": {"body": "w00004 w00017"}},
    {"bool": {"should": [{"term": {"tag": "cat9"}},
                         {"range": {"ts": {"lt": 1701000000000}}}]}},
])
def test_filter_mask_equals_reference(query):
    docs = docs_corpus(700, seed=4)
    mapper = JMapper(DOCS_MAPPING["mappings"])
    builder = JBuilder(mapper)
    for i, d in enumerate(docs):
        builder.add(mapper.parse_document(f"d{i}", d))
    seg = builder.seal()
    jarrays, jmeta = j_upload(seg)
    jplan = JCompiler(mapper, JStats([seg])).compile(
        jdsl.parse_query(query), seg, jmeta)
    want = jqc._eval_filter_mask(jplan, jarrays)
    tseg = segment_from_arrays(segment_arrays(seg))
    tarrays, tmeta = upload_segment(tseg, torch.device("cpu"))
    tplan = TCompiler(TMapper(DOCS_MAPPING["mappings"]),
                      TStats([tseg])).compile(tdsl.parse_query(query), tseg,
                                              tmeta)
    got = tqc._eval_filter_mask(tplan, tarrays)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert 0 < got.sum() < seg.num_docs
