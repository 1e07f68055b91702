"""The document write path of opensearch_tpu_torch held against
opensearch_tpu: the same REST requests to both Nodes, every response
(status and body) equal under `assert_same_response`.

- the four faults repaired: `op_type=create` / `_create`, `if_seq_no` /
  `if_primary_term` (URL and `_bulk` metadata), external versions, and an
  ingest pipeline (the request's or the index's `default_pipeline`), which
  the port answers with a 400 of the reference's error type, since it has
  no ingest pipelines;
- realtime and non-realtime GET, `_source` and `_mget`; `_update` in every
  body form (doc, upsert, doc_as_upsert, detect_noop, body CAS, unknown
  fields), and the port's 400 for a `script`; `_bulk` with update items;
  `_count` with a body and with `q`; index auto-creation and
  `action.auto_create_index: false`; `_flush` and `_forcemerge`;
- a nested block updated and deleted whole, and force-merged;
- BM25, terms-agg and field-sort pages after deletes, updates and a
  force-merge, on one shard and on three (one shard merged alone, the
  multi-shard program); an aggregation repeated across deletes (no
  per-segment cache may answer from before them);
- random sequences of writes, refreshes and merges (hypothesis).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from opensearch_tpu.indices.request_cache import REQUEST_CACHE
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import spmd as jspmd

from opensearch_tpu_torch.indices.query_cache import QUERY_CACHE
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import spmd as tspmd

from test_torch_common import (DOCS_MAPPING, assert_same_response,
                               bulk_ndjson, docs_corpus)

MAPPING = {"mappings": {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"}}}}
NESTED_MAPPING = {"mappings": {"properties": {
    "title": {"type": "text"},
    "comments": {"type": "nested", "properties": {
        "who": {"type": "keyword"}, "stars": {"type": "integer"}}}}}}


def same(nodes, method, path, body=None, **params):
    """One request to both Nodes; the port's response must equal the
    reference's. Returns the reference's."""
    REQUEST_CACHE.clear()
    jn, tn = nodes
    want = jn.request(method, path, body, **params)
    got = tn.request(method, path, body, **params)
    assert_same_response(got, want, f"{method} {path} {params}")
    return want


def same_error_type(nodes, method, path, body=None, **params):
    """Status and error type equal; the reason differs by design."""
    jn, tn = nodes
    want = jn.request(method, path, body, **params)
    got = tn.request(method, path, body, **params)
    assert got["_status"] == want["_status"]
    assert got["error"]["type"] == want["error"]["type"]
    assert got["error"]["root_cause"][0]["type"] == \
        want["error"]["root_cause"][0]["type"]
    return got


def ndjson(lines):
    return "".join(json.dumps(x) + "\n" for x in lines)


@pytest.fixture
def nodes():
    nodes = (JNode(), TNode(device="cpu"))
    same(nodes, "PUT", "/i", MAPPING)
    same(nodes, "PUT", "/i/_doc/1", {"title": "hello world", "n": 1})
    return nodes


# ------------------------------------------------------------- the repairs

def test_op_type_create_conflicts(nodes):
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "x"},
                op_type="create")["_status"] == 409
    assert same(nodes, "PUT", "/i/_create/1", {"title": "x"})[
        "_status"] == 409
    assert same(nodes, "PUT", "/i/_create/2", {"title": "x"})[
        "_status"] == 201
    same(nodes, "GET", "/i/_doc/1")


def test_if_seq_no_compare_and_set(nodes):
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "lost"}, if_seq_no=7,
                if_primary_term=1)["_status"] == 409
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "won"}, if_seq_no=0,
                if_primary_term=2)["_status"] == 409
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "won"}, if_seq_no=0,
                if_primary_term=1)["_status"] == 200
    assert same(nodes, "PUT", "/i/_doc/9", {"title": "x"}, if_seq_no=0,
                if_primary_term=1)["_status"] == 409
    same(nodes, "POST", "/i/_refresh")
    # the CAS holds against a refreshed doc too
    assert same(nodes, "DELETE", "/i/_doc/1", if_seq_no=0,
                if_primary_term=1)["_status"] == 409
    assert same(nodes, "DELETE", "/i/_doc/1", if_seq_no=1,
                if_primary_term=1)["_status"] == 200
    same(nodes, "GET", "/i/_doc/1")


def test_external_versions(nodes):
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "x"}, version=1,
                version_type="external")["_status"] == 409
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "x"}, version=10,
                version_type="external")["_status"] == 200
    assert same(nodes, "PUT", "/i/_doc/1", {"title": "y"}, version=10,
                version_type="external")["_status"] == 409
    same(nodes, "PUT", "/i/_doc/5", {"title": "y"}, version=3,
         version_type="external")
    # a version without version_type=external is not an external one
    same(nodes, "PUT", "/i/_doc/1", {"title": "z"}, version=1)
    same(nodes, "DELETE", "/i/_doc/5", version=4, version_type="external")
    same(nodes, "GET", "/i/_doc/1")
    same(nodes, "GET", "/i/_doc/5")


def test_pipeline_is_refused(nodes):
    got = same_error_type(nodes, "PUT", "/i/_doc/1", {"title": "x"},
                          pipeline="p")
    assert got["_status"] == 400
    assert got["error"]["reason"] == \
        "[pipeline] is not supported by opensearch_tpu_torch yet"
    same_error_type(nodes, "POST", "/_bulk",
                    ndjson([{"index": {"_index": "i", "_id": "4"}},
                            {"title": "x"}]), pipeline="p")
    # "_none" runs no pipeline
    same(nodes, "PUT", "/i/_doc/3", {"title": "x"}, pipeline="_none")
    body = dict(MAPPING, settings={"index": {"default_pipeline": "p"}})
    same(nodes, "PUT", "/dp", body)
    same_error_type(nodes, "PUT", "/dp/_doc/1", {"title": "x"})
    same(nodes, "PUT", "/dp/_doc/1", {"title": "x"}, pipeline="_none")
    # nothing was written by the refused requests
    same(nodes, "GET", "/i/_doc/1")
    same(nodes, "POST", "/_refresh")
    same(nodes, "POST", "/dp/_count")


def test_bulk_metadata_keeps_cas(nodes):
    same(nodes, "POST", "/_bulk", ndjson([
        {"index": {"_index": "i", "_id": "1", "if_seq_no": 5,
                   "if_primary_term": 1}}, {"title": "stale"},
        {"index": {"_index": "i", "_id": "1", "if_seq_no": 0,
                   "if_primary_term": 1}}, {"title": "fresh"},
        {"delete": {"_index": "i", "_id": "1", "if_seq_no": 0,
                    "if_primary_term": 1}},
        {"update": {"_index": "i", "_id": "1", "if_seq_no": 1,
                    "if_primary_term": 1}}, {"doc": {"n": 4}},
        {"create": {"_index": "i", "_id": "1"}}, {"title": "again"}]))
    same(nodes, "GET", "/i/_doc/1")


# ------------------------------------------------------------ reading back

def test_get_source_mget_realtime(nodes):
    same(nodes, "PUT", "/i/_doc/2", {"title": "two", "tag": "b"})
    for realtime in ("true", "false"):
        same(nodes, "GET", "/i/_doc/1", realtime=realtime)
        same(nodes, "GET", "/i/_doc/2", realtime=realtime)
    same(nodes, "GET", "/i/_source/1")
    same(nodes, "GET", "/i/_source/7")
    same(nodes, "GET", "/i/_doc/7")
    same(nodes, "POST", "/_mget", {"docs": [
        {"_index": "i", "_id": "1"}, {"_index": "nope", "_id": "1"},
        {"_index": "i", "_id": 2}, {"_index": "i", "_id": "77"}]})
    same(nodes, "POST", "/i/_mget", {"ids": ["1", "2", "3"]})
    assert same(nodes, "POST", "/i/_mget", {"x": 1})["_status"] == 400
    same(nodes, "POST", "/i/_refresh")
    same(nodes, "PUT", "/i/_doc/1", {"title": "rewritten"})
    same(nodes, "DELETE", "/i/_doc/2")
    for realtime in ("true", "false"):
        same(nodes, "GET", "/i/_doc/1", realtime=realtime)
        same(nodes, "GET", "/i/_doc/2", realtime=realtime)
    same(nodes, "GET", "/i/_doc/9", routing="r")


def test_index_service_mget_and_count(nodes):
    """IndexService's own mget (ids or {_id, routing} specs) and count,
    as the reference's."""
    same(nodes, "PUT", "/i/_doc/2", {"title": "two words", "n": 2})
    same(nodes, "POST", "/i/_refresh")
    same(nodes, "PUT", "/i/_doc/3", {"title": "three", "n": 3})
    jsvc, tsvc = (n.indices.get("i") for n in nodes)
    ids = ["1", {"_id": "2"}, {"_id": "3", "routing": "r"}, "9"]
    assert_same_response(tsvc.mget(ids), jsvc.mget(ids))
    for body in (None, {"query": {"match": {"title": "two"}}},
                 {"query": {"range": {"n": {"gte": 2}}}, "from": 5}):
        REQUEST_CACHE.clear()
        assert tsvc.count(body) == jsvc.count(body)


# ----------------------------------------------------------------- _update

def test_update_body_forms(nodes):
    same(nodes, "POST", "/i/_update/1", {"doc": {"n": 5}})
    same(nodes, "POST", "/i/_update/1", {"doc": {"n": 5}})          # noop
    same(nodes, "POST", "/i/_update/1", {"doc": {"n": 5},
                                         "detect_noop": False})
    same(nodes, "POST", "/i/_update/9", {"doc": {"n": 5}})          # 404
    same(nodes, "POST", "/i/_update/9", {"doc": {"n": 5},
                                         "doc_as_upsert": True})
    same(nodes, "POST", "/i/_update/10", {"upsert": {"n": 2},
                                          "doc": {"n": 3}})
    same(nodes, "POST", "/i/_update/10", {"upsert": {"n": 2},
                                          "doc": {"n": 3}})
    same(nodes, "POST", "/i/_update/10", {"dok": {"n": 3}})
    same(nodes, "POST", "/i/_update/10", {"upsert": {"n": 1}})
    same(nodes, "POST", "/i/_update/10", {"doc": {"x": {"y": 1}}})
    same(nodes, "POST", "/i/_update/10", {"doc": {"x": {"z": 2}}})
    same(nodes, "POST", "/i/_update/10", {"doc": {"n": 8},
                                          "if_seq_no": 0,
                                          "if_primary_term": 1})
    same(nodes, "POST", "/i/_update/10", {"doc": {"n": 8}}, if_seq_no=7,
         if_primary_term=1)
    same(nodes, "POST", "/i/_update/11", {"doc": {"n": 8}}, if_seq_no=7,
         if_primary_term=1)
    same(nodes, "POST", "/i/_update/10", {"doc": {"n": 8}}, version=20,
         version_type="external")
    same(nodes, "POST", "/i/_update/10", {"doc": {"n": 9}}, refresh="true")
    same(nodes, "GET", "/i/_doc/10", realtime="false")
    same(nodes, "POST", "/missing/_update/1", {"doc": {"n": 1},
                                               "doc_as_upsert": True})
    same(nodes, "GET", "/missing/_doc/1")


def test_update_script_answers_400(nodes):
    got = nodes[1].request("POST", "/i/_update/1",
                           {"script": {"source": "ctx._source.n += 1"}})
    assert got["_status"] == 400
    assert got["error"]["type"] == "illegal_argument_exception"
    assert got["error"]["reason"] == \
        "[script] is not supported by opensearch_tpu_torch yet"
    # a stale CAS is judged first, as the reference judges it
    same(nodes, "POST", "/i/_update/1", {"script": "ctx._source.n = 1"},
         if_seq_no=9, if_primary_term=1)


def test_bulk_update_items(nodes):
    same(nodes, "POST", "/_bulk", ndjson([
        {"update": {"_index": "i", "_id": "1"}}, {"doc": {"n": 9}},
        {"update": {"_index": "i", "_id": "2"}}, {"doc": {"n": 1}},
        {"update": {"_index": "i", "_id": "3"}},
        {"doc": {"n": 1}, "doc_as_upsert": True},
        {"update": {"_index": "i", "_id": "4"}}, {"upsert": {"n": 4}},
        {"update": {"_index": "i", "_id": "1"}}, {"doc": {"n": 9}},
        {"update": {"_index": "new", "_id": "1"}},
        {"doc": {"n": 1}, "doc_as_upsert": True}]), refresh="true")
    same(nodes, "POST", "/i/_mget", {"ids": ["1", "2", "3", "4"]})
    same(nodes, "POST", "/i/_search", {"sort": [{"n": "asc"}]})


# ------------------------------------------------ count, create, lifecycle

def test_count_with_body_and_q(nodes):
    same(nodes, "POST", "/_bulk", bulk_ndjson("i", {
        f"d{k}": {"title": f"word{k % 3} other", "tag": f"t{k % 4}", "n": k}
        for k in range(40)}, deletes=["d3"]), refresh="true")
    same(nodes, "POST", "/i/_count")
    same(nodes, "GET", "/i/_count")
    same(nodes, "POST", "/i/_count", {"query": {"match": {"title": "word1"}}})
    same(nodes, "POST", "/i/_count", {"query": {"range": {"n": {"gte": 10}}},
                                      "aggs": {"t": {"terms": {"field":
                                                               "tag"}}}})
    same(nodes, "POST", "/i/_count", q="title:word2")
    same(nodes, "POST", "/i/_count", q="tag:t1")
    same(nodes, "POST", "/_count")
    same(nodes, "POST", "/i*/_count", q="word0")


def test_auto_create_index(nodes):
    same(nodes, "PUT", "/fresh/_doc/1", {"title": "x", "n": 3})
    same(nodes, "POST", "/_bulk", ndjson([
        {"index": {"_index": "logs", "_id": "1"}}, {"msg": "a", "n": 1},
        {"create": {"_index": "logs", "_id": "2"}}, {"msg": "b"}]))
    same(nodes, "POST", "/_refresh")
    same(nodes, "POST", "/logs/_search", {"query": {"match": {"msg": "a"}}})
    same(nodes, "GET", "/fresh/_doc/1")
    # validation precedes the auto-create
    same(nodes, "PUT", "/never/_doc/" + "x" * 600, {"a": 1})
    same(nodes, "GET", "/never/_doc/1")
    same(nodes, "PUT", "/Bad/_doc/1", {"a": 1})


def test_auto_create_index_off():
    settings = {"action.auto_create_index": "false"}
    nodes = (JNode(settings=settings), TNode(device="cpu",
                                             settings=settings))
    assert same(nodes, "PUT", "/missing/_doc/1", {"a": 1})["_status"] == 404
    same(nodes, "POST", "/_bulk", ndjson([
        {"index": {"_index": "missing", "_id": "1"}}, {"a": 1}]))
    same(nodes, "POST", "/missing/_update/1", {"doc": {"a": 1},
                                               "doc_as_upsert": True})
    same(nodes, "PUT", "/made", {})
    same(nodes, "PUT", "/made/_doc/1", {"a": 1})


def test_flush_forcemerge_refresh(nodes):
    for r in range(3):
        same(nodes, "POST", "/_bulk", bulk_ndjson("i", {
            f"d{r}_{k}": {"title": f"word{k % 5}", "tag": f"t{k % 3}",
                          "n": k} for k in range(30)},
            deletes=[f"d{r - 1}_{k}" for k in range(0, 30, 7)] if r
            else ()))
        same(nodes, "POST", "/i/_refresh")
    same(nodes, "POST", "/i/_flush")
    same(nodes, "POST", "/_flush")
    assert len(nodes[1].indices.get("i").shards[0].reader.segments) == 3
    same(nodes, "POST", "/i/_forcemerge")
    same(nodes, "POST", "/_forcemerge")
    for node in nodes:
        shard = node.indices.get("i").shards[0]
        assert len(shard.engine.segments) == len(shard.reader.segments) == 1
    same(nodes, "GET", "/_refresh")
    same(nodes, "POST", "/nope/_refresh")
    same(nodes, "POST", "/i/_search", {"query": {"match": {"title":
                                                           "word2"}}})
    same(nodes, "GET", "/i/_doc/d2_4", realtime="false")


# ------------------------------------------------------------ nested blocks

def test_nested_block_update_delete_merge():
    nodes = (JNode(), TNode(device="cpu"))
    same(nodes, "PUT", "/blog", NESTED_MAPPING)
    docs = {str(i): {"title": f"post {i % 3}", "comments": [
        {"who": f"u{(i + j) % 4}", "stars": j + 1} for j in range(i % 4)]}
        for i in range(12)}
    same(nodes, "POST", "/_bulk", bulk_ndjson("blog", docs),
         refresh="true")
    body = {"query": {"nested": {"path": "comments", "score_mode": "sum",
                                 "query": {"term": {"comments.who": "u1"}}}},
            "aggs": {"c": {"nested": {"path": "comments"}, "aggs": {
                "w": {"terms": {"field": "comments.who"}}}}}}
    same(nodes, "POST", "/blog/_search", body)
    same(nodes, "POST", "/blog/_update/3", {"doc": {"comments": [
        {"who": "u1", "stars": 5}]}})
    same(nodes, "DELETE", "/blog/_doc/5")
    same(nodes, "POST", "/blog/_refresh")
    same(nodes, "POST", "/blog/_search", body)
    same(nodes, "POST", "/blog/_forcemerge")
    same(nodes, "POST", "/blog/_search", body)
    same(nodes, "POST", "/blog/_search", {"query": {"nested": {
        "path": "comments", "query": {"range": {"comments.stars": {
            "gte": 2}}}, "inner_hits": {"size": 2}}}})
    same(nodes, "GET", "/blog/_doc/3", realtime="false")


# ---------------------------------- pages after deletes, updates and a merge

BODIES = [
    {"query": {"match": {"body": "w00011 w00004 w00002"}}, "size": 10},
    {"size": 0, "aggs": {"t": {"terms": {"field": "tag", "size": 20}, "aggs": {
        "v": {"max": {"field": "views"}}}}}},
    {"query": {"match": {"body": "w00006"}}, "sort": [{"views": "desc"}],
     "size": 15},
    {"query": {"bool": {"filter": [{"range": {"views": {"gte": 500}}}]}},
     "sort": [{"ts": "asc"}], "size": 12},
]


def _churned_index(nodes, shards: int, n: int = 600, parts: int = 3):
    """`parts` refreshes of new docs, then one of updates and deletes."""
    body = json.loads(json.dumps(DOCS_MAPPING))
    body["settings"] = {"number_of_shards": shards}
    same(nodes, "PUT", "/docs", body)
    docs = docs_corpus(n)
    for r in range(parts):
        part = {f"d{i}": docs[i]
                for i in range(r * n // parts, (r + 1) * n // parts)}
        same(nodes, "POST", "/_bulk", bulk_ndjson("docs", part))
        same(nodes, "POST", "/docs/_refresh")
    rng = np.random.default_rng(5)
    lines = []
    for i in rng.choice(n, 60, replace=False):
        lines += [{"update": {"_index": "docs", "_id": f"d{i}"}},
                  {"doc": {"views": int(rng.integers(0, 3000)),
                           "tag": f"cat{i % 5}"}}]
    for i in rng.choice(n, 40, replace=False):
        lines.append({"delete": {"_index": "docs", "_id": f"d{i}"}})
    same(nodes, "POST", "/_bulk", ndjson(lines))
    same(nodes, "POST", "/docs/_refresh")


@pytest.mark.parametrize("shards", [1, 3])
def test_pages_after_deletes_updates_and_merge(shards):
    nodes = (JNode(), TNode(device="cpu"))
    _churned_index(nodes, shards)
    for body in BODIES:
        same(nodes, "POST", "/docs/_search", body)
    same(nodes, "POST", "/docs/_forcemerge")
    for body in BODIES:
        same(nodes, "POST", "/docs/_search", body)
    same(nodes, "POST", "/docs/_count")


def test_three_shards_one_merged_takes_the_program():
    """After one shard's merge its rows' layout changes (3 + 1 + 3 rows):
    the multi-shard program still pairs them, and pages equal the
    reference's."""
    nodes = (JNode(), TNode(device="cpu"))
    _churned_index(nodes, 3, parts=2)
    for node in nodes:
        node.indices.get("docs").shards[1].force_merge()
        assert [len(s.reader.segments)
                for s in node.indices.get("docs").shards] == [3, 1, 3]
    for body, program in zip(BODIES[:2], (1, 0)):
        j0, t0 = jspmd.SPMD_QUERIES.value, tspmd.SPMD_QUERIES[0]
        same(nodes, "POST", "/docs/_search", body)
        assert jspmd.SPMD_QUERIES.value - j0 == program
        assert tspmd.SPMD_QUERIES[0] - t0 == program


def test_aggregation_repeated_across_deletes():
    """Aggregate, delete, refresh, aggregate again: no cache on a segment
    (agg statics, filter masks, column means) may answer from before."""
    nodes = (JNode(), TNode(device="cpu"))
    _churned_index(nodes, 1, n=300)
    QUERY_CACHE.clear()
    body = {"size": 0, "query": {"bool": {"filter": [
        {"range": {"views": {"gte": 100}}}]}},
        "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {
            "s": {"sum": {"field": "views"}}}}}}
    for _ in range(3):           # the filter cache fills on a repeat
        same(nodes, "POST", "/docs/_search", body)
    same(nodes, "POST", "/_bulk", ndjson(
        [{"delete": {"_index": "docs", "_id": f"d{i}"}}
         for i in range(0, 300, 3)]))
    same(nodes, "POST", "/docs/_refresh")
    for _ in range(2):
        same(nodes, "POST", "/docs/_search", body)
    same(nodes, "POST", "/docs/_search", {"query": {"match_all": {}},
                                          "size": 3})


# ---------------------------------------------------- random write sequences

OPS = st.lists(st.one_of(
    st.tuples(st.just("index"), st.integers(0, 11), st.integers(0, 4)),
    st.tuples(st.just("update"), st.integers(0, 11), st.integers(0, 4)),
    st.tuples(st.just("delete"), st.integers(0, 11), st.just(0)),
    st.tuples(st.just("refresh"), st.just(0), st.just(0)),
    st.tuples(st.just("merge"), st.just(0), st.just(0))),
    min_size=1, max_size=14)


@settings(max_examples=25, deadline=None)
@given(OPS)
def test_random_write_sequences(ops):
    nodes = (JNode(), TNode(device="cpu"))
    same(nodes, "PUT", "/r", MAPPING)
    for op, doc, val in ops:
        if op == "index":
            same(nodes, "PUT", f"/r/_doc/{doc}",
                 {"title": f"w{val} w{doc % 3}", "tag": f"t{val % 2}",
                  "n": val})
        elif op == "update":
            same(nodes, "POST", f"/r/_update/{doc}", {"doc": {"n": val}})
        elif op == "delete":
            same(nodes, "DELETE", f"/r/_doc/{doc}")
        elif op == "refresh":
            same(nodes, "POST", "/r/_refresh")
        else:
            same(nodes, "POST", "/r/_forcemerge")
    same(nodes, "POST", "/r/_mget", {"ids": [str(i) for i in range(12)]})
    same(nodes, "POST", "/r/_mget", {"docs": [{"_id": str(i)}
                                              for i in range(12)]},
         realtime="false")
    same(nodes, "POST", "/r/_refresh")
    same(nodes, "POST", "/r/_count")
    same(nodes, "POST", "/r/_search", {
        "query": {"match": {"title": "w1 w2"}},
        "aggs": {"t": {"terms": {"field": "tag"}}}})
    same(nodes, "POST", "/r/_search", {"sort": [{"n": "desc"}], "size": 5})
