"""Four REST and search faults of opensearch_tpu_torch, repaired and held
against opensearch_tpu: each test sends the same requests to both Nodes
and compares the responses with `assert_same_response`.

1. URI search folds `q` (a `query_string`), `rest_total_hits_as_int`,
   `allow_partial_search_results`, `timeout` and `scroll` into the body as
   the reference does; the port answers 400 naming `timeout` and `scroll`
   until they are ported.
2. A single write whose body is not an object reaches the mapper (a list:
   400 `mapper_parsing_exception`, its sequence number spent), and a
   missing or unparsable body is indexed as `{}`.
3. `DELETE /{index}` resolves wildcards, `_all`, comma lists, `-`
   exclusions and `ignore_unavailable`.
4. A shard's untyped exception is isolated: every shard failed answers 503
   "all shards failed", a failed reduce 503 of phase `reduce`, some shards
   failed a partial page (or 503 "Partial shards failure" when partial
   results are refused), and a raising multi-shard program falls back to
   the per-shard host loop.
5. A mapping type that neither package maps answers the reference's 400
   reason byte for byte; a type that only the reference maps keeps that
   reason with the port's suffix.
"""

import json

import pytest

from opensearch_tpu.node import Node as JNode
from opensearch_tpu.search import spmd as jspmd

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import controller as tcontroller
from opensearch_tpu_torch.search import spmd as tspmd

from test_torch_common import assert_same_response

MAPPING = {"mappings": {"properties": {
    "t": {"type": "keyword"}, "body": {"type": "text"},
    "n": {"type": "integer"}, "loc": {"type": "geo_point"}}}}


def _load(node, name, shards=1, n_docs=12, mapping=MAPPING):
    res = node.request("PUT", f"/{name}", {
        "settings": {"number_of_shards": shards}, **mapping})
    assert res["_status"] == 200, res
    lines = "".join(
        json.dumps({"index": {"_index": name, "_id": f"{name}-{j}"}}) + "\n"
        + json.dumps({"t": f"v{j % 3}", "n": j,
                      "body": "hello world" if j % 2 else "goodbye moon",
                      "loc": {"lat": 10 + j, "lon": 20 + j}}) + "\n"
        for j in range(n_docs))
    res = node.request("POST", "/_bulk", lines)
    assert res["_status"] == 200 and not res["errors"], res
    node.request("POST", f"/{name}/_refresh")


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, "one")
        _load(node, "three", shards=3)
        _load(node, "other", n_docs=6,
              mapping={"mappings": {"properties": {
                  "t": {"type": "keyword"}, "body": {"type": "text"}}}})
    return jn, tn


def _same(jn, tn, method, path, body=None, status=None, **params):
    want = jn.request(method, path, body, **params)
    got = tn.request(method, path, body, **params)
    if status is not None:
        assert want["_status"] == status, want
    assert_same_response(got, want, f"{method} {path}")
    return got


# ----------------------------------------------- 1. URI search parameters

URI_CASES = {
    "q": ("/one/_search", {"q": "body:hello"}),
    "q_field_term": ("/one/_search", {"q": "t:v1", "sort": "n:asc"}),
    "q_over_body": ("/three/_search", {"q": "body:goodbye"}),
    "total_as_int": ("/one/_search", {"q": "body:hello",
                                      "rest_total_hits_as_int": "true"}),
    "total_as_int_sorted": ("/three/_search", {
        "rest_total_hits_as_int": "true", "sort": "n:desc", "size": "3"}),
    "allow_partial_false": ("/three/_search", {
        "allow_partial_search_results": "false", "q": "t:v2"}),
    "allow_partial_true": ("/one/_search", {
        "allow_partial_search_results": "true"}),
}


@pytest.mark.parametrize("case", sorted(URI_CASES))
def test_uri_search_parameters_fold_into_the_body(nodes, case):
    jn, tn = nodes
    path, params = URI_CASES[case]
    got = _same(jn, tn, "GET", path, None, status=200, **params)
    if "q" in params and params["q"] == "body:hello":
        total = got["hits"]["total"]
        assert (total if isinstance(total, int) else total["value"]) == 6
    if params.get("rest_total_hits_as_int") == "true":
        assert isinstance(got["hits"]["total"], int)


def test_uri_query_replaces_the_body_query(nodes):
    """`q` overrides a body query, as the reference's REST layer does."""
    jn, tn = nodes
    _same(jn, tn, "POST", "/one/_search",
          {"query": {"match_all": {}}, "sort": [{"n": "asc"}]}, status=200,
          q="body:goodbye")


@pytest.mark.parametrize("param,value", [("scroll", "1m"),
                                         ("timeout", "1ms")])
def test_unported_uri_parameters_answer_400(nodes, param, value):
    """The reference acts on `scroll` and `timeout`; the port folds them
    into the body and answers the controller's 400 naming the key, where
    it used to drop them and answer a plain page."""
    jn, tn = nodes
    want = jn.request("GET", "/one/_search", None, **{param: value})
    assert want["_status"] == 200
    if param == "scroll":
        assert "_scroll_id" in want
    got = tn.request("GET", "/one/_search", None, **{param: value})
    assert got["_status"] == 400
    assert got["error"]["type"] == "illegal_argument_exception"
    assert got["error"]["reason"] == (
        f"search body key [{param}] is not supported by "
        f"opensearch_tpu_torch yet")


# -------------------------------------------- 2. a body that is no object

@pytest.mark.parametrize("body", [[1, 2], ["a"], "[]"])
def test_list_body_spends_a_sequence_number(body):
    """A list body answers the mapper's 400 and spends a sequence number:
    the next document's `_seq_no` is the reference's. An empty list is
    falsy and is indexed as `{}`, as the reference's `body or {}`."""
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, "w", n_docs=2)
    _same(jn, tn, "PUT", "/w/_doc/x", body,
          status=201 if body == "[]" else 400)
    got = _same(jn, tn, "PUT", "/w/_doc/y", {"t": "v9"}, status=201)
    assert got["_seq_no"] == 3
    _same(jn, tn, "GET", "/w/_doc/y", status=200)


@pytest.mark.parametrize("body", [None, "{not json", ""])
def test_missing_or_unparsable_body_indexes_an_empty_document(body):
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, "w", n_docs=2)
    got = _same(jn, tn, "PUT", "/w/_doc/e", body, status=201)
    assert got["_seq_no"] == 2
    got = _same(jn, tn, "GET", "/w/_doc/e", status=200)
    assert got["_source"] == {}
    # a generated id differs between the Nodes: compare the rest
    want = jn.request("POST", "/w/_doc", body)
    got = tn.request("POST", "/w/_doc", body)
    assert got["_status"] == want["_status"] == 201
    assert_same_response({**got, "_id": None}, {**want, "_id": None})


def test_bulk_non_object_source_still_agrees():
    """`_bulk` already matched the reference on non-object sources."""
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        _load(node, "w", n_docs=2)
    payload = (json.dumps({"index": {"_index": "w", "_id": "l"}}) + "\n"
               + json.dumps([1, 2]) + "\n"
               + json.dumps({"index": {"_index": "w", "_id": "m"}}) + "\n"
               + json.dumps({"t": "v1"}) + "\n")
    _same(jn, tn, "POST", "/_bulk", payload, status=200)


# ------------------------------------------ 3. DELETE by index expression

INDEX_NAMES = ("a", "b1", "b2", "h", "i", "x1", "x2")

DELETE_CASES = {
    "comma_list": ("/a,h", {}),
    "wildcard": ("/b*", {}),
    "all": ("/_all", {}),
    "star": ("/*", {}),
    "ignore_unavailable": ("/i,nope", {"ignore_unavailable": "true"}),
    "missing_refused": ("/i,nope", {}),
    "missing": ("/nope", {}),
    "exclusion": ("/x*,-x2", {}),
    "repeated": ("/a,a,a*", {}),
    "no_match": ("/zz*", {}),
}


@pytest.mark.parametrize("case", sorted(DELETE_CASES))
def test_delete_index_expression(case):
    path, params = DELETE_CASES[case]
    jn, tn = JNode(), TNode(device="cpu")
    for node in (jn, tn):
        for name in INDEX_NAMES:
            assert node.request("PUT", f"/{name}", {})["_status"] == 200
    got = _same(jn, tn, "DELETE", path, None, **params)
    assert got["_status"] == (404 if case.startswith("missing") else 200)
    assert list(tn.indices.indices) == list(jn.indices.indices)
    # every match deleted once, the rest kept
    remaining = set(tn.indices.indices)
    expected = {
        "comma_list": set(INDEX_NAMES) - {"a", "h"},
        "wildcard": set(INDEX_NAMES) - {"b1", "b2"},
        "all": set(), "star": set(),
        "ignore_unavailable": set(INDEX_NAMES) - {"i"},
        "missing_refused": set(INDEX_NAMES), "missing": set(INDEX_NAMES),
        "exclusion": set(INDEX_NAMES) - {"x1"},
        "repeated": set(INDEX_NAMES) - {"a"},
        "no_match": set(INDEX_NAMES)}[case]
    assert remaining == expected


# ------------------------------------------- 4. shard failure isolation

FAILING_BODIES = {
    # an untyped error compiling a shard's agg: every shard fails
    "geohash_precision_one_shard": ("/one/_search", {
        "size": 0, "aggs": {"g": {"geohash_grid": {
            "field": "loc", "precision": "100km"}}}}),
    "geohash_precision_three_shards": ("/three/_search", {
        "aggs": {"g": {"geohash_grid": {"field": "loc",
                                        "precision": "100km"}}}}),
    "histogram_interval_two_indices": ("/one,other/_search", {
        "size": 3, "aggs": {"h": {"histogram": {"field": "n",
                                                "interval": "abc"}}}}),
    # the shards succeed and the reduce fails
    "terms_size_three_shards": ("/three/_search", {
        "size": 0, "aggs": {"g": {"terms": {"field": "t",
                                            "size": "abc"}}}}),
    "percents_reduce": ("/one,other/_search", {
        "size": 3, "aggs": {"p": {"percentiles": {"field": "n",
                                                  "percents": ["abc"]}}}}),
    # a function_score factor that does not parse, on both indices
    "factor_two_indices": ("/one,other/_search", {
        "size": 3, "query": {"function_score": {"field_value_factor": {
            "field": "n", "factor": "abc"}}}}),
}


@pytest.mark.parametrize("case", sorted(FAILING_BODIES))
def test_shard_failures_answer_the_references_error(nodes, case):
    jn, tn = nodes
    path, body = FAILING_BODIES[case]
    got = _same(jn, tn, "POST", path, body)
    assert got["_status"] == 503
    assert got["error"]["type"] == "search_phase_execution_exception"
    if "reduce" in case or case.startswith("terms"):
        assert got["error"]["phase"] == "reduce"
        assert got["error"]["reason"].startswith(
            "failed to reduce aggregations: ValueError")
    else:
        assert got["error"]["reason"] == "all shards failed"
        assert got["error"]["phase"] == "query"


def test_msearch_item_of_a_failing_body(nodes):
    """An `_msearch` item whose body fails on its shard renders the 503
    as an item error, beside a sibling that succeeds."""
    jn, tn = nodes
    payload = "".join(json.dumps(line) + "\n" for line in (
        {"index": "one"}, FAILING_BODIES["geohash_precision_one_shard"][1],
        {"index": "one"}, {"query": {"term": {"t": "v1"}}}))
    got = _same(jn, tn, "POST", "/_msearch", payload, status=200)
    assert [r["status"] for r in got["responses"]] == [503, 200]


def _break_query_phase(monkeypatch, node, index, shard=0):
    """Make one shard's query phase raise an untyped error."""
    ex = node.indices.get(index).shards[shard].executor

    def boom(*a, **k):
        raise RuntimeError(f"injected fault on [{index}][{shard}]")
    monkeypatch.setattr(ex, "execute_query_phase", boom)


def _break_fetch(monkeypatch, node, index, shard=0):
    ex = node.indices.get(index).shards[shard].executor

    def boom(*a, **k):
        raise RuntimeError(f"injected fetch fault on [{index}][{shard}]")
    monkeypatch.setattr(ex, "_hit_dict", boom)


PAGE_BODIES = {
    "match": {"query": {"match": {"body": "hello"}}, "size": 4},
    "sorted": {"query": {"match_all": {}}, "sort": [{"t": "asc"}],
               "size": 5},
    "aggs": {"query": {"match_all": {}}, "size": 2,
             "aggs": {"tags": {"terms": {"field": "t"}}}},
}


@pytest.mark.parametrize("name", sorted(PAGE_BODIES))
@pytest.mark.parametrize("fault", ["query", "fetch"])
def test_partial_page_when_one_index_fails(nodes, monkeypatch, name, fault):
    """No body raises an untyped error on one index of a two-index search
    and not on the other in both packages (the reference's compile
    errors are alike on every mapping), so the fault is injected: the
    same shard's query phase (or fetch) raises in both Nodes. The other
    index still answers: a partial page with `_shards.failed` and the
    failure entry, its hits and aggregations the reference's."""
    jn, tn = nodes
    body = PAGE_BODIES[name]
    for node in (jn, tn):
        (_break_query_phase if fault == "query" else _break_fetch)(
            monkeypatch, node, "one")
    with jspmd.force_host_loop(), tspmd.force_host_loop():
        before = tcontroller.SHARD_FAILURES[0]
        got = _same(jn, tn, "POST", "/one,other/_search", body, status=200)
        assert got["_shards"]["failed"] == 1
        assert got["_shards"]["successful"] == 1
        assert got["_shards"]["failures"][0]["index"] == "one"
        assert all(h["_index"] == "other" for h in got["hits"]["hits"])
        assert tcontroller.SHARD_FAILURES[0] == before + 1
        # partial results refused: 503 "Partial shards failure"
        got = _same(jn, tn, "POST", "/one,other/_search",
                    {**body, "allow_partial_search_results": False},
                    status=503)
        assert got["error"]["reason"] == "Partial shards failure"
        got = _same(jn, tn, "POST", "/one,other/_search", body, status=503,
                    allow_partial_search_results="false")
        # every shard failed: 503 "all shards failed"
        for node in (jn, tn):
            (_break_query_phase if fault == "query" else _break_fetch)(
                monkeypatch, node, "other")
        got = _same(jn, tn, "POST", "/one,other/_search", body)
        if fault == "query" or got["_status"] != 200:
            assert got["_status"] == 503
            assert got["error"]["reason"] == "all shards failed"
            assert len(got["error"]["failed_shards"]) == 2


def test_one_of_three_shards_fails(nodes, monkeypatch):
    """A 3-shard index with one shard broken: the other two answer."""
    jn, tn = nodes
    for node in (jn, tn):
        _break_query_phase(monkeypatch, node, "three", shard=1)
    with jspmd.force_host_loop(), tspmd.force_host_loop():
        got = _same(jn, tn, "POST", "/three/_search",
                    {"query": {"match_all": {}}, "sort": [{"n": "asc"}],
                     "size": 12}, status=200)
    assert got["_shards"] == {**got["_shards"], "total": 3,
                              "successful": 2, "failed": 1}
    assert got["_shards"]["failures"][0]["shard"] == 1


def test_raising_multi_shard_program_takes_the_host_loop(nodes,
                                                         monkeypatch):
    """When the multi-shard program raises, the request is answered by
    the per-shard host loop (the same page as without the fault), and
    the port counts the fall-back."""
    jn, tn = nodes
    body = {"query": {"match": {"body": "hello"}}, "size": 5}
    want = _same(jn, tn, "POST", "/three/_search", body, status=200)
    t0, f0 = tspmd.SPMD_QUERIES[0], tspmd.HOST_FALLBACKS[0]
    tn.request("POST", "/three/_search", {**body, "size": 6})
    assert tspmd.SPMD_QUERIES[0] == t0 + 1      # the program's route

    def boom(*a, **k):
        raise RuntimeError("injected program fault")
    monkeypatch.setattr(jspmd, "spmd_query_phase", boom)
    monkeypatch.setattr(tspmd, "spmd_query_phase", boom)
    got = _same(jn, tn, "POST", "/three/_search", body, status=200)
    assert_same_response(got, want, "fallback")
    assert got["_shards"]["failed"] == 0
    assert tspmd.HOST_FALLBACKS[0] == f0 + 1


# ------------------------------------------------- 5. unknown mapping types

UNKNOWN_TYPE_FIELDS = {
    "top": {"x": {"type": "nope"}},
    "under_object": {"a": {"properties": {"x": {"type": "nope"}}}},
    "under_nested": {"a": {"type": "nested",
                           "properties": {"x": {"type": "what_type"}}}},
}


@pytest.mark.parametrize("case", sorted(UNKNOWN_TYPE_FIELDS))
def test_type_neither_package_maps_answers_the_references_reason(nodes,
                                                                 case):
    jn, tn = nodes
    body = {"mappings": {"properties": UNKNOWN_TYPE_FIELDS[case]}}
    got = _same(jn, tn, "PUT", f"/unknown_{case}", body, status=400)
    assert got["error"]["type"] == "mapper_parsing_exception"
    assert got["error"]["reason"] == (
        f"No handler for type [{'what_type' if case == 'under_nested' else 'nope'}]"
        f" declared on field [x]")


@pytest.mark.parametrize("ftype", ["ip", "scaled_float", "geo_shape",
                                   "ip_range", "wildcard", "date_nanos"])
def test_type_only_the_reference_maps_keeps_the_ports_suffix(nodes, ftype):
    jn, tn = nodes
    body = {"mappings": {"properties": {"x": {"type": ftype}}}}
    want = jn.request("PUT", f"/only_ref_{ftype}", body)
    got = tn.request("PUT", f"/only_ref_{ftype}", body)
    assert want["_status"] == 200, want
    assert got["_status"] == 400, got
    reason = got["error"]["reason"]
    assert got["error"]["type"] == "mapper_parsing_exception"
    assert reason.startswith(
        f"No handler for type [{ftype}] declared on field [x]: "
        f"opensearch_tpu_torch maps only "), reason
