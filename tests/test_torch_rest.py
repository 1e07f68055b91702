"""REST-surface repairs of opensearch_tpu_torch held against opensearch_tpu:
each test sends the same requests to both Nodes.

- an unexpected exception answers the reference's 500 body (type, reason
  and a stack trace) instead of escaping `Node.request`;
- a document id over 512 UTF-8 bytes answers the reference's 400 on a
  single write, and a `_bulk` item takes it as the reference does;
- index expressions (`_all`, `*`, wildcards, commas, `-` exclusions, an
  `_msearch` header `{}`) resolve as the reference resolves them: one
  index or several are served with the reference's response, none finds
  nothing;
- generated ids are 20 url-safe characters, as the reference's.
"""

import json
import re

import pytest

from opensearch_tpu.node import Node as JNode

from opensearch_tpu_torch.node import Node as TNode

from test_torch_common import assert_same_response

MAPPING = {"mappings": {"properties": {"t": {"type": "keyword"},
                                       "n": {"type": "integer"}}}}


def _load(node, names=("s1", "p1")):
    for i, name in enumerate(names):
        assert node.request("PUT", f"/{name}", MAPPING)["_status"] == 200
        lines = "".join(
            json.dumps({"index": {"_index": name, "_id": f"{name}-{j}"}})
            + "\n" + json.dumps({"t": f"v{j % 3}", "n": i * 10 + j}) + "\n"
            for j in range(5))
        res = node.request("POST", "/_bulk", lines)
        assert res["_status"] == 200 and not res["errors"]
        node.request("POST", f"/{name}/_refresh")


@pytest.fixture(scope="module")
def one_index():
    jn, tn = JNode(), TNode(device="cpu")
    _load(jn, ("s1",))
    _load(tn, ("s1",))
    return jn, tn


@pytest.fixture(scope="module")
def two_indices():
    jn, tn = JNode(), TNode(device="cpu")
    _load(jn)
    _load(tn)
    return jn, tn


def _ndjson(lines) -> str:
    return "".join(json.dumps(line) + "\n" for line in lines)


def _without_trace(resp):
    err = dict(resp["error"])
    trace = err.pop("stack_trace")
    return {**resp, "error": err}, trace


@pytest.mark.parametrize("path", ["/_bulk", "/_msearch"])
def test_unexpected_exception_answers_500(one_index, path):
    """A malformed NDJSON line (`{"n":`) raises inside the handler: both
    answer 500 with the exception's type and reason and a stack trace."""
    jn, tn = one_index
    payload = ('{"index":{"_index":"s1","_id":"x"}}\n{"n":\n'
               if path == "/_bulk" else '{"index":"s1"}\n{"n":\n')
    want = jn.request("POST", path, payload)
    got = tn.request("POST", path, payload)
    assert got["_status"] == want["_status"] == 500
    want_body, _ = _without_trace(want)
    got_body, trace = _without_trace(got)
    assert_same_response(got_body, want_body, path)
    assert "Traceback" in trace


@pytest.mark.parametrize("n_bytes", [512, 515])
def test_long_document_id(n_bytes):
    """A single write of a 515-byte id answers the reference's 400; 512
    bytes are accepted. In `_bulk` the reference validates no item id,
    and the port takes the item as it does."""
    doc_id = "é" * (n_bytes // 2) + "x" * (n_bytes % 2)
    assert len(doc_id.encode("utf-8")) == n_bytes
    out = []
    for node in (JNode(), TNode(device="cpu")):
        _load(node, ("s1",))
        single = node.request("PUT", f"/s1/_doc/{doc_id}", {"t": "z"})
        bulk = node.request(
            "POST", "/_bulk",
            json.dumps({"index": {"_index": "s1", "_id": doc_id + "b"}})
            + "\n" + json.dumps({"t": "y"}) + "\n")
        out.append((single, bulk))
    (want_single, want_bulk), (got_single, got_bulk) = out
    if n_bytes > 512:
        assert got_single["_status"] == 400
        assert got_single["error"]["type"] == "illegal_argument_exception"
        assert "is too long, must be no longer than 512 bytes but was: " \
            f"{n_bytes}" in got_single["error"]["reason"]
    else:
        assert got_single["_status"] == 201
    assert_same_response(got_single, want_single, "single")
    assert_same_response(got_bulk, want_bulk, "bulk")


SERVED = {
    "wildcard": ("POST", "/s*/_search"),
    "exclusion": ("POST", "/*,-p1/_search"),
    "named": ("POST", "/s1/_search"),
    "comma_one": ("POST", "/s1,s1/_search"),
    "none": ("POST", "/zz*/_search"),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_expression_resolving_to_one_index_is_served(two_indices, name):
    jn, tn = two_indices
    method, path = SERVED[name]
    body = {"query": {"match_all": {}}, "sort": [{"n": "asc"}]}
    want = jn.request(method, path, body)
    assert want["_status"] == 200
    assert_same_response(tn.request(method, path, body), want, name)


def test_bare_search_and_empty_msearch_header_one_index(one_index):
    """`POST /_search` and an `_msearch` header `{}` over a node with one
    index resolve to it."""
    jn, tn = one_index
    body = {"query": {"term": {"t": "v1"}}, "sort": [{"n": "asc"}]}
    for method, path, payload in (
            ("POST", "/_search", body),
            ("GET", "/_search", body),
            ("POST", "/_msearch", _ndjson([{}, body, {"index": "s*"},
                                           body])),
            ("POST", "/s1/_msearch", _ndjson([{}, body]))):
        want = jn.request(method, path, payload)
        assert want["_status"] == 200
        assert_same_response(tn.request(method, path, payload), want, path)


@pytest.mark.parametrize("path", ["/_search", "/_all/_search", "/*/_search",
                                  "/s1,p1/_search", "/*1/_search"])
def test_expression_resolving_to_several_indices_answers_400(two_indices,
                                                             path):
    """Expressions over both indices: the port serves them across both,
    as the reference does (it answered 400 before the multi-shard query
    phase was ported; the name stays). `_search`, a sorted body and an
    `_msearch` mixing such an expression with one index agree."""
    jn, tn = two_indices
    for body in ({}, {"query": {"term": {"t": "v1"}},
                      "sort": [{"n": "desc"}], "size": 4}):
        want = jn.request("POST", path, body)
        assert want["_status"] == 200
        assert want["_shards"]["total"] == 2
        assert_same_response(tn.request("POST", path, body), want, path)
    payload = _ndjson([{"index": path.split("/")[1]} if path != "/_search"
                       else {}, {}, {"index": "s1"}, {}])
    want = jn.request("POST", "/_msearch", payload)
    assert [r["status"] for r in want["responses"]] == [200, 200]
    assert_same_response(tn.request("POST", "/_msearch", payload), want)


def test_unknown_index_is_404_in_both(two_indices):
    jn, tn = two_indices
    want = jn.request("POST", "/nope/_search", {})
    got = tn.request("POST", "/nope/_search", {})
    assert got["_status"] == want["_status"] == 404
    assert got["error"]["type"] == want["error"]["type"]


def test_generated_ids_are_the_references_alphabet():
    ids = []
    for node in (JNode(), TNode(device="cpu")):
        _load(node, ("s1",))
        got = [node.request("POST", "/s1/_doc", {"t": "q"})["_id"]
               for _ in range(50)]
        ids.append(got)
    for got in ids:
        assert all(len(i) == 20 for i in got)
        assert all(re.fullmatch(r"[A-Za-z0-9_-]{20}", i) for i in got)
        assert len(set(got)) == len(got)
