"""The BM25 slice as a whole: the same mapping, the same bulk-indexed docs
(two refreshes, so two segments, with re-indexed and deleted docs) and the
same bodies go to opensearch_tpu.node.Node and to
opensearch_tpu_torch.node.Node(device="cpu"). Responses are equal with
`took` ignored: ids, order, totals and `_source` exactly, `_score` and
`max_score` to rtol 1e-6."""

import pytest

from opensearch_tpu.node import Node as JNode

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search.compile import Compiler
from opensearch_tpu_torch.search.executor import _envelope_kernel

from test_torch_common import (CANDIDATE_BODIES, DENSE_BODIES, ERROR_BODIES,
                               SEARCH_BODIES, assert_same_response,
                               bulk_ndjson, load_index, msearch_bodies,
                               msearch_ndjson)

INDEX = "passages"


@pytest.fixture(scope="module")
def nodes():
    jn, tn = JNode(), TNode(device="cpu")
    load_index(jn, INDEX)
    load_index(tn, INDEX)
    return jn, tn


def _kernel_classes(tn, bodies):
    ex = tn.indices.get(INDEX).shards[0].executor
    stats, segments, device = ex.reader.stats_snapshot()
    compiler = Compiler(ex.reader.mapper, stats)
    return [{_envelope_kernel(compiler.compile(
        tdsl.parse_query(b.get("query")), seg, meta))
        for seg, (_arrays, meta) in zip(segments, device)} for b in bodies]


@pytest.mark.parametrize("name", sorted(SEARCH_BODIES) + sorted(ERROR_BODIES))
def test_search_matches_reference(nodes, name):
    body = SEARCH_BODIES.get(name) or ERROR_BODIES[name]
    jn, tn = nodes
    want = jn.request("POST", f"/{INDEX}/_search", body)
    got = tn.request("POST", f"/{INDEX}/_search", body)
    assert (want["_status"] == 200) == (name in SEARCH_BODIES)
    assert_same_response(got, want)


def test_msearch_matches_reference(nodes):
    jn, tn = nodes
    payload = msearch_ndjson(INDEX, msearch_bodies(32))
    want = jn.request("POST", "/_msearch", payload)
    got = tn.request("POST", "/_msearch", payload)
    assert len(want["responses"]) == 32
    assert_same_response(got, want)


def test_both_kernel_classes_served(nodes):
    _jn, tn = nodes
    classes = _kernel_classes(tn, [SEARCH_BODIES[n] for n in DENSE_BODIES])
    assert all(c == {"dense"} for c in classes)
    classes = _kernel_classes(tn, [SEARCH_BODIES[n]
                                   for n in CANDIDATE_BODIES])
    assert all(c == {"candidate"} for c in classes)
    batch = set().union(*_kernel_classes(tn, msearch_bodies(32)))
    assert batch == {"candidate", "dense"}


def test_write_responses_match_reference(nodes):
    jn, tn = nodes
    for node in (jn, tn):
        node.request("PUT", "/writes", {"mappings": {"properties": {
            "t": {"type": "text"}}}})
    steps = [("PUT", "/writes/_doc/a", {"t": "x y"}),
             ("PUT", "/writes/_doc/a", {"t": "y z"}),
             ("DELETE", "/writes/_doc/a", None),
             ("DELETE", "/writes/_doc/nope", None),
             ("POST", "/writes/_refresh", None),
             ("PUT", "/writes", {}),
             ("POST", "/missing/_search", {}),
             ("DELETE", "/writes", None)]
    for method, path, body in steps:
        assert_same_response(tn.request(method, path, body),
                             jn.request(method, path, body))


def test_failed_parse_uses_up_a_seq_no(nodes):
    """A write that fails to parse takes its sequence number before the
    parse, as in the reference: the next good write's `_seq_no` (and the
    bulk items around a bad one) equal the reference's."""
    jn, tn = nodes
    out = []
    for node in (jn, tn):
        node.request("PUT", "/seq", {"mappings": {"properties": {
            "n": {"type": "integer"}, "t": {"type": "text"}}}})
        steps = [node.request("PUT", "/seq/_doc/a", {"n": 1}),
                 node.request("PUT", "/seq/_doc/b", {"n": "not a number"}),
                 node.request("PUT", "/seq/_doc/c", {"n": 3}),
                 node.request("POST", "/_bulk", bulk_ndjson("seq", {
                     "d": {"n": 4}, "e": {"n": [1, "x"]}, "f": {"t": "ok"}}))]
        out.append(steps)
    want, got = out
    assert want[2]["_seq_no"] == 2
    assert_same_response(got, want)
