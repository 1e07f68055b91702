"""The lexical query kinds and the analysis chain of opensearch_tpu_torch
held against opensearch_tpu through both Nodes' REST surface: ids,
prefix / wildcard / regexp / fuzzy (and case-insensitive term and
prefix), match with fuzziness, match on a numeric field, match_phrase
(slop 0 and 2), match_phrase_prefix, match_bool_prefix, multi_match
(best_fields, most_fields, cross_fields, phrase), query_string and
simple_query_string, an index whose field uses the `english` analyzer and
one whose analyzers come from `settings.analysis` (with a
search_analyzer), and highlight and explain over the new kinds; each
body through `_search` and all of them through one `_msearch`.

Contract: `assert_same_response` with scores to rtol 2e-6 and atol 1e-7
at zero (the port rounds every BM25 operation like the reference, and
phrases score on the host in f64 in both); ids, totals, `_source`,
highlights and explanation text exactly. The query types the slice
leaves out answer a 400 naming them; unknown names keep the reference's
`unknown query [x]`."""

import pytest

from opensearch_tpu.node import Node as JNode

from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.search import dsl

from test_torch_common import (CUSTOM_BODIES, NOT_PORTED_BODIES,
                               QUERY_KIND_BODIES, assert_same_response,
                               load_rel_custom_index, load_rel_index,
                               msearch_ndjson)

RTOL, ATOL = 2e-6, 1e-7


@pytest.fixture(scope="module")
def nodes():
    j, t = JNode(), TNode(device="cpu")
    for node in (j, t):
        load_rel_index(node)
        load_rel_custom_index(node)
    return j, t


@pytest.mark.parametrize("name", sorted(QUERY_KIND_BODIES))
def test_query_kind_equals_reference(nodes, name):
    j, t = nodes
    body = QUERY_KIND_BODIES[name]
    want = j.request("POST", "/rel/_search", body)
    got = t.request("POST", "/rel/_search", body)
    assert want["_status"] == 200, want
    assert want["hits"]["total"]["value"] > 0, name
    assert_same_response(got, want, name, score_rtol=RTOL, score_atol=ATOL)


@pytest.mark.parametrize("name", sorted(CUSTOM_BODIES))
def test_custom_analyzer_index_equals_reference(nodes, name):
    j, t = nodes
    body = CUSTOM_BODIES[name]
    want = j.request("POST", "/relc/_search", body)
    got = t.request("POST", "/relc/_search", body)
    assert want["_status"] == 200 and want["hits"]["total"]["value"] > 0
    assert_same_response(got, want, name, score_rtol=RTOL, score_atol=ATOL)


def test_msearch_of_every_kind_equals_reference(nodes):
    j, t = nodes
    payload = msearch_ndjson("rel", [QUERY_KIND_BODIES[n]
                                     for n in sorted(QUERY_KIND_BODIES)])
    assert_same_response(t.request("POST", "/_msearch", payload),
                         j.request("POST", "/_msearch", payload),
                         "msearch", score_rtol=RTOL, score_atol=ATOL)


def test_analyze_chain_of_mappings(nodes):
    """The english analyzer stems and drops stop words at index time; the
    custom index's analyzers come from its settings."""
    _, t = nodes
    mapper = t.indices.get("rel").mapper
    assert mapper.analysis.get("english").terms(
        "The Dogs were Running") == ["dog", "were", "run"]
    custom = t.indices.get("relc").mapper
    assert custom.analysis.get("folded").terms("the Cafés of Résumés") \
        == ["cafe", "resum"]
    assert custom.get_field("body").search_analyzer == "folded_search"


@pytest.mark.parametrize("name", sorted(NOT_PORTED_BODIES))
def test_left_out_kinds_answer_400_naming_them(nodes, name):
    _, t = nodes
    resp = t.request("POST", "/rel/_search", NOT_PORTED_BODIES[name])
    assert resp["_status"] == 400
    kind = next(iter(NOT_PORTED_BODIES[name]["query"]))
    assert resp["error"]["reason"] == \
        f"[{kind}] query is not supported by opensearch_tpu_torch yet"
    assert kind in dsl.NOT_PORTED


def test_unknown_kind_keeps_the_reference_error(nodes):
    j, t = nodes
    body = {"query": {"no_such_query": {"f": 1}}}
    assert_same_response(t.request("POST", "/rel/_search", body),
                         j.request("POST", "/rel/_search", body), "unknown")


@pytest.mark.parametrize("body", [
    {"query": {"constant_score": {}}},
    {"query": {"terms_set": {"body": {"x": 1}}}},
    {"query": {"distance_feature": {"field": "likes"}}},
    {"query": {"regexp": {"body": "a[b"}}},
    {"query": {"multi_match": {"query": "fox", "fields": []}}},
    {"query": {"prefix": {"body": "a", "tag": "b"}}},
], ids=["constant_score_no_filter", "terms_set_no_terms",
        "distance_feature_no_origin", "bad_regexp", "multi_match_no_fields",
        "prefix_two_fields"])
def test_errors_equal_reference(nodes, body):
    j, t = nodes
    want = j.request("POST", "/rel/_search", body)
    assert want["_status"] == 400
    assert_same_response(t.request("POST", "/rel/_search", body), want,
                         "error")
