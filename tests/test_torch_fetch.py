"""The fetch phase of opensearch_tpu_torch held against opensearch_tpu:
`highlight` (default tags, custom tags, fragments, whole fields, wildcard
fields, bool queries), `explain`, `docvalue_fields` (numeric, date and
keyword), `version` and `_source` filtering on the general path, score- and
field-sorted, through both Nodes' `_search` and `_msearch` (the result page
on and off). Highlight strings, `fields`, `_version` and explanation
descriptions exactly; scores and explanation values to rtol 1e-6."""

import pytest

from opensearch_tpu.node import Node as JNode

from opensearch_tpu_torch.node import Node as TNode

from test_torch_common import (assert_same_response, load_docs_index,
                               msearch_ndjson)

INDEX = "docs"
N_DOCS = 1200

FETCH_BODIES = {
    "hl_default": {"query": {"match": {"body": "w00011 w00021"}},
                   "highlight": {"fields": {"body": {}}}, "size": 5},
    "hl_custom": {"query": {"match": {"body": "w00004"}}, "size": 4,
                  "highlight": {"pre_tags": ["<b>"], "post_tags": ["</b>"],
                                "fragment_size": 30,
                                "number_of_fragments": 2,
                                "fields": {"body": {}}}},
    "hl_field_tags": {"query": {"match": {"body": "w00009"}}, "size": 3,
                      "highlight": {"fields": {"body": {
                          "pre_tags": ["["], "post_tags": ["]"],
                          "number_of_fragments": 0}}}},
    "hl_bool": {"query": {"bool": {
        "must": [{"match": {"body": "w00006"}}],
        "should": [{"term": {"tag": "cat3"}}],
        "filter": [{"range": {"views": {"gte": 1000}}}],
        "must_not": [{"match": {"body": "w00002"}}]}},
        "highlight": {"fields": {"*": {}}}, "size": 6},
    "hl_sorted": {"query": {"match": {"body": "w00011"}},
                  "sort": [{"ts": "desc"}], "size": 4,
                  "highlight": {"fields": {"body": {"fragment_size": 40}}}},
    "explain": {"query": {"match": {"body": "w00011 w00030 w00004"}},
                "explain": True, "size": 4},
    "explain_sorted": {"query": {"bool": {
        "must": [{"match": {"body": "w00021"}}],
        "filter": [{"term": {"tag": "cat1"}}]}},
        "sort": [{"views": "asc"}], "explain": True, "size": 3},
    "explain_no_terms": {"query": {"range": {"views": {"lt": 500}}},
                         "explain": True, "size": 2},
    "docvalues": {"query": {"match": {"body": "w00007"}}, "size": 6,
                  "docvalue_fields": [{"field": "ts",
                                       "format": "epoch_millis"},
                                      "views", "tag", "nope"]},
    "docvalues_sorted": {"sort": [{"views": "desc"}], "size": 8,
                         "docvalue_fields": ["ts", "tag", "views"],
                         "_source": False},
    "version": {"query": {"terms": {"tag": ["cat1", "cat2"]}},
                "sort": [{"ts": "asc"}], "version": True, "size": 30},
    "all": {"query": {"match": {"body": "w00021 w00003"}}, "size": 5,
            "highlight": {"fields": {"body": {}}}, "explain": True,
            "docvalue_fields": ["views", "tag"], "version": True,
            "_source": {"includes": ["tag", "views"]},
            "track_total_hits": 20},
}


@pytest.fixture(scope="module")
def nodes():
    jn = JNode()
    tn = TNode(device="cpu")
    tp = TNode(device="cpu", settings={"search.result_page.enabled": True})
    for n in (jn, tn, tp):
        load_docs_index(n, INDEX, N_DOCS)
    return jn, tn, tp


@pytest.mark.parametrize("name", sorted(FETCH_BODIES))
def test_fetch_matches_reference(nodes, name):
    jn, tn, tp = nodes
    body = FETCH_BODIES[name]
    want = jn.request("POST", f"/{INDEX}/_search", body)
    assert want["_status"] == 200 and want["hits"]["hits"], want
    for node in (tn, tp):
        assert_same_response(node.request("POST", f"/{INDEX}/_search", body),
                             want, name)


def test_fetch_outputs_are_there(nodes):
    """The bodies really exercise the subphases: highlights, explanations
    with term details, fields and a re-indexed doc at version 2."""
    _jn, tn, _tp = nodes

    def hits(name):
        return tn.request("POST", f"/{INDEX}/_search",
                          FETCH_BODIES[name])["hits"]["hits"]
    assert all("<b>" in f for h in hits("hl_custom")
               for f in h["highlight"]["body"])
    assert any("tag" in h.get("highlight", {}) for h in hits("hl_bool"))
    assert all(h["_explanation"]["details"] for h in hits("explain"))
    dv = hits("docvalues")
    assert all(set(h["fields"]) >= {"ts", "tag"} for h in dv)
    assert isinstance(dv[0]["fields"]["ts"][0], str)
    assert {h["_version"] for h in hits("version")} == {1, 2}


def test_msearch_fetch_items_match_reference(nodes):
    jn, tn, tp = nodes
    payload = msearch_ndjson(INDEX, [FETCH_BODIES[n] for n in
                                     ("hl_default", "explain", "docvalues",
                                      "version", "all")])
    want = jn.request("POST", "/_msearch", payload)
    for node in (tn, tp):
        assert_same_response(node.request("POST", "/_msearch", payload),
                             want)
