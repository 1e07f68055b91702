"""The port's date_histogram held against the independent Python oracle
`reference_impl.ref_date_histogram` (the one the JAX package's own
tests use): fixed and calendar intervals, offsets, time zones, a query
filter, extended bounds and min_doc_count, through Node(device="cpu")'s
`_search` and `_msearch`. Bucket keys and doc counts exactly."""

import json

import numpy as np
import pytest

from opensearch_tpu_torch.node import Node

from reference_impl import ref_date_histogram

BASE_TS = 1700000000000           # 2023-11-14T22:13:20Z
DAY = 86400_000
HOUR = 3600_000
N_DOCS = 240


def _docs(seed=3):
    rng = np.random.RandomState(seed)
    ts = BASE_TS + rng.randint(0, 200 * DAY, size=N_DOCS)
    return [{"ts": int(t), "views": int(rng.randint(0, 500))} for t in ts]


@pytest.fixture(scope="module")
def corpus():
    docs = _docs()
    node = Node(device="cpu")
    assert node.request("PUT", "/h", {"mappings": {"properties": {
        "ts": {"type": "date"}, "views": {"type": "integer"}}}})[
        "_status"] == 200
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_index": "h", "_id": f"d{i}"}}),
                  json.dumps(d)]
        if i == N_DOCS // 2:    # two segments
            node.request("POST", "/_bulk", "\n".join(lines) + "\n")
            node.request("POST", "/h/_refresh")
            lines = []
    node.request("POST", "/_bulk", "\n".join(lines) + "\n")
    node.request("POST", "/h/_refresh")
    return docs, node


def _hist(node, spec, query=None):
    body = {"size": 0, "aggs": {"h": {"date_histogram": spec}}}
    if query is not None:
        body["query"] = query
    resp = node.request("POST", "/h/_search", body)
    assert resp["_status"] == 200, resp
    return {b["key"]: b["doc_count"]
            for b in resp["aggregations"]["h"]["buckets"]}


CASES = {
    "fixed_1d": ({"fixed_interval": "1d"}, dict(fixed_ms=DAY)),
    "fixed_12h": ({"fixed_interval": "12h"}, dict(fixed_ms=DAY // 2)),
    "fixed_7d": ({"fixed_interval": "7d"}, dict(fixed_ms=7 * DAY)),
    "offset": ({"fixed_interval": "1d", "offset": "3h"},
               dict(fixed_ms=DAY, offset_ms=3 * HOUR)),
    "negative_offset_tz": (
        {"fixed_interval": "1d", "offset": "-45m", "time_zone": "+05:30"},
        dict(fixed_ms=DAY, offset_ms=-45 * 60_000,
             tz_ms=5 * HOUR + 30 * 60_000)),
    "negative_tz": ({"fixed_interval": "1d", "time_zone": "-08:00"},
                    dict(fixed_ms=DAY, tz_ms=-8 * HOUR)),
    "month": ({"calendar_interval": "month"}, dict(calendar="month")),
    "quarter": ({"calendar_interval": "quarter"},
                dict(calendar="quarter")),
    "year": ({"calendar_interval": "year"}, dict(calendar="year")),
    "month_tz": ({"calendar_interval": "month", "time_zone": "+02:00"},
                 dict(calendar="month", tz_ms=2 * HOUR)),
    "extended_bounds": (
        {"fixed_interval": "7d", "min_doc_count": 0, "extended_bounds": {
            "min": BASE_TS - 10 * DAY, "max": BASE_TS + 220 * DAY}},
        dict(fixed_ms=7 * DAY, extended_bounds={
            "min": BASE_TS - 10 * DAY, "max": BASE_TS + 220 * DAY})),
    "min_doc_count_2": ({"fixed_interval": "1d", "min_doc_count": 2},
                        dict(fixed_ms=DAY, min_doc_count=2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_date_histogram_equals_oracle(corpus, name):
    docs, node = corpus
    spec, oracle = CASES[name]
    got = _hist(node, {"field": "ts", **spec})
    want = ref_date_histogram([d["ts"] for d in docs], **oracle)
    assert got == want


def test_date_histogram_under_a_query_equals_oracle(corpus):
    docs, node = corpus
    cut = BASE_TS + 90 * DAY
    got = _hist(node, {"field": "ts", "fixed_interval": "1d"},
                query={"range": {"ts": {"lt": cut}}})
    assert got == ref_date_histogram([d["ts"] for d in docs if d["ts"] < cut],
                                     fixed_ms=DAY)


def test_msearch_date_histograms_equal_oracle(corpus):
    """Several histograms of one _msearch (the batched agg path)."""
    docs, node = corpus
    names = sorted(CASES)
    lines = []
    for n in names:
        lines += [{"index": "h"}, {"size": 0, "aggs": {"h": {
            "date_histogram": {"field": "ts", **CASES[n][0]}}}}]
    resp = node.request("POST", "/_msearch", lines)
    for n, r in zip(names, resp["responses"]):
        got = {b["key"]: b["doc_count"]
               for b in r["aggregations"]["h"]["buckets"]}
        assert got == ref_date_histogram([d["ts"] for d in docs],
                                         **CASES[n][1]), n
