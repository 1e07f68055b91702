"""The scoring query kinds of opensearch_tpu_torch held against
opensearch_tpu: function_score (every function kind, score_mode and
boost_mode, filters, weights, missing fields, min_score, max_boost, the
modifiers that give NaN or -inf), script_score, boosting, terms_set (the
minimum from the query and from a field), distance_feature (numeric and
date) and constant_score.

First at the plan level: the same sealed segment (the reference's, carried
across by `segment_from_arrays` with its positions), each package's
compiler, then the reference's `_eval_plan` query by query against the
port's batched `_eval_plan` (K18 / K19's plain versions on the CPU) at
B=4, the four queries' numbers drawn from a numpy seed. Then every body
of `SCORING_BODIES` through both Nodes' `_search` and one `_msearch`.

Contract: matches exactly; scores to rtol 2e-6 with atol 1e-7 at zero
(transcendental functions of XLA's and PyTorch's CPU back-ends may differ
by an ulp or two, and a few chained operations carry that), NaN where the
reference has NaN; pages under `assert_same_response` with the same
tolerance."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.node import Node as JNode
from opensearch_tpu.ops.device_segment import upload_segment as j_upload
from opensearch_tpu.search import dsl as jdsl
from opensearch_tpu.search.compile import Compiler as JCompiler
from opensearch_tpu.search.compile import ShardStats as JStats
from opensearch_tpu.search.plan_eval import _eval_plan as j_eval

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import segment_from_arrays
from opensearch_tpu_torch.node import Node as TNode
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search.compile import Compiler as TCompiler
from opensearch_tpu_torch.search.compile import ShardStats as TStats
from opensearch_tpu_torch.search.compile import plan_struct
from opensearch_tpu_torch.search.executor import (stack_flat_inputs,
                                                  unflatten_inputs)
from opensearch_tpu_torch.search.plan_eval import _eval_plan as t_eval

from test_torch_common import (BOOST_MODES, REL_FUNCTIONS, REL_MAPPING,
                               SCORE_MODES, SCORING_BODIES,
                               assert_same_response, load_rel_index,
                               msearch_ndjson, rel_corpus, segment_arrays)

RTOL, ATOL = 2e-6, 1e-7
B = 4
# three distinct terms each: the B queries share the plan's structure
TEXTS = ("quick fox running", "lazy dog engine", "brown connection search",
         "relevance tuning fox")
# every function kind in one list (the mode cross below)
ALL_KINDS = (REL_FUNCTIONS["mixed"] + REL_FUNCTIONS["script"]
             + REL_FUNCTIONS["gauss_date"] + REL_FUNCTIONS["fvf_log_nan"])


@pytest.fixture(scope="module")
def segs():
    """The reference's sealed segment of the scoring corpus and the port's
    copy of it, each with its mapper, device image and compiler."""
    jm = JMapper(REL_MAPPING["mappings"])
    builder = JBuilder(jm)
    for i, doc in enumerate(rel_corpus(400)):
        builder.add(jm.parse_document(f"r{i}", doc))
    jseg = builder.seal()
    arrays = segment_arrays(jseg)
    arrays["positions"] = dict(jseg.positions)
    tseg = segment_from_arrays(arrays)
    tm = TMapper(REL_MAPPING["mappings"])
    jarr, jmeta = j_upload(jseg)
    tarr, tmeta = upload_segment(tseg, torch.device("cpu"))
    return ((JCompiler(jm, JStats([jseg])), jseg, jarr, jmeta),
            (TCompiler(tm, TStats([tseg])), tseg, tarr, tmeta))


def _perturb(obj, rng):
    """One query's copy of a body: weights, factors, missing values and
    boosts scaled, numeric origins shifted, so the B queries of a batch
    share the plan's structure and differ in its numbers."""
    obj = copy.deepcopy(obj)

    def walk(o):
        if isinstance(o, dict):
            for k, v in o.items():
                if k in ("weight", "factor", "missing", "boost",
                         "negative_boost", "max_boost", "min_score", "a",
                         "f") and isinstance(v, (int, float)):
                    o[k] = float(v) * float(rng.uniform(0.6, 1.4))
                elif k == "origin" and isinstance(v, (int, float)):
                    o[k] = float(v) + float(rng.uniform(-5, 5))
                elif k == "pivot" and isinstance(v, (int, float)):
                    o[k] = float(v) * float(rng.uniform(0.5, 2))
                else:
                    walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)
    walk(obj)
    return obj


def _retext(query, text):
    """The body with its first `match` on `body` asking `text`."""
    done = [False]

    def walk(o):
        if isinstance(o, dict):
            if "match" in o and isinstance(o["match"], dict) \
                    and "body" in o["match"] and not done[0]:
                o["match"] = {"body": text}
                done[0] = True
                return
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)
    walk(query)
    return query


def _check_plan(segs, query, seed=0):
    """The reference's _eval_plan per query against the port's at B=4."""
    (jc, jseg, jarr, jmeta), (tc, tseg, tarr, tmeta) = segs
    rng = np.random.default_rng(seed)
    queries = [_retext(_perturb(query, rng), TEXTS[b]) for b in range(B)]
    want_s, want_m = [], []
    for q in queries:
        plan = jc.compile(jdsl.parse_query(q), jseg, jmeta)
        inputs = [{k: jnp.asarray(v) for k, v in d.items()}
                  for d in plan.flatten_inputs([])]
        s, m = j_eval(plan, jarr, inputs, [0])
        want_s.append(np.asarray(s))
        want_m.append(np.asarray(m))
    plans = [tc.compile(tdsl.parse_query(q), tseg, tmeta) for q in queries]
    assert len({plan_struct(p) for p in plans}) == 1
    stacked, tree = stack_flat_inputs([p.flatten_inputs([])
                                       for p in plans])
    inputs = unflatten_inputs(tree, [torch.from_numpy(np.ascontiguousarray(
        a)) for a in stacked])
    got_s, got_m = t_eval(plans[0], tarr, inputs, [0], B)
    got_s, got_m = got_s.numpy(), got_m.numpy()
    assert got_s.dtype == np.float32 and got_s.shape == (B, tmeta.d_pad)
    np.testing.assert_array_equal(got_m, np.stack(want_m))
    np.testing.assert_allclose(got_s, np.stack(want_s), rtol=RTOL,
                               atol=ATOL, equal_nan=True)
    return np.stack(want_s), np.stack(want_m)


def _fs(functions, score_mode="multiply", boost_mode="multiply", **extra):
    body = {"query": {"match": {"body": "x"}}, "functions": functions,
            "score_mode": score_mode, "boost_mode": boost_mode}
    body.update(extra)
    return {"function_score": body}


@pytest.mark.parametrize("kind", sorted(REL_FUNCTIONS))
def test_each_function_kind(segs, kind):
    _check_plan(segs, _fs(REL_FUNCTIONS[kind]), seed=len(kind))


@pytest.mark.parametrize("boost_mode", BOOST_MODES)
@pytest.mark.parametrize("score_mode", SCORE_MODES)
def test_score_mode_by_boost_mode(segs, score_mode, boost_mode):
    """All function kinds in one node, every score_mode x boost_mode."""
    _check_plan(segs, _fs(ALL_KINDS, score_mode, boost_mode),
                seed=SCORE_MODES.index(score_mode))


@pytest.mark.parametrize("extra", [
    {"min_score": 4.0}, {"max_boost": 1.5}, {"min_score": 2.0,
                                             "max_boost": 3.0, "boost": 2.0},
], ids=["min_score", "max_boost", "both_and_boost"])
def test_min_score_and_max_boost(segs, extra):
    """min_score compares before the final boost; max_boost clamps the
    combined value."""
    _, m = _check_plan(segs, _fs(REL_FUNCTIONS["mixed"], "sum", "sum",
                                 **extra))
    if "min_score" in extra:
        _, m_all = _check_plan(segs, _fs(REL_FUNCTIONS["mixed"], "sum",
                                         "sum"))
        assert m.sum() < m_all.sum()


def test_nan_modifier_values(segs):
    """A log modifier on negative prices gives NaN: under multiply a NaN
    value counts as a function that does not apply (identity); under max
    the NaN reaches the score, which is then NaN at the same docs on both
    sides."""
    s_mul, m_mul = _check_plan(segs, _fs(REL_FUNCTIONS["fvf_log_nan"]))
    assert not np.isnan(s_mul).any()
    s_max, m_max = _check_plan(segs, _fs(REL_FUNCTIONS["fvf_log_nan"],
                                         "max"))
    assert np.isnan(s_max[m_max]).any()


@pytest.mark.parametrize("name", ["script_score", "script_score_params",
                                  "boosting", "terms_set_param",
                                  "terms_set_field", "distance_feature_num",
                                  "distance_feature_date", "constant_score",
                                  "fs_no_functions",
                                  "fs_decay_unmapped_segment"])
def test_other_scoring_kinds(segs, name):
    _check_plan(segs, SCORING_BODIES[name]["query"], seed=len(name))


def test_distance_feature_dates_in_f32(segs):
    """Date origins and columns are f32 millis (a 131,072 ms step near
    1.7e12): the distances are the f32 ones, as in the reference."""
    s, m = _check_plan(segs, {"distance_feature": {
        "field": "published", "origin": "2023-11-20T10:00:00.123Z",
        "pivot": "1h"}})
    assert m.any() and np.unique(s[m]).size > 10


# ------------------------------------------------------------- REST

@pytest.fixture(scope="module")
def nodes():
    j, t = JNode(), TNode(device="cpu")
    for node in (j, t):
        load_rel_index(node)
    return j, t


@pytest.mark.parametrize("name", sorted(SCORING_BODIES))
def test_scoring_body_equals_reference(nodes, name):
    j, t = nodes
    body = SCORING_BODIES[name]
    want = j.request("POST", "/rel/_search", body)
    assert want["_status"] == 200, want
    assert want["hits"]["total"]["value"] > 0, name
    assert_same_response(t.request("POST", "/rel/_search", body), want,
                         name, score_rtol=RTOL, score_atol=ATOL)


def test_scoring_msearch_equals_reference(nodes):
    j, t = nodes
    payload = msearch_ndjson("rel", [SCORING_BODIES[n]
                                     for n in sorted(SCORING_BODIES)])
    assert_same_response(t.request("POST", "/_msearch", payload),
                         j.request("POST", "/_msearch", payload),
                         "msearch", score_rtol=RTOL, score_atol=ATOL)


def test_nan_scored_docs_leave_the_page(nodes):
    """The reference's page where a max combine gives NaN: the NaN-scored
    docs fail the query phase's score >= min_score test, so they leave
    the page and the total; the port answers the same."""
    j, t = nodes
    nan_max = {"query": _fs(REL_FUNCTIONS["fvf_log_nan"], "max"),
               "size": 50}
    nan_max["query"]["function_score"]["query"] = {"match": {"body": "fox"}}
    first = copy.deepcopy(nan_max)
    first["query"]["function_score"]["score_mode"] = "first"
    want = j.request("POST", "/rel/_search", nan_max)
    assert_same_response(t.request("POST", "/rel/_search", nan_max), want,
                         "nan_max", score_rtol=RTOL, score_atol=ATOL)
    total_first = t.request("POST", "/rel/_search", first)["hits"]["total"]
    assert want["hits"]["total"]["value"] < total_first["value"]


@pytest.mark.parametrize("body", [
    {"query": _fs([{"field_value_factor": {"field": "nope"}}])},
    {"query": _fs([{"field_value_factor": {"field": "likes",
                                           "modifier": "cube"}}])},
    {"query": _fs(REL_FUNCTIONS["weight"], "median")},
    {"query": {"script_score": {"query": {"match_all": {}},
                                "script": {"source": "doc['body'].value"}}}},
    {"query": {"script_score": {"query": {"match_all": {}},
                                "script": {"source": "params.x * 2"}}}},
    {"query": {"terms_set": {"body": {
        "terms": ["fox"], "minimum_should_match_field": "nope"}}}},
    {"query": {"distance_feature": {"field": "nope", "origin": 1,
                                    "pivot": 1}}},
], ids=["fvf_unmapped", "bad_modifier", "bad_score_mode",
        "script_text_field", "script_missing_param", "terms_set_unmapped",
        "distance_feature_unmapped"])
def test_scoring_errors_equal_reference(nodes, body):
    j, t = nodes
    want = j.request("POST", "/rel/_search", body)
    assert want["_status"] == 400, want
    assert_same_response(t.request("POST", "/rel/_search", body), want,
                         "error")


def test_terms_set_script_is_named_as_not_ported(nodes):
    _, t = nodes
    resp = t.request("POST", "/rel/_search", {"query": {"terms_set": {
        "body": {"terms": ["fox"], "minimum_should_match_script": {
            "source": "params.num_terms"}}}}})
    assert resp["_status"] == 400 and "minimum_should_match_script" in \
        resp["error"]["reason"]
