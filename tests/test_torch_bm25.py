"""K2 (score_text_clause) and K1 (bm25_candidate) plain versions of
opensearch_tpu_torch held against opensearch_tpu on identical segment images
and envelopes (the JAX side on the CPU, as its own tests run it).

Hits, totals and doc ids must be exactly equal; scores to rtol 1e-6,
atol 1e-7. The port rounds each BM25 operation once (no multiply-add
contraction); XLA on the CPU contracts the candidate program's
`tf + k1 * c` into a fused multiply-add, so candidate scores may differ from
the reference's by one ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.mapper import MapperService as JMapper
from opensearch_tpu.index.segment import SegmentBuilder as JBuilder
from opensearch_tpu.ops.bm25 import score_text_clause as j_score_text_clause
from opensearch_tpu.ops.device_segment import upload_segment as j_upload
from opensearch_tpu.search import dsl as jdsl
from opensearch_tpu.search.compile import Compiler as JCompiler
from opensearch_tpu.search.compile import ShardStats as JStats
from opensearch_tpu.search.executor import (
    build_candidate_query_phase as j_candidate_phase,
    pack_leaves as j_pack, stack_flat_inputs as j_stack)

from opensearch_tpu_torch.index.mapper import MapperService as TMapper
from opensearch_tpu_torch.index.segment import segment_from_arrays
from opensearch_tpu_torch.ops.bm25 import (bm25_candidate,
                                           score_text_clause)
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.ops.topk import unpack_rows
from opensearch_tpu_torch.search import dsl as tdsl
from opensearch_tpu_torch.search.compile import Compiler as TCompiler
from opensearch_tpu_torch.search.compile import ShardStats as TStats
from opensearch_tpu_torch.search.executor import (pack_leaves,
                                                  stack_flat_inputs,
                                                  unflatten_inputs,
                                                  unpack_leaves)

from opensearch_tpu_torch.utils.demo import query_terms
from test_torch_common import MAPPING, VOCAB, corpus, segment_arrays

RTOL, ATOL = 1e-6, 1e-7
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def env():
    mapper = JMapper(MAPPING["mappings"])
    builder = JBuilder(mapper)
    for i, doc in enumerate(corpus(1200)):
        builder.add(mapper.parse_document(f"d{i}", doc))
    jseg = builder.seal()
    for i in range(0, 1200, 37):                    # deleted docs
        jseg.delete(f"d{i}")
    tseg = segment_from_arrays(segment_arrays(jseg))
    jdev, jmeta = j_upload(jseg)
    tdev, tmeta = upload_segment(tseg, CPU)
    return {"jseg": jseg, "jdev": jdev, "jmeta": jmeta,
            "jc": JCompiler(mapper, JStats([jseg])),
            "tseg": tseg, "tdev": tdev, "tmeta": tmeta,
            "tc": TCompiler(TMapper(MAPPING["mappings"]), TStats([tseg]))}


def _plans(env, query):
    jp = env["jc"].compile(jdsl.parse_query(query), env["jseg"],
                           env["jmeta"])
    tp = env["tc"].compile(tdsl.parse_query(query), env["tseg"],
                           env["tmeta"])
    return jp, tp


def _match(text, **opts):
    return {"match": {"passage": {"query": text, **opts}}}


# (queries of one batch, k, min_scores): 1-16 terms, padding lanes,
# min_hits > 1, deleted docs (in the segment), k above the lane count
CANDIDATE_CASES = {
    "one_term": ([_match(query_terms(1, VOCAB, 11, 1)[0])], 10, None),
    "four_terms_batch": ([_match(q) for q in
                          query_terms(3, VOCAB, 12, 4)], 10, None),
    "sixteen_terms": ([_match(query_terms(1, VOCAB, 13, 16)[0])], 50, None),
    "and_min_hits": ([_match("w00001 w00004 w00009", operator="and"),
                      _match(query_terms(1, VOCAB, 14, 5)[0],
                             minimum_should_match="60%")], 20, None),
    "keyword_terms": ([{"terms": {"tag": ["cat1", "cat2", "cat9"]}},
                       {"term": {"tag": "cat3"}}], 10, None),
    "k_above_lanes": ([_match(query_terms(1, VOCAB, 15, 2)[0])], 2000, None),
    "min_score": ([_match(q) for q in query_terms(2, VOCAB, 16, 3)], 10,
                  [4.0, -np.inf]),
    "missing_term": ([_match("zzz w00123 qqq")], 10, None),
}


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_bm25_candidate_matches_reference(env, case):
    queries, k, min_scores = CANDIDATE_CASES[case]
    pairs = [_plans(env, q) for q in queries]
    jplans = [p[0] for p in pairs]
    tplans = [p[1] for p in pairs]
    ms = np.asarray(min_scores or [-np.inf] * len(queries), np.float32)
    # the reference: its own envelope and jitted candidate program
    stacked, treedef, _axes = j_stack([p.flatten_inputs([]) for p in jplans])
    stacked.append(ms)
    buf, layout = j_pack(stacked)
    fn = jax.jit(j_candidate_phase(jplans[0], env["jmeta"], k, layout,
                                   treedef))
    want = np.asarray(fn(env["jdev"], jnp.asarray(buf)))
    # the port: its envelope and K1's plain version
    tstacked, ttree = stack_flat_inputs([p.flatten_inputs([])
                                         for p in tplans])
    tstacked.append(ms)
    tbuf, tlayout = pack_leaves(tstacked)
    leaves = unpack_leaves(tbuf, tlayout)
    got = bm25_candidate(env["tdev"], unflatten_inputs(ttree, leaves[:-1])[0],
                         tplans[0].static[1], tplans[0].static[0], k,
                         leaves[-1]).numpy()
    assert got.shape == want.shape
    ws, wi, wt = unpack_rows(want, k)
    gs, gi, gt = unpack_rows(got, k)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)


# (queries, which must take the dense kernel class or not) for K2
DENSE_CASES = {
    "one_term": [_match(query_terms(1, VOCAB, 21, 1)[0])],
    "three_terms": [_match(query_terms(1, VOCAB, 22, 3)[0])],
    "twenty_terms": [_match(query_terms(1, VOCAB, 23, 20)[0])],
    "head_terms_and": [_match("w00001 w00002 w00003", operator="and")],
    "keyword_terms": [{"terms": {"tag": ["cat0", "cat7"]}}],
    "batch_mixed": [_match(q) for q in query_terms(3, VOCAB, 24, 6)],
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_score_text_clause_matches_reference(env, case):
    queries = DENSE_CASES[case]
    pairs = [_plans(env, q) for q in queries]
    tstacked, ttree = stack_flat_inputs([p[1].flatten_inputs([])
                                         for p in pairs])
    tbuf, tlayout = pack_leaves(tstacked)
    blk = unflatten_inputs(ttree, unpack_leaves(tbuf, tlayout))[0]
    scores, hits = score_text_clause(env["tdev"], blk)
    jfn = jax.jit(j_score_text_clause)
    for row, (jp, _tp) in enumerate(pairs):
        jblk = {k: jnp.asarray(v) for k, v in jp.inputs.items()}
        ws, wh = jfn(env["jdev"], jblk, jblk["k1"])
        np.testing.assert_array_equal(hits[row].numpy(), np.asarray(wh))
        np.testing.assert_allclose(scores[row].numpy(), np.asarray(ws),
                                   rtol=RTOL, atol=ATOL)
