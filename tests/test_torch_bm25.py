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
from opensearch_tpu_torch.ops.bm25 import (TEXT_CLAUSE_CHUNK_LOG,
                                           bm25_candidate,
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
import text_clause_mirror
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


# ------------------------------------------- K2's schedule (numpy mirror)



def test_k2_chunk_is_the_kernels():
    """The wrapper sizes K2's scratch by the chunk that
    score_text_clause.cu builds with (its CHUNK_LOG), and the scratch is
    one bit a lane for every (query, chunk)."""
    import re
    from pathlib import Path
    from opensearch_tpu_torch.ops import bm25
    src = (Path(bm25.__file__).parent / "csrc"
           / "score_text_clause.cu").read_text()
    logs = re.findall(r"constexpr int CHUNK_LOG = (\d+);", src)
    assert logs == [str(TEXT_CLAUSE_CHUNK_LOG)]
    chunk = 1 << TEXT_CLAUSE_CHUNK_LOG
    for bsz, qb, d_pad, nch in ((1, 1, 1, 1), (32, 1024, 1 << 20, 128),
                                (3, 33, chunk + 1, 2), (2, 0, chunk, 1)):
        assert bm25.text_clause_scratch_words(bsz, qb, d_pad) == \
            bsz * nch * (-(-qb // 32))


@pytest.mark.parametrize("case", text_clause_mirror.EDGE_CASES)
def test_k2_schedule_mirror_equals_plain_and_reference(case):
    """The kernel's schedule (tests/text_clause_mirror.py: chunk bitmaps,
    lists in ascending j, staged partials added in list order) equals the
    plain version bit for bit, and the reference per query to the
    module's contract (hits exactly), on a block spanning three chunks, a
    doc every term lists, QB off 128 with padding lanes, a keep mask, Dp
    off the chunk and a chunk listing more than 1,024 blocks. The
    reference differs from the plain version by an ulp where XLA contracts
    `tf + k1 * c` into a multiply-add."""
    assert text_clause_mirror.CHUNK == 1 << TEXT_CLAUSE_CHUNK_LOG
    d_pad, (post_docs, post_tf, norms, lt), blk, keep = \
        text_clause_mirror.edge_case(case)
    bits = text_clause_mirror.chunk_bitmap(blk["ids"], keep, post_docs,
                                           d_pad)
    if case != "many_blocks":
        # query 0's lane 0 is the three-chunk block: on chunks 0-2
        assert [int(bits[0, c, 0]) & 1 for c in range(3)] == [1, 1, 1]
    else:                 # the common doc's chunk lists every block
        assert int(np.unpackbits(bits[0, 1].view(np.uint8)).sum()) == 1100
    want_s, want_h = text_clause_mirror.text_clause_mirror(
        blk["ids"], keep, blk["w"], blk["row"], blk["avgdl"], blk["b"],
        blk["k1"], post_docs, post_tf, norms, lt, d_pad)
    seg = {"post_docs": torch.from_numpy(post_docs),
           "post_tf": torch.from_numpy(post_tf),
           "norms": torch.from_numpy(norms),
           "length_table": torch.from_numpy(lt),
           "live": torch.ones(d_pad, dtype=torch.bool),
           "root": torch.ones(d_pad, dtype=torch.bool)}
    tblk = {k: torch.from_numpy(v) for k, v in blk.items()}
    ps, ph = score_text_clause(
        seg, tblk, None if keep is None else torch.from_numpy(keep))
    np.testing.assert_array_equal(ph.numpy(), want_h)
    assert np.array_equal(ps.numpy().view(np.int32), want_s.view(np.int32))
    if keep is None:      # the doc every term lists (query 2 pads a lane)
        n = 1100 if case == "many_blocks" else 5
        assert want_h[:, text_clause_mirror.CHUNK + 1].tolist() == \
            [n, n, n - (case == "many_blocks")]
    jseg = {k: jnp.asarray(v.numpy()) for k, v in seg.items()}
    jfn = jax.jit(j_score_text_clause)
    for q in range(blk["ids"].shape[0]):
        jblk = {"ids": jnp.asarray(blk["ids"][q]),
                "w": jnp.asarray(blk["w"][q]),
                "row": jnp.asarray(blk["row"][q]),
                "avgdl": jnp.asarray(blk["avgdl"][q]),
                "b": jnp.asarray(blk["b"][q])}
        js, jh = jfn(jseg, jblk, jnp.float32(blk["k1"][q]),
                     None if keep is None else jnp.asarray(keep[q]))
        np.testing.assert_array_equal(np.asarray(jh), want_h[q])
        np.testing.assert_allclose(np.asarray(js), want_s[q], rtol=RTOL,
                                   atol=ATOL)
