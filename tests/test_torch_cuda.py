"""The CUDA kernels of opensearch_tpu_torch against their plain versions,
on the card (marker `cuda`; these skip where no CUDA device is present, and
run on the card with `python -m pytest tests/test_torch_cuda.py -m cuda`).
Ids, hits and totals exactly; scores exactly too, since the kernels build
with --fmad=false and round every BM25 operation like the plain versions."""

import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops import _build, bm25, topk
from opensearch_tpu_torch.ops.device_segment import upload_segment
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.compile import Compiler, ShardStats
from opensearch_tpu_torch.search.executor import (pack_leaves,
                                                  stack_flat_inputs,
                                                  unflatten_inputs,
                                                  unpack_leaves)
from opensearch_tpu_torch.utils.demo import build_shards_fast, fast_query_terms

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    mapper, segs, terms = build_shards_fast(60000, 1, 5000, 40, 3, 300)
    arrays, meta = upload_segment(segs[0], torch.device("cuda"))
    return mapper, segs[0], terms, arrays, meta


def _batch(card, n_terms, bsz, seed):
    mapper, seg, terms, arrays, meta = card
    comp = Compiler(mapper, ShardStats([seg]))
    plans = [comp.compile(dsl.parse_query({"match": {"body": q}}), seg, meta)
             for q in fast_query_terms(bsz, terms, seed, n_terms)]
    stacked, tree = stack_flat_inputs([p.flatten_inputs([]) for p in plans])
    stacked.append(np.full(bsz, -np.inf, np.float32))
    buf, layout = pack_leaves(stacked, pin=True)
    leaves = unpack_leaves(buf.to("cuda"), layout)
    return plans, unflatten_inputs(tree, leaves[:-1])[0], leaves[-1]


@pytest.mark.parametrize("n_terms,bsz,k", [(1, 1, 50), (4, 8, 50),
                                           (16, 3, 50), (1, 2, 3000)])
def test_bm25_candidate_kernel_equals_plain(card, n_terms, bsz, k):
    """k=3000 exceeds the lanes of a 1-term batch: -inf / doc 0 padding."""
    plans, blk, ms = _batch(card, n_terms, bsz, 10 + n_terms)
    if blk["ids"].shape[1] * 128 > bm25.CANDIDATE_MAX_LANES:
        pytest.skip("query batch exceeds the candidate lane budget")
    arrays = card[3]
    n = max(p.static[1] for p in plans)
    before = _build.LAUNCHES["bm25_candidate"]
    got = bm25.bm25_candidate(arrays, blk, n, False, k, ms)
    assert _build.LAUNCHES["bm25_candidate"] == before + 1
    want = bm25.bm25_candidate_plain(arrays, blk, n, False, k, ms)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bsz", [1, 5])
def test_score_text_clause_kernel_equals_plain(card, bsz):
    _plans, blk, _ms = _batch(card, 20, bsz, 40 + bsz)
    arrays = card[3]
    ks, kh = bm25.score_text_clause(arrays, blk)
    ps, ph = bm25.score_text_clause_plain(arrays, blk)
    torch.cuda.synchronize()
    assert torch.equal(kh, ph)
    assert torch.equal(ks, ps)


@pytest.mark.parametrize("k", [0, 10, 1000])
def test_masked_topk_kernel_equals_plain(card, k):
    _m, _s, _t, arrays, meta = card
    gen = torch.Generator(device="cuda").manual_seed(k)
    scores = torch.randint(0, 7, (4, meta.d_pad), generator=gen,
                           device="cuda").float()
    matches = torch.rand(4, meta.d_pad, generator=gen, device="cuda") < 0.3
    ms = torch.tensor([-np.inf, 2.0, 5.0, 7.0], device="cuda")
    got = topk.masked_topk(scores, matches, arrays["live"], arrays["root"],
                           meta.num_docs, ms, k)
    want = topk.masked_topk_plain(scores, matches, arrays["live"],
                                  arrays["root"], meta.num_docs, ms, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
