"""The CUDA kernels of opensearch_tpu_torch against their plain versions,
on the card (marker `cuda`; these skip where no CUDA device is present, and
run on the card with `python -m pytest tests/test_torch_cuda.py -m cuda`).
Ids, hits, totals, filter masks, counts, min and max exactly; BM25 scores
exactly too, since the kernels build with --fmad=false and round every
operation like the plain versions; K6's f32 sums within the agg contract's
bound n * 2^-24 * sum|v| of the f64 sums, and the same bits from run to
run."""

import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops import _build, binned, bm25, topk
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


def _pairs(ident: bool, seed: int):
    rng = np.random.default_rng(seed)
    if ident:
        doc_ids = np.arange(3000, dtype=np.int32)
    else:
        doc_ids = np.repeat(np.arange(4000, dtype=np.int32),
                            rng.integers(0, 3, 4000))
    nv = len(doc_ids)
    nv_pad = 1 << int(np.ceil(np.log2(nv)))
    d = np.full(nv_pad, -1, np.int32)
    d[:nv] = doc_ids
    o = np.zeros(nv_pad, np.int32)
    o[:nv] = rng.integers(0, 500, nv)
    return torch.from_numpy(d).cuda(), torch.from_numpy(o).cuda(), 4096


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("ident", [True, False])
def test_pairs_match_kernel_equals_plain(gpu, ident):
    d, o, d_pad = _pairs(ident, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    lo = torch.randint(-3, 500, (5,), generator=gen, device="cuda",
                       dtype=torch.int32)
    hi = lo + torch.randint(0, 200, (5,), generator=gen, device="cuda",
                            dtype=torch.int32)
    mask = torch.rand(5, 512, generator=gen, device="cuda") < 0.2
    before = _build.LAUNCHES["pairs_match"]
    got_r = bm25.pairs_match(d, o, d_pad, ident, lo=lo, hi=hi)
    got_t = bm25.pairs_match(d, o, d_pad, ident, ord_mask=mask)
    assert _build.LAUNCHES["pairs_match"] == before + 2
    want_r = bm25.pairs_match_plain(d, o, d_pad, ident, lo=lo, hi=hi)
    want_t = bm25.pairs_match_plain(d, o, d_pad, ident, ord_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got_r, want_r) and torch.equal(got_t, want_t)


@pytest.mark.parametrize("card", [1, 16, 256])
@pytest.mark.parametrize("ident", [True, False])
def test_binned_popcount_kernel_equals_plain(gpu, card, ident):
    d, _o, d_pad = _pairs(ident, card)
    n = d.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(card)
    lanes = torch.randint(-1, card + 1, (n,), generator=gen,
                          device="cuda", dtype=torch.int32)
    lanes = torch.where(d >= 0, lanes, -1)
    bits = binned.lane_bits(lanes, card)
    mask = torch.rand(4, d_pad, generator=gen, device="cuda") < 0.5
    pmask = torch.rand(4, d_pad, generator=gen, device="cuda") < 0.7
    doc_ids = None if ident else d
    got = binned.binned_popcount(mask, pmask, doc_ids, n, bits, card)
    want = binned.binned_popcount_plain(mask, pmask, doc_ids, n, bits, card)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("total", [1, 16, 300, 4096])
def test_binned_reduce_kernel_equals_plain(gpu, total):
    d, _o, d_pad = _pairs(False, total)
    n = d.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(total)
    lanes = torch.randint(-1, total, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    lanes = torch.where(d >= 0, lanes, -1)
    csr = binned.bin_csr(lanes, total)
    vals = torch.randn(n, generator=gen, device="cuda") * 1000
    mask = torch.rand(3, d_pad, generator=gen, device="cuda") < 0.5
    needs = ("cnt", "sum", "sumsq", "min", "max")
    got = binned.binned_reduce(csr, mask, None, d, vals, 0.0, needs, 3)
    again = binned.binned_reduce(csr, mask, None, d, vals, 0.0, needs, 3)
    want = binned.binned_reduce_plain(csr, mask, None, d, vals, 0.0, needs,
                                      3)
    torch.cuda.synchronize()
    for k in ("cnt", "min", "max"):
        assert torch.equal(got[k], want[k]), k
    for k in needs:
        assert torch.equal(got[k].view(torch.int32),
                           again[k].view(torch.int32)), k
    ok = binned._gather_ok(mask, None, d[csr.lane_order.long()],
                           csr.lane_order.shape[0])
    v = vals[csr.lane_order.long()].double()
    for k, contrib in (("sum", v), ("sumsq", v * v)):
        exact = torch.zeros(3, total, dtype=torch.float64,
                            device="cuda").index_add_(
            1, csr.sorted_bins, torch.where(ok, contrib, 0.0))
        absum = torch.zeros_like(exact).index_add_(
            1, csr.sorted_bins, torch.where(ok, contrib.abs(), 0.0))
        cnt = got["cnt"].double()
        bound = cnt * 2.0 ** -24 * absum
        assert bool(((got[k].double() - exact).abs() <= bound).all()), k
