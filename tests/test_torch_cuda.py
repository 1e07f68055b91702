"""The CUDA kernels of opensearch_tpu_torch against their plain versions,
on the card (marker `cuda`; these skip where no CUDA device is present, and
run on the card with `python -m pytest tests/test_torch_cuda.py -m cuda`).
Ids, hits, totals, filter masks, counts, min and max exactly; BM25 scores
exactly too, since the kernels build with --fmad=false and round every
operation like the plain versions; K6's f32 sums within the agg contract's
bound n * 2^-24 * sum|v| of the f64 sums, and the same bits from run to
run. The k-NN kernels: K7 and K8 scores, masks and chosen blocks bit for
bit (every sum in dim order, one rounding per operation); K9 bit for bit
too (one chunked member order on both sides), its means within the same
sum bound of the f64 means. K13 (the sort key), K3's keyed entry (k up to
40,000, past one CTA's sort) and K14 (the result page) bit for bit. K15
(dense_numeric) and K17 (adjacency_counts, also past one launch's 32
filters) bit for bit; K16 (matrix_moments) counts exactly, its sums
within depth * 2^-24 * sum|term| of the f64 sums of its f32 terms (depth:
agg_kernels.moments_sum_depth, the additions on a term's path in the
kernel's two levels) and the same bits from run to run. K18
(function_score) and K19's four entries (terms_set, distance_feature,
boosting, script_score's wrap) bit for bit, logf / log1pf / expf
included, NaN at the same places (torch's CUDA ops call the same
libdevice functions as the kernels). K22 (nested_join) bit for bit in
every score mode; K23 (nested_aggs) exactly; K24 (binned_scatter) counts,
min and max exactly and its sums bit for bit (one sorted two-level order)
and within the sum bound; K25's four geo / rank_feature entries bit for
bit. K3's three entries (masked_topk, its threshold and keyed entries)
bit for bit on the inputs that stress their radix select (keys sharing
their high bits, all keys equal, no or few eligible lanes, NaN / +-0.0 /
-1e30, Dp off a tile or off 4, views off 16-byte alignment, 2^24 lanes),
each row's full-read count as tests/topk_select_mirror.py plans it.
K11's table (pq_lut) bit for bit on every dsub it templates and the
loop's. Row 16 (expand_pad) bit for bit on the four leaf dtypes, 1-3 dims,
axes cut and left whole, its 16-byte vector path and its element path
(rows of 15, 16 and 17 bytes, views that are not 16-byte aligned, fills
-0.0, NaN, INT32_MAX, -1 and true), a publish's image equal to
upload_segment's, and a CPU fallback refused for a CUDA tensor of another
dtype."""

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

from test_torch_common import blocked_layout

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


@pytest.mark.parametrize("case", ["three_chunks", "keep", "dp_off_chunk",
                                  "many_blocks"])
def test_score_text_clause_edge_shapes(gpu, case):
    """K2 on tests/text_clause_mirror.py's edge shapes (a block spanning
    three chunks, a doc every term lists, QB off 128 with padding lanes, a
    keep mask, Dp off the chunk, a chunk listing 1,100 blocks): bit for
    bit with the plain version, one launch a call."""
    from text_clause_mirror import edge_case
    d_pad, (post_docs, post_tf, norms, lt), blk, keep = edge_case(case)
    seg = {"post_docs": post_docs, "post_tf": post_tf, "norms": norms,
           "length_table": lt, "live": np.ones(d_pad, bool),
           "root": np.ones(d_pad, bool)}
    seg = {k: torch.from_numpy(v).to(gpu) for k, v in seg.items()}
    tblk = {k: torch.from_numpy(v).to(gpu) for k, v in blk.items()}
    tkeep = None if keep is None else torch.from_numpy(keep).to(gpu)
    name = "score_text_clause" if keep is None else "score_text_clause_keep"
    before = _build.LAUNCHES[name]
    ks, kh = bm25.score_text_clause(seg, tblk, block_keep=tkeep)
    assert _build.LAUNCHES[name] == before + 1
    if keep is not None:
        tblk = dict(tblk, ids=torch.where(tkeep, tblk["ids"], -1))
    ps, ph = bm25.score_text_clause_plain(seg, tblk)
    torch.cuda.synchronize()
    assert torch.equal(kh, ph)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))


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


# K5's shapes: (B, Dp, n, byte offset of the mask rows): phase 3's n at
# B=1; a ragged n (not a multiple of a warp step's 512 lanes) over a Dp
# that is not a multiple of 16 (the byte route); several ranges at B=32;
# rows at an odd offset (the byte route on an aligned Dp)
POPCOUNT_SHAPES = {"b1_n8192": (1, 8192, 8192, 0),
                   "b5_ragged": (5, 4099, 3008, 0),
                   "b32_ranges": (32, 1 << 16, 1 << 16, 0),
                   "b5_offset": (5, 4096, 4096, 1)}


@pytest.mark.parametrize("card", [1, 16, 64, 91, 256, 4096])
@pytest.mark.parametrize("ident", [True, False])
@pytest.mark.parametrize("with_pmask", [False, True])
@pytest.mark.parametrize("shape", sorted(POPCOUNT_SHAPES))
def test_binned_popcount_kernel_equals_plain(gpu, card, ident, with_pmask,
                                             shape):
    """K5 exactly, one launch a call: bins in registers (card <= 64) and
    the per-bin loop (91 and more), identity and gathered lanes, with and
    without pmask, 16-byte and byte mask reads."""
    bsz, d_pad, n, offset = POPCOUNT_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(card + 7 * bsz)
    lanes = torch.randint(-1, card + 1, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    bits = binned.lane_bits(lanes, card)

    def rows(p):
        flat = torch.rand(bsz * d_pad + offset, generator=gen,
                          device="cuda") < p
        return flat[offset:].view(bsz, d_pad)
    mask = rows(0.5)
    pmask = rows(0.7) if with_pmask else None
    doc_ids = None if ident else torch.randint(
        -1, d_pad, (n,), generator=gen, device="cuda", dtype=torch.int32)
    before = _build.LAUNCHES["binned_popcount"]
    got = binned.binned_popcount(mask, pmask, doc_ids, n, bits, card)
    assert _build.LAUNCHES["binned_popcount"] == before + 1
    want = binned.binned_popcount_plain(mask, pmask, doc_ids, n, bits, card)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("card", [16, 91])
@pytest.mark.parametrize("ident", [True, False])
def test_binned_popcount_query_groups(gpu, card, ident):
    """B=40 over 2^22 lanes: two query groups a range, the second of 8
    queries; with a pmask; exact, one launch."""
    bsz, n = 40, 1 << 22
    gen = torch.Generator(device="cuda").manual_seed(card + ident)
    lanes = torch.randint(-1, card + 1, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    bits = binned.lane_bits(lanes, card)
    mask = torch.rand(bsz, n, generator=gen, device="cuda") < 0.5
    pmask = torch.rand(bsz, n, generator=gen, device="cuda") < 0.7
    doc_ids = None if ident else torch.randint(
        -1, n, (n,), generator=gen, device="cuda", dtype=torch.int32)
    before = _build.LAUNCHES["binned_popcount"]
    got = binned.binned_popcount(mask, pmask, doc_ids, n, bits, card)
    assert _build.LAUNCHES["binned_popcount"] == before + 1
    want = binned.binned_popcount_plain(mask, pmask, doc_ids, n, bits, card)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _fold(items, starts, ends, warp):
    """Sums of items [B, m] over [starts, ends) ranges in K6's order: one
    thread adding in order, or 32 threads each adding every 32nd item in
    order, then the warp's 5-level shuffle tree (f32, one rounding an
    addition)."""
    bsz = items.shape[0]
    k = starts.shape[0]
    span = int((ends - starts).max()) if k else 0
    step = 32 if warp else 1
    acc = torch.zeros(bsz, k, step, dtype=torch.float32, device="cuda")
    lanes = torch.arange(step, device="cuda")
    for j in range(0, span, step):
        pos = starts[:, None] + j + lanes[None, :]
        inside = pos < ends[:, None]
        x = items[:, pos.clamp(max=max(items.shape[1] - 1, 0))]
        acc = torch.where(inside[None], acc + x, acc)
    if warp:
        for off in (16, 8, 4, 2, 1):
            acc = acc[..., :off] + acc[..., off:2 * off]
    return acc[..., 0]


def _k6_fold_order(csr, contrib):
    """K6's sums of contrib [B, nnz] (CSR order, 0 where not eligible) in
    the kernel's order: chunks, then each bin's chunk partials, a warp or
    a thread each as the kernel chooses from the static sizes."""
    nch, total = csr.n_chunks, csr.total
    cs = csr.chunk_start.long()
    part = _fold(contrib, cs[:-1], cs[1:],
                 warp=contrib.shape[1] > 4 * nch)
    bc = csr.bin_chunk.long()
    return _fold(part, bc[:-1], bc[1:], warp=nch > 4 * total)


@pytest.mark.parametrize("total", [1, 16, 300, 4096])
@pytest.mark.parametrize("layout,d_pad,with_pmask", [
    ("pairs", 4096, False), ("pairs", 4096, True), ("pairs", 4099, True),
    ("identity", 4096, False), ("identity", 4099, True),
    ("identity", 1000, False), ("sparse", 65536, False),
    ("sparse", 65539, True)])
def test_binned_reduce_kernel_equals_plain(gpu, total, layout, d_pad,
                                           with_pmask):
    """K6 over packed mask bits (AND pmask), pairs and identity layouts,
    Dp on and off a multiple of 32 (and of 16: the pack's scalar path);
    on a sparse pairs field (about Dp / 64 lanes, some docs twice, some
    -1) the mask is not packed and the folds read its bytes."""
    gen = torch.Generator(device="cuda").manual_seed(total + d_pad)
    if layout == "pairs":
        d, _o, _dp = _pairs(False, total)
    elif layout == "sparse":
        docs = torch.randperm(d_pad, generator=gen, device="cuda")[
            :d_pad // 64]
        d = torch.cat([docs, docs[:50], torch.full(
            (7,), -1, device="cuda")]).sort()[0].to(torch.int32)
    else:
        d = torch.arange(d_pad, dtype=torch.int32, device="cuda")
    n = d.shape[0]
    lanes = torch.randint(-1, total, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    lanes = torch.where(d >= 0, lanes, -1)
    csr = binned.bin_csr(lanes, total)
    assert binned.k6_packs(csr.lane_order.shape[0], d_pad) == (
        layout != "sparse")
    vals = torch.randn(n, generator=gen, device="cuda") * 1000
    mask = torch.rand(3, d_pad, generator=gen, device="cuda") < 0.5
    pmask = (torch.rand(3, d_pad, generator=gen, device="cuda") < 0.7) \
        if with_pmask else None
    doc_ids = None if layout == "identity" else d
    needs = ("cnt", "sum", "sumsq", "min", "max")
    before = _build.LAUNCHES["binned_reduce"]
    got = binned.binned_reduce(csr, mask, pmask, doc_ids, vals, 0.0, needs,
                               3)
    again = binned.binned_reduce(csr, mask, pmask, doc_ids, vals, 0.0,
                                 needs, 3)
    assert _build.LAUNCHES["binned_reduce"] == before + 2
    want = binned.binned_reduce_plain(csr, mask, pmask, doc_ids, vals, 0.0,
                                      needs, 3)
    torch.cuda.synchronize()
    for k in ("cnt", "min", "max"):
        assert torch.equal(got[k], want[k]), k
    for k in needs:
        assert torch.equal(got[k].view(torch.int32),
                           again[k].view(torch.int32)), k
    ok = binned._gather_ok(mask, pmask, d[csr.lane_order.long()],
                           csr.lane_order.shape[0])
    v32 = vals[csr.lane_order.long()]
    for k, contrib in (("sum", v32), ("sumsq", v32 * v32)):
        folded = _k6_fold_order(csr, torch.where(ok, contrib, 0.0))
        assert torch.equal(got[k].view(torch.int32),
                           folded.view(torch.int32)), k
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


# ------------------------------------------------------------- k-NN (K7-K9)

def _knn_data(n, dims, seed):
    from opensearch_tpu_torch.utils.demo import clustered_vectors
    vecs, qs = clustered_vectors(n, dims, n_centers=16, seed=seed,
                                 n_queries=40)
    return torch.from_numpy(vecs).cuda(), torch.from_numpy(qs).cuda()


@pytest.mark.parametrize("space", ["l2", "cosinesimil", "innerproduct"])
@pytest.mark.parametrize("bsz,dims", [(b, d) for b in (1, 3, 5, 8, 32, 33, 40)
                                      for d in (1, 3, 37, 100, 128, 129,
                                                768)])
def test_knn_exact_kernel_equals_plain(gpu, space, bsz, dims):
    """K7 bit for bit: B=1 and 8- and 32-query tiles (B=33 and 40 run a
    whole 32-query tile and then the rest), dims off the 16-dim chunk and
    off 4 (4-byte copies), on three layouts of the column: 4,096 rows,
    3,001 rows (a ragged last tile) and those 3,001 rows as a contiguous
    view 4 bytes past a 16-byte boundary; then knn_topk_mark against its
    plain version after K3."""
    from opensearch_tpu_torch.ops import knn
    vecs, qs = _knn_data(3000, dims, 7)
    q = qs[:bsz].contiguous()
    ragged = 3001
    flat = torch.zeros(ragged * dims + 1, device="cuda")
    unaligned = flat[1:].view(ragged, dims)
    unaligned[:3000] = vecs
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    padded = torch.zeros(4096, dims, device="cuda")
    padded[:3000] = vecs
    for column in (padded, unaligned.clone(), unaligned):
        before = _build.LAUNCHES["knn_exact"]
        got = knn.exact_knn_scores(column, q, space)
        assert _build.LAUNCHES["knn_exact"] == before + 1
        want = knn.exact_knn_scores_plain(column, q, space)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (column.shape, column.data_ptr() % 16)
    d_pad = 4096
    got = knn.exact_knn_scores(padded, q, space)
    eligible = (torch.rand(bsz, d_pad, device="cuda") < 0.5)
    eligible[:, 3000:] = False
    live = torch.ones(d_pad, dtype=torch.bool, device="cuda")
    s, m = knn.knn_match_topk(got, eligible, live, 10)
    packed = topk.masked_topk_plain(got, eligible, live, live, d_pad,
                                    torch.full((bsz,), -np.inf,
                                               device="cuda"), 10)
    ps, pm = knn.knn_topk_mark_plain(packed, got, 10)
    torch.cuda.synchronize()
    assert torch.equal(m, pm) and torch.equal(s, ps)
    assert int(m.sum()) == 10 * bsz


@pytest.mark.parametrize("space", ["l2", "cosinesimil", "innerproduct"])
def test_ivf_probe_kernel_equals_plain(gpu, space):
    """K8 bit for bit: the same blocks, scores and candidate masks."""
    from opensearch_tpu_torch.ops import knn
    vecs, qs = _knn_data(5000, 48, 3)
    exists = np.ones(5000, bool)
    exists[::13] = False
    ivf = knn.build_ivf(vecs.cpu().numpy(), exists, nlist=32, nprobe=4,
                        device="cuda")
    packed, ids = knn.pack_ivf_lists(vecs.cpu().numpy(), ivf.lists)
    args = (torch.from_numpy(packed).cuda(), torch.from_numpy(ids).cuda(),
            torch.from_numpy(ivf.centroids).cuda(),
            torch.from_numpy(ivf.block_centroid).cuda(), 8192)
    for bsz, nprobe in ((1, 4), (33, 9)):
        q = qs[:bsz].contiguous()
        before = _build.LAUNCHES["ivf_probe"]
        keys_before = _build.LAUNCHES["ivf_block_keys"]
        gd, gm = knn.ivf_knn_scores(*args, q, space, nprobe)
        assert _build.LAUNCHES["ivf_probe"] == before + 1
        assert _build.LAUNCHES["ivf_block_keys"] == keys_before + 1
        pd, pm = knn.ivf_knn_scores_plain(*args, q, space, nprobe)
        torch.cuda.synchronize()
        assert torch.equal(gm, pm)
        assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))
        assert int(gm.sum()) > 0


@pytest.mark.parametrize("bsz", [1, 33])
def test_ivf_block_keys_kernel_equals_plain(gpu, bsz):
    """K8's launch (a): every block's centroid key bit for bit."""
    from opensearch_tpu_torch.ops import knn
    vecs, qs = _knn_data(2000, 48, 4)
    cent = vecs[:40].contiguous()
    block_centroid = torch.randint(0, 40, (300,), dtype=torch.int32,
                                   device="cuda")
    q = qs[:bsz].contiguous()
    before = _build.LAUNCHES["ivf_block_keys"]
    got = knn.ivf_block_keys(cent, block_centroid, q)
    assert _build.LAUNCHES["ivf_block_keys"] == before + 1
    want = knn.ivf_block_keys_plain(cent, block_centroid, q)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _flat_view(a: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of a, `offset` floats into a larger buffer."""
    flat = torch.zeros(a.numel() + offset, dtype=a.dtype, device=a.device)
    view = flat[offset:].view(a.shape)
    view.copy_(a)
    return view


@pytest.mark.parametrize("n,nlist,dims", [(20000, 64, 100), (3000, 7, 33),
                                          (5000, 1500, 8), (3001, 600, 96),
                                          (2049, 300, 1), (1999, 300, 37)])
def test_kmeans_step_kernel_equals_plain(gpu, n, nlist, dims):
    """K9: assignments exactly, centroids within n * 2^-24 * sum|x| of the
    f64 means (both sides), the same bits on two runs, and an empty
    cluster keeps its centroid. nlist x dims past the resident centroids
    (600 x 96: the streamed path over blocks of 256), n off the 96-point
    tile, dims 1 and odd dims (4-byte copies)."""
    from opensearch_tpu_torch.ops import knn
    vecs, _qs = _knn_data(n, dims, 5)
    cent = vecs[torch.arange(nlist, device="cuda") * (n // nlist)].clone()
    cent[-1] = 1e4                      # no point is nearest: empty
    before = _build.LAUNCHES["kmeans_step"]
    got_c, got_a = knn.kmeans_step(vecs, cent)
    again_c, again_a = knn.kmeans_step(vecs, cent)
    assert _build.LAUNCHES["kmeans_step"] == before + 2
    want_c, want_a = knn.kmeans_step_plain(vecs, cent)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_a, again_a)
    assert torch.equal(got_c.view(torch.int32), again_c.view(torch.int32))
    assert torch.equal(got_c.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(got_c[-1], cent[-1])
    x = vecs.double()
    a = got_a.long()
    sums = torch.zeros(nlist, dims, dtype=torch.float64,
                       device="cuda").index_add_(0, a, x)
    abss = torch.zeros_like(sums).index_add_(0, a, x.abs())
    cnt = torch.bincount(a, minlength=nlist).double()[:, None]
    ok = cnt[:, 0] > 0
    exact = sums[ok] / cnt[ok]
    # a mean of c members: the sum within c * 2^-24 * sum|x|, over c,
    # plus the division's rounding
    bound = 2.0 ** -24 * abss[ok] + 2.0 ** -23 * exact.abs()
    for side in (got_c, want_c):
        assert bool(((side[ok].double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("nlist,dims,aligned", [(300, 12, True),
                                                (700, 100, True),
                                                (300, 12, False)])
def test_kmeans_step_ties_and_infinite_distances(gpu, nlist, dims, aligned):
    """K9 bit for bit with its plain version (one launch a call, the same
    bits on two runs) where exact ties cross the kernel's lane, register
    tile and block boundaries (duplicate centroids at 15 and 16, 0 and
    nlist - 1, 63 and 64, 255 and 256), with points sitting on the tied
    centroids; then with every centroid at 1e30 (|c|^2 overflows: every
    distance +inf), where every point gets centroid 0. The data as a view
    4 bytes past a 16-byte boundary takes the 4-byte copies."""
    from opensearch_tpu_torch.ops import knn
    n = 3000
    vecs, _qs = _knn_data(n, dims, 9)
    cent = vecs[torch.arange(nlist, device="cuda") * (n // nlist)].clone()
    pairs = [(lo, hi) for lo, hi in ((15, 16), (0, nlist - 1), (63, 64),
                                     (255, 256)) if hi < nlist]
    for i, (lo, hi) in enumerate(pairs):
        cent[hi] = cent[lo]
        vecs[10 * i:10 * i + 10] = cent[lo]
    if not aligned:
        vecs = _flat_view(vecs, 1)
        assert vecs.data_ptr() % 16 != 0 and vecs.is_contiguous()
    far = torch.full_like(cent, 1e30)
    for centroids in (cent, far):
        before = _build.LAUNCHES["kmeans_step"]
        got_c, got_a = knn.kmeans_step(vecs, centroids)
        again_c, again_a = knn.kmeans_step(vecs, centroids)
        assert _build.LAUNCHES["kmeans_step"] == before + 2
        want_c, want_a = knn.kmeans_step_plain(vecs, centroids)
        torch.cuda.synchronize()
        assert torch.equal(got_a, want_a) and torch.equal(got_a, again_a)
        assert torch.equal(got_c.view(torch.int32), want_c.view(torch.int32))
        assert torch.equal(got_c.view(torch.int32), again_c.view(torch.int32))
        if centroids is far:
            assert bool((got_a == 0).all())
        else:
            for i, (lo, _hi) in enumerate(pairs):
                assert bool((got_a[10 * i:10 * i + 10] == lo).all())


# ------------------------------------- K3's threshold entry, MaxSim, hybrid

@pytest.mark.parametrize("k", [0, 10, 20000])
def test_masked_topk_threshold_kernel_equals_plain(gpu, k):
    """The set of each row's k winners (tied scores: lowest docs first),
    marked at the finite eligible ones, as K3's plain top-k marks it."""
    d_pad, bsz = 1 << 15, 3
    gen = torch.Generator(device="cuda").manual_seed(k + 1)
    scores = torch.randint(0, 50, (bsz, d_pad), generator=gen,
                           device="cuda").float()
    matches = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.7
    live = torch.rand(d_pad, generator=gen, device="cuda") < 0.9
    root = torch.ones(d_pad, dtype=torch.bool, device="cuda")
    ms = torch.tensor([-np.inf, 10.0, 45.0], device="cuda")
    before = _build.LAUNCHES["masked_topk_threshold"]
    got = topk.masked_topk_threshold(scores, matches, live, root, 30000, ms,
                                     k)
    assert _build.LAUNCHES["masked_topk_threshold"] == before + 1
    want = topk.masked_topk_threshold_plain(scores, matches, live, root,
                                            30000, ms, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[0].sum()) == min(k, int(
        (matches[0] & live)[:30000].sum()))


def _maxsim_data(n_docs, t_bucket, dims, bsz, tq, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    count = torch.randint(0, t_bucket + 1, (n_docs,), generator=gen,
                          device="cuda", dtype=torch.int32)
    tokens = torch.randn(n_docs, t_bucket, dims, generator=gen,
                         device="cuda")
    lanes = torch.arange(t_bucket, device="cuda")[None, :]
    tokens[lanes >= count[:, None]] = 0.0
    query = torch.randn(bsz, tq, dims, generator=gen, device="cuda")
    qmask = torch.ones(bsz, tq, device="cuda")
    qmask[:, tq - tq // 4:] = 0.0          # padded query lanes
    query[qmask == 0] = 0.0
    return tokens, count, query, qmask


MAXSIM_SHAPES = [(8, 37, 4, 1), (128, 128, 32, 33), (16, 64, 8, 5),
                 (128, 13, 32, 1)]


@pytest.mark.parametrize("t_bucket,dims,tq,bsz", MAXSIM_SHAPES + [
    (1024, 16, 33, 2), (300, 32, 5, 3), (8, 16, 4, 1), (8, 32, 32, 1)])
def test_maxsim_exact_kernel_equals_plain(gpu, t_bucket, dims, tq, bsz):
    """K10 bit for bit, one launch a call, the same bits on two runs: odd
    dims, T 8 to 1024 (docs across subtiles of 256 slots), Tq 4 to 33 (two
    query tiles), B 1 to 33, docs of 0, 1, 31, 32, 33 and T tokens in the
    first window of 32 docs, zero-token docs and padded query lanes; then
    the query and the tokens as views 4 bytes past a 16-byte boundary. At
    T = 8 with dims <= 32 and one query tile a window is a single item, so
    a CTA opens a window while the one two back is still being finished;
    40,000 docs give every resident CTA several windows."""
    from opensearch_tpu_torch.ops import maxsim
    n_docs = 40_000 if t_bucket == 8 else 700
    tokens, count, query, qmask = _maxsim_data(n_docs, t_bucket, dims, bsz,
                                               tq, t_bucket + dims)
    edge = torch.tensor([0, 1, 31, 32, 33, t_bucket], dtype=torch.int32,
                        device="cuda").clamp(max=t_bucket)
    count[1:7] = edge
    lanes = torch.arange(t_bucket, device="cuda")[None, :]
    tokens[lanes >= count[:, None]] = 0.0
    for args in ((tokens, count, query, qmask),
                 (tokens, count, _flat_view(query, 1), qmask),
                 (_flat_view(tokens, 1), count, query, qmask)):
        assert args[0].is_contiguous() and args[2].is_contiguous()
        before = _build.LAUNCHES["maxsim_exact"]
        got = maxsim.exact_maxsim_scores(*args)
        assert _build.LAUNCHES["maxsim_exact"] == before + 1
        again = maxsim.exact_maxsim_scores(*args)
        want = maxsim.exact_maxsim_scores_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert bool((got[:, count == 0] == 0).all())


@pytest.mark.parametrize("t_bucket,dims,tq,bsz", MAXSIM_SHAPES)
def test_maxsim_pq_kernels_equal_plain(gpu, t_bucket, dims, tq, bsz):
    """K11's two entries bit for bit: the tables (`pq_lut`) and the code
    scorer, with M = dims / 4 or, for odd dims, M = dims (several tables
    per tile or one)."""
    from opensearch_tpu_torch.ops import maxsim
    tokens, count, query, qmask = _maxsim_data(700, t_bucket, dims, bsz, tq,
                                               dims)
    m = dims // 4 if dims % 4 == 0 else dims
    gen = torch.Generator(device="cuda").manual_seed(m)
    codebook = torch.randn(m, 256, dims // m, generator=gen, device="cuda")
    codes = torch.randint(0, 256, (700, t_bucket, m), generator=gen,
                          device="cuda", dtype=torch.uint8)
    before = (_build.LAUNCHES["pq_lut"], _build.LAUNCHES["maxsim_pq"])
    lut = maxsim.pq_lut(codebook, query)
    want_lut = maxsim.pq_lut_plain(codebook, query)
    got = maxsim.pq_maxsim_from_lut(codes, lut, count, qmask)
    assert (_build.LAUNCHES["pq_lut"],
            _build.LAUNCHES["maxsim_pq"]) == (before[0] + 1, before[1] + 1)
    want = maxsim.pq_maxsim_from_lut_plain(codes, lut, count, qmask)
    torch.cuda.synchronize()
    assert torch.equal(lut.view(torch.int32), want_lut.view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (T, dims, M, Tq, B) for K11's query-token groups (ops/maxsim.py
# pq_group): odd M = dims with Tq past 32 (G 8: groups of 8 and one of 1),
# Tq off the group, T off 32, M = dims = 128 (G 1), B = 33 at the MaxSim
# cell's M = 32 (G 4), and M = 24 (G 8, a 192 KiB table)
PQ_GROUP_SHAPES = [(16, 9, 9, 33, 2), (40, 12, 3, 6, 3),
                   (24, 128, 128, 5, 2), (128, 128, 32, 32, 33),
                   (48, 96, 24, 17, 4)]


@pytest.mark.parametrize("t_bucket,dims,m,tq,bsz", PQ_GROUP_SHAPES)
def test_maxsim_pq_group_shapes(gpu, t_bucket, dims, m, tq, bsz):
    """K11's scorer bit for bit with its plain version, one launch a call,
    zero-token docs and padded query lanes included."""
    from opensearch_tpu_torch.ops import maxsim
    _tokens, count, query, qmask = _maxsim_data(700, t_bucket, dims, bsz,
                                                tq, t_bucket + m)
    gen = torch.Generator(device="cuda").manual_seed(m)
    codebook = torch.randn(m, 256, dims // m, generator=gen, device="cuda")
    codes = torch.randint(0, 256, (700, t_bucket, m), generator=gen,
                          device="cuda", dtype=torch.uint8)
    lut = maxsim.pq_lut(codebook, query)
    before = _build.LAUNCHES["maxsim_pq"]
    got = maxsim.pq_maxsim_from_lut(codes, lut, count, qmask)
    assert _build.LAUNCHES["maxsim_pq"] == before + 1
    want = maxsim.pq_maxsim_from_lut_plain(codes, lut, count, qmask)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[:, count == 0] == 0).all())


def test_maxsim_pq_refuses_a_group_not_its_own(gpu, monkeypatch):
    """The scorer checks the wrapper's query-token group against its own
    rule (maxsim_pq.cu group_for), so the two cannot drift apart
    silently: a group of 8 at M = 32 (a 256 KiB table) raises."""
    from opensearch_tpu_torch.ops import maxsim
    monkeypatch.setattr(maxsim, "pq_group", lambda m, tq: 8)
    codes = torch.zeros(8, 4, 32, dtype=torch.uint8, device="cuda")
    lut = torch.zeros(1, 32, 32, 256, device="cuda")
    with pytest.raises(_build.KernelError):
        maxsim.pq_maxsim_from_lut(
            codes, lut, torch.ones(8, dtype=torch.int32, device="cuda"),
            torch.ones(1, 32, device="cuda"))


def test_maxsim_pq_refuses_a_table_past_shared_memory(gpu):
    """M = 230 needs 235,520 bytes of table for one query token: the
    wrapper raises, it does not drop to the plain version."""
    from opensearch_tpu_torch.ops import maxsim
    codes = torch.zeros(8, 4, 230, dtype=torch.uint8, device="cuda")
    lut = torch.zeros(1, 2, 230, 256, device="cuda")
    before = _build.LAUNCHES["maxsim_pq"]
    with pytest.raises(ValueError):
        maxsim.pq_maxsim_from_lut(
            codes, lut, torch.ones(8, dtype=torch.int32, device="cuda"),
            torch.ones(1, 2, device="cuda"))
    assert _build.LAUNCHES["maxsim_pq"] == before


@pytest.mark.parametrize("bsz", [1, 33])
@pytest.mark.parametrize("n_sub,k", [(1, 0), (2, 10), (3, 100)])
def test_hybrid_window_kernel_equals_plain(gpu, bsz, n_sub, k):
    """K12 bit for bit: windows with -inf padding, counts, min, max, the
    lane-order sum of squares and the union total."""
    from opensearch_tpu_torch.ops import hybrid
    d_pad = 1 << 14
    gen = torch.Generator(device="cuda").manual_seed(bsz + k)
    rows, elig = [], []
    live = torch.ones(d_pad, dtype=torch.bool, device="cuda")
    for i in range(n_sub):
        scores = torch.rand(bsz, d_pad, generator=gen, device="cuda") * 5
        e = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.002 * (
            i + 1)
        elig.append(e)
        rows.append(topk.masked_topk(scores, e, live, live, 12000,
                                     torch.full((bsz,), -np.inf,
                                                device="cuda"), k))
    rows, elig = torch.stack(rows), torch.stack(elig)
    before = _build.LAUNCHES["hybrid_window"]
    got = hybrid.hybrid_window(rows, elig, k)
    assert _build.LAUNCHES["hybrid_window"] == before + 1
    want = hybrid.hybrid_window_plain(rows, elig, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------- K13 sort key, K3's keyed entry, K14 page

def _structured_image(n_docs, seed):
    """A structured segment's device image on the card: views / ts
    numeric columns and a multi-valued keyword column (pairs layout)."""
    from opensearch_tpu_torch.utils.demo import structured_segment
    _mapper, seg = structured_segment(n_docs, seed=seed)
    col = seg.ordinal_dv["tag"]
    rng = np.random.default_rng(seed)
    extra = rng.choice(n_docs, n_docs // 7, replace=False)
    docs = np.concatenate([col.doc_ids, extra.astype(np.int32)])
    ords = np.concatenate([col.ords, rng.integers(
        0, len(col.dictionary), len(extra)).astype(np.int32)])
    order = np.argsort(docs, kind="stable")
    col.doc_ids, col.ords = docs[order], ords[order]
    col.exists[rng.choice(n_docs, 50, replace=False)] = False
    keep = col.exists[col.doc_ids]
    col.doc_ids, col.ords = col.doc_ids[keep], col.ords[keep]
    views = seg.numeric_dv["views"]
    views.exists[rng.choice(n_docs, 50, replace=False)] = False
    return upload_segment(seg, torch.device("cuda"))


@pytest.mark.parametrize("field", ["views", "ts", "tag", "nope"])
@pytest.mark.parametrize("order", ["asc", "desc"])
def test_sort_key_kernel_equals_plain(gpu, field, order):
    from opensearch_tpu_torch.ops import sort_key
    arrays, _meta = _structured_image(30000, 5)
    before = _build.LAUNCHES["sort_key"]
    got = sort_key.build_sort_key(arrays, (field, order))
    assert _build.LAUNCHES["sort_key"] == before + 1
    want = sort_key.sort_key_plain(arrays, (field, order))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("k", [0, 100, 40000])
@pytest.mark.parametrize("keyed", [True, False])
def test_masked_topk_keyed_kernel_equals_plain(gpu, k, keyed):
    """Keys with many ties (and -0.0 beside +0.0) over 2^16 lanes, two
    rows; at k 40,000 fewer lanes are eligible than k in one row, so -inf
    lanes fill the tail in index order."""
    d_pad, bsz = 1 << 16, 2
    gen = torch.Generator(device="cuda").manual_seed(k + keyed)
    scores = torch.randint(0, 40, (bsz, d_pad), generator=gen,
                           device="cuda").float()
    matches = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.8
    matches[1] &= torch.rand(d_pad, generator=gen, device="cuda") < 0.5
    live = torch.rand(d_pad, generator=gen, device="cuda") < 0.95
    root = torch.ones(d_pad, dtype=torch.bool, device="cuda")
    key = torch.randint(-300, 300, (d_pad,), generator=gen,
                        device="cuda").float()
    key[::7] = -0.0
    key[::11] = -1e30
    ms = torch.tensor([-np.inf, 5.0], device="cuda")
    key = key if keyed else None
    before = _build.LAUNCHES["masked_topk_keyed"]
    got = topk.masked_topk_keyed(scores, matches, live, root, 60000, ms,
                                 key, k)
    assert _build.LAUNCHES["masked_topk_keyed"] == before + 1
    want = topk.masked_topk_keyed_plain(scores, matches, live, root, 60000,
                                        ms, key, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------- the masked top-k family's select
#
# The three entries of masked_topk.cu share one radix select (two full
# reads, then a candidate buffer; the overflow rule re-reads the input
# where a bin holds more than select_cap(Dp) keys). Each case runs every
# entry bit for bit against its plain version, one launch a call, and
# holds each row's full-read count to the pass plan of
# tests/topk_select_mirror.py.

SELECT_KINDS = ("random", "ranks_2_23", "epoch_ms", "all_equal",
                "none_eligible", "few_eligible", "specials")
# (B, Dp, num_docs, offset): one row of 2^16 lanes; 3 rows of 5,000 lanes
# (a multiple of 4, not of a 1,024-lane tile) and num_docs < Dp; 32 rows
# of 3,001 (lane-at-a-time loads); 3 rows whose score / key views sit 4
# bytes past a 16-byte boundary (lane-at-a-time loads at Dp % 4 == 0)
SELECT_SHAPES = ((1, 1 << 16, 1 << 16, 0), (3, 5000, 4500, 0),
                 (32, 3001, 2900, 0), (3, 4096, 4000, 1))


def _offset_view(a: np.ndarray, offset: int) -> torch.Tensor:
    """a on the card, `offset` elements into a larger buffer."""
    flat = torch.zeros(a.size + offset, dtype=torch.float32, device="cuda")
    flat[offset:] = torch.from_numpy(a.reshape(-1)).cuda()
    return flat[offset:].view(a.shape)


def _select_inputs(kind, bsz, d_pad, num_docs, offset, seed):
    """scores, matches, live, root, min_score and the keyed entry's key
    (row 0's values), with each row's masked values for the mirror."""
    rng = np.random.default_rng(seed)
    shape = (bsz, d_pad)
    share = 0.9
    if kind == "random":
        vals = rng.integers(0, 7, shape).astype(np.float32)
        share = 0.3
    elif kind == "ranks_2_23":      # K13's ranks: the top 20+ bits shared
        vals = (2.0 ** 23 + rng.integers(0, 4096, shape)).astype(np.float32)
    elif kind == "epoch_ms":        # 2^17 ms steps: long runs of ties
        vals = (1.7e12 + rng.integers(0, 90 * 86400_000, shape)).astype(
            np.float32)
    elif kind == "all_equal":
        vals = np.full(shape, 3.5, np.float32)
        share = 1.0
    elif kind == "none_eligible":
        vals = rng.random(shape).astype(np.float32)
        share = 0.0
    elif kind == "few_eligible":    # fewer eligible lanes than k
        vals = rng.random(shape).astype(np.float32)
        share = 0.01
    else:
        pool = np.array([np.nan, -np.nan, 0.0, -0.0, -1e30, 1e30, np.inf,
                         -np.inf, 1.5, -1.5], np.float32)
        vals = rng.choice(pool, shape)
    matches = rng.random(shape) < share
    live = rng.random(d_pad) < 0.95
    root = np.ones(d_pad, bool)
    root[::97] = False
    ms = np.full(bsz, -np.inf, np.float32)
    if bsz > 1:
        ms[1] = np.float32(np.nanmedian(vals[1])) if kind != "specials" \
            else np.float32(-1.0)
    dev = "cuda"
    t = {"scores": _offset_view(vals, offset),
         "matches": torch.from_numpy(matches).to(dev),
         "live": torch.from_numpy(live).to(dev),
         "root": torch.from_numpy(root).to(dev),
         "ms": torch.from_numpy(ms).to(dev),
         "key": _offset_view(vals[0], offset)}
    in_seg = np.arange(d_pad) < num_docs
    elig = matches & live & root & in_seg & (vals >= ms[:, None])
    return t, vals, elig


def _mirror_reads(values, elig, k, threshold=False):
    from topk_select_mirror import lane_keys, select
    room = topk.select_buffer_room(values.shape[1], values.shape[0])
    return [select(lane_keys(v, e), k, room, threshold)[1]
            for v, e in zip(values, elig)]


@pytest.mark.parametrize("k", [0, 1, 100, topk.MAX_K])
@pytest.mark.parametrize("shape", SELECT_SHAPES)
@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_masked_topk_select_cases(gpu, kind, shape, k):
    bsz, d_pad, num_docs, offset = shape
    k = min(k, d_pad)
    t, vals, elig = _select_inputs(kind, bsz, d_pad, num_docs, offset, k)
    args = (t["scores"], t["matches"], t["live"], t["root"], num_docs,
            t["ms"], k)
    scratch = topk.select_scratch("masked_topk", bsz, d_pad, k, "cuda")
    before = _build.LAUNCHES["masked_topk"]
    got = topk.masked_topk(*args, scratch=scratch)
    assert _build.LAUNCHES["masked_topk"] == before + 1
    want = topk.masked_topk_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if k:
        assert topk.select_full_reads(scratch, bsz) == \
            _mirror_reads(vals, elig, k)


@pytest.mark.parametrize("k", [0, 1, 100, 20000, "Dp"])
@pytest.mark.parametrize("shape", SELECT_SHAPES)
@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_masked_topk_threshold_select_cases(gpu, kind, shape, k):
    bsz, d_pad, num_docs, offset = shape
    k = d_pad if k == "Dp" else min(k, d_pad)
    t, vals, elig = _select_inputs(kind, bsz, d_pad, num_docs, offset,
                                   k + 7)
    args = (t["scores"], t["matches"], t["live"], t["root"], num_docs,
            t["ms"], k)
    scratch = topk.select_scratch("masked_topk_threshold", bsz, d_pad, k,
                                  "cuda")
    before = _build.LAUNCHES["masked_topk_threshold"]
    got = topk.masked_topk_threshold(*args, scratch=scratch)
    assert _build.LAUNCHES["masked_topk_threshold"] == before + 1
    want = topk.masked_topk_threshold_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if k:
        assert topk.select_full_reads(scratch, bsz) == \
            _mirror_reads(vals, elig, k, threshold=True)


@pytest.mark.parametrize("k", [0, 1, 100, 40000, "Dp"])
@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("shape", SELECT_SHAPES)
@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_masked_topk_keyed_select_cases(gpu, kind, shape, keyed, k):
    """The keyed entry selects by the shared key (row 0's values; every
    row's lanes keyed alike) or, without one, by the scores."""
    bsz, d_pad, num_docs, offset = shape
    k = d_pad if k == "Dp" else min(k, d_pad)
    t, vals, elig = _select_inputs(kind, bsz, d_pad, num_docs, offset,
                                   k + 11)
    key = t["key"] if keyed else None
    args = (t["scores"], t["matches"], t["live"], t["root"], num_docs,
            t["ms"], key, k)
    scratch = topk.select_scratch("masked_topk_keyed", bsz, d_pad, k,
                                  "cuda")
    before = _build.LAUNCHES["masked_topk_keyed"]
    got = topk.masked_topk_keyed(*args, scratch=scratch)
    assert _build.LAUNCHES["masked_topk_keyed"] == before + 1
    want = topk.masked_topk_keyed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if k:
        by = np.broadcast_to(vals[0], vals.shape) if keyed else vals
        assert topk.select_full_reads(scratch, bsz) == \
            _mirror_reads(by, elig, k)


def _byte_view(a: torch.Tensor, offset: int) -> torch.Tensor:
    """bool a on the card, `offset` bytes into a larger buffer."""
    flat = torch.zeros(a.numel() + offset, dtype=torch.bool, device="cuda")
    flat[offset:] = a.reshape(-1)
    return flat[offset:].view(a.shape)


@pytest.mark.parametrize("flag", ["matches", "live", "root"])
@pytest.mark.parametrize("entry", ["masked_topk", "masked_topk_threshold",
                                   "masked_topk_keyed"])
def test_masked_topk_select_flag_view_off_16_bytes(gpu, entry, flag):
    """A match / live / root view 4 bytes past a 16-byte boundary at Dp %
    16 == 0: the 4-byte flag loads stay, the bulk L2 prefetch (16-byte
    aligned addresses only) is off."""
    bsz, d_pad, k = 3, 1 << 16, 100
    t, vals, elig = _select_inputs("random", bsz, d_pad, d_pad, 0, 5)
    t[flag] = _byte_view(t[flag], 4)
    assert t[flag].data_ptr() % 16 == 4
    args = [t["scores"], t["matches"], t["live"], t["root"], d_pad, t["ms"]]
    if entry == "masked_topk_keyed":
        args.append(t["key"])
    scratch = topk.select_scratch(entry, bsz, d_pad, k, "cuda")
    before = _build.LAUNCHES[entry]
    got = getattr(topk, entry)(*args, k, scratch=scratch)
    assert _build.LAUNCHES[entry] == before + 1
    want = getattr(topk, entry + "_plain")(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    by = np.broadcast_to(vals[0], vals.shape) \
        if entry == "masked_topk_keyed" else vals
    assert topk.select_full_reads(scratch, bsz) == _mirror_reads(
        by, elig, k, threshold=entry == "masked_topk_threshold")


@pytest.mark.parametrize("entry", ["masked_topk", "masked_topk_threshold",
                                   "masked_topk_keyed"])
def test_masked_topk_select_2_24_lanes(gpu, entry):
    """One row of 2^24 lanes keyed by value ranks past 2^23 (the sorted
    cell's shape), 80% eligible: the bin of the k-th key fits the buffer,
    so the select reads the input twice."""
    d_pad = 1 << 24
    gen = torch.Generator(device="cuda").manual_seed(24)
    ranks = torch.randperm(10_000_000, generator=gen, device="cuda")
    vals = torch.full((1, d_pad), -1e30, device="cuda")
    vals[0, :10_000_000] = ranks.float()
    matches = torch.rand(1, d_pad, generator=gen, device="cuda") < 0.8
    live = torch.ones(d_pad, dtype=torch.bool, device="cuda")
    ms = torch.full((1,), -np.inf, device="cuda")
    k = {"masked_topk": 1000, "masked_topk_threshold": 20000,
         "masked_topk_keyed": 41088}[entry]
    scores = torch.rand(1, d_pad, generator=gen, device="cuda") \
        if entry == "masked_topk_keyed" else vals
    args = [scores, matches, live, live, 10_000_000, ms]
    if entry == "masked_topk_keyed":
        args.append(vals[0])
    scratch = topk.select_scratch(entry, 1, d_pad, k, "cuda")
    before = _build.LAUNCHES[entry]
    got = getattr(topk, entry)(*args, k, scratch=scratch)
    assert _build.LAUNCHES[entry] == before + 1
    want = getattr(topk, entry + "_plain")(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert topk.select_full_reads(scratch, 1) == [2]


@pytest.mark.parametrize("order", [None, "asc", "desc"])
def test_page_merge_kernel_equals_plain(gpu, order):
    """Four segments' keyed rows (one without the sort column, docvalue
    lanes of a column and of an absent one) into one page."""
    from opensearch_tpu_torch.ops import page, sort_key
    rows, sort_cols, dv_cols = [], [], []
    for s, n in enumerate((30000, 20000, 9000, 25000)):
        arrays, meta = _structured_image(n, 10 + s)
        d_pad = arrays["live"].shape[0]
        gen = torch.Generator(device="cuda").manual_seed(s)
        scores = torch.rand(1, d_pad, generator=gen, device="cuda")
        matches = torch.rand(1, d_pad, generator=gen, device="cuda") < 0.3
        field = "views" if s != 2 else "nope"
        key = sort_key.build_sort_key(arrays, (field, order)) \
            if order is not None else None
        k = 300 if s != 3 else 7000
        rows.append(topk.masked_topk_keyed(
            scores, matches, arrays["live"], arrays["root"], n,
            torch.full((1,), -np.inf, device="cuda"), key, k)[0])
        sort_cols.append(arrays["numeric"].get(field))
        dv_cols.append([arrays["numeric"]["ts"], None])
    before = _build.LAUNCHES["page_merge"]
    got = page.page_merge(rows, order, sort_cols, dv_cols, 500, 1 << 15)
    assert _build.LAUNCHES["page_merge"] == before + 1
    want = page.page_merge_plain(rows, order, sort_cols, dv_cols, 500,
                                 1 << 15)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ------------------------------------- remaining agg kinds (K15-K17)

@pytest.mark.parametrize("field", ["fare", "views", "tag_pairs"])
def test_dense_numeric_kernel_equals_plain(gpu, field):
    """K15 bit for bit: a column with docs lacking it (fare), the identity
    layout (views) and multi-valued pairs."""
    from opensearch_tpu_torch.ops import agg_kernels
    from opensearch_tpu_torch.ops.device_segment import upload_segment
    from opensearch_tpu_torch.utils.demo import taxi_segment
    if field == "tag_pairs":
        arrays, _meta = _structured_image(30000, 3)
        col = arrays["ordinal"]["tag"]
        d, v = col["doc_ids"], col["ords"].to(torch.float32)
        d_pad = arrays["live"].shape[0]
    else:
        _mapper, seg = taxi_segment(30000, seed=4)
        arrays, meta = upload_segment(seg, gpu)
        col = arrays["numeric"][field]
        d, v, d_pad = col["doc_ids"], col["values_f32"], meta.d_pad
    before = _build.LAUNCHES["dense_numeric"]
    got = agg_kernels.dense_numeric(d, v.contiguous(), d_pad, -7.5)
    assert _build.LAUNCHES["dense_numeric"] == before + 1
    want = agg_kernels.dense_numeric_plain(d, v, d_pad, -7.5)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("total,n_fields", [(1, 3), (16, 3), (3000, 3),
                                            (16, 5), (1, 2)])
def test_matrix_moments_kernel_equals_plain(gpu, total, n_fields):
    """K16: counts exactly; every sum within moments_sum_depth * 2^-24 *
    sum|term| of the f64 sum of its f32 terms, and the same bits on two
    runs (three fields: the fused kernel; five: the kernel that takes the
    groups in turn)."""
    # 2^17 docs in one bin: 512 chunks, pass 2 by block
    d_pad, bsz = (1 << 17) if n_fields == 2 else (1 << 15), 5
    gen = torch.Generator(device="cuda").manual_seed(total)
    lanes = torch.randint(-1, total, (d_pad,), generator=gen, device="cuda",
                          dtype=torch.int32)
    _check_moments(binned.bin_csr(lanes, total), n_fields, d_pad, bsz, gen,
                   None)


@pytest.mark.parametrize("block", [False, True], ids=["warp", "block"])
def test_matrix_moments_folds_of_a_skewed_parent(gpu, block):
    """K16 with either pass-2 fold forced on a parent of one 300-chunk bin
    among 2,000 one-chunk bins: the same bounds as above."""
    d_pad = 1 << 17
    gen = torch.Generator(device="cuda").manual_seed(7)
    lanes = torch.randint(1, 2001, (d_pad,), generator=gen, device="cuda",
                          dtype=torch.int32)
    lanes[: 300 * binned.CSR_CHUNK] = 0
    csr = binned.bin_csr(lanes, 2001)
    assert csr.max_bin_chunks == 300
    _check_moments(csr, 3, d_pad, 4, gen, block)


def _check_moments(csr, n_fields, d_pad, bsz, gen, block):
    from opensearch_tpu_torch.ops import agg_kernels
    total = csr.total
    vals = torch.randn(n_fields, d_pad, generator=gen, device="cuda") * 300
    exists = torch.rand(n_fields, d_pad, generator=gen, device="cuda") < 0.9
    mask = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.6
    pmask = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.8
    before = _build.LAUNCHES["matrix_moments"]
    cnt, sums = agg_kernels.matrix_moments(csr, mask, pmask, vals, exists,
                                           block)
    again = agg_kernels.matrix_moments(csr, mask, pmask, vals, exists,
                                       block)[1]
    assert _build.LAUNCHES["matrix_moments"] == before + 2
    want_cnt, want_sums = agg_kernels.matrix_moments_plain(
        csr, mask, pmask, vals, exists)
    torch.cuda.synchronize()
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(sums.view(torch.int32), again.view(torch.int32))
    docs = csr.lane_order.long()
    ok = (mask & pmask)[:, docs]
    v, e = vals[:, docs], exists[:, docs]
    bins = csr.sorted_bins.long()
    depth = agg_kernels.moments_sum_depth(
        binned.CSR_CHUNK, csr.max_bin_chunks,
        agg_kernels.moments_block_fold(csr) if block is None else block)
    for g, (a, b) in enumerate(agg_kernels.moment_groups(n_fields)):
        own = ok & e[a] & e[b]
        x, y = v[a], v[b]
        # each term as the kernel rounds it in f32: the bound is the sum's
        x2 = x * x
        terms = (x, x2, x2 * x, x2 * x2) if a == b else (x * y, x, y)
        for k, t in enumerate(terms):
            t = torch.where(own, t, 0.0).double()
            exact = torch.zeros(bsz, total, dtype=torch.float64,
                                device="cuda").index_add_(1, bins, t)
            absum = torch.zeros_like(exact).index_add_(1, bins, t.abs())
            bound = depth * 2.0 ** -24 * absum
            assert bool(((sums[k, g].double() - exact).abs()
                         <= bound).all()), (g, k)


@pytest.mark.parametrize("n,card", [(4, 1), (9, 1), (3, 40), (5, 700),
                                    (33, 1), (40, 6)])
def test_adjacency_counts_kernel_equals_plain(gpu, n, card):
    """K17 exactly, at the root and under parent bins (shared and global
    cells), and past 32 filters (one launch per pair of filter blocks)."""
    from opensearch_tpu_torch.ops import agg_kernels
    d_pad, bsz = 1 << 16, 3
    gen = torch.Generator(device="cuda").manual_seed(n * card)
    masks = [torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.3
             for _ in range(n)]
    mask = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.7
    pmask = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.9
    pbin = None if card == 1 else torch.randint(
        -1, card, (d_pad,), generator=gen, device="cuda", dtype=torch.int32)
    before = _build.LAUNCHES["adjacency_counts"]
    got = agg_kernels.adjacency_counts(masks, mask, pmask, pbin, card)
    assert _build.LAUNCHES["adjacency_counts"] == before + len(
        agg_kernels.adjacency_blocks(n))
    want = agg_kernels.adjacency_counts_plain(masks, mask, pmask, pbin, card)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ------------------------------------------------------------ K18 / K19

def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, NaN where the other has NaN (any NaN payload)."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def _fs_functions(gen, bsz, d_pad, kinds):
    """Score functions of the given kinds on random columns, filters and
    planes (a log modifier over a column with negative values and zeros:
    NaN and -inf values)."""
    from opensearch_tpu_torch.ops import scoring
    fns = []
    for j, kind in enumerate(kinds):
        col = torch.randn(d_pad, generator=gen, device="cuda") * 40
        col[::7] = 0.0
        exists = torch.rand(d_pad, generator=gen, device="cuda") < 0.9
        filt = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.6 \
            if j % 2 else None
        fn = scoring.ScoreFunction(kind=kind, filter=filt,
                                   has_weight=j % 3 != 1)
        if kind == "fvf":
            fn.modifier = scoring.MODIFIERS[j % len(scoring.MODIFIERS)]
            fn.value, fn.exists = col, exists
        elif kind == "random":
            fn.seed = 12345 + j
        elif kind == "script":
            fn.plane = torch.randn(bsz, d_pad, generator=gen,
                                   device="cuda")
        elif kind == "decay":
            fn.decay = scoring.DECAYS[j % 3]
            fn.value, fn.exists = col.abs() * 1e9 + 1.7e12, exists
        fns.append(fn)
    return fns


def _fs_params(gen, bsz, n_fn):
    from opensearch_tpu_torch.ops import scoring
    p = torch.rand(bsz, scoring.FS_HEAD + len(scoring.FN_SLOTS) * n_fn,
                   generator=gen, device="cuda") * 3 + 0.1
    p[:, 1] = 2.5                         # max_boost
    for j in range(n_fn):
        base = scoring.FS_HEAD + len(scoring.FN_SLOTS) * j
        p[:, base + 3] = 1.7e12           # origin (date millis)
        p[:, base + 4] = 86400000.0 * 5   # scale
        p[:, base + 5] = 86400000.0       # offset
        p[:, base + 6] = 0.5              # decay
    return p


@pytest.mark.parametrize("score_mode", ["multiply", "sum", "avg", "max",
                                        "min", "first"])
@pytest.mark.parametrize("boost_mode", ["multiply", "replace", "sum", "avg",
                                        "max", "min"])
def test_function_score_kernel_equals_plain(gpu, score_mode, boost_mode):
    """K18 bit for bit against its plain version on the card (NaN where
    the plain version has NaN), every function kind, every modifier over
    the functions of the three configurations, each decay, filters, a
    weight on some, min_score on and off."""
    from opensearch_tpu_torch.ops import scoring
    bsz, d_pad = 3, 5000
    gen = torch.Generator(device="cuda").manual_seed(
        scoring.SCORE_MODES.index(score_mode) * 7
        + scoring.BOOST_MODES.index(boost_mode))
    child_s = torch.rand(bsz, d_pad, generator=gen, device="cuda") * 9
    child_m = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.8
    configs = [
        ["fvf"] * len(scoring.MODIFIERS),
        ["weight_only", "fvf", "random", "script", "decay", "decay",
         "decay"],
        ["decay", "fvf", "weight_only"] * 5 + ["random"]]
    for c, kinds in enumerate(configs):
        fns = _fs_functions(gen, bsz, d_pad, kinds)
        params = _fs_params(gen, bsz, len(fns))
        for has_min in (False, True):
            before = _build.LAUNCHES["function_score"]
            got = scoring.function_score(child_s, child_m, fns, params,
                                         score_mode, boost_mode, has_min)
            assert _build.LAUNCHES["function_score"] == before + 1
            want = scoring.function_score_plain(
                child_s, child_m, fns, params, score_mode, boost_mode,
                has_min)
            torch.cuda.synchronize()
            assert _same(got[1], want[1]), (c, has_min)
            assert _same(got[0], want[0]), (c, has_min)


@pytest.mark.parametrize("n_children", [1, 5, 33, 70])
@pytest.mark.parametrize("from_field", [False, True])
def test_terms_set_kernel_equals_plain(gpu, n_children, from_field):
    """K19 terms_set bit for bit, past one launch's 32 children."""
    from opensearch_tpu_torch.ops import scoring
    bsz, d_pad = 4, 3000
    gen = torch.Generator(device="cuda").manual_seed(n_children)
    children = [(torch.rand(bsz, d_pad, generator=gen, device="cuda"),
                 torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.3)
                for _ in range(n_children)]
    boost = torch.rand(bsz, generator=gen, device="cuda") + 0.5
    if from_field:
        msm_v = (torch.rand(d_pad, generator=gen, device="cuda") * 6).floor()
        msm_e = torch.rand(d_pad, generator=gen, device="cuda") < 0.8
        args = (msm_v, msm_e, None)
    else:
        args = (None, None, torch.randint(0, 5, (bsz,), generator=gen,
                                          device="cuda", dtype=torch.int32))
    before = _build.LAUNCHES["terms_set_scores"]
    got = scoring.terms_set(children, *args, boost)
    assert _build.LAUNCHES["terms_set_scores"] == before + -(
        -n_children // scoring.TS_MAX)
    want = scoring.terms_set_plain(children, *args, boost)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_distance_feature_boosting_script_kernels_equal_plain(gpu):
    """K19 distance_feature (on date millis in f32), boosting and the
    script_score wrap, bit for bit."""
    from opensearch_tpu_torch.ops import scoring
    bsz, d_pad = 5, 7000
    gen = torch.Generator(device="cuda").manual_seed(3)
    value = 1.7e12 + torch.rand(d_pad, generator=gen, device="cuda") * 1e10
    exists = torch.rand(d_pad, generator=gen, device="cuda") < 0.9
    origin = torch.full((bsz,), 1.705e12, device="cuda")
    pivot = torch.rand(bsz, generator=gen, device="cuda") * 1e9 + 1e8
    boost = torch.rand(bsz, generator=gen, device="cuda") + 0.5
    checks = [
        ("distance_feature_scores",
         scoring.distance_feature(value, exists, origin, pivot, boost),
         scoring.distance_feature_plain(value, exists, origin, pivot,
                                        boost))]
    pos_s = torch.rand(bsz, d_pad, generator=gen, device="cuda") * 7
    pos_m = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.5
    neg_m = torch.rand(bsz, d_pad, generator=gen, device="cuda") < 0.5
    nb = torch.rand(bsz, generator=gen, device="cuda")
    checks.append(("boosting_scores",
                   scoring.boosting(pos_s, pos_m, neg_m, nb, boost),
                   scoring.boosting_plain(pos_s, pos_m, neg_m, nb, boost)))
    plane = torch.randn(bsz, d_pad, generator=gen, device="cuda")
    checks.append(("script_score_wrap",
                   scoring.script_score_wrap(pos_m, plane, boost),
                   scoring.script_score_wrap_plain(pos_m, plane, boost)))
    torch.cuda.synchronize()
    for name, got, want in checks:
        assert _build.LAUNCHES[name] > 0
        assert _same(got[0], want[0]) and _same(got[1], want[1]), name


# ---------------------------------------- K20 blockmax_keep and K21 row_merge

def _bm_batch(card, bsz, seed, per_query=(2, 3, 4)):
    """B text queries of 2-4 terms (or `per_query`'s counts, in turn)
    compiled with block-max's inputs, each of at least BLOCKMAX_MIN_BLOCKS
    lanes, staged as one batch."""
    mapper, seg, terms, arrays, meta = card
    comp = Compiler(mapper, ShardStats([seg]), blockmax=True)
    plans, n = [], 0
    while len(plans) < bsz:
        q = fast_query_terms(1, terms, seed + n,
                             per_query[n % len(per_query)])[0]
        n += 1
        p = comp.compile(dsl.parse_query({"match": {"body": q}}), seg, meta)
        if p.kind == "text" and \
                p.inputs["ids"].shape[0] >= bm25.BLOCKMAX_MIN_BLOCKS:
            plans.append(p)
    stacked, tree = stack_flat_inputs([p.flatten_inputs([]) for p in plans])
    stacked.append(np.where(np.arange(bsz) % 5 == 4, 1.0,
                            -np.inf).astype(np.float32))
    buf, layout = pack_leaves(stacked, pin=True)
    leaves = unpack_leaves(buf.to("cuda"), layout)
    return plans, unflatten_inputs(tree, leaves[:-1])[0], leaves[-1]


@pytest.mark.parametrize("bsz,k", [(1, 10), (7, 1), (32, 10), (5, 1024)])
def test_blockmax_keep_kernel_equals_plain(card, bsz, k):
    """K20's keep mask and pruned counts bit for bit; every fifth row has
    a min_score floor (no pruning)."""
    plans, blk, ms = _bm_batch(card, bsz, 70 + bsz)
    arrays = card[3]
    n = max(p.static[1] for p in plans)
    before = _build.LAUNCHES["blockmax_keep"]
    keep, pruned = bm25.blockmax_keep_mask(arrays, blk, n, k, ms)
    assert _build.LAUNCHES["blockmax_keep"] == before + 1
    want_keep, want_pruned = bm25.blockmax_keep_mask_plain(arrays, blk, n, k,
                                                           ms)
    torch.cuda.synchronize()
    assert torch.equal(keep, want_keep)
    assert torch.equal(pruned, want_pruned)
    assert int(pruned[4::5].sum()) == 0 if bsz > 4 else True


def test_blockmax_keep_prunes_one_term_queries(card):
    """On one-term queries theta (the 10th best posting of the term's
    top-8 blocks) stands above many other blocks' bounds: K20 prunes
    lanes, bit for bit with its plain version."""
    plans, blk, ms = _bm_batch(card, 32, 95, per_query=(1,))
    arrays = card[3]
    keep, pruned = bm25.blockmax_keep_mask(arrays, blk, 1, 10, ms)
    want_keep, want_pruned = bm25.blockmax_keep_mask_plain(arrays, blk, 1,
                                                           10, ms)
    torch.cuda.synchronize()
    assert torch.equal(keep, want_keep)
    assert torch.equal(pruned, want_pruned)
    assert int(pruned.sum()) > 0
    assert int(pruned[4::5].sum()) == 0


def test_keep_entries_of_k1_and_k2_equal_plain(card):
    """K1 and K2 with K20's keep mask against their plain versions (K1's
    row with the trailing pruned lane), counted under their keep keys."""
    _check_keep_entries(card, *_bm_batch(card, 8, 90))


def test_keep_entries_drop_pruned_lanes(card):
    """The same on one-term queries, where K20 prunes lanes: a dropped
    lane adds nothing to K1's row or K2's scores."""
    _check_keep_entries(card, *_bm_batch(card, 32, 95, per_query=(1,)),
                        want_pruned=True)


def _check_keep_entries(card, plans, blk, ms, want_pruned=False):
    arrays = card[3]
    n = max(p.static[1] for p in plans)
    keep, pruned = bm25.blockmax_keep_mask(arrays, blk, n, 10, ms)
    assert int(pruned.sum()) > 0 or not want_pruned
    before = (_build.LAUNCHES["bm25_candidate_keep"],
              _build.LAUNCHES["score_text_clause_keep"])
    if blk["ids"].shape[1] * 128 <= bm25.CANDIDATE_MAX_LANES:
        got = bm25.bm25_candidate(arrays, blk, n, False, 10, ms,
                                  block_keep=keep, pruned=pruned)
        want = bm25.bm25_candidate(
            {k: v.cpu() if torch.is_tensor(v) else v
             for k, v in arrays.items()},
            {k: v.cpu() for k, v in blk.items()}, n, False, 10, ms.cpu(),
            block_keep=keep.cpu(), pruned=pruned.cpu())
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert _build.LAUNCHES["bm25_candidate_keep"] == before[0] + 1
    ks, kh = bm25.score_text_clause(arrays, blk, block_keep=keep)
    ps, ph = bm25.score_text_clause_plain(
        arrays, dict(blk, ids=torch.where(keep, blk["ids"], -1)))
    torch.cuda.synchronize()
    assert torch.equal(kh, ph) and torch.equal(ks, ps)
    assert _build.LAUNCHES["score_text_clause_keep"] == before[1] + 1


@pytest.mark.parametrize("ks,k", [([10] * 5, 10), ([1000] * 8, 1000),
                                  ([7, 0, 300, 65, 1, 300], 100),
                                  ([65536] * 8, 65536),
                                  ([0, 0, 0], 10), ([0] * 8, 65536),
                                  ([3, 0, 5], 20), ([12, 30], 42),
                                  ([40960] * 4, 40960),
                                  ([65536, 100, 0, 40960, 7], 40960),
                                  ([700, 5000, 1, 0, 300, 2, 9000, 64], 1000),
                                  ([1], 1), ([300], 10)])
def test_row_merge_kernel_equals_plain(gpu, ks, k):
    """K21's merge bit for bit: keys drawn from 50 values (ties across and
    within rows), -inf slots, -0.0 and +0.0 keys; uneven k_r, empty rows
    and every row empty, k below, at and above the rows' lanes; rows wider
    than k (only their first k lanes can place)."""
    from opensearch_tpu_torch.ops import spmd as kspmd
    gen = torch.Generator(device="cuda").manual_seed(len(ks) + k)
    width = 3 * max(ks) + 1
    buf = torch.zeros(len(ks), width, device="cuda")
    for r, kr in enumerate(ks):
        keys = torch.randint(-25, 25, (kr,), generator=gen,
                             device="cuda").float()
        keys[torch.rand(kr, generator=gen, device="cuda") < 0.1] = -np.inf
        keys[keys == 0] = -0.0 if r % 2 else 0.0
        buf[r, :kr] = torch.sort(keys, descending=True).values
        buf[r, kr:2 * kr] = torch.rand(kr, generator=gen, device="cuda")
        buf[r, 2 * kr:3 * kr] = torch.randint(
            0, 1 << 20, (kr,), generator=gen, device="cuda",
            dtype=torch.int32).view(torch.float32)
        buf[r, 3 * kr] = torch.tensor([kr * 3], dtype=torch.int32,
                                      device="cuda").view(torch.float32)
    pruned = torch.arange(len(ks), dtype=torch.int32, device="cuda")
    before = _build.LAUNCHES["row_merge"]
    got = kspmd.row_merge(buf, ks, pruned, k)
    assert _build.LAUNCHES["row_merge"] == before + 1
    want = kspmd.row_merge_plain(buf.cpu(), ks, pruned.cpu(), k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_rows,k", [(4, 40960), (5, 1000), (8, 10),
                                      (3, 65536)])
def test_row_merge_kernel_on_keyed_rows(gpu, n_rows, k):
    """K21 on rows as the multi-shard program makes them: each row written
    by K3-keyed (`masked_topk_keyed` into a row of the merge buffer) over a
    sort key with ties, +-0.0, NaN of both signs and ineligible (-inf)
    lanes, Dp rows of uneven sizes; the merge bit for bit against its
    plain version."""
    from opensearch_tpu_torch.ops import spmd as kspmd
    gen = torch.Generator(device="cuda").manual_seed(n_rows * 7 + k)
    d_pads = [1 << 16, 1 << 17, 1 << 12, 1 << 16, 1 << 15, 1 << 16,
              1 << 14, 1 << 16][:n_rows]
    ks = [min(k, d) for d in d_pads]
    buf = torch.zeros(n_rows, 3 * max(ks) + 1, device="cuda")
    for r, (d_pad, k_r) in enumerate(zip(d_pads, ks)):
        key = torch.randint(-20, 20, (d_pad,), generator=gen,
                            device="cuda").float()
        key[key == 0] = -0.0 if r % 2 else 0.0
        key[key == 7] = float("nan")
        key[key == -7] = -float("nan")
        scores = torch.rand(1, d_pad, generator=gen, device="cuda")
        matches = torch.rand(1, d_pad, generator=gen, device="cuda") < 0.7
        live = torch.ones(d_pad, dtype=torch.bool, device="cuda")
        ms = torch.full((1,), -np.inf, device="cuda")
        topk.masked_topk_keyed(scores, matches, live, live, d_pad - 3, ms,
                               key, k_r, out=buf[r:r + 1, :3 * k_r + 1])
    pruned = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    before = _build.LAUNCHES["row_merge"]
    got = kspmd.row_merge(buf, ks, pruned, k)
    assert _build.LAUNCHES["row_merge"] == before + 1
    want = kspmd.row_merge_plain(buf.cpu(), ks, pruned.cpu(), k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("order", ["asc", "desc"])
def test_row_value_key_kernel_equals_plain(gpu, order):
    from opensearch_tpu_torch.ops import spmd as kspmd
    gen = torch.Generator(device="cuda").manual_seed(3)
    d_pad, n_u = 1 << 16, 600
    col = {"unique_f32": torch.sort(torch.randn(1024, generator=gen,
                                                device="cuda")).values,
           "min_rank": torch.randint(-5, n_u + 5, (d_pad,), generator=gen,
                                     device="cuda", dtype=torch.int32),
           "max_rank": torch.randint(-5, n_u + 5, (d_pad,), generator=gen,
                                     device="cuda", dtype=torch.int32),
           "exists": torch.rand(d_pad, generator=gen, device="cuda") < 0.8}
    before = _build.LAUNCHES["row_value_key"]
    got = kspmd.row_value_key(col, order, d_pad, gpu)
    assert _build.LAUNCHES["row_value_key"] == before + 1
    want = kspmd.row_value_key_plain({k: v.cpu() for k, v in col.items()},
                                     order)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ------------------------- K22 nested_join, K23 nested_aggs, K24, K25

def _blocks(gen, d_pad, n_roots, extra=()):
    """A doc-block layout on the card: roots at random rows, each with 0-6
    nested rows placed anywhere before it, on one of two paths; root i
    takes extra[i] more rows besides."""
    parent = torch.full((d_pad,), -1, dtype=torch.int32)
    paths = torch.full((d_pad,), -1, dtype=torch.int32)
    perm = torch.randperm(d_pad, generator=gen)
    roots = perm[:n_roots].sort()[0]
    free = perm[n_roots:].tolist()
    for r in roots.tolist():
        for _ in range(int(torch.randint(0, 7, (1,), generator=gen))):
            if not free:
                break
            c = free.pop()
            parent[c] = r
            paths[c] = int(torch.randint(0, 2, (1,), generator=gen))
    for root, k in zip(roots.tolist(), extra):
        for _ in range(k):
            parent[free.pop()] = root
    live = torch.rand(d_pad, generator=gen) < 0.9
    root = torch.zeros(d_pad, dtype=torch.bool)
    root[roots] = True
    return _on_card(parent, paths, live, root)


def _on_card(parent, paths, live, root):
    """The image's doc-block arrays of a layout, on the card, with its CSR
    and its roots."""
    from opensearch_tpu_torch.ops.device_segment import root_child_csr
    start, rows = root_child_csr(parent.numpy(), parent.shape[0])
    return {"parent_ptr": parent.cuda(), "nested_path": paths.cuda(),
            "child_start": torch.from_numpy(start).cuda(),
            "child_rows": torch.from_numpy(rows).cuda(), "live": live.cuda(),
            "root": root.cuda()}


def _blocked(gen, d_pad, heavy=0, far=0):
    """test_torch_common.blocked_layout on the card, drawn from a seed of
    gen: blocks one after another over several kernel tiles (some across a
    tile's end), a `heavy`-row document, `far` rows moved under the last
    root (their windows past the stage)."""
    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,),
                                                  generator=gen)))
    return _on_card(*(torch.from_numpy(x) for x in blocked_layout(
        rng, d_pad, heavy=heavy, far=far)))


# K22's layouts, (B, Dp, the layout from a generator): the scattered one
# (rows anywhere before their root: every tile gathers; Dp off 16: element
# loads), the blocked
# one over several tiles (windows staged) at B=1, 6 and 33 (a query group
# of one), a 10,000-row root (a heavy tile: the CTA's chunked fold), rows
# moved far from their root (their tiles gather)
NESTED_JOIN_CASES = {
    "scattered": (6, 9000, lambda g: _blocks(g, 9000, 2000)),
    "blocked": (6, 5 * 2048 + 96, lambda g: _blocked(g, 5 * 2048 + 96)),
    "blocked_b1": (1, 5 * 2048, lambda g: _blocked(g, 5 * 2048)),
    "blocked_b33": (33, 3 * 2048 + 16, lambda g: _blocked(g, 3 * 2048 + 16)),
    "heavy_10000": (6, 12 * 2048, lambda g: _blocked(g, 12 * 2048,
                                                      heavy=10000)),
    "far": (6, 4 * 2048, lambda g: _blocked(g, 4 * 2048, far=20)),
}


@pytest.mark.parametrize("layout", sorted(NESTED_JOIN_CASES))
@pytest.mark.parametrize("mode", ["avg", "sum", "max", "min", "none"])
def test_nested_join_kernel_equals_plain(gpu, mode, layout):
    """K22 bit for bit: a root's selected rows folded in row order; one
    launch a call."""
    from opensearch_tpu_torch.ops import nested
    gen = torch.Generator().manual_seed(22)
    bsz, d_pad, build = NESTED_JOIN_CASES[layout]
    seg = build(gen)
    child_s = (torch.rand(bsz, d_pad, generator=gen) * 9).cuda()
    child_m = (torch.rand(bsz, d_pad, generator=gen) < 0.6).cuda()
    path_ord = torch.tensor([0, 1, -1, 0, 1, 0] * 6,
                            dtype=torch.int32)[:bsz].cuda()
    boost = (torch.rand(bsz, generator=gen) + 0.5).cuda()
    before = _build.LAUNCHES["nested_join"]
    got = nested.nested_join(child_s, child_m, seg, path_ord, boost, mode)
    want = nested.nested_join_plain(
        child_s, child_m, seg["live"], seg["nested_path"], seg["parent_ptr"],
        seg["child_start"], seg["child_rows"], path_ord, boost, mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["nested_join"] == before + 1
    assert _same(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].any())
    if layout == "heavy_10000":
        assert int(seg["child_start"].diff().max()) == 10000


def test_nested_join_unaligned_views(gpu):
    """Views off a 16-byte boundary take the element path, bit for bit."""
    from opensearch_tpu_torch.ops import nested
    gen = torch.Generator().manual_seed(221)
    d_pad = 3 * 2048
    seg = _blocked(gen, d_pad)
    child_s = (torch.rand(5 * d_pad + 1, generator=gen) * 9).cuda()[1:] \
        .view(5, d_pad)
    child_m = (torch.rand(5 * d_pad + 1, generator=gen) < 0.6).cuda()[1:] \
        .view(5, d_pad)
    path_ord = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32).cuda()
    boost = torch.ones(5).cuda()
    for mode in ("sum", "max"):
        got = nested.nested_join(child_s, child_m, seg, path_ord, boost, mode)
        want = nested.nested_join_plain(
            child_s, child_m, seg["live"], seg["nested_path"],
            seg["parent_ptr"], seg["child_start"], seg["child_rows"],
            path_ord, boost, mode)
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and torch.equal(got[1], want[1])


# K23's cases: (B, Dp, layout, card, mask share, context): the scattered
# layout's (B, Dp, roots, extra rows of the first roots): the walk's
# bitset (card <= 64) and earlier-rows test (a 26-row root: four
# batches), the CTA's path of a 10,000-row root and of 33 and 43 rows
# (bitmap windows past 65,536 buckets), B=1, no row selected, Dp off 16;
# the blocked layout over several tiles (nested: each tile's parent window
# staged; "far": rows moved under a far root, their tile gathering) at
# B=1, 5 and 33, the root context's single bucket (card 1: one warp
# reduction) and a card past the CTA-private counters' cap. Context
# "random": each row's own bucket; "roots": every live root's mask set,
# its bucket drawn once (the aggregation's parent context)
NESTED_AGG_CASES = {
    "mixed": (5, 20000, (5000, ()), 37, 0.7, "random"),
    "heavy_root": (4, 30000, (3000, (10000, 27)), 64, 0.7, "random"),
    "card65": (3, 30000, (3000, (40, 20)), 65, 0.7, "random"),
    "card300_heavy": (3, 30000, (3000, (10000, 20)), 300, 0.7, "random"),
    "many_buckets": (2, 30000, (3000, (10000,)), 70000, 0.7, "random"),
    "b1": (1, 30000, (3000, (40, 20)), 37, 0.7, "random"),
    "all_false": (3, 30000, (3000, (10000,)), 37, 0.0, "random"),
    "dp_off16": (3, 30001, (3000, ()), 37, 0.7, "random"),
    "blocked": (5, 5 * 2048 + 96, "blocked", 37, 0.7, "random"),
    "blocked_card1": (5, 5 * 2048 + 96, "blocked", 1, 1.0, "roots"),
    "blocked_card64": (5, 5 * 2048, "blocked", 64, 0.9, "roots"),
    "blocked_past_cap": (3, 5 * 2048, "blocked", 5000, 0.9, "roots"),
    "blocked_b1": (1, 5 * 2048, "blocked", 1, 1.0, "roots"),
    "blocked_b33": (33, 3 * 2048 + 16, "blocked", 64, 0.8, "roots"),
    "far": (5, 4 * 2048, "far", 37, 0.8, "roots"),
}


@pytest.mark.parametrize("case", sorted(NESTED_AGG_CASES))
def test_nested_aggs_kernels_equal_plain(gpu, case):
    """K23 nested and reverse_nested: own rows, buckets and counts
    exactly, one launch of each a call."""
    from opensearch_tpu_torch.ops import nested
    bsz, d_pad, layout, card, share, context = NESTED_AGG_CASES[case]
    gen = torch.Generator().manual_seed(23)
    if layout == "blocked":
        seg = _blocked(gen, d_pad)
    elif layout == "far":
        seg = _blocked(gen, d_pad, far=20)
    else:
        seg = _blocks(gen, d_pad, *layout)
    mask = (torch.rand(bsz, d_pad, generator=gen) < share).cuda()
    peff = torch.randint(-1, card, (bsz, d_pad), generator=gen,
                         dtype=torch.int32).cuda()
    if context == "roots":
        roots = seg["root"] & seg["live"]
        mask &= roots[None, :]
        bucket = torch.randint(0, card, (d_pad,), generator=gen,
                               dtype=torch.int32).cuda()
        peff = torch.where(mask, bucket[None, :], -1).to(torch.int32)
    path_ord = torch.tensor([0, 1, 0, -1, 1] * 7,
                            dtype=torch.int32)[:bsz].cuda()
    before = (_build.LAUNCHES["nested_agg"],
              _build.LAUNCHES["reverse_nested_agg"])
    got = nested.nested_agg(mask, peff, seg, path_ord, card)
    got_r = nested.reverse_nested_agg(mask, peff, seg, card)
    assert (_build.LAUNCHES["nested_agg"],
            _build.LAUNCHES["reverse_nested_agg"]) == (before[0] + 1,
                                                       before[1] + 1)
    want = nested.nested_agg_plain(mask, peff, seg["live"],
                                   seg["nested_path"], seg["parent_ptr"],
                                   path_ord, card)
    want_r = nested.reverse_nested_agg_plain(mask, peff, seg["parent_ptr"],
                                             card)
    torch.cuda.synchronize()
    for g, w in zip(got + got_r, want + want_r):
        assert torch.equal(g, w)
    assert (int(got[2].sum()) > 0) == (share > 0)
    if context == "random":
        assert (int(got_r[2].sum()) > 0) == (share > 0)


def _check_scatter(lanes, total, values, needs):
    """K24 against its plain version: counts, min and max exactly, sums
    bit for bit, two calls the same bits, one launch a call."""
    before = _build.LAUNCHES["binned_scatter"]
    got = binned.binned_scatter(lanes, total, values, needs)
    again = binned.binned_scatter(lanes, total, values, needs)
    want = binned.binned_scatter_plain(lanes, total, values, needs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["binned_scatter"] == before + 2
    for k in needs:
        assert _same(got[k], want[k]), k
        assert _same(got[k], again[k]), k
    return got


SCATTER_CAP = binned.SCATTER_MAX_BINS


@pytest.mark.parametrize("per_query,total,n", [
    (False, 16, 70000), (True, 3, 5000), (False, 40000, 100000),
    (False, SCATTER_CAP - 1, 70000), (True, SCATTER_CAP, 70000),
    (False, SCATTER_CAP + 1, 70000)])
def test_binned_scatter_kernel_equals_plain(gpu, per_query, total, n):
    """K24: counts, min and max exactly; sums and sums of squares bit for
    bit (one two-level order over each bin's lanes in lane order on both
    sides) and within n * 2^-24 * sum|v| of the f64 sums; on both sides
    of SCATTER_MAX_BINS (one partition pass, then the radix passes)."""
    gen = torch.Generator().manual_seed(24)
    bsz = 4
    lanes = torch.randint(-2, total + 2, (bsz, n), generator=gen,
                          dtype=torch.int32).cuda()
    shape = (bsz, n) if per_query else (n,)
    values = (torch.randn(shape, generator=gen) * 100).cuda()
    needs = ("cnt", "sum", "sumsq", "min", "max")
    got = _check_scatter(lanes, total, values, needs)
    ok = (lanes >= 0) & (lanes < total)
    idx = torch.where(ok, lanes, total).long()
    v = values.expand(bsz, -1).double()
    exact = torch.zeros(bsz, total + 1, dtype=torch.float64,
                        device="cuda").scatter_add_(1, idx, v)[:, :total]
    mag = torch.zeros(bsz, total + 1, dtype=torch.float64,
                      device="cuda").scatter_add_(1, idx, v.abs())[:, :total]
    cnt = got["cnt"].double()
    assert bool(((got["sum"].double() - exact).abs()
                 <= cnt * 2.0 ** -24 * mag + 1e-30).all())


def _scatter_case(case, gen):
    """(lanes [B, n], total, values, needs) of one edge case."""
    bsz = 3
    if case == "chunk_edges":
        # bins of 255, 256, 257 and 513 lanes (a chunk's edges), spread
        # over the rows among dropped lanes
        sizes = [255, 256, 257, 513]
        n = 9000
        rows = []
        for _b in range(bsz):
            row = torch.full((n,), -1, dtype=torch.int32)
            pos = torch.randperm(n, generator=gen)
            at = 0
            for bin_, size in enumerate(sizes):
                row[pos[at:at + size]] = bin_
                at += size
            rows.append(row)
        return torch.stack(rows).cuda(), len(sizes), None, ("cnt", "sum",
                                                            "sumsq")
    if case == "all_dropped":
        n = 5000
        lanes = torch.randint(0, 2, (bsz, n), generator=gen,
                              dtype=torch.int32) * 21 - 1     # -1 or 20
        return lanes.cuda(), 20, None, ("cnt", "sum", "min", "max")
    if case == "one_bin":
        return (torch.full((bsz, 70000), 3, dtype=torch.int32).cuda(), 20,
                (torch.randn(70000, generator=gen) * 10).cuda(),
                ("cnt", "sum", "sumsq", "min", "max"))
    if case == "ragged_n":
        n = 3 * 2048 + 77          # off the tile and off 4: scalar loads
        return (torch.randint(-1, 21, (bsz, n), generator=gen,
                              dtype=torch.int32).cuda(), 20,
                (torch.randn(bsz, n, generator=gen) * 10).cuda(),
                ("cnt", "sum", "sumsq", "min", "max"))
    if case == "unaligned":
        # a contiguous view 4 bytes past an aligned allocation
        n = 8192
        store = torch.randint(-1, 300, (bsz * n + 1,), generator=gen,
                              dtype=torch.int32).cuda()
        return (store[1:].view(bsz, n), 299,
                (torch.randn(n, generator=gen) * 10).cuda(),
                ("cnt", "sum", "min", "max"))
    if case == "radix_skewed":
        n = 60000
        lanes = torch.where(torch.rand(bsz, n, generator=gen) < 0.7,
                            12345, torch.randint(0, 40000, (bsz, n),
                                                 generator=gen))
        return (lanes.to(torch.int32).cuda(), 40000,
                (torch.randn(bsz, n, generator=gen) * 10).cuda(),
                ("cnt", "sum", "sumsq"))
    if case == "max_one_bin_per_doc":
        # the dynamic child-bin max: total = n, a bin per lane's doc
        n = 50000
        docs = torch.randint(0, n, (bsz, n), generator=gen,
                             dtype=torch.int32)
        docs = torch.where(torch.rand(bsz, n, generator=gen) < 0.3, n, docs)
        vals = torch.randint(0, 1000, (bsz, n), generator=gen).float()
        return docs.cuda(), n, vals.cuda(), ("max",)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["chunk_edges", "all_dropped", "one_bin",
                                  "ragged_n", "unaligned", "radix_skewed",
                                  "max_one_bin_per_doc"])
def test_binned_scatter_edge_cases(gpu, case):
    lanes, total, values, needs = _scatter_case(
        case, torch.Generator().manual_seed(241))
    got = _check_scatter(lanes, total, values, needs)
    if case == "all_dropped":
        assert int(got["cnt"].sum()) == 0
    if case == "chunk_edges":
        assert got["cnt"].tolist() == [[255, 256, 257, 513]] * 3


def test_geo_scores_kernels_equal_plain(gpu):
    """K25's four entries against their plain versions on the card: the
    same sinf / cosf / asinf / powf / logf, one rounding per operation."""
    from opensearch_tpu_torch.ops import geo
    gen = torch.Generator().manual_seed(25)
    bsz, d_pad = 6, 30000
    lat = (torch.rand(d_pad, generator=gen) * 180 - 90).cuda()
    lon = (torch.rand(d_pad, generator=gen) * 360 - 180).cuda()
    exists = (torch.rand(d_pad, generator=gen) < 0.9).cuda()
    qlat = (torch.rand(bsz, generator=gen) * 180 - 90).cuda()
    qlon = (torch.rand(bsz, generator=gen) * 360 - 180).cuda()
    dist = (torch.rand(bsz, generator=gen) * 5e6).cuda()
    boost = (torch.rand(bsz, generator=gen) + 0.5).cuda()
    top = qlat.clamp(-80, 80) + 10
    bottom = top - 30
    left = qlon
    right = torch.where(torch.arange(bsz, device="cuda") % 2 == 0,
                        qlon + 40, qlon - 40)     # odd rows cross the line
    feat = (torch.rand(d_pad, generator=gen) * 100 - 5).cuda()
    pivot = (torch.rand(bsz, generator=gen) * 20 + 1).cuda()
    scale = (torch.rand(bsz, generator=gen) + 1).cuda()
    expo = (torch.rand(bsz, generator=gen) * 2 + 0.2).cuda()
    checks = [
        (geo.geo_distance(lat, lon, exists, qlat, qlon, dist, boost),
         geo.geo_distance_plain(lat, lon, exists, qlat, qlon, dist, boost)),
        (geo.geo_bbox(lat, lon, exists, top, left, bottom, right, boost),
         geo.geo_bbox_plain(lat, lon, exists, top, left, bottom, right,
                            boost)),
        (geo.distance_feature_geo(lat, lon, exists, qlat, qlon, dist, boost),
         geo.distance_feature_geo_plain(lat, lon, exists, qlat, qlon, dist,
                                        boost))]
    for fn in geo.RANK_FUNCTIONS:
        checks.append((geo.rank_feature(feat, exists, fn, pivot, scale, expo,
                                        boost),
                       geo.rank_feature_plain(feat, exists, fn, pivot, scale,
                                              expo, boost)))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(checks):
        assert _same(got[0], want[0]) and torch.equal(got[1], want[1]), i
    for name in geo.ENTRIES:
        assert _build.LAUNCHES[name] > 0


# ------------------------------------------------------ row 16, expand_pad

EXPAND_CASES = [
    ((5,), (128,), torch.int32, -1),
    ((1000,), (1024,), torch.float32, 0.0),
    ((37,), (64,), torch.bool, False),
    ((7, 100), (8, 128), torch.int32, 2 ** 31 - 1),
    ((3, 5), (3, 64), torch.uint8, 0),
    ((130, 8), (256, 8), torch.float32, 0.0),
    ((9, 4, 6), (16, 4, 6), torch.uint8, 0),
    ((3, 5, 7), (4, 8, 8), torch.float32, 0.0),
    ((50, 2, 3), (64, 2, 3), torch.bool, False),
]


@pytest.mark.parametrize("compact,full,dtype,fill", EXPAND_CASES)
def test_expand_pad_kernel_equals_plain(gpu, compact, full, dtype, fill):
    from opensearch_tpu_torch.ops.device_segment import (expand_pad,
                                                         expand_pad_plain)
    gen = torch.Generator(device="cuda").manual_seed(len(compact))
    if dtype == torch.float32:
        x = torch.randn(compact, generator=gen, device="cuda")
    elif dtype == torch.bool:
        x = torch.rand(compact, generator=gen, device="cuda") < 0.5
    else:
        x = torch.randint(0, 120, compact, generator=gen, device="cuda",
                          dtype=dtype)
    before = _build.LAUNCHES["expand_pad"]
    got = expand_pad(x, full, fill)
    want = expand_pad_plain(x, full, fill)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["expand_pad"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == full
    if dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("total", [
    2 ** 32 - 2112 * 256 - 1000,    # 32-bit indices: total + stride fits
    2 ** 32 - 1000])                # within one grid stride of 2^32
def test_expand_pad_near_the_32_bit_index_limit(gpu, total):
    """A uint8 leaf of about 2^32 elements: the grid-stride loop ends, the
    prefix and the fill land where they should."""
    from opensearch_tpu_torch.ops.device_segment import (expand_pad,
                                                         expand_pad_plain)
    x = torch.arange(1000, device="cuda").to(torch.uint8)
    got = expand_pad(x, (total,), 7)
    torch.cuda.synchronize()
    assert torch.equal(got[:1000], x)
    assert int((got[1000:] != 7).sum()) == 0
    del got
    torch.cuda.empty_cache()
    assert torch.equal(expand_pad(x, (total,), 7)[-5000:],
                       expand_pad_plain(x, (total,), 7)[-5000:])


def test_expand_pad_refuses_other_dtypes(gpu):
    from opensearch_tpu_torch.ops.device_segment import expand_pad
    with pytest.raises(ValueError):
        expand_pad(torch.zeros(4, dtype=torch.int64, device="cuda"), (8,), 0)
    with pytest.raises(ValueError):
        expand_pad(torch.zeros(4, 2, device="cuda").t(), (4, 4), 0.0)


def test_delta_publish_image_equals_upload(gpu):
    from opensearch_tpu_torch.index.mapper import MapperService
    from opensearch_tpu_torch.index.segment import SegmentBuilder
    from opensearch_tpu_torch.ops.device_segment import publish_segment
    from opensearch_tpu_torch.utils.demo import (HTTP_LOGS_MAPPING,
                                                 http_logs_docs)
    mapper = MapperService(HTTP_LOGS_MAPPING)
    builder = SegmentBuilder(mapper, "s")
    for i, doc in enumerate(http_logs_docs(40)):
        builder.add(mapper.parse_document(str(i), doc))
    seg = builder.seal()
    seg.live[::5] = False
    before = _build.LAUNCHES["expand_pad"]
    got, meta, sent = publish_segment(seg, gpu, delta=True)
    want, want_meta = upload_segment(seg, gpu)
    torch.cuda.synchronize()
    assert meta == want_meta and _build.LAUNCHES["expand_pad"] > before

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


# the vector path (16-byte chunks: rows of whole 16-byte multiples, both
# pointers aligned) and the element path (everything else)
PAYLOAD_NAN = float(np.frombuffer(np.uint32(0x7FA00001).tobytes(),
                                  np.float32)[0])
EXPAND_VECTOR_CASES = [
    # row lengths of 15, 16 and 17 bytes into 32-byte rows
    ((4, 15), (8, 32), torch.uint8, 0),
    ((4, 16), (8, 32), torch.uint8, 0),
    ((4, 17), (8, 32), torch.uint8, 0),
    ((4, 16), (8, 17), torch.uint8, 0),
    # the PQ codes' shape at small scale: folds to one axis
    ((100, 8, 32), (128, 8, 32), torch.uint8, 0),
    ((100, 128), (128, 128), torch.float32, -0.0),
    ((1000,), (1024,), torch.float32, float("nan")),
    ((1000,), (1024,), torch.float32, PAYLOAD_NAN),
    ((1000,), (1024,), torch.int32, 2 ** 31 - 1),
    ((96, 20), (128, 64), torch.int32, -1),
    ((992,), (4096,), torch.bool, True),
    ((3, 16), (5, 48), torch.bool, False),
]


def _expand_input(compact, dtype, gen):
    if dtype == torch.float32:
        return torch.randn(compact, generator=gen, device="cuda")
    if dtype == torch.bool:
        return torch.rand(compact, generator=gen, device="cuda") < 0.5
    return torch.randint(0, 120, compact, generator=gen, device="cuda",
                         dtype=dtype)


def _hold_expand(x, full, fill):
    from opensearch_tpu_torch.ops.device_segment import (expand_pad,
                                                         expand_pad_plain)
    before = _build.LAUNCHES["expand_pad"]
    got = expand_pad(x, full, fill)
    want = expand_pad_plain(x, full, fill)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["expand_pad"] == before + 1
    assert got.dtype == x.dtype and tuple(got.shape) == tuple(full)
    if x.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("compact,full,dtype,fill", EXPAND_VECTOR_CASES)
def test_expand_pad_vector_and_element_paths(gpu, compact, full, dtype,
                                             fill):
    gen = torch.Generator(device="cuda").manual_seed(sum(compact))
    _hold_expand(_expand_input(compact, dtype, gen), full, fill)


@pytest.mark.parametrize("dtype,offset", [(torch.uint8, 1),
                                          (torch.uint8, 16),
                                          (torch.float32, 1),
                                          (torch.int32, 4)])
def test_expand_pad_unaligned_view(gpu, dtype, offset):
    """A contiguous view whose data_ptr is not 16-byte aligned (an offset
    of 1 element of a fresh tensor) takes the element path; an offset of
    16 bytes keeps the vector path."""
    gen = torch.Generator(device="cuda").manual_seed(offset)
    base = _expand_input((offset + 1024,), dtype, gen)
    x = base[offset:]
    assert x.is_contiguous()
    _hold_expand(x, (2048,), 0 if dtype != torch.float32 else 0.0)
    _hold_expand(x.view(64, 16), (64, 32), 0 if dtype != torch.float32
                 else -0.0)


PQ_LUT_CASES = [(dsub, m) for dsub in (1, 2, 4, 8, 16, 3) for m in (8, 3)]


@pytest.mark.parametrize("dsub,m", PQ_LUT_CASES)
def test_pq_lut_kernel_equals_plain(gpu, dsub, m):
    """K11's table bit for bit on every templated dsub and the loop's (3),
    with B * Tq = 3 * 11 = 33 rows: one full 32-row tile and one of a
    single row."""
    from opensearch_tpu_torch.ops import maxsim
    gen = torch.Generator(device="cuda").manual_seed(dsub * 100 + m)
    codebook = torch.randn(m, 256, dsub, generator=gen, device="cuda")
    query = torch.randn(3, 11, m * dsub, generator=gen, device="cuda")
    query[0, 0, :dsub] = -0.0       # an entry of -0.0 products
    before = _build.LAUNCHES["pq_lut"]
    got = maxsim.pq_lut(codebook, query)
    want = maxsim.pq_lut_plain(codebook, query)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pq_lut"] == before + 1
    assert tuple(got.shape) == (3, 11, m, 256)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
