"""K24's stable partition and K6's packed mask, mirrored in torch on the
CPU (the CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them to their plain versions there).

K24 (ops/csrc/binned_scatter.cu) places each kept lane of a query at its
rank within its bin's run: per warp tile of consecutive lanes a count of
each bucket, an exclusive scan over the tiles per (query, bucket), a scan
over the buckets per query, then each tile walked again 32 lanes at a
time, a lane's slot its tile's base for its bucket plus the running count
plus the lower peers of its step. Above the cap the same partition runs as
a stable LSD radix over the bin's digits. The mirror below follows those
steps over hypothesis-drawn shapes and tile sizes; every kept lane must
land at its place in `_dyn_runs`' (bin, lane) order, and the chunked sums
of the partitioned buffer must equal `dynamic_sum_plain` bit for bit.

K6 (ops/csrc/binned_reduce.cu) packs each query's mask AND pmask into bits
in doc order, 16 docs a thread, two halves a word; a lane's eligibility is
then one bit. The mirror's bits equal `_gather_ok` on pairs and identity
layouts, and its words `pack_bits` (K5's order)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from opensearch_tpu_torch.ops import binned


# ------------------------------------------------------------------ K24

def _tile_counts(bucket, valid, nb, wt, tiles):
    """[B, nb, tiles]: each warp tile's count of each bucket."""
    bsz, n = bucket.shape
    tile = (torch.arange(n) // wt).expand(bsz, -1)
    idx = (torch.arange(bsz)[:, None] * nb + bucket) * tiles + tile
    out = torch.zeros(bsz * nb * tiles, dtype=torch.int64)
    out.index_add_(0, idx[valid], torch.ones(int(valid.sum()),
                                              dtype=torch.int64))
    return out.reshape(bsz, nb, tiles)


def _partition_pass(bins, valid, shift, nbits, nb, wt, tiles):
    """One pass of K24's partition over [B, len] items (bins, valid):
    the slot of each valid item in its query's output row."""
    bsz, n = bins.shape
    bucket = torch.where(valid, (bins >> shift) & ((1 << nbits) - 1), 0)
    counts = _tile_counts(bucket, valid, nb, wt, tiles)
    prefix = torch.cumsum(counts, 2) - counts          # scan over tiles
    per_bucket = counts.sum(2)
    start = torch.cumsum(per_bucket, 1) - per_bucket   # scan over buckets
    base = start[:, :, None] + prefix                   # [B, nb, tiles]
    slots = torch.full((bsz, n), -1, dtype=torch.int64)
    running = torch.zeros(bsz, tiles, nb, dtype=torch.int64)
    lower = torch.tril(torch.ones(32, 32, dtype=torch.bool), -1)
    rows = torch.arange(bsz)[:, None]
    # each warp walks its tile 32 lanes a step, all tiles at once
    for step in range(0, wt, 32):
        pos = (torch.arange(tiles)[:, None] * wt + step
               + torch.arange(32)[None, :]).reshape(-1)      # [tiles * 32]
        inside = pos < n
        p = pos.clamp(max=n - 1)
        x = bucket[:, p].reshape(bsz, tiles, 32)
        ok = (valid[:, p] & inside).reshape(bsz, tiles, 32)
        peers = (x[..., :, None] == x[..., None, :]) & ok[..., :, None] \
            & ok[..., None, :]
        rank = (peers & lower).sum(-1)                       # lower peers
        t_idx = torch.arange(tiles)[None, :, None].expand(bsz, -1, 32)
        got = base[rows[:, :, None], x, t_idx] \
            + running[rows[:, :, None], t_idx, x] + rank
        flat = got.reshape(bsz, -1)
        okf = ok.reshape(bsz, -1)
        cols = p.expand(bsz, -1)
        slots[rows.expand(-1, cols.shape[1])[okf], cols[okf]] = flat[okf]
        for b in range(bsz):
            running[b].index_put_(
                (t_idx[b][ok[b]], x[b][ok[b]]),
                torch.ones(int(ok[b].sum()), dtype=torch.int64),
                accumulate=True)
    # slots index the rows as the scatter does: no two items share one
    for b in range(bsz):
        s = slots[b][valid[b]]
        assert s.unique().numel() == s.numel()
    return slots


def partition_mirror(lanes, total, plan):
    """K24's partition of lanes [B, n] (bins outside [0, total) dropped)
    under `plan`: the slot of each lane in its query's partitioned row, -1
    for a dropped lane."""
    bsz, n = lanes.shape
    bins = lanes.long()
    valid = (bins >= 0) & (bins < total)
    if plan.passes == 1:
        return _partition_pass(bins, valid, 0, plan.digit, plan.nb,
                               plan.wt, plan.tiles)
    # pass 0 drops the dropped lanes; later passes read the previous
    # pass's kept items, in its slot order
    slots = _partition_pass(bins, valid, 0, plan.digit, plan.nb, plan.wt,
                            plan.tiles)
    kept = valid.sum(1)
    for p in range(1, plan.passes):
        item_bins = torch.zeros(bsz, n, dtype=torch.int64)
        item_lane = torch.full((bsz, n), -1, dtype=torch.int64)
        for b in range(bsz):
            v = valid[b]
            item_bins[b, slots[b][v]] = bins[b][v]
            item_lane[b, slots[b][v]] = torch.nonzero(v)[:, 0]
        item_ok = torch.arange(n)[None, :] < kept[:, None]
        nxt = _partition_pass(item_bins, item_ok, p * plan.digit,
                              plan.digit, plan.nb, plan.wt, plan.tiles)
        slots = torch.full((bsz, n), -1, dtype=torch.int64)
        for b in range(bsz):
            ok = item_ok[b]
            slots[b, item_lane[b][ok]] = nxt[b][ok]
    return slots


def chunked_sums(buf, counts):
    """The kernel's sums over a partitioned f32 buffer [B, n]: each bin's
    run cut into CSR_CHUNK chunks, each summed from 0 in order, then the
    bin's chunks from 0 in order."""
    bsz, total = counts.shape
    chunk = binned.CSR_CHUNK
    start = torch.cumsum(counts, 1) - counts
    out = torch.zeros(bsz, total, dtype=torch.float32)
    # only the bins that hold a lane in some query
    used = (counts > 0).any(0)
    counts, start = counts[:, used], start[:, used]
    if counts.shape[1] == 0:
        return out
    out[:, used] = _chunked_runs(buf, counts, start, chunk)
    return out


def _chunked_runs(buf, counts, start, chunk):
    bsz, total = counts.shape
    out = torch.zeros(bsz, total, dtype=torch.float32)
    most = int(counts.max()) if counts.numel() else 0
    for j in range(-(-most // chunk)):
        s = torch.zeros(bsz, total, dtype=torch.float32)
        ln = (counts - j * chunk).clamp(0, chunk)
        for i in range(int(ln.max())):
            pos = (start + j * chunk + i).clamp(max=buf.shape[1] - 1)
            s = s + torch.where(i < ln, torch.gather(buf, 1, pos), 0.0)
        out = out + torch.where(ln > 0, s, 0.0)
    return out


@st.composite
def scatter_cases(draw):
    bsz = draw(st.integers(1, 3))
    n = draw(st.integers(1, 1400))
    # one pass up to SCATTER_MAX_BINS bins, two radix passes above, three
    # past 2^22
    total = draw(st.sampled_from([
        1, 2, 3, 7, 20, 255, 256, 257, 600, binned.SCATTER_MAX_BINS,
        binned.SCATTER_MAX_BINS + 1, 5000, 40000, (1 << 22) + 3]))
    drop = draw(st.sampled_from([0.0, 0.3, 0.9, 1.0]))
    skew = draw(st.booleans())
    wt = draw(st.sampled_from([128, 256, 384, 1024, 2048]))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    return bsz, n, total, drop, skew, wt, seed


def _lanes(bsz, n, total, drop, skew, seed):
    rng = np.random.default_rng(seed)
    if skew:     # most lanes in one bin, the rest spread
        bins = np.where(rng.random((bsz, n)) < 0.8, total // 2,
                        rng.integers(0, total, (bsz, n)))
    else:
        bins = rng.integers(0, total, (bsz, n))
    out = rng.choice([-1, total, total + 5], (bsz, n))
    keep = rng.random((bsz, n)) >= drop
    values = (rng.standard_normal((bsz, n)) * 100).astype(np.float32)
    return (torch.from_numpy(np.where(keep, bins, out).astype(np.int32)),
            torch.from_numpy(values))


@settings(max_examples=60, deadline=None)
@given(scatter_cases())
def test_k24_partition_mirror_places_lanes_in_run_order(case):
    bsz, n, total, drop, skew, wt, seed = case
    lanes, values = _lanes(bsz, n, total, drop, skew, seed)
    plan = binned.scatter_plan(n, total, ("sum",), wt=wt)
    assert plan.passes == (1 if total <= binned.SCATTER_MAX_BINS else -(
        -binned._bits(total) // binned.SCATTER_DIGIT_BITS))
    slots = partition_mirror(lanes, total, plan)
    _bins, order, counts = binned._dyn_runs(lanes, total)
    kept = counts.sum(1)
    for b in range(bsz):
        want = torch.full((n,), -1, dtype=torch.int64)
        k = int(kept[b])
        want[order[b, :k]] = torch.arange(k)
        assert torch.equal(slots[b], want)
    # the partitioned buffer's chunked sums: dynamic_sum_plain's bits
    buf = torch.zeros(bsz, n, dtype=torch.float32)
    for b in range(bsz):
        ok = slots[b] >= 0
        buf[b, slots[b][ok]] = values[b][ok]
    ok = (lanes >= 0) & (lanes < total)
    want = binned.dynamic_sum_plain(lanes, total,
                                    torch.where(ok, values, 0.0))
    got = chunked_sums(buf, counts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("total,passes", [
    (1, 1), (binned.SCATTER_MAX_BINS - 1, 1), (binned.SCATTER_MAX_BINS, 1),
    (binned.SCATTER_MAX_BINS + 1, 2), (40000, 2), (1 << 22, 2),
    ((1 << 22) + 1, 3), (1 << 24, 3)])
def test_k24_plan_routes_by_static_sizes(total, passes):
    plan = binned.scatter_plan(1 << 20, total, ("cnt", "sum"))
    assert plan.passes == passes
    if passes > 1:
        assert plan.digit * passes >= binned._bits(total)
        assert plan.digit <= binned.SCATTER_DIGIT_BITS
        assert plan.nb == 1 << plan.digit
    assert plan.wt % 128 == 0 and plan.tiles * plan.wt >= 1 << 20
    # tile counts stay within a sixteenth of the lanes
    assert plan.nb * plan.tiles <= max((1 << 20) // 16, plan.nb)
    assert binned.scatter_plan(1 << 20, total, ("min", "max")).passes == 0


def test_k24_scratch_is_the_kept_lanes_and_tile_counts():
    """cnt + sum at the geo cell's shape: one value buffer of B x n f32
    (the kept lanes at most) plus the tile counts and small arrays; the
    key sort's 2 x 8-byte keys and 2 x 4-byte partials a lane are gone."""
    bsz, n = 32, 1 << 24
    got = binned.scatter_scratch_bytes(bsz, n, 20, ("cnt", "sum"))
    assert 4 * bsz * n <= got <= 4 * bsz * n * 1.02
    assert binned.scatter_scratch_bytes(bsz, n, 20, ("cnt", "min",
                                                     "max")) == 0


# ------------------------------------------------------------------- K6

def pack_mirror(mask, pmask):
    """K6's pass 0: u32 words [B, ceil(Dp / 32)] as int64, bit j of word w
    = mask & pmask at doc 32w + j; 16 docs a thread, halves joined."""
    m = mask if pmask is None else mask & pmask
    bsz, d_pad = m.shape
    n_words = -(-d_pad // 32)
    padded = torch.zeros(bsz, n_words * 32, dtype=torch.bool)
    padded[:, :d_pad] = m
    halves = padded.reshape(bsz, n_words * 2, 16).to(torch.int64)
    h = (halves << torch.arange(16)).sum(-1)
    return h[:, 0::2] | (h[:, 1::2] << 16)


def bit_ok(words, docs, d_pad):
    """A lane's eligibility from the packed words: one bit a doc."""
    docs = docs.long()
    valid = (docs >= 0) & (docs < d_pad)
    safe = torch.where(valid, docs, 0)
    bit = (words[:, safe >> 5] >> (safe & 31)) & 1
    return (bit == 1) & valid


@pytest.mark.parametrize("d_pad", [1, 31, 32, 100, 4096, 5000])
@pytest.mark.parametrize("layout", ["pairs", "identity"])
@pytest.mark.parametrize("with_pmask", [False, True])
def test_k6_packed_mask_equals_gather_ok(d_pad, layout, with_pmask):
    rng = np.random.default_rng(d_pad + 7 * with_pmask)
    bsz = 3
    mask = torch.from_numpy(rng.random((bsz, d_pad)) < 0.4)
    pmask = torch.from_numpy(rng.random((bsz, d_pad)) < 0.7) \
        if with_pmask else None
    if layout == "identity":
        n, docs = d_pad, None
    else:
        docs_np = np.repeat(np.arange(d_pad, dtype=np.int32),
                            rng.integers(0, 3, d_pad))
        docs_np = np.concatenate([docs_np, np.full(5, -1, np.int32)])
        n, docs = len(docs_np), torch.from_numpy(docs_np)
    words = pack_mirror(mask, pmask)
    lane_docs = torch.arange(n, dtype=torch.int32) if docs is None else docs
    want = binned._gather_ok(mask, pmask, docs, n)
    assert torch.equal(bit_ok(words, lane_docs, d_pad), want)
    # in CSR order, as the fold reads them
    lanes = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32))
    csr = binned.bin_csr(lanes, 8)
    docs_ord = csr.lane_order if docs is None else csr.in_order(docs)
    assert torch.equal(bit_ok(words, docs_ord, d_pad),
                       want[:, csr.lane_order.long()])
    if d_pad % 32 == 0:
        m = mask if pmask is None else mask & pmask
        assert torch.equal(words, binned.pack_bits(m))


def test_k6_ordered_columns_are_kept_beside_the_csr():
    lanes = torch.tensor([3, 0, 1, 3, -1, 0], dtype=torch.int32)
    csr = binned.bin_csr(lanes, 4)
    vals = torch.arange(6, dtype=torch.float32)
    a = csr.in_order(vals)
    assert csr.in_order(vals) is a
    assert torch.equal(a, vals[csr.lane_order.long()])
    other = vals.clone()
    assert csr.in_order(other) is not a
    assert csr.ordered_bytes() == 2 * 5 * 4
    # the chunks by their first lane: bins 0 (lanes 1, 5), 1 (2), 3 (0, 3)
    order = csr.chunk_order()
    firsts = csr.lane_order[csr.chunk_start[:-1].long()][order.long()]
    assert firsts.tolist() == sorted(firsts.tolist())
    assert sorted(order.tolist()) == list(range(csr.n_chunks))
    assert csr.ordered_bytes() == 2 * 5 * 4 + 4 * csr.n_chunks


@pytest.mark.parametrize("nnz,d_pad,packs", [
    (1 << 24, 1 << 24, True), ((1 << 24) // 32, 1 << 24, True),
    ((1 << 24) // 32 - 1, 1 << 24, False), ((1 << 24) // 64, 1 << 24, False),
    (1, 32, True), (1, 33, False)])
def test_k6_packs_dense_fields_only(nnz, d_pad, packs):
    """K6 packs the mask where the CSR holds a lane per 32 docs or more (a
    32-byte sector a lane would read all of it); sparser fields read each
    lane's mask bytes."""
    assert binned.k6_packs(nnz, d_pad) == packs
