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
layouts, and its words `pack_bits` (K5's order).

K5 (ops/csrc/binned_popcount.cu) packs a query's lanes a warp step of 16
words: on the identity layout each lane reads 16 mask bytes, a byte
compare (__vcmpne4) and a multiply gather them into 16 bits, and a pair
shuffle joins two lanes' halves into one word (the byte route, 16 byte
loads, gives the same bits); on a gathered layout 16 ballots, each word
kept by a pair of lanes. The mirror's words equal the reference's
`_pack_bits` exactly, on lane counts that are and are not a multiple of a
step's 512 lanes, and its counts `binned_popcount_plain`'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from opensearch_tpu.search.aggs import engine as jengine
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


# ------------------------------------------------------------------- K5

def _vcmpne4(x):
    """__vcmpne4(x, 0): 0xff in each byte of x that is not 0, else 0."""
    out = np.zeros_like(x)
    for i in range(4):
        nz = ((x >> np.uint32(8 * i)) & np.uint32(0xFF)) != 0
        out |= np.where(nz, np.uint32(0xFF << (8 * i)), np.uint32(0))
    return out


def _flags16(chunks):
    """16 bytes a lane -> 16 bits: the byte compare, then the multiply
    that gathers each byte's low bit (nib4 in the kernel)."""
    q = np.ascontiguousarray(chunks).view("<u4")            # [lanes, 4]
    f = (_vcmpne4(q) & np.uint32(0x01010101)).astype(np.uint64)
    nib = ((f * np.uint64(0x01020408)) & np.uint64(0xFFFFFFFF)) >> 24
    h = (nib << (np.arange(4, dtype=np.uint64) * 4)).sum(1)
    # the byte route: the same bits from 16 byte loads
    byte_bits = ((chunks != 0).astype(np.uint64)
                 << np.arange(16, dtype=np.uint64)).sum(1)
    assert np.array_equal(h, byte_bits)
    return h.astype(np.uint32)


def k5_pack_mirror(mrow, prow, doc_ids, n):
    """One query's words u32 [n / 32], warp step by warp step: lane L of
    a step at word wb takes word wb + L / 2 (0 past the last word)."""
    nw = n // 32
    lanes = -(-nw // 16) * 32                       # whole steps
    lane = np.arange(lanes)
    w, half = lane // 2, lane & 1
    ok = w < nw
    if doc_ids is None:
        off = (w * 32 + half * 16)[:, None] + np.arange(16)
        chunks = np.zeros((lanes, 16), np.uint8)
        chunks[ok] = mrow[off[ok]]
        h = _flags16(chunks)
        if prow is not None:
            pchunks = np.zeros((lanes, 16), np.uint8)
            pchunks[ok] = prow[off[ok]]
            h &= _flags16(pchunks)
        o = h[lane ^ 1]                             # __shfl_xor_sync(h, 1)
        word = np.where(half == 1, o | (h << np.uint32(16)),
                        h | (o << np.uint32(16)))
    else:
        docs = np.full(lanes * 16, -1, np.int64)
        docs[:n] = doc_ids
        valid = (docs >= 0) & (docs < len(mrow))
        safe = np.where(valid, docs, 0)
        hit = valid & (mrow[safe] != 0)
        if prow is not None:
            hit &= prow[safe] != 0
        # ballot i of a step: bit j = lane j of word wb + i
        ballots = (hit.reshape(-1, 32).astype(np.uint64)
                   << np.arange(32, dtype=np.uint64)).sum(1)
        word = ballots.astype(np.uint32)[w]         # kept by lanes 2i, 2i+1
    assert np.array_equal(word[0::2], word[1::2])   # both lanes of a pair
    assert not word[0::2][nw:].any()
    return word[0::2][:nw]


@pytest.mark.parametrize("n", [512, 1184, 8192, 8224])
@pytest.mark.parametrize("layout", ["identity", "gathered"])
@pytest.mark.parametrize("with_pmask", [False, True])
def test_k5_pack_mirror_against_reference(n, layout, with_pmask):
    """K5's 16-byte pack (byte compare, bit gather, pair shuffle) and its
    ballots against the reference's _pack_bits, exactly, on mask bytes of
    any value (a byte not 0 is true); then its counts against the plain
    version's."""
    rng = np.random.default_rng(n + 2 * with_pmask + (layout == "gathered"))
    bsz, d_pad, card = 3, n + 48, 16
    mask = np.where(rng.random((bsz, d_pad)) < 0.45,
                    rng.integers(1, 256, (bsz, d_pad)), 0).astype(np.uint8)
    pmask = (rng.random((bsz, d_pad)) < 0.7).astype(np.uint8) \
        if with_pmask else None
    doc_ids = None if layout == "identity" else \
        rng.integers(-1, d_pad, n).astype(np.int32)
    lanes = rng.integers(-1, card + 1, n).astype(np.int32)
    bits = binned.lane_bits(torch.from_numpy(lanes), card)
    want_counts = binned.binned_popcount_plain(
        torch.from_numpy(mask != 0),
        None if pmask is None else torch.from_numpy(pmask != 0),
        None if doc_ids is None else torch.from_numpy(doc_ids), n, bits,
        card)
    for b in range(bsz):
        words = k5_pack_mirror(mask[b], None if pmask is None else pmask[b],
                               doc_ids, n)
        docs = np.arange(n) if doc_ids is None else doc_ids
        ok = (docs >= 0) & (mask[b][np.where(docs >= 0, docs, 0)] != 0)
        if pmask is not None:
            ok &= pmask[b][np.where(docs >= 0, docs, 0)] != 0
        want = np.asarray(jengine._pack_bits(jnp.asarray(ok)))
        np.testing.assert_array_equal(words, want)
        inter = words[None, :] & bits.numpy().view(np.uint32)
        got = np.unpackbits(inter.view(np.uint8)).reshape(card, -1).sum(1)
        np.testing.assert_array_equal(got, want_counts[b].numpy())


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
