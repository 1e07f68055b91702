"""Binned reductions of the aggregation engine: the popcount counter (K5,
`binned_popcount`), the CSR reducer (K6, `binned_reduce`) and the
per-query-bin reducer (K24, `binned_scatter`, at the end), each a CUDA
kernel with its plain PyTorch version, plus the static layouts K5 and K6
read.

Both reduce per-lane contributions into bins whose lane assignment is
static for an aggregation plan and a segment (`bin_lanes`: int32 [n], a
lane outside [0, total) belongs to no bin), while the contribution's
eligibility is dynamic per query: lane l of query b counts when
mask[b][doc(l)] (and pmask[b][doc(l)]) holds, with doc(l) = doc_ids[l] on a
pairs layout and l itself on the identity and doc-space layouts. The static
side is built once per (plan, segment):

- `lane_bits`: the bin bitmasks int32 [total, n/32] of the popcount route
  (bit j of word w = lane 32w + j, the reference's `_pack_bits` order);
- `BinCSR`: the binned lanes grouped by bin, in lane order inside a bin,
  cut into chunks of at most CSR_CHUNK lanes that never cross a bin.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch

from opensearch_tpu_torch.ops import _build

CSR_CHUNK = 256          # lanes per K6 chunk (one warp's share)
ORDERED_COLUMNS = 4      # K6's per-lane columns kept in CSR order a CSR
PACK_DOCS_PER_LANE = 32  # K6 packs the mask where Dp <= 32 x the CSR's lanes
POPCOUNT_MAX_CARD = 12288  # K5's shared bin counters: 48 KB
NEEDS_BITS = {"cnt": 1, "sum": 2, "sumsq": 4, "min": 8, "max": 16}
POS_INF = float("inf")
NEG_INF = float("-inf")


# ------------------------------------------------------------ static side

def lane_bits(bin_lanes: torch.Tensor, total: int) -> torch.Tensor:
    """Per-bin lane bitmasks of a static lane->bin map: int32 [total, n/32]
    holding the u32 bit patterns. Distinct lanes of one word set distinct
    bits, so an integer add is an OR."""
    n = bin_lanes.shape[0]
    nw = n // 32
    dev = bin_lanes.device
    lanes = torch.arange(n, device=dev)
    ok = (bin_lanes >= 0) & (bin_lanes < total)
    sel = lanes[ok]
    idx = bin_lanes[ok].long() * nw + sel // 32
    words = torch.zeros(total * nw, dtype=torch.int64, device=dev)
    words.index_add_(0, idx, torch.ones_like(sel) << (sel % 32))
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).reshape(total, nw)


@dataclass
class BinCSR:
    """The binned lanes of a static lane->bin map grouped by bin."""
    total: int
    lane_order: torch.Tensor    # int32 [nnz] lanes, by bin, lane order kept
    sorted_bins: torch.Tensor   # int32 [nnz] the bin of each of those lanes
    chunk_start: torch.Tensor   # int32 [nch + 1] offsets into lane_order
    bin_chunk: torch.Tensor     # int32 [total + 1] first chunk of each bin
    max_bin_chunks: int         # the chunks of the bin that has the most
    # per-lane columns gathered into CSR order, by the source's identity,
    # and the chunks' order (K6's copies, kept beside the CSR)
    _ordered: Dict[int, tuple] = field(default_factory=dict, repr=False,
                                       compare=False)
    _chunk_order: Optional[torch.Tensor] = field(default=None, repr=False,
                                                 compare=False)

    @property
    def n_chunks(self) -> int:
        return self.chunk_start.shape[0] - 1

    def in_order(self, column: torch.Tensor) -> torch.Tensor:
        """column[lane_order] (a per-lane column: doc ids or values),
        gathered once per (CSR, column) and kept beside the CSR, so that
        K6's folds read it coalesced. The entry holds its source, so an id
        is never reused while its copy lives."""
        hit = self._ordered.get(id(column))
        if hit is not None and hit[0] is column:
            return hit[1]
        if len(self._ordered) >= ORDERED_COLUMNS:
            self._ordered.clear()
        ordered = column[self.lane_order.long()].contiguous()
        self._ordered[id(column)] = (column, ordered)
        return ordered

    def chunk_order(self) -> torch.Tensor:
        """The chunks by their first lane (int32 [nch]): K6 visits them so,
        and the bins' chunks in flight then cover one window of docs."""
        if self._chunk_order is None:
            first = self.lane_order[self.chunk_start[:-1].long()]
            self._chunk_order = torch.sort(first, stable=True)[1].to(
                torch.int32).contiguous()
        return self._chunk_order

    def ordered_bytes(self) -> int:
        """Device bytes of K6's copies kept beside the CSR."""
        kept = [o for _c, o in self._ordered.values()]
        if self._chunk_order is not None:
            kept.append(self._chunk_order)
        return sum(o.numel() * o.element_size() for o in kept)


def bin_csr(bin_lanes: torch.Tensor, total: int,
            chunk: int = CSR_CHUNK) -> BinCSR:
    """Group the lanes of bin_lanes (int32 [n]) by bin with a stable sort
    and cut each bin's run into chunks of at most `chunk` lanes."""
    dev = bin_lanes.device
    ok = (bin_lanes >= 0) & (bin_lanes < total)
    lanes = ok.nonzero(as_tuple=True)[0]
    bins = bin_lanes[lanes].long()
    bins, order = torch.sort(bins, stable=True)
    lane_order = lanes[order]
    counts = torch.bincount(bins, minlength=total)[:total]
    per_bin = (counts + chunk - 1) // chunk
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    bin_chunk = torch.cat([zero, torch.cumsum(per_bin, 0)])
    bin_start = torch.cat([zero, torch.cumsum(counts, 0)])[:-1]
    nch, most = (int(x) for x in torch.stack([
        bin_chunk[-1], per_bin.max() if total else zero[0]]).tolist())
    chunk_bin = torch.repeat_interleave(
        torch.arange(total, device=dev), per_bin, output_size=nch)
    j = torch.arange(nch, device=dev)
    starts = bin_start[chunk_bin] + (j - bin_chunk[chunk_bin]) * chunk
    chunk_start = torch.cat([starts, torch.full(
        (1,), lane_order.shape[0], dtype=torch.int64, device=dev)])
    return BinCSR(total, lane_order.to(torch.int32).contiguous(),
                  bins.to(torch.int32),
                  chunk_start.to(torch.int32).contiguous(),
                  bin_chunk.to(torch.int32).contiguous(), most)


# ----------------------------------------------------------------- K5 -------

def pack_bits(ok: torch.Tensor) -> torch.Tensor:
    """bool [B, n] -> int64 [B, n/32] words, bit j of word w = lane
    32w + j."""
    bsz, n = ok.shape
    shifts = torch.arange(32, device=ok.device, dtype=torch.int64)
    return (ok.reshape(bsz, n // 32, 32).to(torch.int64) << shifts).sum(-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32) held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _gather_ok(mask, pmask, doc_ids, n: int):
    """The dynamic eligibility of n lanes, bool [B, n]."""
    d_pad = mask.shape[1]
    docs = torch.arange(n, device=mask.device) if doc_ids is None \
        else doc_ids.long()
    valid = (docs >= 0) & (docs < d_pad)
    safe = torch.where(valid, docs, 0)
    ok = mask[:, safe] & valid
    if pmask is not None:
        ok = ok & pmask[:, safe]
    return ok


def binned_popcount_plain(mask, pmask, doc_ids, n: int, binbits, card: int):
    """Plain version of K5: counts[b][bin] = sum over words w of
    popcount(pack(ok[b])[w] & binbits[bin][w]). Returns int32 [B, card]."""
    words = pack_bits(_gather_ok(mask, pmask, doc_ids, n))
    bits = binbits.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty(mask.shape[0], card, dtype=torch.int32,
                      device=mask.device)
    for b in range(card):
        out[:, b] = popcount32(words & bits[b]).sum(1).to(torch.int32)
    return out


def binned_popcount(mask, pmask, doc_ids, n: int, binbits, card: int):
    """K5: per-bin counts of each query's eligible lanes. Replaces
    opensearch_tpu/search/aggs/engine.py:_pack_bits + the popcount route of
    _binned_sums and the fused bucket_bits / presence_bits kinds.

    mask / pmask bool [B, Dp] (pmask may be None); doc_ids int32 [n] or
    None (lane k is doc k); n % 32 == 0; binbits int32 [card, n/32] (u32
    bit patterns). Returns int32 [B, card]."""
    if not mask.is_cuda:
        return binned_popcount_plain(mask, pmask, doc_ids, n, binbits, card)
    dev = mask.device
    bsz, d_pad = mask.shape
    if n % 32 or n <= 0:
        raise ValueError(f"binned_popcount takes a positive lane count that "
                         f"is a multiple of 32, got {n}")
    if not 0 < card <= POPCOUNT_MAX_CARD:
        raise ValueError(f"binned_popcount takes 1..{POPCOUNT_MAX_CARD} "
                         f"bins, got {card}")
    _require(mask, torch.bool, (bsz, d_pad), dev, "mask")
    if pmask is not None:
        _require(pmask, torch.bool, (bsz, d_pad), dev, "pmask")
    if doc_ids is None:
        if n > d_pad:
            raise ValueError(f"identity lanes exceed Dp: {n} > {d_pad}")
    else:
        _require(doc_ids, torch.int32, (n,), dev, "doc_ids")
    _require(binbits, torch.int32, (card, n // 32), dev, "binbits")
    out = torch.empty(bsz, card, dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(0)
    fn = _build.entry("binned_popcount", [ctypes.c_void_p] * 2
                      + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p])
    code = fn(_build.ptr(mask), null if pmask is None else _build.ptr(pmask),
              d_pad, null if doc_ids is None else _build.ptr(doc_ids), n,
              _build.ptr(binbits), card, bsz, _build.ptr(out),
              _build.stream_of(dev))
    _build.LAUNCHES["binned_popcount"] += 1
    _build.check("binned_popcount", code)
    return out


# ----------------------------------------------------------------- K6 -------

def chunked_sum(csr: BinCSR, contrib: torch.Tensor) -> torch.Tensor:
    """Per-bin f32 sums of contrib [B, nnz] (in lane_order) in K6's two
    levels: one sum per CSR chunk of at most CSR_CHUNK lanes, then each
    bin's chunk partials in chunk order. The rounding error then grows
    with the chunk and the chunk count, not with a bin's whole length."""
    bsz = contrib.shape[0]
    dev = contrib.device
    starts = csr.chunk_start.long()
    nch = csr.n_chunks
    chunk_of = torch.repeat_interleave(
        torch.arange(nch, device=dev), starts[1:] - starts[:-1],
        output_size=contrib.shape[1])
    partial = torch.zeros(bsz, nch, dtype=torch.float32, device=dev) \
        .scatter_add_(1, chunk_of.expand(bsz, -1), contrib)
    chunk_bin = torch.repeat_interleave(
        torch.arange(csr.total, device=dev),
        (csr.bin_chunk[1:] - csr.bin_chunk[:-1]).long(), output_size=nch)
    return torch.zeros(bsz, csr.total, dtype=torch.float32, device=dev) \
        .scatter_add_(1, chunk_bin.expand(bsz, -1), partial)


def binned_reduce_plain(csr: BinCSR, mask, pmask, doc_ids, values,
                        cval: float, needs: Sequence[str], bsz: int
                        ) -> Dict[str, torch.Tensor]:
    """Plain version of K6: the same per-bin statistics by scatter_add_
    and scatter_reduce_ over the CSR's lanes, the sums in K6's two levels
    (`chunked_sum`) (empty bins: count 0, sums 0, min +inf, max -inf)."""
    dev = csr.lane_order.device
    lanes = csr.lane_order.long()
    bins = csr.sorted_bins.long().expand(bsz, -1)
    total = csr.total
    if mask is None:
        ok = torch.ones(bsz, lanes.shape[0], dtype=torch.bool, device=dev)
    else:
        docs = csr.lane_order if doc_ids is None else doc_ids[lanes]
        ok = _gather_ok(mask, pmask, docs, lanes.shape[0])
    v = values[lanes] if values is not None else torch.full(
        (lanes.shape[0],), cval, dtype=torch.float32, device=dev)
    v = v.expand(bsz, -1)
    out: Dict[str, torch.Tensor] = {}
    if "cnt" in needs:
        out["cnt"] = torch.zeros(bsz, total, dtype=torch.int32,
                                 device=dev).scatter_add_(
            1, bins, ok.to(torch.int32))
    if "sum" in needs:
        out["sum"] = chunked_sum(csr, torch.where(ok, v, 0.0))
    if "sumsq" in needs:
        out["sumsq"] = chunked_sum(csr, torch.where(ok, v * v, 0.0))
    if "min" in needs:
        out["min"] = torch.full((bsz, total), POS_INF, device=dev) \
            .scatter_reduce_(1, bins, torch.where(ok, v, POS_INF), "amin")
    if "max" in needs:
        out["max"] = torch.full((bsz, total), NEG_INF, device=dev) \
            .scatter_reduce_(1, bins, torch.where(ok, v, NEG_INF), "amax")
    return out


def k6_packs(nnz: int, d_pad: int) -> bool:
    """Whether K6 packs the mask for a CSR of nnz lanes over Dp docs: where
    the lanes are dense enough that a 32-byte sector a lane would read
    the whole mask anyway; sparser fields read the lanes' mask bytes."""
    return d_pad <= PACK_DOCS_PER_LANE * nnz


def binned_reduce(csr: BinCSR, mask, pmask, doc_ids, values, cval: float,
                  needs: Sequence[str], bsz: int) -> Dict[str, torch.Tensor]:
    """K6: per-bin count / sum / sumsq / min / max of each query's eligible
    lanes over a static CSR. Replaces the one-hot GEMM and scatter routes
    of opensearch_tpu/search/aggs/engine.py:_binned_sums, the metric kinds'
    min / max scatters and the bucket kinds' child-bin scatter-max.

    mask / pmask bool [B, Dp] or None (mask None: every lane counts, one
    query); doc_ids int32 [n] or None (lane k is doc k); values f32 [n] or
    None (every lane contributes cval). Returns {need: [B, total]} with
    int32 counts and f32 statistics."""
    dev = csr.lane_order.device
    if dev.type != "cuda":
        return binned_reduce_plain(csr, mask, pmask, doc_ids, values, cval,
                                   needs, bsz)
    unknown = set(needs) - set(NEEDS_BITS)
    if unknown:
        raise ValueError(f"binned_reduce computes {sorted(NEEDS_BITS)}, "
                         f"got {sorted(unknown)}")
    total = csr.total
    nch = csr.n_chunks
    d_pad = 0
    if mask is not None:
        d_pad = mask.shape[1]
        _require(mask, torch.bool, (bsz, d_pad), dev, "mask")
        if pmask is not None:
            _require(pmask, torch.bool, (bsz, d_pad), dev, "pmask")
    elif pmask is not None or bsz != 1:
        raise ValueError("binned_reduce without a mask takes one query and "
                         "no pmask")
    else:
        d_pad = 1 << 30     # no mask: doc ids only need to be >= 0
    if doc_ids is not None:
        _require(doc_ids, torch.int32, (doc_ids.shape[0],), dev, "doc_ids")
    if values is not None:
        _require(values, torch.float32, (values.shape[0],), dev, "values")
    _require(csr.lane_order, torch.int32, (csr.lane_order.shape[0],), dev,
             "lane_order")
    _require(csr.chunk_start, torch.int32, (nch + 1,), dev, "chunk_start")
    _require(csr.bin_chunk, torch.int32, (total + 1,), dev, "bin_chunk")
    bits = 0
    out: Dict[str, torch.Tensor] = {}
    for name in needs:
        bits |= NEEDS_BITS[name]
        out[name] = torch.empty(bsz, total, device=dev,
                                dtype=torch.int32 if name == "cnt"
                                else torch.float32)
    scratch = torch.empty(5 * max(bsz * nch, 1), dtype=torch.int32,
                          device=dev)
    null = ctypes.c_void_p(0)
    # with a mask: the lanes' doc ids and values in CSR order and the
    # chunks' order (kept beside the CSR), and the packed mask words where
    # k6_packs (else the folds read the lanes' mask bytes)
    n_words, vec = 0, 0
    docs_ord = vals_ord = order = words = None
    if mask is not None:
        docs_ord = csr.lane_order if doc_ids is None \
            else csr.in_order(doc_ids)
        vals_ord = None if values is None else csr.in_order(values)
        order = csr.chunk_order()
        if k6_packs(csr.lane_order.shape[0], d_pad):
            n_words = -(-d_pad // 32)
            words = torch.empty(bsz, n_words, dtype=torch.int32, device=dev)
        vec = int(d_pad % 16 == 0 and mask.data_ptr() % 16 == 0 and (
            pmask is None or pmask.data_ptr() % 16 == 0))

    def p(name):
        return _build.ptr(out[name]) if name in out else null

    def opt(t):
        return null if t is None else _build.ptr(t)
    fn = _build.entry("binned_reduce", [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 10
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    code = fn(_build.ptr(csr.lane_order), csr.lane_order.shape[0],
              _build.ptr(csr.chunk_start), nch,
              _build.ptr(csr.bin_chunk), total, opt(mask), opt(pmask),
              d_pad, opt(doc_ids), opt(values), float(cval),
              bits, bsz, _build.ptr(scratch), p("cnt"), p("sum"),
              p("sumsq"), p("min"), p("max"), opt(docs_ord), opt(vals_ord),
              opt(order), opt(words), n_words, vec, _build.stream_of(dev))
    _build.LAUNCHES["binned_reduce"] += 1
    _build.check("binned_reduce", code)
    return out


def _require(t: torch.Tensor, dtype, shape, device, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"[{what}] must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


# ----------------------------------------------------------------- K24 ------
#
# The dynamic-bin route: bins that are per query (under a `nested` or
# `reverse_nested` aggregation, and geo_bounds / geo_centroid) take part in
# no static CSR. Counts, min and max are order-free; a sum takes the fixed
# two-level order of K6 over each query's lanes sorted by (bin, lane): one
# partial per chunk of CSR_CHUNK lanes of a bin's run, then the bin's
# partials in chunk order, each level summed from 0 one addition at a time.

def _dyn_runs(lanes: torch.Tensor, total: int):
    """Each query's binned lanes sorted by (bin, lane): (bins long [B, n]
    sorted, total for a dropped lane; their lanes long [B, n]; the count
    of each bin long [B, total])."""
    bsz, n = lanes.shape
    ok = (lanes >= 0) & (lanes < total)
    bins = torch.where(ok, lanes.long(), total)
    key = bins * n + torch.arange(n, device=lanes.device)
    key, order = torch.sort(key, dim=1)
    counts = torch.zeros(bsz, total + 1, dtype=torch.int64,
                         device=lanes.device).scatter_add_(
        1, bins, torch.ones_like(bins))[:, :total]
    return key // n, order, counts


def dynamic_sum_plain(lanes: torch.Tensor, total: int,
                      contrib: torch.Tensor) -> torch.Tensor:
    """Per-bin f32 sums of contrib [B, n] (or [n], the same for every
    query) in K24's order: for each query, the lanes of a bin in lane order
    cut into chunks of CSR_CHUNK, each chunk summed from 0, then the
    chunks summed from 0 in order. Returns f32 [B, total]."""
    bsz, n = lanes.shape
    dev = lanes.device
    _, order, counts = _dyn_runs(lanes, total)
    if contrib.dim() == 1:
        contrib = contrib[None, :].expand(bsz, -1)
    vals = torch.gather(contrib, 1, order)
    chunks = (counts + CSR_CHUNK - 1) // CSR_CHUNK          # [B, total]
    chunk_base = torch.cumsum(chunks, 1) - chunks           # first chunk
    run_start = torch.cumsum(counts, 1) - counts            # first lane
    n_chunks = int(chunks.sum(1).max()) if total else 0
    if n_chunks == 0:
        return torch.zeros(bsz, total, dtype=torch.float32, device=dev)
    # chunk c of a query: its bin, its first sorted position, its length
    c_idx = torch.arange(n_chunks, device=dev).expand(bsz, -1).contiguous()
    c_bin = torch.searchsorted(torch.cumsum(chunks, 1), c_idx,
                               right=True).clamp(max=total - 1)
    in_bin = c_idx - torch.gather(chunk_base, 1, c_bin)
    c_start = torch.gather(run_start, 1, c_bin) + in_bin * CSR_CHUNK
    c_len = (torch.gather(counts, 1, c_bin) - in_bin * CSR_CHUNK).clamp(
        0, CSR_CHUNK)
    c_len = torch.where(c_idx < chunks.sum(1, keepdim=True), c_len, 0)
    partial = torch.zeros(bsz, n_chunks, dtype=torch.float32, device=dev)
    for j in range(int(c_len.max())):
        pos = (c_start + j).clamp(max=n - 1)
        partial = partial + torch.where(j < c_len,
                                        torch.gather(vals, 1, pos), 0.0)
    out = torch.zeros(bsz, total, dtype=torch.float32, device=dev)
    for j in range(int(chunks.max())):
        idx = (chunk_base + j).clamp(max=n_chunks - 1)
        out = out + torch.where(j < chunks,
                                torch.gather(partial, 1, idx), 0.0)
    return out


def binned_scatter_plain(lanes: torch.Tensor, total: int, values,
                         needs: Sequence[str], cval: float = 0.0
                         ) -> Dict[str, torch.Tensor]:
    """Plain version of K24: counts by scatter_add_, min / max by
    scatter_reduce_, sums (`sum`, and `sumsq` of v * v) in K24's order
    (`dynamic_sum_plain`); empty bins: count 0, sums 0, min +inf, max
    -inf."""
    bsz, n = lanes.shape
    dev = lanes.device
    ok = (lanes >= 0) & (lanes < total)
    bins = torch.where(ok, lanes.long(), total)
    if values is None:
        values = torch.full((n,), cval, dtype=torch.float32, device=dev)
    v = values.expand(bsz, -1) if values.dim() == 1 else values
    out: Dict[str, torch.Tensor] = {}
    if "cnt" in needs:
        out["cnt"] = torch.zeros(bsz, total + 1, dtype=torch.int32,
                                 device=dev).scatter_add_(
            1, bins, ok.to(torch.int32))[:, :total]
    if "sum" in needs:
        out["sum"] = dynamic_sum_plain(lanes, total,
                                       torch.where(ok, v, 0.0))
    if "sumsq" in needs:
        out["sumsq"] = dynamic_sum_plain(lanes, total,
                                         torch.where(ok, v * v, 0.0))
    if "min" in needs:
        out["min"] = torch.full((bsz, total + 1), POS_INF,
                                device=dev).scatter_reduce_(
            1, bins, torch.where(ok, v, POS_INF), "amin")[:, :total]
    if "max" in needs:
        out["max"] = torch.full((bsz, total + 1), NEG_INF,
                                device=dev).scatter_reduce_(
            1, bins, torch.where(ok, v, NEG_INF), "amax")[:, :total]
    return out


SCATTER_MAX_BINS = 2048   # K24: one partition pass's buckets (11 bits)
SCATTER_DIGIT_BITS = 11   # the radix passes' digits at most
_SCAN_BLOCK = 2048


@dataclass(frozen=True)
class ScatterPlan:
    """How K24 reduces [B, n] lanes into `total` bins (static sizes only):
    passes 0 (counts, min and max: one sweep), 1 (sums: one stable
    partition by bin, total <= SCATTER_MAX_BINS) or more (sums: a stable
    LSD radix partition, `digit` bits a pass); `nb` buckets a pass, `wt`
    lanes a warp's tile, `tiles` of them a row; buffer rows of `stride`
    (n rounded up to 4); at most `max_chunks` CSR_CHUNK chunks a row."""
    passes: int
    digit: int
    nb: int
    wt: int
    tiles: int
    stride: int
    max_chunks: int


def _bits(total: int) -> int:
    return max(total - 1, 0).bit_length()


def scatter_plan(n: int, total: int, needs: Sequence[str],
                 wt: int = None) -> ScatterPlan:
    """K24's route from the static sizes. `wt` defaults to the kernel's
    warp tile (at least 2,048 lanes and 16 per bucket, so the tile counts
    stay a sixteenth of the lanes at most); any multiple of 128 gives the
    same results."""
    sums = bool({"sum", "sumsq"} & set(needs))
    if not sums:
        passes, digit, nb = 0, 0, 0
    elif total <= SCATTER_MAX_BINS:
        passes, digit, nb = 1, _bits(total), total
    else:
        bits = _bits(total)
        passes = -(-bits // SCATTER_DIGIT_BITS)
        digit = -(-bits // passes)
        nb = 1 << digit
    if wt is None:
        wt = 8192 if passes == 0 else max(
            2048, 16 * (1 << max(nb - 1, 0).bit_length()))
    if wt <= 0 or wt % 128:
        raise ValueError(f"a warp tile is a positive multiple of 128 lanes, "
                         f"got {wt}")
    return ScatterPlan(passes, digit, nb, wt, -(-n // wt), -(-n // 4) * 4,
                       -(-n // CSR_CHUNK) + min(total, n))


def _scatter_layout(plan: ScatterPlan, bsz: int, total: int,
                    needs: Sequence[str]) -> Dict[str, int]:
    """Bytes of each scratch slot of K24's plan (0: the slot is unused),
    in the scratch's order; the kernel takes each slot by its name."""
    p = plan.passes
    rows = bsz * plan.stride
    scan = 0
    if p:
        scan = max(bsz * plan.nb * -(-plan.tiles // _SCAN_BLOCK),
                   bsz * -(-(total + 1) // _SCAN_BLOCK))
    return {"tile": 4 * bsz * plan.nb * plan.tiles,
            "bcnt": 4 * bsz * plan.nb, "bstart": 4 * bsz * plan.nb,
            "rowlen": 4 * bsz if p else 0,
            "bins_a": 4 * rows if p >= 2 else 0,
            "bins_b": 4 * rows if p >= 2 else 0,
            "vals_a": 4 * rows if p else 0,
            "vals_b": 4 * rows if p >= 2 else 0,
            "rcnt": 4 * bsz * total if p >= 2 else 0,
            "rstart": 4 * bsz * total if p >= 2 else 0,
            "cbase": 4 * bsz * (total + 1) if p else 0,
            "psum": 4 * bsz * plan.max_chunks if "sum" in needs else 0,
            "psq": 4 * bsz * plan.max_chunks if "sumsq" in needs else 0,
            "scan": 4 * scan}


def _scatter_offsets(plan: ScatterPlan, bsz: int, total: int,
                     needs: Sequence[str]):
    """Each used slot's byte offset in K24's scratch (slots 256-byte
    aligned; None where unused) and the scratch's bytes."""
    layout = _scatter_layout(plan, bsz, total, needs)
    offsets, size = {}, 0
    for name, nbytes in layout.items():
        offsets[name] = size if nbytes else None
        size += -(-nbytes // 256) * 256
    return offsets, size


def scatter_scratch_bytes(bsz: int, n: int, total: int,
                          needs: Sequence[str]) -> int:
    """Device scratch bytes of one K24 call."""
    return _scatter_offsets(scatter_plan(n, total, needs), bsz, total,
                            needs)[1]


def binned_scatter(lanes: torch.Tensor, total: int, values,
                   needs: Sequence[str], cval: float = 0.0
                   ) -> Dict[str, torch.Tensor]:
    """K24: per-query binned count / sum / sumsq / min / max. lanes int32
    [B, n]: each query's bin per lane (outside [0, total): dropped, so the
    eligibility folds into the bin); values f32 [n] (shared) or [B, n], or
    None (every lane contributes cval). Returns {need: [B, total]} with
    int32 counts and f32 statistics. Replaces the scatter route of
    opensearch_tpu/search/aggs/engine.py:_binned_sums (:1157-1167) under a
    dynamic context and the geo_metric scatters (:1675-1700)."""
    if not lanes.is_cuda:
        return binned_scatter_plain(lanes, total, values, needs, cval)
    unknown = set(needs) - set(NEEDS_BITS)
    if unknown:
        raise ValueError(f"binned_scatter computes {sorted(NEEDS_BITS)}, "
                         f"got {sorted(unknown)}")
    dev = lanes.device
    bsz, n = lanes.shape
    if total <= 0 or total > 1 << 24 or n <= 0 or n >= 1 << 30 \
            or not 0 < bsz < 65536:
        raise ValueError(f"binned_scatter takes 1..2^30 lanes, 1..2^24 bins "
                         f"and 1..65,535 queries, got n={n}, total={total}, "
                         f"B={bsz}")
    _require(lanes, torch.int32, (bsz, n), dev, "lanes")
    per_query = 0
    if values is not None:
        per_query = int(values.dim() == 2)
        _require(values, torch.float32, (bsz, n) if per_query else (n,),
                 dev, "values")
    bits = 0
    out: Dict[str, torch.Tensor] = {}
    for name in needs:
        bits |= NEEDS_BITS[name]
        out[name] = torch.empty(bsz, total, device=dev,
                                dtype=torch.int32 if name == "cnt"
                                else torch.float32)
    plan = scatter_plan(n, total, needs)
    offsets, size = _scatter_offsets(plan, bsz, total, needs)
    scratch = torch.empty(max(size, 1), dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()

    def at(slot):
        return None if offsets[slot] is None else base + offsets[slot]
    vec = int(n % 4 == 0 and lanes.data_ptr() % 16 == 0
              and (values is None or values.data_ptr() % 16 == 0))
    null = ctypes.c_void_p(0)

    def p(name):
        return _build.ptr(out[name]) if name in out else null
    fn = _build.entry("binned_scatter", [ctypes.c_void_p] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                      + [ctypes.c_int] * 8
                      + [ctypes.c_void_p] * (len(offsets) + 6))
    code = fn(_build.ptr(lanes), bsz, n, total,
              null if values is None else _build.ptr(values), per_query,
              float(cval), bits, plan.passes, plan.digit, plan.wt,
              plan.tiles, plan.stride, plan.max_chunks, vec,
              at("tile"), at("bcnt"), at("bstart"), at("rowlen"),
              at("bins_a"), at("bins_b"), at("vals_a"), at("vals_b"),
              at("rcnt"), at("rstart"), at("cbase"), at("psum"), at("psq"),
              at("scan"), p("cnt"), p("sum"), p("sumsq"), p("min"),
              p("max"), _build.stream_of(dev))
    _build.LAUNCHES["binned_scatter"] += 1
    _build.check("binned_scatter", code)
    return out
