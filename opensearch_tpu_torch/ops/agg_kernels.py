"""Kernels of the remaining aggregation kinds, each a CUDA kernel with its
plain PyTorch version beside its wrapper:

- K15 `dense_numeric`: a numeric field's dense per-doc column (the
  smallest value, the count of values) from its (doc, value) pairs;
- K16 `matrix_moments`: the partial sums of `matrix_stats` per parent bin
  over a static doc CSR (K6's layout, ops/binned.py:bin_csr);
- K17 `adjacency_counts`: the cell counts of `adjacency_matrix` per
  parent bin.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.binned import (BinCSR, _require, bin_csr,
                                             chunked_sum)

# K17's filters a launch; more filters take one launch per pair of blocks
# of half as many
ADJACENCY_MAX_FILTERS = 32
# K16's CSR chunk: 64 docs a thread before a warp folds its partials (K6's
# 256 would fold 8x as often, and the folds set K16's time)
MOMENTS_CHUNK = 2048
# K16's pass 2 folds a bin's chunk partials with one block of eight warps
# where the largest bin has more chunks than this, else with one warp
MOMENTS_BLOCK_CHUNKS = 256


# ----------------------------------------------------------------- K15 ------

def dense_numeric_plain(doc_ids: torch.Tensor, values: torch.Tensor,
                        d_pad: int, missing: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K15: the per-doc minimum by scatter_reduce_ and the
    per-doc count by scatter_add_ (padding pairs land in a dropped extra
    lane)."""
    dev = doc_ids.device
    valid = doc_ids >= 0
    idx = torch.where(valid, doc_ids, d_pad).long()
    dense = torch.full((d_pad + 1,), float("inf"), dtype=torch.float32,
                       device=dev).scatter_reduce_(
        0, idx, torch.where(valid, values, float("inf")), "amin")[:d_pad]
    value = torch.where(torch.isfinite(dense), dense,
                        torch.tensor(missing, dtype=torch.float32,
                                     device=dev))
    counts = torch.zeros(d_pad + 1, dtype=torch.int32, device=dev) \
        .scatter_add_(0, idx, valid.to(torch.int32))[:d_pad]
    return value, counts


def dense_numeric(doc_ids: torch.Tensor, values: torch.Tensor, d_pad: int,
                  missing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15: (value f32 [Dp], counts int32 [Dp]) of a numeric column's pairs
    `doc_ids` int32 [NVp] (grouped by doc ascending, -1 padding) and
    `values` f32 [NVp]: each doc's smallest value (`missing` where it has
    none) and its number of values. Replaces
    opensearch_tpu/search/plan_eval.py:dense_numeric."""
    if not doc_ids.is_cuda:
        return dense_numeric_plain(doc_ids, values, d_pad, missing)
    dev = doc_ids.device
    nv = doc_ids.shape[0]
    _require(doc_ids, torch.int32, (nv,), dev, "doc_ids")
    _require(values, torch.float32, (nv,), dev, "values")
    value = torch.empty(d_pad, dtype=torch.float32, device=dev)
    counts = torch.empty(d_pad, dtype=torch.int32, device=dev)
    fn = _build.entry("dense_numeric", [ctypes.c_void_p] * 2
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                      + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(doc_ids), _build.ptr(values), nv, d_pad,
              float(missing), _build.ptr(value), _build.ptr(counts),
              _build.stream_of(dev))
    _build.LAUNCHES["dense_numeric"] += 1
    _build.check("dense_numeric", code)
    return value, counts


# ----------------------------------------------------------------- K16 ------

def moment_groups(n_fields: int) -> List[Tuple[int, int]]:
    """K16's term groups: (f, f) for each field, then (a, b) for each pair
    a < b, in the reference's order."""
    return [(f, f) for f in range(n_fields)] + [
        (a, b) for a in range(n_fields) for b in range(a + 1, n_fields)]


def moments_csr(bin_lanes: torch.Tensor, total: int) -> BinCSR:
    """The doc CSR of K16: the parent bins' docs in chunks of at most
    MOMENTS_CHUNK."""
    return bin_csr(bin_lanes, total, chunk=MOMENTS_CHUNK)


def moments_block_fold(csr: BinCSR) -> bool:
    """Whether K16's pass 2 folds a bin by block (else by warp): where the
    largest bin has more than MOMENTS_BLOCK_CHUNKS chunks."""
    return csr.max_bin_chunks > MOMENTS_BLOCK_CHUNKS


def moments_sum_depth(chunk: int, max_bin_chunks: int, block: bool) -> int:
    """The most f32 additions on the path of any term into one of K16's
    sums over a CSR of chunks of at most `chunk` docs: pass 1's every 32nd
    doc of a chunk and the warp's 5 shuffle levels, then pass 2's every
    32nd chunk of a bin (every 256th by block), 5 levels and, by block, the
    7 other warps' results in turn. Each sum then lies within depth *
    2^-24 * sum|term| of the exact sum of its f32 terms."""
    step = 256 if block else 32
    return (-(-chunk // 32) + 5 + -(-max_bin_chunks // step) + 5
            + (7 if block else 0))


def matrix_moments_plain(csr: BinCSR, mask, pmask, vals: torch.Tensor,
                         exists: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K16: the same terms per doc, counted by
    scatter_add_ and summed in K6's two levels (binned.chunked_sum: one sum
    per CSR chunk, then the chunk partials of a bin in order). Returns
    (cnt int32 [G, B, total], sum f32 [4, G, B, total])."""
    bsz = mask.shape[0]
    n_fields = vals.shape[0]
    groups = moment_groups(n_fields)
    docs = csr.lane_order.long()
    ok = mask[:, docs]
    if pmask is not None:
        ok = ok & pmask[:, docs]
    v = vals[:, docs]
    e = exists[:, docs]
    bins = csr.sorted_bins.long().expand(bsz, -1)
    cnts, sums = [], []
    for fa, fb in groups:
        own = ok & e[fa] & e[fb]
        x = torch.where(own, v[fa], 0.0)
        cnts.append(torch.zeros(bsz, csr.total, dtype=torch.int32,
                                device=mask.device).scatter_add_(
            1, bins, own.to(torch.int32)))
        if fa == fb:
            x2 = x * x
            terms = (x, x2, x2 * x, x2 * x2)
        else:
            y = torch.where(own, v[fb], 0.0)
            terms = (x * y, x, y, torch.zeros_like(x))
        sums.append(torch.stack([chunked_sum(csr, t) for t in terms]))
    return torch.stack(cnts), torch.stack(sums, dim=1)


def matrix_moments(csr: BinCSR, mask, pmask, vals: torch.Tensor,
                   exists: torch.Tensor, block: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16: for B queries (mask / pmask bool [B, Dp], pmask may be None)
    and F dense fields (vals f32 [F, Dp], exists bool [F, Dp]), per parent
    bin of the doc CSR `csr`: (cnt int32 [G, B, total], sum f32 [4, G, B,
    total]) over the groups of moment_groups(F); a field's sums are v, v^2,
    v^3, v^4, a pair's a*b, a, b and 0. `block` picks pass 2's fold (None:
    moments_block_fold). Replaces the matrix_stats kind of
    opensearch_tpu/search/aggs/engine.py:_eval_agg."""
    dev = csr.lane_order.device
    if dev.type != "cuda":
        return matrix_moments_plain(csr, mask, pmask, vals, exists)
    bsz, d_pad = mask.shape
    n_fields = vals.shape[0]
    n_groups = len(moment_groups(n_fields))
    total, nch = csr.total, csr.n_chunks
    _require(mask, torch.bool, (bsz, d_pad), dev, "mask")
    if pmask is not None:
        _require(pmask, torch.bool, (bsz, d_pad), dev, "pmask")
    _require(vals, torch.float32, (n_fields, d_pad), dev, "vals")
    _require(exists, torch.bool, (n_fields, d_pad), dev, "exists")
    _require(csr.lane_order, torch.int32, (csr.lane_order.shape[0],), dev,
             "lane_order")
    _require(csr.chunk_start, torch.int32, (nch + 1,), dev, "chunk_start")
    _require(csr.bin_chunk, torch.int32, (total + 1,), dev, "bin_chunk")
    cnt = torch.empty(n_groups, bsz, total, dtype=torch.int32, device=dev)
    sums = torch.empty(4, n_groups, bsz, total, dtype=torch.float32,
                       device=dev)
    scratch = torch.empty(5 * max(n_groups * bsz * nch, 1),
                          dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(0)
    fn = _build.entry("matrix_moments", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    code = fn(_build.ptr(csr.lane_order), csr.lane_order.shape[0],
              _build.ptr(csr.chunk_start), nch, _build.ptr(csr.bin_chunk),
              total, _build.ptr(mask),
              null if pmask is None else _build.ptr(pmask), d_pad,
              _build.ptr(vals), _build.ptr(exists), n_fields, n_groups,
              bsz, int(moments_block_fold(csr) if block is None else block),
              _build.ptr(scratch), _build.ptr(cnt), _build.ptr(sums),
              _build.stream_of(dev))
    _build.LAUNCHES["matrix_moments"] += 1
    _build.check("matrix_moments", code)
    return cnt, sums


def matrix_stats_names(fields: Sequence[str]) -> List[Tuple[str, int, int]]:
    """The reference's partial names of K16's outputs, each with its group
    and its sum (-1: the count): `f::cnt`, `f::sum` .. `f::sum4` per
    field, `a*b::cnt` / `::sumxy` / `::sumx` / `::sumy` per pair."""
    out = []
    for g, (a, b) in enumerate(moment_groups(len(fields))):
        if a == b:
            key = fields[a]
            sums = ("sum", "sum2", "sum3", "sum4")
        else:
            key = f"{fields[a]}*{fields[b]}"
            sums = ("sumxy", "sumx", "sumy")
        out.append((f"{key}::cnt", g, -1))
        out.extend((f"{key}::{name}", g, k) for k, name in enumerate(sums))
    return out


def matrix_stats_partials(fields: Sequence[str], cnt: torch.Tensor,
                          sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K16's outputs under the reference's partial names."""
    return {name: cnt[g] if k < 0 else sums[k, g]
            for name, g, k in matrix_stats_names(fields)}


# ----------------------------------------------------------------- K17 ------

def adjacency_pairs(n: int) -> List[Tuple[int, int]]:
    """The cells (i, j), i <= j, in K17's output order."""
    return [(i, j) for i in range(n) for j in range(i, n)]


def adjacency_counts_plain(masks: Sequence[torch.Tensor], mask, pmask,
                           pbin: Optional[torch.Tensor], card: int
                           ) -> torch.Tensor:
    """Plain version of K17: each cell's docs by scatter_add_ into the
    parent bins. Returns int32 [B, n(n+1)/2, card]."""
    ok = mask if pmask is None else mask & pmask
    bsz, d_pad = ok.shape
    dev = ok.device
    if pbin is None:
        bins = torch.zeros(d_pad, dtype=torch.long, device=dev)
    else:
        ok = ok & (pbin >= 0)
        bins = torch.where(pbin >= 0, pbin, 0).long()
    f = [m & ok for m in masks]
    out = torch.zeros(bsz, len(adjacency_pairs(len(masks))), card,
                      dtype=torch.int32, device=dev)
    for p, (i, j) in enumerate(adjacency_pairs(len(masks))):
        out[:, p].scatter_add_(1, bins.expand(bsz, -1),
                               (f[i] & f[j]).to(torch.int32))
    return out


def adjacency_blocks(n: int) -> List[List[int]]:
    """The filter sets of K17's launches for n filters: all n where they fit
    one launch, else every pair of blocks of ADJACENCY_MAX_FILTERS / 2
    consecutive filters. Each pair (i, j) lies in some set: in any set
    with i's block when i and j share it (there are at least three blocks),
    else in the set of their two blocks."""
    if n <= ADJACENCY_MAX_FILTERS:
        return [list(range(n))]
    half = ADJACENCY_MAX_FILTERS // 2
    blocks = [list(range(s, min(s + half, n))) for s in range(0, n, half)]
    return [blocks[x] + blocks[y] for x in range(len(blocks))
            for y in range(x + 1, len(blocks))]


def adjacency_blocked(masks: Sequence[torch.Tensor], count) -> torch.Tensor:
    """K17's output for any number of filters from `count(masks_subset)`
    (int32 [B, m(m+1)/2, card] over a subset, in adjacency_pairs(m)
    order): one call per set of adjacency_blocks, each cell copied to its
    place among the n filters' cells."""
    n = len(masks)
    sets = adjacency_blocks(n)
    if len(sets) == 1:
        return count(list(masks))
    place = {pair: p for p, pair in enumerate(adjacency_pairs(n))}
    out = None
    for ids in sets:
        part = count([masks[i] for i in ids])
        if out is None:
            out = part.new_empty(part.shape[0], len(place), part.shape[2])
        dst = torch.tensor([place[(ids[a], ids[b])]
                            for a, b in adjacency_pairs(len(ids))],
                           device=part.device)
        out[:, dst] = part
    return out


def adjacency_counts(masks: Sequence[torch.Tensor], mask, pmask,
                     pbin: Optional[torch.Tensor], card: int
                     ) -> torch.Tensor:
    """K17: int32 [B, n(n+1)/2, card], the docs of each query (mask bool
    [B, Dp], and pmask where not None) that match filters i and j (masks:
    n bool [B, Dp]), per parent bin (pbin int32 [Dp], -1: none; None: one
    bin). Past ADJACENCY_MAX_FILTERS filters, one launch per filter set of
    adjacency_blocks. Replaces the adjacency kind of
    opensearch_tpu/search/aggs/engine.py:_eval_agg."""
    if not mask.is_cuda:
        return adjacency_counts_plain(masks, mask, pmask, pbin, card)
    dev = mask.device
    bsz, d_pad = mask.shape
    if not masks:
        raise ValueError("adjacency_counts takes at least one filter")
    if d_pad % 16:
        raise ValueError(f"adjacency_counts takes Dp % 16 == 0, got {d_pad}")
    _require(mask, torch.bool, (bsz, d_pad), dev, "mask")
    if pmask is not None:
        _require(pmask, torch.bool, (bsz, d_pad), dev, "pmask")
    for m in masks:
        _require(m, torch.bool, (bsz, d_pad), dev, "filter mask")
    if pbin is not None:
        _require(pbin, torch.int32, (d_pad,), dev, "pbin")
    fn = _build.entry("adjacency_counts", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    null = ctypes.c_void_p(0)

    def launch(sub: List[torch.Tensor]) -> torch.Tensor:
        n = len(sub)
        out = torch.empty(bsz, n * (n + 1) // 2, card, dtype=torch.int32,
                          device=dev)
        ptrs = (ctypes.c_void_p * n)(*[m.data_ptr() for m in sub])
        code = fn(ctypes.cast(ptrs, ctypes.c_void_p), n, _build.ptr(mask),
                  null if pmask is None else _build.ptr(pmask), d_pad,
                  null if pbin is None else _build.ptr(pbin), card, bsz,
                  _build.ptr(out), _build.stream_of(dev))
        _build.LAUNCHES["adjacency_counts"] += 1
        _build.check("adjacency_counts", code)
        return out
    return adjacency_blocked(masks, launch)
