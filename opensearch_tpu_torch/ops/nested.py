"""Kernels of nested documents (block joins), each a CUDA kernel with its
plain PyTorch version beside its wrapper:

- K22 `nested_join` (csrc/nested_join.cu): the `nested` query's join of
  its child plan's (scores, matches) to the root rows, in one of the
  score modes avg / sum / max / min / none, times the boost; on the card
  a CTA a tile of JOIN_TILE_ROWS roots for JOIN_QUERY_GROUP queries, the
  tile's CSR positions staged once, each query's window of child rows
  (at most JOIN_STAGE_ROWS) staged ahead, one thread a root folding in
  CSR order; a tile of more than JOIN_POS_CAP positions or with a root of
  more than JOIN_HEAVY_ROWS walks its heavy roots by the CTA, JOIN_CHUNK
  positions a step for every query;
- K23 `nested_aggs` (csrc/nested_aggs.cu), two entries: `nested_agg`
  (the `nested` aggregation: each nested row of the path whose root is in
  a bucket takes its root's bucket; the per-bucket row counts; on the
  card a CTA a tile of NESTED_TILE_ROWS rows for NESTED_QUERY_GROUP
  queries, the tile's doc blocks read once, each query's parent window
  (at most NESTED_STAGE_ROWS rows) staged ahead, counts in the CTA's
  shared counters up to NESTED_CNT_CAP buckets) and
  `reverse_nested_agg` (back to the roots: the distinct (bucket, root)
  counts and each root's bucket, the largest of its rows' buckets; on the
  card a walk of each root's rows in the static CSR below: a root of at
  most REVERSE_HEAVY_ROWS rows by one thread, its distinct buckets in a
  64-bit set up to REVERSE_BITSET_CARD buckets, else by testing each
  selected row against the root's earlier ones; a bigger root by the
  whole CTA, through a bitmap of REVERSE_BITMAP_BUCKETS buckets a window).

The segment's doc blocks: `parent_ptr` int32 [Dp] (a nested row's root
row, -1 for a root), `nested_path` int32 [Dp] (a nested row's path
ordinal) and K22's static per-root CSR (`child_start` int32 [Dp + 1],
`child_rows` int32 [NCp]: a root's nested rows in row order,
ops/device_segment.py:root_child_csr).

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.binned import _require

# K22's score modes by their code (search/compile.py NESTED_SCORE_MODES)
SCORE_MODES = ("avg", "sum", "max", "min", "none")
# K23 reverse_nested's walk (csrc/nested_aggs.cu HEAVY_ROWS, BITSET_CARD,
# BITMAP_WORDS * 32)
REVERSE_HEAVY_ROWS = 32
REVERSE_BITSET_CARD = 64
REVERSE_BITMAP_BUCKETS = 32768
# K23 nested's tile (csrc/nested_aggs.cu AGG_TILE_ROWS, AGG_STAGE_ROWS,
# AGG_QUERY_GROUP and CNT_CAP, the CTA-private counters' cap)
NESTED_TILE_ROWS = 2048
NESTED_STAGE_ROWS = 2304
NESTED_QUERY_GROUP = 32
NESTED_CNT_CAP = 4096
# K22's tile (csrc/nested_join.cu JOIN_*)
JOIN_TILE_ROWS = 2048
JOIN_STAGE_ROWS = 2304
JOIN_POS_CAP = 2304
JOIN_HEAVY_ROWS = 64
JOIN_CHUNK = 128
JOIN_QUERY_GROUP = 32
NEG_INF = float("-inf")
POS_INF = float("inf")


# ----------------------------------------------------------------- K22 ------

def _csr_ranks(child_start: torch.Tensor, child_rows: torch.Tensor,
               parent_ptr: torch.Tensor):
    """The CSR's real positions grouped by their rank inside their root's
    run: a list, per rank k, of (root rows, child rows) long tensors.
    Inside one group each root appears once, so a group's updates never
    collide."""
    nnz = int(child_start[-1])
    if nnz == 0:
        return []
    rows = child_rows[:nnz].long()
    roots = parent_ptr[rows].long()
    rank = torch.arange(nnz, device=rows.device) \
        - child_start[roots].long()
    order = torch.sort(rank, stable=True)[1]
    counts = torch.bincount(rank).tolist()
    out, at = [], 0
    for c in counts:
        pos = order[at:at + c]
        out.append((roots[pos], rows[pos]))
        at += c
    return out


def nested_join_plain(child_s: torch.Tensor, child_m: torch.Tensor,
                      live: torch.Tensor, nested_path: torch.Tensor,
                      parent_ptr: torch.Tensor, child_start: torch.Tensor,
                      child_rows: torch.Tensor, path_ord: torch.Tensor,
                      boost: torch.Tensor, mode: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K22: each root's selected nested rows (the child
    plan matches, the row is live and on the query's path) folded in row
    order from 0 (sum, and the count for avg) or from -inf / +inf (max /
    min), one rounding per addition, then where(any selected, combined *
    boost, 0)."""
    bsz, d_pad = child_s.shape
    dev = child_s.device
    on_path = (path_ord >= 0)[:, None] & (nested_path[None, :]
                                          == path_ord[:, None])
    sel = child_m & on_path & live[None, :]
    pmatch = torch.zeros(bsz, d_pad, dtype=torch.bool, device=dev)
    if mode == "none":
        for roots, rows in _csr_ranks(child_start, child_rows, parent_ptr):
            pmatch[:, roots] |= sel[:, rows]
        return torch.zeros(bsz, d_pad, dtype=torch.float32,
                           device=dev), pmatch
    init = {"max": NEG_INF, "min": POS_INF}.get(mode, 0.0)
    acc = torch.full((bsz, d_pad), init, dtype=torch.float32, device=dev)
    cnt = torch.zeros(bsz, d_pad, dtype=torch.float32, device=dev)
    for roots, rows in _csr_ranks(child_start, child_rows, parent_ptr):
        s = sel[:, rows]
        v = child_s[:, rows]
        pmatch[:, roots] |= s
        if mode == "max":
            acc[:, roots] = torch.maximum(acc[:, roots],
                                          torch.where(s, v, NEG_INF))
        elif mode == "min":
            acc[:, roots] = torch.minimum(acc[:, roots],
                                          torch.where(s, v, POS_INF))
        else:
            acc[:, roots] = acc[:, roots] + torch.where(s, v, 0.0)
            cnt[:, roots] = cnt[:, roots] + s.to(torch.float32)
    if mode == "avg":
        acc = acc / torch.clamp(cnt, min=1.0)
    return torch.where(pmatch, acc * boost[:, None], 0.0), pmatch


def nested_join(child_s: torch.Tensor, child_m: torch.Tensor, seg,
                path_ord: torch.Tensor, boost: torch.Tensor, mode: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K22: (root scores f32 [B, Dp], root matches bool [B, Dp]) of a
    nested query from its child plan's scores f32 / matches bool [B, Dp],
    the segment image `seg` (live, nested_path, parent_ptr and the child
    CSR) and per-query path_ord int32 / boost f32 [B]. Replaces
    opensearch_tpu/search/plan_eval.py:100-129."""
    if mode not in SCORE_MODES:
        raise ValueError(f"nested_join score modes are {SCORE_MODES}, got "
                         f"[{mode}]")
    if not child_s.is_cuda:
        return nested_join_plain(child_s, child_m, seg["live"],
                                 seg["nested_path"], seg["parent_ptr"],
                                 seg["child_start"], seg["child_rows"],
                                 path_ord, boost, mode)
    dev = child_s.device
    bsz, d_pad = child_s.shape
    _require(child_s, torch.float32, (bsz, d_pad), dev, "child_s")
    _require(child_m, torch.bool, (bsz, d_pad), dev, "child_m")
    for key, dtype, shape in (("live", torch.bool, (d_pad,)),
                              ("nested_path", torch.int32, (d_pad,)),
                              ("child_start", torch.int32, (d_pad + 1,))):
        _require(seg[key], dtype, shape, dev, key)
    rows = seg["child_rows"]
    _require(rows, torch.int32, (rows.shape[0],), dev, "child_rows")
    _require(path_ord, torch.int32, (bsz,), dev, "path_ord")
    _require(boost, torch.float32, (bsz,), dev, "boost")
    out_s = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    out_m = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    fn = _build.entry("nested_join", [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    code = fn(_build.ptr(child_s), _build.ptr(child_m),
              _build.ptr(seg["live"]), _build.ptr(seg["nested_path"]),
              _build.ptr(seg["child_start"]), _build.ptr(rows),
              _build.ptr(path_ord), SCORE_MODES.index(mode), bsz, d_pad,
              _build.ptr(boost), _build.ptr(out_s), _build.ptr(out_m),
              _build.stream_of(dev))
    _build.LAUNCHES["nested_join"] += 1
    _build.check("nested_join", code)
    return out_s, out_m


# ----------------------------------------------------------------- K23 ------

def nested_agg_plain(mask: torch.Tensor, parent_eff: torch.Tensor,
                     live: torch.Tensor, nested_path: torch.Tensor,
                     parent_ptr: torch.Tensor, path_ord: torch.Tensor,
                     card: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K23's nested entry: (own bool [B, Dp]: the
    path's live nested rows whose root is eligible and in a bucket;
    child_eff int32 [B, Dp]: the root's bucket there, -1 elsewhere;
    counts int32 [B, card])."""
    bsz, d_pad = mask.shape
    dev = mask.device
    safe_p = torch.where(parent_ptr >= 0, parent_ptr, 0).long()
    peff = parent_eff[:, safe_p]
    own = ((nested_path[None, :] == path_ord[:, None])
           & (path_ord >= 0)[:, None] & (live & (parent_ptr >= 0))[None, :]
           & mask[:, safe_p] & (peff >= 0))
    child_eff = torch.where(own, peff, -1).to(torch.int32)
    counts = torch.zeros(bsz, card + 1, dtype=torch.int32, device=dev) \
        .scatter_add_(1, torch.where(own, peff, card).long(),
                      own.to(torch.int32))[:, :card]
    return own, child_eff, counts


def nested_agg(mask: torch.Tensor, parent_eff: torch.Tensor, seg,
               path_ord: torch.Tensor, card: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K23 nested: from the eligible rows mask bool [B, Dp], their bucket
    parent_eff int32 [B, Dp] (-1: none), the image's doc blocks and
    per-query path_ord int32 [B]: (own, child_eff, counts), as
    nested_agg_plain. Replaces opensearch_tpu/search/aggs/engine.py:
    1559-1577."""
    if not mask.is_cuda:
        return nested_agg_plain(mask, parent_eff, seg["live"],
                                seg["nested_path"], seg["parent_ptr"],
                                path_ord, card)
    dev = mask.device
    bsz, d_pad = mask.shape
    _check_agg_inputs(mask, parent_eff, seg, card, dev)
    _require(path_ord, torch.int32, (bsz,), dev, "path_ord")
    own = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    child_eff = torch.empty(bsz, d_pad, dtype=torch.int32, device=dev)
    counts = torch.zeros(bsz, card, dtype=torch.int32, device=dev)
    fn = _build.entry("nested_agg", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
                      lib="nested_aggs")
    code = fn(_build.ptr(mask), _build.ptr(parent_eff),
              _build.ptr(seg["live"]), _build.ptr(seg["nested_path"]),
              _build.ptr(seg["parent_ptr"]), _build.ptr(path_ord), bsz,
              d_pad, card, _build.ptr(own), _build.ptr(child_eff),
              _build.ptr(counts), _build.stream_of(dev))
    _build.LAUNCHES["nested_agg"] += 1
    _build.check("nested_agg", code, lib="nested_aggs")
    return own, child_eff, counts


def reverse_nested_agg_plain(mask: torch.Tensor, parent_eff: torch.Tensor,
                             parent_ptr: torch.Tensor, card: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of K23's reverse_nested entry: over the selected
    nested rows (eligible, in a bucket), (own bool [B, Dp]: the roots that
    take a bucket; root_eff int32 [B, Dp]: the largest bucket of a root's
    selected rows, -1 for none; counts int32 [B, card]: the distinct roots
    per bucket, from the sorted (bucket, root) keys' run starts).
    parent_eff holds -1 (no bucket) or a bucket in [0, card)."""
    bsz, d_pad = mask.shape
    dev = mask.device
    sel = mask & (parent_eff >= 0) & (parent_ptr >= 0)[None, :]
    pptr = parent_ptr.long()[None, :].expand(bsz, -1)
    root_eff = torch.full((bsz, d_pad + 1), -1, dtype=torch.int32,
                          device=dev).scatter_reduce_(
        1, torch.where(sel, pptr, d_pad),
        torch.where(sel, parent_eff, -1).to(torch.int32),
        "amax")[:, :d_pad]
    key = torch.where(sel, parent_eff.long() * d_pad + pptr, -1)
    key = torch.sort(key, dim=1, descending=True)[0]
    first = torch.ones_like(sel)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    first &= key >= 0
    bucket = torch.where(first, key // d_pad, card)
    counts = torch.zeros(bsz, card + 1, dtype=torch.int32, device=dev) \
        .scatter_add_(1, bucket, first.to(torch.int32))[:, :card]
    return root_eff >= 0, root_eff, counts


def reverse_nested_agg(mask: torch.Tensor, parent_eff: torch.Tensor, seg,
                       card: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K23 reverse_nested: (own, root_eff, counts) of
    reverse_nested_agg_plain from the eligible nested rows mask bool
    [B, Dp], their bucket parent_eff int32 [B, Dp] (-1, or a bucket in
    [0, card)) and the image's parent_ptr. On the card a walk of each
    root's rows in the image's static CSR (`child_start`, `child_rows`,
    a function of parent_ptr): no sort, no scratch. Replaces
    opensearch_tpu/search/aggs/engine.py:1579-1609."""
    if not mask.is_cuda:
        return reverse_nested_agg_plain(mask, parent_eff, seg["parent_ptr"],
                                        card)
    dev = mask.device
    bsz, d_pad = mask.shape
    _check_agg_inputs(mask, parent_eff, seg, card, dev)
    _require(seg["child_start"], torch.int32, (d_pad + 1,), dev,
             "child_start")
    rows = seg["child_rows"]
    _require(rows, torch.int32, (rows.shape[0],), dev, "child_rows")
    own = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    root_eff = torch.empty(bsz, d_pad, dtype=torch.int32, device=dev)
    counts = torch.zeros(bsz, card, dtype=torch.int32, device=dev)
    fn = _build.entry("reverse_nested_agg", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
                      lib="nested_aggs")
    code = fn(_build.ptr(mask), _build.ptr(parent_eff),
              _build.ptr(seg["child_start"]), _build.ptr(rows), bsz, d_pad,
              card, _build.ptr(own), _build.ptr(root_eff),
              _build.ptr(counts), _build.stream_of(dev))
    _build.LAUNCHES["reverse_nested_agg"] += 1
    _build.check("reverse_nested_agg", code, lib="nested_aggs")
    return own, root_eff, counts


def _check_agg_inputs(mask, parent_eff, seg, card: int, dev) -> None:
    bsz, d_pad = mask.shape
    if card <= 0:
        raise ValueError(f"nested aggregations take at least one bucket, "
                         f"got {card}")
    _require(mask, torch.bool, (bsz, d_pad), dev, "mask")
    _require(parent_eff, torch.int32, (bsz, d_pad), dev, "parent_eff")
    for key in ("nested_path", "parent_ptr"):
        _require(seg[key], torch.int32, (d_pad,), dev, key)
    _require(seg["live"], torch.bool, (d_pad,), dev, "live")
