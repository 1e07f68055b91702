"""K21 `row_merge`: the merge of the multi-shard query phase on one card
(the single-device form of opensearch_tpu/parallel/distributed.py's
runner merge), with its two C entries and their plain PyTorch versions.

- `row_value_key`: a row's dense f32 merge key for a numeric field sort,
  as opensearch_tpu/ops/topk.py:value_merge_key builds it: the doc's
  decoded value (`-unique_f32[min_rank]` for asc, `unique_f32[max_rank]`
  for desc), MISSING_VALUE_KEY where the doc has none. The row's K3 keyed
  top-k selects over it.
- `row_merge`: the rows' keyed top-k outputs (K3's keys | scores |
  indices | total layout, row r of width 3 k_r + 1 at the start of row r
  of one [R, W] buffer) merged into the request's k best: key
  descending, then row ascending, then rank within the row -- lax.top_k
  over the row-major concatenation, which is what the reference's
  intra-device top-k, all_gather and replicated top-k come to on one
  device. The packed output carries (key, score, row, ord) per winner,
  the sum of the row totals (the psum) and the per-row pruned counts, so
  one device-to-host copy returns the query phase.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.topk import (MISSING_VALUE_KEY, NEG_INF,
                                           total_order_topk,
                                           value_merge_key)

# the most rows one request merges (search/spmd.SPMD_MAX_PACK on one card)
MAX_ROWS = 8


def row_value_key_plain(col, order: str) -> torch.Tensor:
    """Plain version of row_value_key: value_merge_key."""
    return value_merge_key(col, order)


def row_value_key(col, order: str, d_pad: int,
                  device: torch.device) -> torch.Tensor:
    """K21's key entry: f32 [Dp] merge key of a numeric sort over one
    row's device column dict (`unique_f32`, `min_rank` / `max_rank`,
    `exists`); col None (the row has no such column) keys every doc as
    missing."""
    if col is None:
        return torch.full((d_pad,), MISSING_VALUE_KEY, dtype=torch.float32,
                          device=device)
    if not col["exists"].is_cuda:
        return row_value_key_plain(col, order)
    dev = col["exists"].device
    ranks = col["max_rank" if order == "desc" else "min_rank"]
    uniq = col["unique_f32"]
    for t, dt, shape, what in ((ranks, torch.int32, (d_pad,), "rank"),
                               (col["exists"], torch.bool, (d_pad,),
                                "exists"),
                               (uniq, torch.float32, (uniq.shape[0],),
                                "unique_f32")):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"[{what}] must be a contiguous {dt} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty(d_pad, dtype=torch.float32, device=dev)
    fn = _build.entry("row_value_key", [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                      lib="row_merge")
    code = fn(_build.ptr(uniq), _build.ptr(ranks), _build.ptr(col["exists"]),
              uniq.shape[0], d_pad, int(order == "desc"), _build.ptr(out),
              _build.stream_of(dev))
    _build.LAUNCHES["row_value_key"] += 1
    _build.check("row_value_key", code, lib="row_merge")
    return out


def merged_width(k: int, n_rows: int) -> int:
    """Words of row_merge's packed output: keys | scores | rows | ords
    (k each) | total | the per-row pruned counts."""
    return 4 * k + 1 + n_rows


def row_merge_plain(buf: torch.Tensor, ks: Sequence[int],
                    pruned: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of row_merge: the rows' K3 entries concatenated in
    row order, the top k in lax.top_k's order (ties to the lowest
    position), slots past the rows' lanes -inf. f32 [4k + 1 + R]."""
    dev = buf.device
    keys, scores, rows, ords, total = [], [], [], [], 0
    for r, kr in enumerate(ks):
        row = buf[r]
        keys.append(row[:kr])
        scores.append(row[kr:2 * kr])
        ords.append(row[2 * kr:3 * kr].view(torch.int32))
        rows.append(torch.full((kr,), r, dtype=torch.int32, device=dev))
        total += int(row[3 * kr:3 * kr + 1].view(torch.int32)[0])
    keys, scores = torch.cat(keys), torch.cat(scores)
    rows, ords = torch.cat(rows), torch.cat(ords)
    take = min(k, keys.shape[0])
    top, pos = total_order_topk(keys, take)
    pad = k - take
    out_keys = torch.cat([top, torch.full((pad,), NEG_INF, device=dev)])
    out_scores = torch.cat([scores[pos], torch.zeros(pad, device=dev)])
    zeros = torch.zeros(pad, dtype=torch.int32, device=dev)
    out_rows = torch.cat([rows[pos], zeros])
    out_ords = torch.cat([ords[pos], zeros])
    return torch.cat([out_keys, out_scores, out_rows.view(torch.float32),
                      out_ords.view(torch.float32),
                      torch.tensor([total], dtype=torch.int32,
                                   device=dev).view(torch.float32),
                      pruned.to(torch.int32).view(torch.float32)])


def row_merge(buf: torch.Tensor, ks: Sequence[int], pruned: torch.Tensor,
              k: int) -> torch.Tensor:
    """K21: merge R <= 8 rows' keyed top-k outputs into the request's k
    best. buf f32 [R, W] holds row r's K3 output (3 k_r + 1 words) at the
    start of row r; ks the k_r (host ints, 0 <= k_r, 3 k_r + 1 <= W);
    pruned i32 [R] the rows' pruned-lane counts; 0 < k <= 65,536.
    Returns f32 [4k + 1 + R] (merged_width).

    Precondition: each row's keys arrive sorted, non-increasing in the
    total order of their bits (`total_order_topk`'s: -0.0 below +0.0),
    as K3-keyed (`masked_topk_keyed`) writes them. The kernel merges the
    sorted rows by rank (no sort); the plain version sorts, so it does
    not depend on the precondition. parallel/distributed.py's `run_rows`
    is the only caller."""
    if not buf.is_cuda:
        return row_merge_plain(buf, ks, pruned, k)
    dev = buf.device
    n_rows, width = buf.shape
    if not 1 <= n_rows <= MAX_ROWS or len(ks) != n_rows:
        raise ValueError(f"row_merge takes 1..{MAX_ROWS} rows and one k "
                         f"per row, got {n_rows} rows and {len(ks)} ks")
    if not 0 < k <= 1 << 16 or any(not 0 <= kr or 3 * kr + 1 > width
                                   for kr in ks):
        raise ValueError(f"row_merge takes 0 < k <= 65536 and rows of "
                         f"3 k_r + 1 <= {width} words, got k={k}, ks={ks}")
    if buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("[buf] must be a contiguous float32 tensor")
    if pruned.dtype != torch.int32 or tuple(pruned.shape) != (n_rows,) \
            or pruned.device != dev or not pruned.is_contiguous():
        raise ValueError(f"[pruned] must be a contiguous int32 tensor of "
                         f"shape ({n_rows},) on {dev}")
    out = torch.empty(merged_width(k, n_rows), dtype=torch.float32,
                      device=dev)
    ks_host = (ctypes.c_int * n_rows)(*[int(kr) for kr in ks])
    fn = _build.entry("row_merge", [ctypes.c_void_p] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
    code = fn(_build.ptr(buf), n_rows, width, ks_host, _build.ptr(pruned), k,
              _build.ptr(out), _build.stream_of(dev))
    _build.LAUNCHES["row_merge"] += 1
    _build.check("row_merge", code)
    return out


def unpack_merged(packed, k: int, n_rows: int):
    """Host split of row_merge's output (numpy f32 [4k + 1 + R]): keys,
    scores, rows, ords, total, pruned."""
    keys = packed[:k]
    scores = packed[k:2 * k]
    rows = packed[2 * k:3 * k].view("int32")
    ords = packed[3 * k:4 * k].view("int32")
    total = int(packed[4 * k:4 * k + 1].view("int32")[0])
    pruned = packed[4 * k + 1:4 * k + 1 + n_rows].view("int32")
    return keys, scores, rows, ords, total, pruned
