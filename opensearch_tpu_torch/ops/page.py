"""The single-round-trip result page (K14, `page_merge`): a CUDA kernel with
its plain PyTorch version.

Replaces opensearch_tpu/search/executor.py:_page_merger.run (with
opensearch_tpu/ops/topk.py:value_merge_key). It takes every segment's
keyed top-k row of one request (ops/topk.py:masked_topk_keyed, B=1),
re-keys the winners by their decoded f32 value in field mode (segment
ranks do not compare across segments, values do), selects the request's
k_page best of the concatenation in lax.top_k's order, and gathers each
winner's score, global id (segment position * stride + doc), sort rank and
exists flag and each fused docvalue field's rank and exists flag into one
packed int32 page (f32 lanes as their bits):

    keys | scores | gids | (sort rank | sort exists) | (rank | exists) per
    docvalue field | the S segment totals

each lane group k_page long, the totals S long.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.topk import (MISSING_VALUE_KEY, NEG_INF,
                                           total_order_topk, value_merge_key)


def _split(row: torch.Tensor):
    k = (row.shape[0] - 1) // 3
    return (k, row[:k], row[k:2 * k], row[2 * k:3 * k].view(torch.int32),
            row[3 * k:3 * k + 1].view(torch.int32))


def page_merge_plain(rows: Sequence[torch.Tensor], order: Optional[str],
                     sort_cols: Sequence[Optional[dict]],
                     dv_cols: Sequence[Sequence[Optional[dict]]],
                     k_page: int, stride: int) -> torch.Tensor:
    """Plain version of K14. `rows`: each segment's keyed row f32 [3k+1];
    `order` None for a score page, else the field sort's order;
    `sort_cols[s]`: segment s's device numeric column of the sort field
    (None: the segment has none); `dv_cols[s][f]`: its column of docvalue
    field f, or None where the page decodes no values."""
    field_mode = order is not None
    keys, scores, gids, sranks, sexists = [], [], [], [], []
    dv_lanes: List[tuple] = [([], []) for _ in (dv_cols[0] if dv_cols
                                                else ())]
    totals = []
    for pos, row in enumerate(rows):
        k, rk, sc, ti, total = _split(row)
        tl = ti.long()
        zeros = torch.zeros(k, dtype=torch.int32, device=row.device)
        if field_mode:
            col = sort_cols[pos]
            valid = rk != NEG_INF
            if col is None:
                vkey = torch.full_like(rk, MISSING_VALUE_KEY)
                sranks.append(zeros)
                sexists.append(zeros)
            else:
                vkey = value_merge_key(col, order)[tl]
                ra = col["min_rank" if order == "asc" else "max_rank"]
                sranks.append(ra[tl])
                sexists.append(col["exists"][tl].to(torch.int32))
            keys.append(torch.where(valid, vkey, torch.full_like(rk,
                                                                 NEG_INF)))
        else:
            keys.append(rk)
        scores.append(sc)
        gids.append(ti + pos * stride)
        for f, (r_l, e_l) in enumerate(dv_lanes):
            col = dv_cols[pos][f]
            if col is None:
                r_l.append(zeros)
                e_l.append(zeros)
            else:
                r_l.append(col["min_rank"][tl])
                e_l.append(col["exists"][tl].to(torch.int32))
        totals.append(total)
    mk, mi = total_order_topk(torch.cat(keys), k_page)
    parts = [mk.view(torch.int32), torch.cat(scores)[mi].view(torch.int32),
             torch.cat(gids)[mi]]
    if field_mode:
        parts += [torch.cat(sranks)[mi], torch.cat(sexists)[mi]]
    for r_l, e_l in dv_lanes:
        parts += [torch.cat(r_l)[mi], torch.cat(e_l)[mi]]
    parts.append(torch.cat(totals))
    return torch.cat(parts)


def page_descriptor(rows: Sequence[torch.Tensor], order: Optional[str],
                    sort_cols: Sequence[Optional[dict]],
                    dv_cols: Sequence[Sequence[Optional[dict]]]):
    """K14's per-segment descriptor table (int64 [S, 7 + 2 * n_dv]: each
    segment's row and column pointers, uploaded to the rows' device) and
    the lane count L = sum k_i."""
    dev = rows[0].device
    n_dv = len(dv_cols[0]) if dv_cols else 0
    desc = np.zeros((len(rows), 7 + 2 * n_dv), dtype=np.int64)
    off = 0
    for s, row in enumerate(rows):
        if row.dtype != torch.float32 or row.dim() != 1 or row.device != dev \
                or not row.is_contiguous() or (row.shape[0] - 1) % 3:
            raise ValueError("page_merge takes contiguous f32 [3k+1] rows "
                             "on one device")
        k = (row.shape[0] - 1) // 3
        desc[s, :3] = (row.data_ptr(), k, off)
        off += k
        col = sort_cols[s] if order is not None else None
        if col is not None:
            ra = col["min_rank" if order == "asc" else "max_rank"]
            desc[s, 3:7] = (col["unique_f32"].data_ptr(),
                            col["unique_f32"].shape[0], ra.data_ptr(),
                            col["exists"].data_ptr())
        for f in range(n_dv):
            dcol = dv_cols[s][f]
            if dcol is not None:
                desc[s, 7 + 2 * f] = dcol["min_rank"].data_ptr()
                desc[s, 8 + 2 * f] = dcol["exists"].data_ptr()
    return torch.from_numpy(desc).to(dev), off


def page_merge_launch(desc: torch.Tensor, n_lanes: int, order: Optional[str],
                      k_page: int, stride: int) -> torch.Tensor:
    """K14's launch over an uploaded descriptor table (page_descriptor);
    the rows and columns it points at must stay alive until it ran."""
    if not desc.is_cuda:
        raise ValueError("page_merge_launch runs the CUDA kernel: its "
                         "descriptor must lie on the card")
    if not 0 < k_page <= n_lanes:
        raise ValueError(f"page_merge takes 0 < k_page <= {n_lanes}, got "
                         f"{k_page}")
    dev = desc.device
    n_seg = desc.shape[0]
    n_dv = (desc.shape[1] - 7) // 2
    p2 = 1
    while p2 < n_lanes:
        p2 <<= 1
    width = 3 + (2 if order is not None else 0) + 2 * n_dv
    out = torch.empty(k_page * width + n_seg, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * p2, dtype=torch.int64, device=dev)
    fn = _build.entry("page_merge", [ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(desc), n_seg, n_dv, n_lanes, k_page,
              int(order is not None), int(order == "desc"), stride,
              _build.ptr(out), _build.ptr(scratch), _build.stream_of(dev))
    _build.LAUNCHES["page_merge"] += 1
    _build.check("page_merge", code)
    return out


def page_merge(rows: Sequence[torch.Tensor], order: Optional[str],
               sort_cols: Sequence[Optional[dict]],
               dv_cols: Sequence[Sequence[Optional[dict]]],
               k_page: int, stride: int) -> torch.Tensor:
    """K14: one request's packed result page (see the module docstring)
    from its segments' keyed rows; 0 < k_page <= sum of the rows' k."""
    if not rows[0].is_cuda:
        return page_merge_plain(rows, order, sort_cols, dv_cols, k_page,
                                stride)
    desc, n_lanes = page_descriptor(rows, order, sort_cols, dv_cols)
    return page_merge_launch(desc, n_lanes, order, k_page, stride)
