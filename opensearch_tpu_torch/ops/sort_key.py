"""The dense per-doc sort key of a field sort (K13, `sort_key`): a CUDA
kernel with its plain PyTorch version.

Replaces opensearch_tpu/search/executor.py:_build_sort_key. The key is f32
[Dp], higher sorts first, built from the segment's device columns
(ops/device_segment.py): for a numeric / date / boolean field the doc's
value rank as f32 (negated for asc: min_rank, desc: max_rank); for a
keyword field the per-doc min (asc, negated) or max (desc) of its
ordinals; MISSING_KEY (-1e30) where the doc has no value, and everywhere
when the segment has no column for the field. The ranks are segment-local:
the key orders docs inside one segment only (exact up to 2^24 distinct
values, as the reference's f32 cast); the cross-segment order comes from
the host's exact values.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from opensearch_tpu_torch.ops import _build

# sort key for eligible docs that lack the sort field: far below any real
# rank key, far above NEG_INF (which marks ineligible docs), so fetched last
MISSING_KEY = -1e30
_ORD_INIT = {"asc": 1 << 30, "desc": -1}


def _column(arrays, field: str):
    col = arrays["numeric"].get(field)
    if col is not None:
        return "numeric", col
    col = arrays["ordinal"].get(field)
    if col is not None:
        return "ordinal", col
    return None, None


def sort_key_plain(arrays, primary_sort: Tuple[str, str]) -> torch.Tensor:
    """Plain version of K13 over one segment's device image."""
    d_pad = arrays["live"].shape[0]
    dev = arrays["live"].device
    field, order = primary_sort
    kind, col = _column(arrays, field)
    missing = torch.tensor(MISSING_KEY, dtype=torch.float32, device=dev)
    if kind is None:
        return missing.expand(d_pad).clone()
    if kind == "numeric":
        if order == "asc":
            key = -col["min_rank"].to(torch.float32)
        else:
            key = col["max_rank"].to(torch.float32)
        return torch.where(col["exists"], key, missing)
    init = _ORD_INIT[order]
    pair_valid = col["doc_ids"] >= 0
    # invalid pairs land in one extra lane that is dropped
    idx = torch.where(pair_valid, col["doc_ids"], d_pad).long()
    vals = torch.where(pair_valid, col["ords"], init)
    dense = torch.full((d_pad + 1,), init, dtype=torch.int32, device=dev)
    dense.scatter_reduce_(0, idx, vals,
                          "amin" if order == "asc" else "amax")
    dense = dense[:d_pad].to(torch.float32)
    key = -dense if order == "asc" else dense
    return torch.where(col["exists"], key, missing)


def build_sort_key(arrays, primary_sort: Optional[Tuple[str, str]]
                   ) -> Optional[torch.Tensor]:
    """K13: the f32 [Dp] sort key of (field, order) over one segment's
    device image; None for a score sort (the query phase then selects by
    score)."""
    if primary_sort is None:
        return None
    live = arrays["live"]
    if not live.is_cuda:
        return sort_key_plain(arrays, primary_sort)
    d_pad = live.shape[0]
    dev = live.device
    field, order = primary_sort
    kind, col = _column(arrays, field)
    out = torch.empty(d_pad, dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(None)
    rank = exists = doc_ids = ords = dense = null
    nv = 0
    if kind is None:
        mode = 0
    elif kind == "numeric":
        mode = 1 if order == "asc" else 2
        rank = _build.ptr(_checked(
            col["min_rank" if order == "asc" else "max_rank"],
            torch.int32, d_pad, dev))
        exists = _build.ptr(_checked(col["exists"], torch.bool, d_pad, dev))
    else:
        mode = 3 if order == "asc" else 4
        nv = col["doc_ids"].shape[0]
        doc_ids = _build.ptr(_checked(col["doc_ids"], torch.int32, nv, dev))
        ords = _build.ptr(_checked(col["ords"], torch.int32, nv, dev))
        exists = _build.ptr(_checked(col["exists"], torch.bool, d_pad, dev))
        dense_t = torch.empty(d_pad, dtype=torch.int32, device=dev)
        dense = _build.ptr(dense_t)
    fn = _build.entry("sort_key", [ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    code = fn(mode, rank, exists, doc_ids, ords, nv, d_pad, dense,
              _build.ptr(out), _build.stream_of(dev))
    _build.LAUNCHES["sort_key"] += 1
    _build.check("sort_key", code)
    return out


def _checked(t: torch.Tensor, dtype, n: int, dev) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != (n,) or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"sort_key takes a contiguous {dtype} column of "
                         f"shape ({n},) on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t
