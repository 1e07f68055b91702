"""The shared masked top-k (K3, `masked_topk`): eligibility, total and an
exact top-k over dense per-doc keys, as a CUDA kernel with its plain PyTorch
version.

Order contract (the reference's `lax.top_k` over a masked key vector): key
descending, ties to the lowest index, and -inf lanes (ineligible docs) still
selectable, in index order, when fewer than k lanes are eligible.
`torch.topk` does not promise that tie order, so the plain version orders
with a stable sort.

Packed rows (`pack_rows`) are f32 [B, 2k+1]: k scores | k indices as int32
bits | the total as int32 bits, the reference's `_pack_row` layout.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch.ops import _build

NEG_INF = float("-inf")


def stable_topk(keys: torch.Tensor, k: int):
    """Top-k along the last dim with ties to the lowest index."""
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_rows(scores: torch.Tensor, idx: torch.Tensor,
              total: torch.Tensor) -> torch.Tensor:
    return torch.cat([scores.to(torch.float32),
                      idx.to(torch.int32).view(torch.float32),
                      total.to(torch.int32)[:, None].view(torch.float32)],
                     dim=1)


def unpack_rows(packed, k: int):
    """Host-side inverse of pack_rows on a numpy [B, 2k+1] array."""
    scores = packed[:, :k]
    idx = packed[:, k:2 * k].view("int32")
    totals = packed[:, 2 * k:2 * k + 1].view("int32")[:, 0]
    return scores, idx, totals


def masked_topk_plain(scores, matches, live, root, num_docs: int,
                      min_score, k: int) -> torch.Tensor:
    """Plain version of K3: eligible = matches & live & root & (index <
    num_docs) & (score >= min_score); total = sum(eligible); top-k of the
    eligible scores with -inf elsewhere. Returns f32 [B, 2k+1]."""
    d_pad = scores.shape[1]
    in_seg = torch.arange(d_pad, device=scores.device) < num_docs
    eligible = matches & live & root & in_seg \
        & (scores >= min_score[:, None])
    total = eligible.sum(dim=1, dtype=torch.int32)
    masked = torch.where(eligible, scores, NEG_INF)
    top, idx = stable_topk(masked, k)
    return pack_rows(top, idx, total)


def masked_topk(scores, matches, live, root, num_docs: int, min_score,
                k: int) -> torch.Tensor:
    """K3: the dense query phase's eligibility, total and masked top-k.
    Replaces opensearch_tpu/search/executor.py:build_batched_query_phase
    (`one`, with `_topk_or_empty` and `_pack_row`).

    scores f32 [B, Dp], matches bool [B, Dp], live / root bool [Dp],
    min_score f32 [B], 0 <= k <= Dp. Returns f32 [B, 2k+1]."""
    if not scores.is_cuda:
        return masked_topk_plain(scores, matches, live, root, num_docs,
                                 min_score, k)
    bsz, d_pad = scores.shape
    dev = scores.device
    if not 0 <= k <= d_pad or k > (1 << 14):
        raise ValueError(f"masked_topk takes 0 <= k <= min(Dp, 16384), "
                         f"got k={k} with Dp={d_pad}")
    for t, dt, shape, what in ((scores, torch.float32, (bsz, d_pad), "scores"),
                               (matches, torch.bool, (bsz, d_pad), "matches"),
                               (live, torch.bool, (d_pad,), "live"),
                               (root, torch.bool, (d_pad,), "root"),
                               (min_score, torch.float32, (bsz,),
                                "min_score")):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"[{what}] must be a contiguous {dt} tensor of shape {shape} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty(bsz, 2 * k + 1, dtype=torch.float32, device=dev)
    # scratch: per row the radix prefix (u64), remaining rank, candidate
    # count and total, a 256-bin histogram, then k candidate keys
    scratch = torch.empty(bsz * (4 + 256 + k), dtype=torch.int64, device=dev)
    fn = _build.entry("masked_topk", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(scores), _build.ptr(matches), _build.ptr(live),
              _build.ptr(root), _build.ptr(min_score), bsz, d_pad,
              int(num_docs), k, _build.ptr(out), _build.ptr(scratch),
              _build.stream_of(dev))
    _build.LAUNCHES["masked_topk"] += 1
    _build.check("masked_topk", code)
    return out
