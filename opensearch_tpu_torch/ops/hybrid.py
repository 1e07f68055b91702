"""The fused hybrid query phase's window bounds and union total (K12,
`hybrid_window`), as a CUDA kernel with its plain PyTorch version.

Per query the phase emits one f32 row of n_sub * (2k + 4) + 1 lanes: per
sub-query its K3 window [k scores | k doc ids], then count | min | max |
sum of squares over the window's valid lanes (score > -inf), and a
trailing union total (docs eligible under any sub-query). `count`, the
ids and the union are int32 bits, as in the reference's row
(opensearch_tpu/search/executor.py:build_hybrid_query_phase). The sum of
squares runs in lane order in both versions; the reference's XLA
reduction order is not fixed, so it differs from the port's within
k * 2^-24 * sum s^2.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.knn import _check
from opensearch_tpu_torch.ops.topk import NEG_INF


def hybrid_window_plain(rows: torch.Tensor, eligible: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Plain version of K12: rows f32 [n_sub, B, 2k+1] (K3's packed rows
    per sub-query), eligible bool [n_sub, B, Dp] -> f32 [B, n_sub * (2k +
    4) + 1]."""
    n_sub, bsz, _ = rows.shape
    top = rows[:, :, :k]
    valid = top > NEG_INF
    cnt = valid.sum(dim=2, dtype=torch.int32)
    mn = torch.where(valid, top, float("inf")).amin(dim=2) if k \
        else torch.full((n_sub, bsz), float("inf"), device=rows.device)
    mx = torch.where(valid, top, NEG_INF).amax(dim=2) if k \
        else torch.full((n_sub, bsz), NEG_INF, device=rows.device)
    ssq = torch.zeros(n_sub, bsz, dtype=torch.float32, device=rows.device)
    for j in range(k):
        v = torch.where(valid[:, :, j], top[:, :, j], 0.0)
        ssq = ssq + v * v
    pieces = []
    for i in range(n_sub):
        pieces += [rows[i, :, :2 * k], cnt[i, :, None].view(torch.float32),
                   mn[i, :, None], mx[i, :, None], ssq[i, :, None]]
    union = eligible.any(dim=0).sum(dim=1, dtype=torch.int32)
    pieces.append(union[:, None].view(torch.float32))
    return torch.cat(pieces, dim=1)


def hybrid_window(rows: torch.Tensor, eligible: torch.Tensor,
                  k: int) -> torch.Tensor:
    """K12: the fused hybrid row of each query from the sub-queries' K3
    rows and eligibility masks, f32 [B, n_sub * (2k + 4) + 1]."""
    if not rows.is_cuda:
        return hybrid_window_plain(rows, eligible, k)
    n_sub, bsz, width = rows.shape
    d_pad = eligible.shape[2]
    dev = rows.device
    if width != 2 * k + 1 or n_sub <= 0:
        raise ValueError(f"hybrid_window takes K3 rows of 2k+1 = {2 * k + 1} "
                         f"lanes for at least one sub-query, got "
                         f"{tuple(rows.shape)}")
    _check(((rows, torch.float32, (n_sub, bsz, 2 * k + 1), "rows"),
            (eligible, torch.bool, (n_sub, bsz, d_pad), "eligible")), dev)
    out = torch.empty(bsz, n_sub * (2 * k + 4) + 1, dtype=torch.float32,
                      device=dev)
    counts = torch.empty(max(bsz, 1), dtype=torch.int32, device=dev)
    fn = _build.entry("hybrid_window", [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(rows), _build.ptr(eligible), n_sub, bsz, d_pad, k,
              _build.ptr(counts), _build.ptr(out), _build.stream_of(dev))
    _build.LAUNCHES["hybrid_window"] += 1
    _build.check("hybrid_window", code)
    return out
