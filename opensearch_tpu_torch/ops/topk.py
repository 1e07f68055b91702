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

The keyed entry (`masked_topk_keyed`) is the general path's query phase:
the top-k over a per-doc sort key in lax.top_k's total order (-0.0 below
+0.0), for any k up to Dp, as f32 [B, 3k+1] rows: k keys | k scores at the
winners | k indices | the total. The value-keyed merge helpers of
opensearch_tpu/ops/topk.py (`MISSING_VALUE_KEY`, `f32_sortable`,
`single_valued`, `value_merge_key`) serve the result page (ops/page.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import _build

NEG_INF = float("-inf")
# the largest k masked_topk selects (its last pass sorts the k winners of a
# row in shared memory); past it, masked_topk_threshold marks the set of
# winners without ordering them, and masked_topk_keyed sorts them in
# global memory
MAX_K = 1 << 14

# The radix select's scratch (ops/csrc/masked_topk.cu), in int64 slots per
# row: a RowState (STATE_SLOTS), two u32 histograms of 2,048 bins
# (HIST_SLOTS) and two candidate buffers of select_cap(Dp) keys; then the
# entry's own (masked_topk: its k winners a row; masked_topk_keyed: its
# winners and its sort's second buffer, p2 a row each).
STATE_SLOTS = 8
HIST_SLOTS = 2048
# RowState.full_reads as an int32 index into a row's state: the passes of
# the select that read the whole input (2 unless the overflow rule fired)
FULL_READS_WORD = 12


def select_cap(d_pad: int) -> int:
    """Keys a row's candidate buffer holds: a bin with more keys than this
    is not buffered, and the select reads the input again (the overflow
    rule)."""
    return max(d_pad // 8, min(d_pad, 4096))


def select_buffer_room(d_pad: int, bsz: int) -> int:
    """Keys a bin may hold to be buffered: select_cap less the slots each
    warp of the select's grid may leave unused in its last append chunk
    (masked_topk.cu's select_grid, append_chunk and buffer_room)."""
    # select_grid: CTAs of at least 4 tiles of 1,024 lanes, 2,048 / B CTAs
    # a row (8 to 1,024); 8 warps a CTA
    ctas = max(1, min((-(-d_pad // 1024) + 3) // 4,
                      min(max(2048 // bsz, 8), 1024)))
    cap, warps = select_cap(d_pad), ctas * 8
    chunk = max(1, min(64, cap // (4 * warps)))
    return cap - warps * (chunk - 1)


def select_scratch_slots(bsz: int, d_pad: int) -> int:
    """int64 slots of the select's own scratch for a [B, Dp] call."""
    return bsz * (STATE_SLOTS + HIST_SLOTS + 2 * select_cap(d_pad))


def _pow2_at_least(k: int) -> int:
    p2 = 1
    while p2 < k:
        p2 <<= 1
    return p2


def _scratch_slots(entry: str, bsz: int, d_pad: int, k: int) -> int:
    tail = {"masked_topk": bsz * k, "masked_topk_threshold": 0,
            "masked_topk_keyed": 2 * bsz * _pow2_at_least(k)}[entry]
    return max(select_scratch_slots(bsz, d_pad) + tail, 1)


def select_scratch(entry: str, bsz: int, d_pad: int, k: int,
                   device) -> torch.Tensor:
    """A scratch tensor for one call of `entry` (masked_topk,
    masked_topk_threshold or masked_topk_keyed) at [B, Dp] and k. Pass it
    as the call's `scratch` to read the select's state afterwards
    (select_full_reads)."""
    return torch.empty(_scratch_slots(entry, bsz, d_pad, k),
                       dtype=torch.int64, device=device)


def select_full_reads(scratch: torch.Tensor, bsz: int) -> list:
    """Per row, how many passes of the select read the whole input, from
    the scratch of a finished call with k > 0 (a copy to the host: call it
    outside any timed window)."""
    state = scratch[:bsz * STATE_SLOTS].view(torch.int32)
    return state.view(bsz, 2 * STATE_SLOTS)[:, FULL_READS_WORD].tolist()


def _scratch_for(entry: str, scratch, bsz: int, d_pad: int, k: int, dev):
    """The caller's scratch after checking it, or a new one."""
    if scratch is None:
        return select_scratch(entry, bsz, d_pad, k, dev)
    need = _scratch_slots(entry, bsz, d_pad, k)
    if scratch.dtype != torch.int64 or scratch.device != dev \
            or not scratch.is_contiguous() or scratch.numel() < need:
        raise ValueError(f"[scratch] must be a contiguous int64 tensor of at "
                         f"least {need} elements on {dev}, got "
                         f"{scratch.dtype} {tuple(scratch.shape)} on "
                         f"{scratch.device}")
    return scratch


# Missing-field sentinel for VALUE-keyed merges: below every admissible
# value key (f32_sortable admits |v| < 1e29 only) but above the NEG_INF
# ineligibility mask, so a doc missing the sort field stays a candidate
# that sorts last.
MISSING_VALUE_KEY = -1e30


def f32_sortable(col) -> bool:
    """Admit a column to a value-keyed merge only when every unique value
    is exactly f32-representable and within the sentinel range (the f32
    key selection then equals the host's exact f64 one). Memoized on the
    column. Epoch-millis dates usually fail and take the host path."""
    cached = getattr(col, "_f32_sortable", None)
    if cached is None:
        u = col.unique
        cached = bool(
            len(u) == 0
            or (np.all(np.abs(u) < 1e29)
                and np.array_equal(u.astype(np.float32).astype(np.float64),
                                   u)))
        col._f32_sortable = cached
    return cached


def single_valued(col) -> bool:
    """True when no doc of the column carries more than one value: the
    result page's fused docvalue gather then reproduces docvalue_fields
    exactly. Memoized on the column."""
    cached = getattr(col, "_single_valued", None)
    if cached is None:
        cached = bool(np.unique(col.doc_ids).size == col.doc_ids.size)
        col._single_valued = cached
    return cached


def value_merge_key(col, order: str) -> torch.Tensor:
    """Dense [Dp] f32 cross-segment merge key of a numeric-field sort from
    the device column dict: the doc's decoded f32 value (negated for asc),
    MISSING_VALUE_KEY where the doc has none."""
    u = col["unique_f32"]
    hi = u.shape[0] - 1
    if order == "asc":
        keys = -u[col["min_rank"].clamp(0, hi).long()]
    else:
        keys = u[col["max_rank"].clamp(0, hi).long()]
    return torch.where(col["exists"], keys,
                       torch.tensor(MISSING_VALUE_KEY, dtype=torch.float32,
                                    device=keys.device))


def total_order_topk(keys: torch.Tensor, k: int):
    """Top-k of f32 keys along the last dim in lax.top_k's order: a total
    order on the bits (-0.0 below +0.0), ties to the lowest index."""
    bits = keys.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7fffffff, bits)
    _, idx = torch.sort(ordered, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return keys.gather(-1, idx), idx


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
    eligible scores with -inf elsewhere, in lax.top_k's total order (-0.0
    below +0.0, NaN by its bits). Returns f32 [B, 2k+1]."""
    d_pad = scores.shape[1]
    in_seg = torch.arange(d_pad, device=scores.device) < num_docs
    eligible = matches & live & root & in_seg \
        & (scores >= min_score[:, None])
    total = eligible.sum(dim=1, dtype=torch.int32)
    masked = torch.where(eligible, scores, NEG_INF)
    top, idx = total_order_topk(masked, k)
    return pack_rows(top, idx, total)


def _check_rows(scores, matches, live, root, min_score) -> None:
    bsz, d_pad = scores.shape
    dev = scores.device
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


def masked_topk(scores, matches, live, root, num_docs: int, min_score,
                k: int, scratch=None) -> torch.Tensor:
    """K3: the dense query phase's eligibility, total and masked top-k.
    Replaces opensearch_tpu/search/executor.py:build_batched_query_phase
    (`one`, with `_topk_or_empty` and `_pack_row`).

    scores f32 [B, Dp], matches bool [B, Dp], live / root bool [Dp],
    min_score f32 [B], 0 <= k <= Dp. Returns f32 [B, 2k+1]. `scratch`
    (select_scratch) keeps the select's state readable after the call."""
    if not scores.is_cuda:
        return masked_topk_plain(scores, matches, live, root, num_docs,
                                 min_score, k)
    bsz, d_pad = scores.shape
    dev = scores.device
    if not 0 <= k <= d_pad or k > MAX_K:
        raise ValueError(f"masked_topk takes 0 <= k <= min(Dp, 16384), "
                         f"got k={k} with Dp={d_pad}")
    _check_rows(scores, matches, live, root, min_score)
    out = torch.empty(bsz, 2 * k + 1, dtype=torch.float32, device=dev)
    # scratch: the select's (select_scratch_slots), then k winners a row
    scratch = _scratch_for("masked_topk", scratch, bsz, d_pad, k, dev)
    fn = _build.entry("masked_topk", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(scores), _build.ptr(matches), _build.ptr(live),
              _build.ptr(root), _build.ptr(min_score), bsz, d_pad,
              int(num_docs), k, _build.ptr(out), _build.ptr(scratch),
              _build.stream_of(dev))
    _build.LAUNCHES["masked_topk"] += 1
    _build.check("masked_topk", code)
    return out


def mark_winners(packed: torch.Tensor, d_pad: int, k: int) -> torch.Tensor:
    """bool [B, Dp]: true at the doc of each finite slot of K3's packed
    [B, 2k+1] rows; no invalid slot touches doc 0."""
    bsz = packed.shape[0]
    idx = packed[:, k:2 * k].view(torch.int32).long()
    valid = packed[:, :k] > NEG_INF
    rows = torch.arange(bsz, device=packed.device)[:, None].expand(bsz, k)
    mark = torch.zeros(bsz, d_pad, dtype=torch.bool, device=packed.device)
    mark[rows[valid], idx[valid]] = True
    return mark


def masked_topk_threshold_plain(scores, matches, live, root, num_docs: int,
                                min_score, k: int) -> torch.Tensor:
    """Plain version of masked_topk_threshold: K3's plain top-k, then the
    mark of its finite winners. bool [B, Dp]."""
    return mark_winners(masked_topk_plain(scores, matches, live, root,
                                          num_docs, min_score, k),
                        scores.shape[1], k)


def masked_topk_threshold(scores, matches, live, root, num_docs: int,
                          min_score, k: int, scratch=None) -> torch.Tensor:
    """K3's second entry: the SET of each row's k winners (K3's
    eligibility and key order), as bool [B, Dp] marked at the winners
    with a finite score, for any 0 <= k <= Dp. Serves the selections past
    MAX_K: a `knn` node's k and an IVF probe's block budget. `scratch` as
    masked_topk's."""
    if not scores.is_cuda:
        return masked_topk_threshold_plain(scores, matches, live, root,
                                           num_docs, min_score, k)
    bsz, d_pad = scores.shape
    dev = scores.device
    if not 0 <= k <= d_pad:
        raise ValueError(f"masked_topk_threshold takes 0 <= k <= Dp, got "
                         f"k={k} with Dp={d_pad}")
    _check_rows(scores, matches, live, root, min_score)
    mark = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    # scratch: the select's alone (winners are marked where found)
    scratch = _scratch_for("masked_topk_threshold", scratch, bsz, d_pad, k,
                           dev)
    fn = _build.entry("masked_topk_threshold", [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
                      lib="masked_topk")
    code = fn(_build.ptr(scores), _build.ptr(matches), _build.ptr(live),
              _build.ptr(root), _build.ptr(min_score), bsz, d_pad,
              int(num_docs), k, _build.ptr(mark), _build.ptr(scratch),
              _build.stream_of(dev))
    _build.LAUNCHES["masked_topk_threshold"] += 1
    _build.check("masked_topk_threshold", code, lib="masked_topk")
    return mark


def masked_topk_keyed_plain(scores, matches, live, root, num_docs: int,
                            min_score, key, k: int) -> torch.Tensor:
    """Plain version of masked_topk_keyed: K3's eligibility and total,
    the top-k of where(eligible, key, -inf) in lax.top_k's order (key
    None: the scores), and the scores at the winners. f32 [B, 3k+1]."""
    d_pad = scores.shape[1]
    in_seg = torch.arange(d_pad, device=scores.device) < num_docs
    eligible = matches & live & root & in_seg \
        & (scores >= min_score[:, None])
    total = eligible.sum(dim=1, dtype=torch.int32)
    keys = scores if key is None else key[None, :].expand_as(scores)
    top, idx = total_order_topk(torch.where(eligible, keys, NEG_INF), k)
    return torch.cat([top, scores.gather(1, idx),
                      idx.to(torch.int32).view(torch.float32),
                      total[:, None].view(torch.float32)], dim=1)


def unpack_keyed_rows(packed, k: int):
    """Host-side split of masked_topk_keyed rows (numpy [B, 3k+1]): keys,
    scores, indices and totals."""
    keys = packed[:, :k]
    scores = packed[:, k:2 * k]
    idx = packed[:, 2 * k:3 * k].view("int32")
    totals = packed[:, 3 * k:3 * k + 1].view("int32")[:, 0]
    return keys, scores, idx, totals


def masked_topk_keyed(scores, matches, live, root, num_docs: int,
                      min_score, key, k: int, out=None,
                      scratch=None) -> torch.Tensor:
    """K3's keyed entry: the general path's query phase
    (opensearch_tpu/search/executor.py:build_query_phase in "field" mode,
    and in "score" mode with `key` None). Eligibility and total as K3; the
    top-k of the masked key, for any 0 <= k <= Dp.

    scores f32 [B, Dp], matches bool [B, Dp], live / root bool [Dp],
    min_score f32 [B], key f32 [Dp] (shared by the batch) or None.
    Returns f32 [B, 3k+1]: keys | scores | indices | total, written into
    `out` when given (a contiguous f32 [B, 3k+1] view, e.g. a row of the
    multi-shard merge buffer). `scratch` as masked_topk's."""
    bsz, d_pad = scores.shape
    dev = scores.device
    if out is not None and (out.dtype != torch.float32
                            or tuple(out.shape) != (bsz, 3 * k + 1)
                            or out.device != dev
                            or not out.is_contiguous()):
        raise ValueError(f"[out] must be a contiguous float32 tensor of "
                         f"shape ({bsz}, {3 * k + 1}) on {dev}")
    if not scores.is_cuda:
        rows = masked_topk_keyed_plain(scores, matches, live, root,
                                       num_docs, min_score, key, k)
        if out is None:
            return rows
        return out.copy_(rows)
    if not 0 <= k <= d_pad:
        raise ValueError(f"masked_topk_keyed takes 0 <= k <= Dp, got k={k} "
                         f"with Dp={d_pad}")
    _check_rows(scores, matches, live, root, min_score)
    if key is not None and (key.dtype != torch.float32
                            or tuple(key.shape) != (d_pad,)
                            or key.device != dev
                            or not key.is_contiguous()):
        raise ValueError(f"[key] must be a contiguous float32 tensor of "
                         f"shape ({d_pad},) on {dev}, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    if out is None:
        out = torch.empty(bsz, 3 * k + 1, dtype=torch.float32, device=dev)
    # scratch: the select's, then the winners and the sort's second buffer
    # (p2 >= k each a row)
    scratch = _scratch_for("masked_topk_keyed", scratch, bsz, d_pad, k, dev)
    fn = _build.entry("masked_topk_keyed", [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
                      lib="masked_topk")
    code = fn(_build.ptr(scores), _build.ptr(matches), _build.ptr(live),
              _build.ptr(root), _build.ptr(min_score),
              None if key is None else _build.ptr(key), bsz, d_pad,
              int(num_docs), k, _build.ptr(out), _build.ptr(scratch),
              _build.stream_of(dev))
    _build.LAUNCHES["masked_topk_keyed"] += 1
    _build.check("masked_topk_keyed", code, lib="masked_topk")
    return out
