"""BM25 scoring kernels -- the dense per-clause scorer (K2,
`score_text_clause`) and the candidate-buffer query phase (K1,
`bm25_candidate`) -- and the doc-value filter kernel (K4, `pairs_match`),
each a CUDA kernel with its plain PyTorch version, and block-max phase A
(K20, `blockmax_keep_mask`), whose keep mask K1 and K2 take.

A text clause gathers its terms' 128-wide posting blocks from the resident
`[NBp, 128]` matrices and computes the BM25 partial per lane,

    w * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl)),

with dl = length_table[norms[row][doc]] and the same operation order as
opensearch_tpu.ops.bm25, so the float rounding is the reference's.

Every function here takes a batch of B queries against one segment: per-lane
inputs are `[B, QB]` and per-clause scalars `[B]`. A wrapper runs its plain
version only for tensors on the CPU; for CUDA tensors it launches its kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.topk import (NEG_INF, pack_rows, stable_topk,
                                           total_order_topk)

# sort key of a padding lane in the candidate buffer (above every doc id)
CANDIDATE_PAD_DOC = 1 << 30
CANDIDATE_MAX_LANES = 1 << 14
CANDIDATE_MAX_TERMS = 16

# Block-max pruning (K20): skip posting blocks whose seal-time score bound
# cannot reach the query's top-k threshold, rank-exact by construction.
# Phase A scores the BLOCKMAX_SLICE_BLOCKS highest-bound blocks exactly;
# the k-th best eligible doc of that slice lower-bounds the true k-th best,
# and every block whose bound falls below it is beaten. Clauses of fewer
# than BLOCKMAX_MIN_BLOCKS lanes skip phase A (the slice would cover most
# of their postings). The gate is the node setting
# `search.blockmax.enabled` (off by default).
BLOCKMAX_SLICE_BLOCKS = 8
BLOCKMAX_MIN_BLOCKS = 16
# a min_score above this is a caller's floor (or an inert row): phase A
# stands down and keeps every block
BLOCKMAX_MIN_SCORE_OFF = -1e30
# the largest clause term count K20 serves (the compiler's expansion cap)
BLOCKMAX_MAX_TERMS = 1024
_SLICE_SENTINEL = (1 << 31) - 1


def idf(doc_count: int, doc_freq: int) -> float:
    """Lucene BM25Similarity.idfExplain."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def _lane_partials(seg: Dict[str, torch.Tensor], blk: Dict[str, torch.Tensor]):
    """Gathered docs and BM25 partials of every lane, [B, QB, 128] each,
    plus the real-lane mask (padding block lanes and -1 doc lanes false)."""
    ids = blk["ids"]
    lane_real = ids >= 0
    safe_ids = torch.where(lane_real, ids, 0).long()
    docs = seg["post_docs"][safe_ids]
    tfs = seg["post_tf"][safe_ids]
    valid = docs >= 0
    safe_docs = torch.where(valid, docs, 0).long()
    norm_bytes = seg["norms"][blk["row"].long()[:, None, None], safe_docs]
    dl = seg["length_table"][norm_bytes.long()]
    b = blk["b"][:, None, None]
    k1 = blk["k1"][:, None, None]
    denom = tfs + k1 * (1.0 - b + b * dl / blk["avgdl"][:, None, None])
    partial = blk["w"][:, :, None] * tfs * (k1 + 1.0) / denom
    return docs, partial, valid & lane_real[:, :, None]


# ----------------------------------------------------------------- K20 ------

def _kept_ids(blk, keep):
    """The clause's block ids with every lane the keep mask drops turned
    into a padding lane (-1): such a lane gathers nothing and adds
    nothing, as the reference's masked gather."""
    return torch.where(keep, blk["ids"], -1)


def blockmax_keep_mask_plain(seg, blk, n_terms: int, k: int, min_score):
    """Plain version of K20 (the reference's blockmax_keep_mask for B
    queries). Per lane: self_ub = max(w, 0) * (k1 + 1) * bscale *
    post_bound[id]; the per-term maxima tmax and their sum S, added term
    by term; ub = self_ub + (S - tmax[tid]). The top
    BLOCKMAX_SLICE_BLOCKS lanes by ub (ties to the lowest lane) are scored
    exactly, their (doc, partial, hit) entries sorted by (doc, position),
    summed over a window of n_terms at each doc's first entry; theta is
    the k-th best eligible doc score of the slice (-inf when fewer, or when
    min_score > BLOCKMAX_MIN_SCORE_OFF). keep = ub >= theta; pruned counts
    the real lanes dropped. Returns (keep bool [B, QB], pruned i32 [B])."""
    ids = blk["ids"]
    bsz, qb = ids.shape
    dev = ids.device
    lane_real = ids >= 0
    safe_ids = torch.where(lane_real, ids, 0).long()
    tid = blk["tid"]
    k1 = blk["k1"][:, None]
    w_pos = torch.maximum(blk["w"], torch.zeros((), device=dev))
    self_ub = w_pos * (k1 + 1.0) * blk["bscale"][:, None] \
        * seg["post_bound"][safe_ids]
    self_ub = torch.where(lane_real, self_ub, 0.0)
    tmax = torch.stack([
        torch.where(lane_real & (tid == t), self_ub, 0.0).amax(dim=1)
        for t in range(n_terms)], dim=1)                       # [B, T]
    total_max = torch.zeros(bsz, dtype=torch.float32, device=dev)
    for t in range(n_terms):
        total_max = total_max + tmax[:, t]
    safe_tid = torch.where(lane_real, tid, 0).long()
    ub = self_ub + (total_max[:, None] - tmax.gather(1, safe_tid))

    n_slice = min(BLOCKMAX_SLICE_BLOCKS, qb)
    _, sidx = total_order_topk(torch.where(lane_real, ub, NEG_INF), n_slice)
    s_real = lane_real.gather(1, sidx)
    sid = safe_ids.gather(1, sidx)
    docs = seg["post_docs"][sid]                               # [B, S, 128]
    tfs = seg["post_tf"][sid]
    valid = (docs >= 0) & s_real[:, :, None]
    safe_docs = torch.where(valid, docs, 0).long()
    norm_bytes = seg["norms"][blk["row"].long()[:, None, None], safe_docs]
    dl = seg["length_table"][norm_bytes.long()]
    b = blk["b"][:, None, None]
    k1b = blk["k1"][:, None, None]
    denom = tfs + k1b * (1.0 - b + b * dl / blk["avgdl"][:, None, None])
    partial = blk["w"].gather(1, sidx)[:, :, None] * tfs * (k1b + 1.0) \
        / denom
    elig0 = valid & seg["live"][safe_docs] & seg["root"][safe_docs]
    flat_docs = torch.where(elig0, docs, _SLICE_SENTINEL).reshape(bsz, -1)
    flat_p = torch.where(elig0, partial, 0.0).reshape(bsz, -1)
    flat_h = elig0.to(torch.int32).reshape(bsz, -1)
    n = flat_docs.shape[1]
    sdocs, order = torch.sort(flat_docs, dim=1, stable=True)
    sp = flat_p.gather(1, order)
    sh = flat_h.gather(1, order)
    tot, hits = sp, sh
    for j in range(1, n_terms):
        same = torch.zeros_like(sdocs, dtype=torch.bool)
        prev_p = torch.zeros_like(sp)
        prev_h = torch.zeros_like(sh)
        if j < n:
            same[:, :-j] = sdocs[:, j:] == sdocs[:, :-j]
            prev_p[:, :-j] = sp[:, j:]
            prev_h[:, :-j] = sh[:, j:]
        tot = tot + torch.where(same, prev_p, 0.0)
        hits = hits + torch.where(same, prev_h, 0)
    head = torch.ones_like(sdocs, dtype=torch.bool)
    head[:, 1:] = sdocs[:, 1:] != sdocs[:, :-1]
    elig = head & (sdocs < _SLICE_SENTINEL) \
        & (hits >= blk["min_hits"][:, None])
    cand = torch.where(elig, tot, NEG_INF)
    theta = total_order_topk(cand, min(k, n))[0][:, -1]
    theta = torch.where(min_score > BLOCKMAX_MIN_SCORE_OFF, NEG_INF, theta)
    keep = ub >= theta[:, None]
    pruned = (lane_real & ~keep).sum(dim=1, dtype=torch.int32)
    return keep, pruned


def blockmax_keep_mask(seg, blk, n_terms: int, k: int, min_score):
    """K20: block-max phase A for B text-clause queries against one
    segment. Replaces opensearch_tpu/ops/bm25.py:blockmax_keep_mask.

    seg: the device image with its `post_bound` leaf. blk: the clause's
    ids / w / tid [B, QB] (QB >= 8) and bscale / row / avgdl / b / k1 /
    min_hits [B]; min_score f32 [B]; n_terms the clause's distinct-term
    count (<= BLOCKMAX_MAX_TERMS) and 0 < k <= BLOCKMAX_SLICE_BLOCKS * 128.
    Returns (keep bool [B, QB], pruned int32 [B])."""
    if not seg["post_docs"].is_cuda:
        return blockmax_keep_mask_plain(seg, blk, n_terms, k, min_score)
    ids = blk["ids"]
    bsz, qb = ids.shape
    d_pad = seg["live"].shape[0]
    dev = ids.device
    if qb < 8:
        raise ValueError(f"blockmax_keep_mask takes QB >= 8, got {qb}")
    if not 1 <= n_terms <= BLOCKMAX_MAX_TERMS:
        raise ValueError(f"blockmax_keep_mask takes 1..{BLOCKMAX_MAX_TERMS}"
                         f" terms, got {n_terms}")
    if not 0 < k <= BLOCKMAX_SLICE_BLOCKS * 128:
        raise ValueError(f"blockmax_keep_mask takes 0 < k <= "
                         f"{BLOCKMAX_SLICE_BLOCKS * 128}, got {k}")
    _require_image(seg, d_pad)
    nb = seg["post_docs"].shape[0]
    _require(seg["post_bound"], torch.float32, (nb,), dev, "post_bound")
    _require(ids, torch.int32, (bsz, qb), dev, "ids")
    _require(blk["w"], torch.float32, (bsz, qb), dev, "w")
    _require(blk["tid"], torch.int32, (bsz, qb), dev, "tid")
    for key, dt in (("bscale", torch.float32), ("row", torch.int32),
                    ("avgdl", torch.float32), ("b", torch.float32),
                    ("k1", torch.float32), ("min_hits", torch.int32)):
        _require(blk[key], dt, (bsz,), dev, key)
    _require(min_score, torch.float32, (bsz,), dev, "min_score")
    keep = torch.empty(bsz, qb, dtype=torch.bool, device=dev)
    pruned = torch.empty(bsz, dtype=torch.int32, device=dev)
    scratch = torch.empty(bsz * qb, dtype=torch.float32, device=dev)
    fn = _build.entry("blockmax_keep", [ctypes.c_void_p] * 17
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    code = fn(_build.ptr(ids), _build.ptr(blk["w"]), _build.ptr(blk["tid"]),
              _build.ptr(blk["bscale"]), _build.ptr(blk["row"]),
              _build.ptr(blk["avgdl"]), _build.ptr(blk["b"]),
              _build.ptr(blk["k1"]), _build.ptr(blk["min_hits"]),
              _build.ptr(min_score), _build.ptr(seg["post_bound"]),
              _build.ptr(seg["post_docs"]), _build.ptr(seg["post_tf"]),
              _build.ptr(seg["norms"]), _build.ptr(seg["length_table"]),
              _build.ptr(seg["live"]), _build.ptr(seg["root"]),
              bsz, qb, d_pad, nb, n_terms, k, _build.ptr(keep),
              _build.ptr(pruned), _build.ptr(scratch),
              _build.stream_of(dev))
    _build.LAUNCHES["blockmax_keep"] += 1
    _build.check("blockmax_keep", code)
    return keep, pruned


# ----------------------------------------------------------------- K2 -------

def score_text_clause_plain(seg, blk):
    """Plain version of K2: dense scores f32 [B, Dp] and hit counts i32
    [B, Dp]. A doc's partials add in lane order, starting from 0, like the
    reference's scatter-add: lanes are split into passes by their rank among
    the earlier lanes of the same doc, so each pass adds to distinct docs and
    pass r adds every doc's r-th partial."""
    d_pad = seg["live"].shape[0]
    docs, partial, real = _lane_partials(seg, blk)
    bsz = docs.shape[0]
    flat_docs = torch.where(real, docs, d_pad).reshape(bsz, -1).long()
    flat_p = torch.where(real, partial, 0.0).reshape(bsz, -1)
    flat_real = real.reshape(bsz, -1)
    n = flat_docs.shape[1]
    sdoc, order = torch.sort(flat_docs, dim=1, stable=True)
    pos = torch.arange(n, device=docs.device).expand(bsz, n)
    start = torch.ones_like(sdoc, dtype=torch.bool)
    start[:, 1:] = sdoc[:, 1:] != sdoc[:, :-1]
    run_start = torch.where(start, pos, 0).cummax(dim=1).values
    rank = torch.empty_like(pos)
    rank.scatter_(1, order, pos - run_start)
    rank = torch.where(flat_real, rank, -1)
    scores = torch.zeros(bsz, d_pad, dtype=torch.float32, device=docs.device)
    hits = torch.zeros(bsz, d_pad, dtype=torch.int32, device=docs.device)
    for r in range(int(rank.max().item()) + 1):
        bi, li = (rank == r).nonzero(as_tuple=True)
        di = flat_docs[bi, li]
        scores[bi, di] += flat_p[bi, li]
        hits[bi, di] += 1
    return scores, hits


# log2 of the docs one K2 CTA owns of one query (score_text_clause.cu
# CHUNK_LOG; the kernel checks the scratch it is given against it)
TEXT_CLAUSE_CHUNK_LOG = 13


def text_clause_scratch_words(bsz: int, qb: int, d_pad: int) -> int:
    """K2's scratch in 32-bit words: a bitmap over the QB lanes for every
    (query, chunk of 2^13 docs), the blocks that reach the chunk."""
    return bsz * (-(-d_pad >> TEXT_CLAUSE_CHUNK_LOG)) * (-(-qb // 32))


def score_text_clause(seg, blk, block_keep=None):
    """K2: one text clause of B queries scored into dense per-doc vectors.
    Replaces opensearch_tpu/ops/bm25.py:score_text_clause.

    seg: device segment image (post_docs, post_tf, norms, length_table,
    live). blk: ids i32 [B, QB] (-1 = padding lane), w f32 [B, QB], row i32
    [B], avgdl / b / k1 f32 [B]. block_keep: K20's bool [B, QB] mask, or
    None; a lane it drops contributes nothing. Returns (scores f32 [B, Dp],
    hits i32 [B, Dp]); hits counts the clause terms that matched each
    doc. The kernel's scratch (`text_clause_scratch_words`) is allocated
    here."""
    if not seg["post_docs"].is_cuda:
        if block_keep is not None:
            blk = dict(blk, ids=_kept_ids(blk, block_keep))
        return score_text_clause_plain(seg, blk)
    ids = blk["ids"]
    bsz, qb = ids.shape
    d_pad = seg["live"].shape[0]
    dev = ids.device
    _require_image(seg, d_pad)
    _require(ids, torch.int32, (bsz, qb), dev, "ids")
    _require(blk["w"], torch.float32, (bsz, qb), dev, "w")
    for key, dt in (("row", torch.int32), ("avgdl", torch.float32),
                    ("b", torch.float32), ("k1", torch.float32)):
        _require(blk[key], dt, (bsz,), dev, key)
    if block_keep is not None:
        _require(block_keep, torch.bool, (bsz, qb), dev, "block_keep")
    scores = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    hits = torch.empty(bsz, d_pad, dtype=torch.int32, device=dev)
    bits = torch.empty(text_clause_scratch_words(bsz, qb, d_pad),
                       dtype=torch.int32, device=dev)
    fn = _build.entry("score_text_clause", [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                     ctypes.c_void_p])
    code = fn(_build.ptr(ids),
              ctypes.c_void_p(0) if block_keep is None
              else _build.ptr(block_keep),
              _build.ptr(blk["w"]), _build.ptr(blk["row"]),
              _build.ptr(blk["avgdl"]), _build.ptr(blk["b"]),
              _build.ptr(blk["k1"]), _build.ptr(seg["post_docs"]),
              _build.ptr(seg["post_tf"]), _build.ptr(seg["norms"]),
              _build.ptr(seg["length_table"]), bsz, qb, d_pad,
              seg["post_docs"].shape[0], _build.ptr(scores),
              _build.ptr(hits), _build.ptr(bits), bits.numel(),
              _build.stream_of(dev))
    _build.LAUNCHES["score_text_clause" if block_keep is None
                    else "score_text_clause_keep"] += 1
    _build.check("score_text_clause", code)
    return scores, hits


# ----------------------------------------------------------------- K1 -------

def bm25_candidate_plain(seg, blk, n_terms: int, constant: bool, k: int,
                         min_score: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 (the reference's build_candidate_query_phase
    `one`, batched): the clause's lanes sorted stably by doc, a backward
    window of n_terms lanes summed at each run's end (p[end] + p[end-1] +
    ..., the reference's float order), eligibility, and the top-k of the
    buffer with ties to the lowest lane. Returns the packed rows f32
    [B, 2k+1]: k scores | k doc ids (int32 bits) | total."""
    docs, partial, real = _lane_partials(seg, blk)
    bsz = docs.shape[0]
    dev = docs.device
    doc_key = torch.where(real, docs, CANDIDATE_PAD_DOC).reshape(bsz, -1)
    part = torch.where(real, partial, 0.0).reshape(bsz, -1)
    hit = real.reshape(bsz, -1).to(torch.int32)
    n = doc_key.shape[1]
    sdoc, order = torch.sort(doc_key, dim=1, stable=True)
    spart = torch.gather(part, 1, order)
    shit = torch.gather(hit, 1, order)
    is_end = torch.ones_like(sdoc, dtype=torch.bool)
    is_end[:, :-1] = sdoc[:, :-1] != sdoc[:, 1:]
    run_score, run_hits = spart, shit
    for j in range(1, n_terms):
        same = torch.zeros_like(is_end)
        same[:, j:] = sdoc[:, :-j] == sdoc[:, j:]
        prev_part = torch.zeros_like(spart)
        prev_part[:, j:] = spart[:, :-j]
        prev_hit = torch.zeros_like(shit)
        prev_hit[:, j:] = shit[:, :-j]
        run_score = run_score + torch.where(same, prev_part, 0.0)
        run_hits = run_hits + torch.where(same, prev_hit, 0)
    matches = run_hits >= blk["min_hits"][:, None]
    score = blk["boost"][:, None].expand(bsz, n) if constant else run_score
    valid_end = is_end & (sdoc < CANDIDATE_PAD_DOC)
    safe_end = torch.where(valid_end, sdoc, 0).long()
    eligible = valid_end & matches & seg["live"][safe_end] \
        & seg["root"][safe_end] & (score >= min_score[:, None])
    total = eligible.sum(dim=1, dtype=torch.int32)
    masked = torch.where(eligible, score, NEG_INF)
    k_eff = min(k, n)
    top_scores, top_lane = stable_topk(masked, k_eff)
    top_docs = torch.gather(sdoc, 1, top_lane).to(torch.int32)
    if k_eff < k:
        top_scores = torch.cat([top_scores, torch.full(
            (bsz, k - k_eff), NEG_INF, device=dev)], dim=1)
        top_docs = torch.cat([top_docs, torch.zeros(
            bsz, k - k_eff, dtype=torch.int32, device=dev)], dim=1)
    return pack_rows(top_scores, top_docs, total)


def bm25_candidate(seg, blk, n_terms: int, constant: bool, k: int,
                   min_score: torch.Tensor, block_keep=None,
                   pruned=None) -> torch.Tensor:
    """K1: the candidate-buffer query phase of B single-text-clause queries
    against one segment. Replaces opensearch_tpu/search/executor.py:
    build_candidate_query_phase (`one`, family bm25_candidate).

    blk: ids i32 [B, QB] with QB a power of two and QB*128 <= 16384, w f32
    [B, QB]; per query row, min_hits i32, avgdl / b / k1 / boost f32 [B].
    min_score f32 [B]. n_terms <= 16 is the clause's distinct-term count,
    the longest run one doc can have. Returns f32 [B, 2k+1] packed rows.
    With K20's block_keep bool [B, QB] and pruned i32 [B] (the block-max
    arm) a dropped lane contributes nothing and each row gains a trailing
    lane, the pruned count's int32 bits: f32 [B, 2k+2]."""
    if not seg["post_docs"].is_cuda:
        if block_keep is None:
            return bm25_candidate_plain(seg, blk, n_terms, constant, k,
                                        min_score)
        rows = bm25_candidate_plain(
            seg, dict(blk, ids=_kept_ids(blk, block_keep)), n_terms,
            constant, k, min_score)
        return torch.cat([rows, pruned.to(torch.int32)[:, None].view(
            torch.float32)], dim=1)
    ids = blk["ids"]
    bsz, qb = ids.shape
    d_pad = seg["live"].shape[0]
    dev = ids.device
    if qb < 8 or qb & (qb - 1) or qb * 128 > CANDIDATE_MAX_LANES:
        raise ValueError(f"bm25_candidate takes QB a power of two in "
                         f"[8, {CANDIDATE_MAX_LANES // 128}], got {qb}")
    if not 1 <= n_terms <= CANDIDATE_MAX_TERMS:
        raise ValueError(f"bm25_candidate takes 1..{CANDIDATE_MAX_TERMS} "
                         f"terms, got {n_terms}")
    _require_image(seg, d_pad)
    _require(ids, torch.int32, (bsz, qb), dev, "ids")
    _require(blk["w"], torch.float32, (bsz, qb), dev, "w")
    for key, dt in (("row", torch.int32), ("avgdl", torch.float32),
                    ("b", torch.float32), ("k1", torch.float32),
                    ("min_hits", torch.int32), ("boost", torch.float32)):
        _require(blk[key], dt, (bsz,), dev, key)
    _require(min_score, torch.float32, (bsz,), dev, "min_score")
    null = ctypes.c_void_p(0)
    if block_keep is not None:
        _require(block_keep, torch.bool, (bsz, qb), dev, "block_keep")
        _require(pruned, torch.int32, (bsz,), dev, "pruned")
    out = torch.empty(bsz, 2 * k + 1 + (block_keep is not None),
                      dtype=torch.float32, device=dev)
    fn = _build.entry("bm25_candidate", [ctypes.c_void_p] * 17 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    code = fn(_build.ptr(ids),
              null if block_keep is None else _build.ptr(block_keep),
              null if pruned is None else _build.ptr(pruned),
              _build.ptr(blk["w"]), _build.ptr(blk["row"]),
              _build.ptr(blk["avgdl"]), _build.ptr(blk["b"]),
              _build.ptr(blk["k1"]), _build.ptr(blk["min_hits"]),
              _build.ptr(blk["boost"]), _build.ptr(min_score),
              _build.ptr(seg["post_docs"]), _build.ptr(seg["post_tf"]),
              _build.ptr(seg["norms"]), _build.ptr(seg["length_table"]),
              _build.ptr(seg["live"]), _build.ptr(seg["root"]),
              bsz, qb, d_pad, n_terms, int(bool(constant)), k,
              _build.ptr(out), _build.stream_of(dev))
    # the keep entry (the block-max arm) counts apart
    _build.LAUNCHES["bm25_candidate" if block_keep is None
                    else "bm25_candidate_keep"] += 1
    _build.check("bm25_candidate", code)
    return out


# ----------------------------------------------------------------- K4 -------

def _pairs_to_docs_plain(hit, doc_ids, d_pad: int, ident: bool):
    """Per-pair hit flags bool [B, n] -> per-doc bool [B, d_pad]: a slice
    or a false padding on the identity layout, else an OR into each pair's
    doc."""
    bsz, n = hit.shape
    if ident:
        if n >= d_pad:
            return hit[:, :d_pad].contiguous()
        return torch.cat([hit, torch.zeros(bsz, d_pad - n, dtype=torch.bool,
                                           device=hit.device)], dim=1)
    out = torch.zeros(bsz, d_pad, dtype=torch.bool, device=hit.device)
    bi, li = hit.nonzero(as_tuple=True)
    out[bi, doc_ids[li].long()] = True
    return out


def pairs_match_plain(doc_ids, ords, d_pad: int, ident: bool, lo=None,
                      hi=None, ord_mask=None):
    """Plain version of K4: a pair hits when its doc id is valid and its
    rank lies in [lo[b], hi[b]) (or ord_mask[b][ord] holds); a doc matches
    when any of its pairs hits. Returns bool [B, d_pad]."""
    pair_valid = doc_ids >= 0
    if ord_mask is None:
        hit = (ords[None, :] >= lo[:, None]) & (ords[None, :] < hi[:, None])
    else:
        hit = ord_mask[:, ords.long()]
    return _pairs_to_docs_plain(hit & pair_valid[None, :], doc_ids, d_pad,
                                ident)


def pairs_match(doc_ids, ords, d_pad: int, ident: bool, lo=None, hi=None,
                ord_mask=None):
    """K4: a doc-value filter over a value-pair column for B queries.
    Replaces opensearch_tpu/ops/bm25.py:_pairs_to_docs with its callers
    range_match_on_ranks and ordinal_terms_match.

    doc_ids / ords int32 [NVp] (doc -1 = padding lane); either lo / hi
    int32 [B] (rank in [lo, hi)) or ord_mask bool [B, Up] (ords index it).
    ident: the column is the identity layout (lane k holds doc k). Returns
    bool [B, d_pad]."""
    if not doc_ids.is_cuda:
        return pairs_match_plain(doc_ids, ords, d_pad, ident, lo, hi,
                                 ord_mask)
    dev = doc_ids.device
    n = doc_ids.shape[0]
    _require(doc_ids, torch.int32, (n,), dev, "doc_ids")
    _require(ords, torch.int32, (n,), dev, "ords")
    if ord_mask is None:
        bsz = lo.shape[0]
        _require(lo, torch.int32, (bsz,), dev, "lo")
        _require(hi, torch.int32, (bsz,), dev, "hi")
        up = 0
    else:
        bsz, up = ord_mask.shape
        _require(ord_mask, torch.bool, (bsz, up), dev, "ord_mask")
    if ident and n > d_pad:
        raise ValueError(f"an identity column has at most Dp lanes, got "
                         f"{n} > {d_pad}")
    out = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    null = ctypes.c_void_p(0)
    fn = _build.entry("pairs_match", [ctypes.c_void_p] * 2 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 2)
    code = fn(_build.ptr(doc_ids), _build.ptr(ords), n,
              null if lo is None else _build.ptr(lo),
              null if hi is None else _build.ptr(hi),
              null if ord_mask is None else _build.ptr(ord_mask), up, bsz,
              d_pad, int(bool(ident)), _build.ptr(out), _build.stream_of(dev))
    _build.LAUNCHES["pairs_match"] += 1
    _build.check("pairs_match", code)
    return out


def range_match_on_ranks(doc_ids, ords, lo_rank, hi_rank, d_pad: int,
                         ident: bool = False):
    """Doc matches if ANY of its values has rank in [lo_rank, hi_rank)
    (int32 [B] each); rank bounds come from the host's searchsorted over
    the column's sorted unique values."""
    return pairs_match(doc_ids, ords, d_pad, ident, lo=lo_rank, hi=hi_rank)


def ordinal_terms_match(doc_ids, ords, ord_mask, d_pad: int,
                        ident: bool = False):
    """Doc matches if ANY of its ordinals is in the query's set (ord_mask
    bool [B, Up] over the field's dictionary or value ranks)."""
    return pairs_match(doc_ids, ords, d_pad, ident, ord_mask=ord_mask)


# ------------------------------------------------------------- helpers ------

def _require(t: torch.Tensor, dtype, shape, device, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"[{what}] must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


def _require_image(seg, d_pad: int) -> None:
    dev = seg["post_docs"].device
    nb = seg["post_docs"].shape[0]
    _require(seg["post_docs"], torch.int32, (nb, 128), dev, "post_docs")
    _require(seg["post_tf"], torch.float32, (nb, 128), dev, "post_tf")
    _require(seg["norms"], torch.int32, (seg["norms"].shape[0], d_pad), dev,
             "norms")
    _require(seg["length_table"], torch.float32, (256,), dev, "length_table")
    _require(seg["live"], torch.bool, (d_pad,), dev, "live")
    _require(seg["root"], torch.bool, (d_pad,), dev, "root")
