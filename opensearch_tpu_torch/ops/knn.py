"""Dense k-NN (the port's copy of opensearch_tpu.ops.knn): the exact scan
(K7, `knn_exact`), the IVF probe (K8, `ivf_probe`) and the seal-time
k-means step (K9, `kmeans_step`), each a CUDA kernel with its plain
PyTorch version, plus the host side of the IVF index.

- Exact: every doc row against a batch of B queries, [Dp, dims] x
  [dims, B], scored in the field's space; a query keeps its k best
  eligible docs (`knn_match_topk`, through K3).
- IVF: k-means centroids built when a segment seals; the inverted lists
  are fixed 256-row blocks, packed list-major (`pack_ivf_lists`), so a
  probe ranks blocks by their centroid's L2 distance to the query, takes
  the best `budget` of them (K3) and scores their contiguous rows in place.

Score conventions follow the k-NN plugin's spaces:
  l2: 1/(1+d^2), cosinesimil: (1+cos)/2, innerproduct: ip>=0 -> ip+1 else
  1/(1-ip).

Every sum runs in dim order with one rounding per operation, in the
kernels and the plain versions alike, so they agree bit for bit. The
reference computes its products as blocked matmuls, so its scores differ
from the port's by a few ulps (about dims * 2^-24 * sum|v_i q_i|).

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from opensearch_tpu_torch import resolve_device
from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.topk import (MAX_K, NEG_INF, mark_winners,
                                           masked_topk,
                                           masked_topk_threshold,
                                           stable_topk)

SPACES = ("l2", "cosinesimil", "innerproduct")
_SPACE_CODE = {s: i for i, s in enumerate(SPACES)}

# fixed block width of the inverted lists: a probe slices whole blocks, so
# its candidate count is budget * IVF_BLOCK however imbalanced the clusters
IVF_BLOCK = 256
# K9's counting sort runs over tiles of KMEANS_TILE points, and its sums
# over chunks of KMEANS_CHUNK members (kmeans_step.cu's TILE and CHUNK);
# its assignment reads the centroids transposed in blocks of KMEANS_BLOCK
# (kmeans_step.cu's CB)
KMEANS_TILE = 1024
KMEANS_CHUNK = 256
KMEANS_BLOCK = 256


def _check_space(space: str):
    if space not in SPACES:
        raise ValueError(f"unknown knn space [{space}]")


@dataclass
class IVFIndex:
    """Host-side IVF structure of a vector column, built at seal time.

    `lists[i]` is one block of IVF_BLOCK doc ords (-1 padded) owned by
    centroid `block_centroid[i]`; a cluster with many members spans several
    consecutive blocks, an empty one none."""
    centroids: np.ndarray        # [nlist, dims] float32
    lists: np.ndarray            # [n_blocks, IVF_BLOCK] int32, -1 padded
    block_centroid: np.ndarray   # int32 [n_blocks] owning centroid
    nlist: int
    nprobe: int                  # default probe count from the mapping


# --------------------------------------------------------- dim-order sums

def _sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """sum_j x_j^2 per row of [N, dims], in dim order."""
    out = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for j in range(rows.shape[1]):
        col = rows[:, j]
        out = out + col * col
    return out


def _dots(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """queries [B, dims] . rows [N, dims] -> [B, N], summed in dim order."""
    cols = rows.t().contiguous()
    out = torch.zeros(queries.shape[0], rows.shape[0], dtype=torch.float32,
                      device=rows.device)
    for j in range(rows.shape[1]):
        out = out + queries[:, j:j + 1] * cols[j][None, :]
    return out


def space_score_plain(dots, dn, qn, space: str) -> torch.Tensor:
    """The raw similarity of `space` from the dot products and squared
    norms (broadcastable), converted to the k-NN plugin score."""
    if space == "l2":
        raw = -(dn - 2.0 * dots + qn)
        return torch.reciprocal(1.0 + torch.clamp(-raw, min=0.0))
    if space == "cosinesimil":
        den = torch.clamp(torch.sqrt(dn) * torch.sqrt(qn), min=1e-30)
        return (1.0 + torch.clamp(dots / den, -1.0, 1.0)) / 2.0
    return torch.where(dots >= 0, dots + 1.0,
                       torch.reciprocal(1.0 - dots))


def _check(tensors, dev) -> None:
    for t, dt, shape, what in tensors:
        if t.dtype != dt or tuple(t.shape) != tuple(shape) \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"[{what}] must be a contiguous {dt} tensor of shape "
                f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")


# ------------------------------------------------------------ exact (K7)

def exact_knn_scores_plain(vectors: torch.Tensor, queries: torch.Tensor,
                           space: str) -> torch.Tensor:
    """Plain version of K7: vectors f32 [Dp, dims], queries f32 [B, dims]
    -> scores f32 [B, Dp]."""
    _check_space(space)
    dots = _dots(vectors, queries)
    return space_score_plain(dots, _sq_norms(vectors)[None, :],
                             _sq_norms(queries)[:, None], space)


def exact_knn_scores(vectors: torch.Tensor, queries: torch.Tensor,
                     space: str) -> torch.Tensor:
    """K7: every doc row's score against each query, f32 [B, Dp].
    Replaces opensearch_tpu/ops/knn.py:exact_knn_scores (with
    raw_similarity and space_score). Any dims and Dp; `vectors` may be a
    contiguous view at any offset (16-byte copies where dims % 4 == 0 and
    its data is 16-byte aligned, 4-byte copies otherwise)."""
    _check_space(space)
    if not vectors.is_cuda:
        return exact_knn_scores_plain(vectors, queries, space)
    d_pad, dims = vectors.shape
    bsz = queries.shape[0]
    dev = vectors.device
    _check(((vectors, torch.float32, (d_pad, dims), "vectors"),
            (queries, torch.float32, (bsz, dims), "queries")), dev)
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    # the queries staged [dim][query] per tile of up to 32, then |q|^2
    dims4 = -(-dims // 4) * 4
    scratch = torch.empty((bsz + 32) * dims4 + bsz, dtype=torch.float32,
                          device=dev)
    fn = _build.entry("knn_exact", [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    code = fn(_build.ptr(vectors), _build.ptr(queries), bsz, d_pad, dims,
              _SPACE_CODE[space], _build.ptr(scratch), _build.ptr(out),
              _build.stream_of(dev))
    _build.LAUNCHES["knn_exact"] += 1
    _build.check("knn_exact", code)
    return out


def knn_topk_mark_plain(packed: torch.Tensor, scores: torch.Tensor,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of knn_topk_mark: the finite winners of K3's packed
    [B, 2k+1] rows keep their score and match; every other doc 0 / false.
    No invalid slot touches doc 0."""
    matches = mark_winners(packed, scores.shape[1], k)
    return torch.where(matches, scores, 0.0), matches


def knn_topk_mark(packed: torch.Tensor, scores: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's second entry: scores f32 [B, Dp] and matches bool [B, Dp] of
    the k winners of each packed row (knn_match_topk after its top-k)."""
    if not scores.is_cuda:
        return knn_topk_mark_plain(packed, scores, k)
    bsz, d_pad = scores.shape
    dev = scores.device
    _check(((packed, torch.float32, (bsz, 2 * k + 1), "packed"),
            (scores, torch.float32, (bsz, d_pad), "scores")), dev)
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    matches = torch.empty(bsz, d_pad, dtype=torch.bool, device=dev)
    fn = _build.entry("knn_topk_mark", [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
                      lib="knn_exact")
    code = fn(_build.ptr(packed), _build.ptr(scores), bsz, k, d_pad,
              _build.ptr(out), _build.ptr(matches), _build.stream_of(dev))
    _build.LAUNCHES["knn_topk_mark"] += 1
    _build.check("knn_topk_mark", code, lib="knn_exact")
    return out, matches


def knn_match_topk(scores: torch.Tensor, eligible: torch.Tensor,
                   live: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restrict dense scores [B, Dp] to each query's k best eligible docs
    (score desc, doc asc on ties): (scores, matches), 0 / false elsewhere.
    Replaces opensearch_tpu/ops/knn.py:knn_match_topk.

    The top-k is K3 with min_score -inf. K3 ands `live`, `root` and the
    segment bound onto `eligible`; the reference's eligibility is exists &
    live (& filter & IVF candidates) with no root term, so `live` stands in
    for `root` and the bound is Dp: `eligible` already holds both. Past
    MAX_K the node needs only the set of winners: K3's threshold entry
    marks it."""
    bsz, d_pad = scores.shape
    k_eff = min(int(k), d_pad)
    min_score = torch.full((bsz,), NEG_INF, dtype=torch.float32,
                           device=scores.device)
    if k_eff > MAX_K:
        matches = masked_topk_threshold(scores, eligible, live, live, d_pad,
                                        min_score, k_eff)
        return torch.where(matches, scores, 0.0), matches
    packed = masked_topk(scores, eligible, live, live, d_pad, min_score,
                         k_eff)
    return knn_topk_mark(packed, scores, k_eff)


# --------------------------------------------------------------- IVF (K8)

def ivf_budget(nprobe: int, nlist: int, n_blocks: int) -> int:
    """Blocks a probe reads: ~nprobe lists' worth of blocks, plus one."""
    nprobe_eff = min(int(nprobe), nlist)
    return min(n_blocks, -(-nprobe_eff * n_blocks // nlist) + 1)


def pack_ivf_lists(vectors: np.ndarray, lists: np.ndarray):
    """List-contiguous copies of the vector rows + their doc ords, so each
    probed block is one contiguous slice (a second copy of the vectors,
    inflated by list padding)."""
    flat = lists.reshape(-1)
    safe = np.where(flat >= 0, flat, 0)
    packed = np.ascontiguousarray(vectors[safe].astype(np.float32))
    packed[flat < 0] = 0.0
    return packed, np.ascontiguousarray(flat.astype(np.int32))


def ivf_block_keys_plain(centroids, block_centroid, queries):
    """Plain version of K8's launch (a): the rank key of each IVF block
    for each query, -(|c|^2 - 2 c.q) of the block's centroid c, f32
    [B, n_blocks]."""
    cd = _sq_norms(centroids)[None, :] - 2.0 * _dots(centroids, queries)
    return -cd[:, block_centroid.long()]


def ivf_block_keys(centroids, block_centroid, queries):
    """K8's launch (a), `ivf_block_keys`: f32 [B, n_blocks] block rank
    keys (the larger, the nearer the block's centroid in L2)."""
    if not queries.is_cuda:
        return ivf_block_keys_plain(centroids, block_centroid, queries)
    bsz, dims = queries.shape
    nlist = centroids.shape[0]
    n_blocks = block_centroid.shape[0]
    dev = queries.device
    _check(((centroids, torch.float32, (nlist, dims), "centroids"),
            (block_centroid, torch.int32, (n_blocks,), "block_centroid"),
            (queries, torch.float32, (bsz, dims), "queries")), dev)
    neg_key = torch.empty(bsz, n_blocks, dtype=torch.float32, device=dev)
    fn = _build.entry("ivf_block_keys", [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                      lib="ivf_probe")
    code = fn(_build.ptr(centroids), _build.ptr(block_centroid),
              _build.ptr(queries), bsz, n_blocks, dims, _build.ptr(neg_key),
              _build.stream_of(dev))
    _build.LAUNCHES["ivf_block_keys"] += 1
    _build.check("ivf_block_keys", code, lib="ivf_probe")
    return neg_key


def ivf_knn_scores_plain(packed_vecs, packed_ids, centroids, block_centroid,
                         d: int, queries, space: str, nprobe: int):
    """Plain version of K8: (dense scores f32 [B, d], candidate mask bool
    [B, d]) of a probe of the `budget` best blocks per query."""
    _check_space(space)
    bsz, dims = queries.shape
    n_blocks = block_centroid.shape[0]
    budget = ivf_budget(nprobe, centroids.shape[0], n_blocks)
    neg_key = ivf_block_keys_plain(centroids, block_centroid, queries)
    _, blk = stable_topk(neg_key, budget)
    rows = packed_vecs.reshape(n_blocks, IVF_BLOCK, dims)[blk].reshape(
        bsz, budget * IVF_BLOCK, dims)
    ids = packed_ids.reshape(n_blocks, IVF_BLOCK)[blk].reshape(
        bsz, budget * IVF_BLOCK).long()
    dots = torch.zeros(bsz, budget * IVF_BLOCK, dtype=torch.float32,
                       device=queries.device)
    dn = torch.zeros_like(dots)
    for j in range(dims):
        v = rows[:, :, j]
        dn = dn + v * v
        dots = dots + v * queries[:, j:j + 1]
    scores = space_score_plain(dots, dn, _sq_norms(queries)[:, None], space)
    valid = ids >= 0
    q_of = torch.arange(bsz, device=queries.device)[:, None].expand_as(ids)
    dense = torch.zeros(bsz, d, dtype=torch.float32, device=queries.device)
    mask = torch.zeros(bsz, d, dtype=torch.bool, device=queries.device)
    dense[q_of[valid], ids[valid]] = scores[valid]
    mask[q_of[valid], ids[valid]] = True
    return dense, mask


def ivf_knn_scores(packed_vecs, packed_ids, centroids, block_centroid,
                   d: int, queries, space: str, nprobe: int):
    """K8: (dense scores f32 [B, d], candidate mask bool [B, d]); scores
    are exact for candidate docs and 0 elsewhere. Replaces
    opensearch_tpu/ops/knn.py:ivf_knn_scores. Blocks rank by their
    centroid's L2 distance in every space (the lists were clustered in
    L2); the block choice is K3 over the negated keys."""
    _check_space(space)
    if not queries.is_cuda:
        return ivf_knn_scores_plain(packed_vecs, packed_ids, centroids,
                                    block_centroid, d, queries, space,
                                    nprobe)
    bsz, dims = queries.shape
    nlist = centroids.shape[0]
    n_blocks = block_centroid.shape[0]
    dev = queries.device
    _check(((packed_vecs, torch.float32, (n_blocks * IVF_BLOCK, dims),
             "packed_vecs"),
            (packed_ids, torch.int32, (n_blocks * IVF_BLOCK,), "packed_ids"),
            (centroids, torch.float32, (nlist, dims), "centroids"),
            (block_centroid, torch.int32, (n_blocks,), "block_centroid"),
            (queries, torch.float32, (bsz, dims), "queries")), dev)
    budget = ivf_budget(nprobe, nlist, n_blocks)
    neg_key = ivf_block_keys(centroids, block_centroid, queries)
    every = torch.ones(n_blocks, dtype=torch.bool, device=dev)
    choice = (neg_key, every[None, :].expand(bsz, -1).contiguous(), every,
              every, n_blocks, torch.full((bsz,), NEG_INF, device=dev),
              budget)
    if budget <= MAX_K:
        chosen = masked_topk(*choice)
    else:
        # past MAX_K the probe takes the set of chosen blocks (it stores
        # each row's score in place, so their order does not matter):
        # every row marks exactly `budget` blocks, listed in block order
        ids = masked_topk_threshold(*choice).nonzero()[:, 1].to(torch.int32)
        chosen = torch.zeros(bsz, 2 * budget + 1, dtype=torch.float32,
                             device=dev)
        chosen[:, budget:2 * budget] = ids.view(bsz, budget).view(
            torch.float32)
    dense = torch.empty(bsz, d, dtype=torch.float32, device=dev)
    mask = torch.empty(bsz, d, dtype=torch.bool, device=dev)
    qn = torch.empty(max(bsz, 1), dtype=torch.float32, device=dev)
    fn = _build.entry("ivf_probe", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    code = fn(_build.ptr(packed_vecs), _build.ptr(packed_ids),
              _build.ptr(queries), _build.ptr(chosen), bsz, budget, dims, d,
              _SPACE_CODE[space], _build.ptr(qn), _build.ptr(dense),
              _build.ptr(mask), _build.stream_of(dev))
    _build.LAUNCHES["ivf_probe"] += 1
    _build.check("ivf_probe", code)
    return dense, mask


# ------------------------------------------------------- k-means (K9)

def _member_sums(data: torch.Tensor, assign: torch.Tensor, nlist: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-centroid sums of the assigned points [nlist, dims] and member
    counts [nlist], in K9's order: a centroid's members in point order,
    cut into chunks of KMEANS_CHUNK, each chunk summed in order from 0,
    then the chunks' sums in chunk order (zero padding adds nothing: a sum
    from +0 is never -0)."""
    n, dims = data.shape
    dev = data.device
    order = torch.sort(assign, stable=True)[1]
    counts = torch.bincount(assign, minlength=nlist)
    start = torch.cumsum(counts, 0) - counts
    n_chunks = (counts + KMEANS_CHUNK - 1) // KMEANS_CHUNK
    chunk_start = torch.cumsum(n_chunks, 0) - n_chunks
    owner = assign[order]
    rank = torch.arange(n, device=dev) - start[owner]
    total = int(n_chunks.sum())
    members = torch.zeros(total, KMEANS_CHUNK, dims, dtype=torch.float32,
                          device=dev)
    members[chunk_start[owner] + rank // KMEANS_CHUNK,
            rank % KMEANS_CHUNK] = data[order]
    partial = torch.zeros(total, dims, dtype=torch.float32, device=dev)
    for u in range(KMEANS_CHUNK):
        partial = partial + members[:, u]
    widest = int(n_chunks.max()) if nlist else 0
    by_list = torch.zeros(nlist, widest, dims, dtype=torch.float32,
                          device=dev)
    chunk_owner = torch.repeat_interleave(
        torch.arange(nlist, device=dev), n_chunks)
    by_list[chunk_owner,
            torch.arange(total, device=dev) - chunk_start[chunk_owner]] = \
        partial
    sums = torch.zeros(nlist, dims, dtype=torch.float32, device=dev)
    for g in range(widest):
        sums = sums + by_list[:, g]
    return sums, counts


def kmeans_step_plain(data: torch.Tensor, centroids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: (new centroids f32 [nlist, dims], assignments
    int32 [n])."""
    nlist = centroids.shape[0]
    dist = _sq_norms(data)[:, None] - 2.0 * _dots(centroids, data) \
        + _sq_norms(centroids)[None, :]
    assign = torch.argmin(dist, dim=1)
    sums, counts = _member_sums(data, assign, nlist)
    counts = counts[:, None]
    new = torch.where(counts > 0,
                      sums / torch.clamp(counts, min=1).to(torch.float32),
                      centroids)
    return new, assign.to(torch.int32)


def kmeans_step(data: torch.Tensor, centroids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: one Lloyd step, argmin-L2 assignment (lowest centroid on ties)
    and per-centroid means (an empty cluster keeps its centroid), summed
    in `_member_sums`' order.
    Replaces opensearch_tpu/ops/knn.py:_kmeans.step."""
    if not data.is_cuda:
        return kmeans_step_plain(data, centroids)
    n, dims = data.shape
    nlist = centroids.shape[0]
    dev = data.device
    _check(((data, torch.float32, (n, dims), "data"),
            (centroids, torch.float32, (nlist, dims), "centroids")), dev)
    out = torch.empty(nlist, dims, dtype=torch.float32, device=dev)
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    # the norms and the centroids transposed, [ceil(nlist / KMEANS_BLOCK)]
    # blocks of [dims rounded up to 4][KMEANS_BLOCK]
    width = -(-nlist // KMEANS_BLOCK) * KMEANS_BLOCK
    cn = torch.empty(max(width, 1), dtype=torch.float32, device=dev)
    ct = torch.empty(max(width * (-(-dims // 4) * 4), 1), dtype=torch.float32,
                     device=dev)
    # the CSR of points by centroid (per-tile counts; count, start and
    # chunk start per centroid; the point ids) and the chunks' sums
    hist = torch.empty(max(nlist * -(-n // KMEANS_TILE), 1),
                       dtype=torch.int32, device=dev)
    lists = torch.empty(3 * nlist + 2, dtype=torch.int32, device=dev)
    order = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    partial = torch.empty((-(-n // KMEANS_CHUNK) + nlist) * dims,
                          dtype=torch.float32, device=dev)
    fn = _build.entry("kmeans_step", [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9)
    code = fn(_build.ptr(data), _build.ptr(centroids), n, nlist, dims,
              _build.ptr(cn), _build.ptr(ct), _build.ptr(hist),
              _build.ptr(lists), _build.ptr(order), _build.ptr(partial),
              _build.ptr(out), _build.ptr(assign), _build.stream_of(dev))
    _build.LAUNCHES["kmeans_step"] += 1
    _build.check("kmeans_step", code)
    return out, assign


def _kmeans(vectors: np.ndarray, nlist: int, iters: int = 10,
            seed: int = 17, device=None) -> np.ndarray:
    """Lloyd's k-means on `device` (the card unless the caller names
    another); returns the centroids. The initial centroids are the
    reference's: `nlist` rows drawn without replacement from
    np.random.RandomState(seed)."""
    dev = resolve_device(device)
    n = vectors.shape[0]
    rng = np.random.RandomState(seed)
    init = vectors[rng.choice(n, size=nlist, replace=False)]
    data = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    centroids = torch.from_numpy(
        np.ascontiguousarray(init, np.float32)).to(dev)
    for _ in range(iters):
        centroids, _assign = kmeans_step(data, centroids)
    return centroids.cpu().numpy()


def build_ivf(vectors: np.ndarray, exists: np.ndarray, nlist: int,
              nprobe: int = 0, iters: int = 10, seed: int = 17,
              device=None) -> IVFIndex:
    """Cluster the present vectors on `device` (K9); the final assignment
    and the block lists are host numpy, as in the reference, so equal
    centroids give equal lists."""
    present = np.nonzero(exists)[0].astype(np.int32)
    nlist = max(1, min(nlist, len(present)))
    data = vectors[present].astype(np.float32)
    centroids = _kmeans(data, nlist, iters=iters, seed=seed, device=device)
    dots = data @ centroids.T
    dn = (data ** 2).sum(axis=1, keepdims=True)
    cn = (centroids ** 2).sum(axis=1)
    assign = np.argmin(dn - 2 * dots + cn, axis=1)
    blocks = []
    block_centroid = []
    for c in range(nlist):
        members = present[assign == c]
        # an empty cluster emits no block: an all-padding block would still
        # take probe-budget slots from blocks with real candidates
        for off in range(0, len(members), IVF_BLOCK):
            chunk = members[off:off + IVF_BLOCK]
            row = np.full(IVF_BLOCK, -1, dtype=np.int32)
            row[:len(chunk)] = chunk
            blocks.append(row)
            block_centroid.append(c)
    if not blocks:          # no vectors at all: one padding block keeps
        blocks.append(np.full(IVF_BLOCK, -1, dtype=np.int32))
        block_centroid.append(0)        # the shapes valid for the scan
    lists = np.stack(blocks)
    if nprobe <= 0:
        nprobe = max(1, nlist // 8)
    return IVFIndex(centroids=centroids, lists=lists,
                    block_centroid=np.asarray(block_centroid, np.int32),
                    nlist=nlist, nprobe=nprobe)


def ivf_index_from(spec) -> Optional[IVFIndex]:
    """An IVFIndex from itself or from a dict of its fields (centroids,
    lists, block_centroid, nlist, nprobe), with the arrays' dtypes fixed;
    None stays None."""
    if spec is None or isinstance(spec, IVFIndex):
        return spec
    return IVFIndex(
        centroids=np.ascontiguousarray(spec["centroids"], np.float32),
        lists=np.ascontiguousarray(spec["lists"], np.int32),
        block_centroid=np.ascontiguousarray(spec["block_centroid"],
                                            np.int32),
        nlist=int(spec["nlist"]), nprobe=int(spec["nprobe"]))
