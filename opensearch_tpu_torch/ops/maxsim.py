"""Late-interaction MaxSim (the port's copy of opensearch_tpu.ops.maxsim):
the exact scan (K10, `maxsim_exact`) and the product-quantized scan (K11,
`maxsim_pq`: the ADC table `pq_lut` and the code scorer), each a CUDA
kernel with its plain PyTorch version, plus the host side of the seal-time
product quantization (`train_pq`, `encode_pq`, `decode_pq`).

ColBERT-style scoring: a doc stores one vector per token, a query brings
one vector per query token, and

    score(doc) = sum_t qmask[t] * max_s q_t . d_s

over query tokens t and the doc's real tokens s (s < token_count[doc]).
Padded doc lanes are -inf before the max; a doc with no tokens scores 0.
Query token matrices arrive padded to a power-of-two bucket with `qmask`
zeroing the padded lanes (search/compile.py).

- Exact: per-doc token matrices live as one padded f32 [Dp, T, dims]
  block.
- PQ: codes u8 [Dp, T, M] against a codebook f32 [M, 256, dsub]
  (dims = M * dsub). `pq_lut` builds lut[b, t, m, c] = codebook[m, c] .
  q[b, t, m-th subvector]; the scorer sums lut[b, t, m, codes[d, s, m]]
  over m, so decoded vectors never exist.

Every sum runs in a fixed order with one rounding per operation, in the
kernels and the plain versions alike: dot products in dim order, the
table sums in m order, the token sum in t order. So the kernels equal
their plain versions bit for bit, and a query's score does not depend on
the batch it rides in. The reference sums its dot products as blocked
matmuls, so its scores differ from the port's by a few ulps.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from opensearch_tpu_torch.ops import _build
from opensearch_tpu_torch.ops.knn import _check, knn_match_topk

# PQ geometry: 8-bit codes -> 256 centroids per subspace
PQ_CODES = 256
# the plain versions walk the docs in chunks whose [B, Tq, docs, T]
# intermediates stay near this many elements
_PLAIN_CHUNK_ELEMS = 1 << 26
# K10 takes token buckets up to MAX_T_BUCKET lanes and stages queries in
# tiles of MAXSIM_QUERY_TILE tokens (maxsim_exact.cu's MAX_T and NQ); K11
# keeps at least one query token's [M, 256] table in shared memory
MAX_T_BUCKET = 1024
MAXSIM_QUERY_TILE = 32
_SMEM_LIMIT = 232448
# K11's scorer: besides its table, a CTA's shared memory holds its docs'
# totals and token counts and a counter (maxsim_pq.cu TOTALS_BYTES; the
# kernel checks the group it is given against its own rule)
_PQ_TOTALS_BYTES = 1040


def pq_group(m: int, tq: int) -> int:
    """Query tokens K11's scorer stages at once: the widest G of 8, 4, 2,
    1 whose table [M, 256, G] f32 fits in a CTA's shared memory, and no
    wider than Tq needs."""
    for g in (8, 4, 2):
        if g // 2 < tq and m * PQ_CODES * 4 * g + _PQ_TOTALS_BYTES \
                <= _SMEM_LIMIT:
            return g
    return 1


def token_mask(token_count: torch.Tensor, t_bucket: int) -> torch.Tensor:
    """[D, T] bool: True for real token lanes (s < token_count[d])."""
    lanes = torch.arange(t_bucket, dtype=torch.int32,
                         device=token_count.device)
    return lanes[None, :] < token_count[:, None]


def _doc_chunk(bsz: int, tq: int, t_bucket: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMS // max(bsz * tq * t_bucket, 1))


def _masked_best(dots: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """max over the doc-token axis (last) of dots with padded lanes at
    -inf; a non-finite max (no tokens) becomes 0."""
    best = torch.where(real, dots, float("-inf")).amax(dim=-1)
    return torch.where(torch.isfinite(best), best, 0.0)


# ------------------------------------------------------------ exact (K10)

def exact_maxsim_scores_plain(tokens: torch.Tensor,
                              token_count: torch.Tensor,
                              query: torch.Tensor,
                              qmask: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: tokens f32 [Dp, T, dims], token_count i32
    [Dp], query f32 [B, Tq, dims], qmask f32 [B, Tq] -> f32 [B, Dp]."""
    d_pad, t_bucket, dims = tokens.shape
    bsz, tq, _ = query.shape
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=tokens.device)
    chunk = _doc_chunk(bsz, tq, t_bucket)
    for lo in range(0, d_pad, chunk):
        tok = tokens[lo:lo + chunk]
        n = tok.shape[0]
        dots = torch.zeros(bsz, tq, n, t_bucket, dtype=torch.float32,
                           device=tokens.device)
        for j in range(dims):
            dots = dots + query[:, :, j, None, None] * tok[None, None, :, :, j]
        best = _masked_best(dots, token_mask(token_count[lo:lo + n],
                                             t_bucket)[None, None])
        total = torch.zeros(bsz, n, dtype=torch.float32, device=tokens.device)
        for t in range(tq):
            total = total + best[:, t] * qmask[:, t, None]
        out[:, lo:lo + n] = total
    return out


def exact_maxsim_scores(tokens: torch.Tensor, token_count: torch.Tensor,
                        query: torch.Tensor,
                        qmask: torch.Tensor) -> torch.Tensor:
    """K10: the exact MaxSim score of every doc for each query, f32
    [B, Dp]. Replaces opensearch_tpu/ops/maxsim.py:exact_maxsim_scores
    (with _tiled_token_dots)."""
    if not tokens.is_cuda:
        return exact_maxsim_scores_plain(tokens, token_count, query, qmask)
    d_pad, t_bucket, dims = tokens.shape
    bsz, tq, _ = query.shape
    dev = tokens.device
    if not 0 < t_bucket <= MAX_T_BUCKET or dims <= 0:
        raise ValueError(f"maxsim_exact takes 1 <= T <= {MAX_T_BUCKET} "
                         f"token lanes and dims >= 1, got T={t_bucket}, "
                         f"dims={dims}")
    _check(((tokens, torch.float32, (d_pad, t_bucket, dims), "tokens"),
            (token_count, torch.int32, (d_pad,), "token_count"),
            (query, torch.float32, (bsz, tq, dims), "query"),
            (qmask, torch.float32, (bsz, tq), "qmask")), dev)
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    # the queries staged in tiles of MAXSIM_QUERY_TILE tokens, then the
    # carried maxima of each CTA the kernel runs (it says how many)
    ctas = ctypes.c_int(0)
    _build.check("maxsim_exact", _build.entry(
        "maxsim_exact_ctas", [ctypes.c_void_p],
        lib="maxsim_exact")(ctypes.byref(ctas)))
    tiles = bsz * -(-tq // MAXSIM_QUERY_TILE)
    scratch = torch.empty(tiles * MAXSIM_QUERY_TILE
                          * (-(-dims // 4) * 4 + 2 * ctas.value),
                          dtype=torch.float32, device=dev)
    fn = _build.entry("maxsim_exact", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
    code = fn(_build.ptr(tokens), _build.ptr(token_count), _build.ptr(query),
              _build.ptr(qmask), bsz, d_pad, t_bucket, tq, dims,
              _build.ptr(scratch), ctas.value, _build.ptr(out),
              _build.stream_of(dev))
    _build.LAUNCHES["maxsim_exact"] += 1
    _build.check("maxsim_exact", code)
    return out


# --------------------------------------------------------------- PQ (K11)

def pq_lut_plain(codebook: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Plain version of K11's `pq_lut`: codebook f32 [M, 256, dsub], query
    f32 [B, Tq, M * dsub] -> lut f32 [B, Tq, M, 256], each entry summed in
    subvector order."""
    m, codes, dsub = codebook.shape
    bsz, tq, _ = query.shape
    qsub = query.reshape(bsz, tq, m, dsub)
    lut = torch.zeros(bsz, tq, m, codes, dtype=torch.float32,
                      device=query.device)
    for j in range(dsub):
        lut = lut + codebook[None, None, :, :, j] * qsub[:, :, :, None, j]
    return lut


def pq_lut(codebook: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """K11's first entry: the ADC lookup table of every query token, f32
    [B, Tq, M, 256]. Replaces opensearch_tpu/ops/maxsim.py:pq_lut."""
    if not query.is_cuda:
        return pq_lut_plain(codebook, query)
    m, codes, dsub = codebook.shape
    bsz, tq, dims = query.shape
    dev = query.device
    if codes != PQ_CODES or m * dsub != dims or dsub <= 0:
        raise ValueError(f"pq_lut takes a [M, {PQ_CODES}, dsub] codebook "
                         f"with M * dsub = dims, got {tuple(codebook.shape)} "
                         f"for dims {dims}")
    _check(((codebook, torch.float32, (m, codes, dsub), "codebook"),
            (query, torch.float32, (bsz, tq, dims), "query")), dev)
    lut = torch.empty(bsz, tq, m, codes, dtype=torch.float32, device=dev)
    fn = _build.entry("pq_lut", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 2, lib="maxsim_pq")
    code = fn(_build.ptr(codebook), _build.ptr(query), bsz * tq, m, dsub,
              _build.ptr(lut), _build.stream_of(dev))
    _build.LAUNCHES["pq_lut"] += 1
    _build.check("pq_lut", code, lib="maxsim_pq")
    return lut


def pq_maxsim_from_lut_plain(codes: torch.Tensor, lut: torch.Tensor,
                             token_count: torch.Tensor,
                             qmask: torch.Tensor) -> torch.Tensor:
    """Plain version of K11's scorer: codes u8 [Dp, T, M], lut f32
    [B, Tq, M, 256], token_count i32 [Dp], qmask f32 [B, Tq] -> f32
    [B, Dp]."""
    d_pad, t_bucket, m = codes.shape
    bsz, tq = qmask.shape
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=codes.device)
    chunk = _doc_chunk(bsz, 1, t_bucket)
    for lo in range(0, d_pad, chunk):
        idx = codes[lo:lo + chunk].long()
        n = idx.shape[0]
        real = token_mask(token_count[lo:lo + n], t_bucket)[None]
        total = torch.zeros(bsz, n, dtype=torch.float32, device=codes.device)
        for t in range(tq):
            dots = torch.zeros(bsz, n, t_bucket, dtype=torch.float32,
                               device=codes.device)
            for sub in range(m):
                dots = dots + lut[:, t, sub][:, idx[:, :, sub]]
            total = total + _masked_best(dots, real) * qmask[:, t, None]
        out[:, lo:lo + n] = total
    return out


def pq_maxsim_from_lut(codes: torch.Tensor, lut: torch.Tensor,
                       token_count: torch.Tensor,
                       qmask: torch.Tensor) -> torch.Tensor:
    """K11's second entry, `maxsim_pq`: every doc's PQ MaxSim score from
    its codes by table gather, f32 [B, Dp]. The kernel walks the query
    tokens in groups of `pq_group(M, Tq)`, ascending."""
    if not codes.is_cuda:
        return pq_maxsim_from_lut_plain(codes, lut, token_count, qmask)
    d_pad, t_bucket, m = codes.shape
    bsz, tq = qmask.shape
    dev = codes.device
    table = m * PQ_CODES * 4 + _PQ_TOTALS_BYTES
    if table > _SMEM_LIMIT or t_bucket <= 0:
        raise ValueError(f"maxsim_pq keeps one query token's [M, 256] "
                         f"table in shared memory: M={m} needs {table} "
                         f"bytes, more than {_SMEM_LIMIT}")
    _check(((codes, torch.uint8, (d_pad, t_bucket, m), "codes"),
            (lut, torch.float32, (bsz, tq, m, PQ_CODES), "lut"),
            (token_count, torch.int32, (d_pad,), "token_count"),
            (qmask, torch.float32, (bsz, tq), "qmask")), dev)
    out = torch.empty(bsz, d_pad, dtype=torch.float32, device=dev)
    fn = _build.entry("maxsim_pq", [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    code = fn(_build.ptr(codes), _build.ptr(lut), _build.ptr(token_count),
              _build.ptr(qmask), bsz, d_pad, t_bucket, tq, m,
              pq_group(m, tq), _build.ptr(out), _build.stream_of(dev))
    _build.LAUNCHES["maxsim_pq"] += 1
    _build.check("maxsim_pq", code)
    return out


def pq_maxsim_scores(codes: torch.Tensor, codebook: torch.Tensor,
                     token_count: torch.Tensor, query: torch.Tensor,
                     qmask: torch.Tensor) -> torch.Tensor:
    """K11: PQ MaxSim, f32 [B, Dp]: the table (`pq_lut`), then the code
    scorer. Replaces opensearch_tpu/ops/maxsim.py:pq_maxsim_scores."""
    return pq_maxsim_from_lut(codes, pq_lut(codebook, query), token_count,
                              qmask)


def maxsim_match_topk(scores: torch.Tensor, eligible: torch.Tensor,
                      live: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k epilogue, identical to ops/knn.knn_match_topk (K3 and the
    mark), so the page treats maxsim matches like a knn node's."""
    return knn_match_topk(scores, eligible, live, k)


# ------------------------------------------------------- seal-time PQ ----

def train_pq(vectors: np.ndarray, m: int, iters: int = 8,
             seed: int = 29) -> np.ndarray:
    """Per-subspace k-means codebook [m, 256, dsub] over the segment's
    token vectors (host, at seal). Fewer distinct tokens than 256 leaves
    the tail centroids zero: codes never reference them."""
    n, dims = vectors.shape
    dsub = dims // m
    codebook = np.zeros((m, PQ_CODES, dsub), dtype=np.float32)
    if n == 0:
        return codebook
    rng = np.random.RandomState(seed)
    data = vectors.astype(np.float32).reshape(n, m, dsub)
    for sub in range(m):
        x = data[:, sub, :]
        ncent = min(PQ_CODES, n)
        cent = x[rng.choice(n, size=ncent, replace=False)].copy()
        for _ in range(iters):
            d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
            assign = np.argmin(d2, axis=1)
            for c in range(ncent):
                members = x[assign == c]
                if len(members):
                    cent[c] = members.mean(axis=0)
        codebook[sub, :ncent] = cent
    return codebook


def encode_pq(vectors: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """[N, dims] -> [N, M] uint8 nearest-centroid codes (host, at seal)."""
    n = vectors.shape[0]
    m, _, dsub = codebook.shape
    if n == 0:
        return np.zeros((0, m), dtype=np.uint8)
    data = vectors.astype(np.float32).reshape(n, m, dsub)
    codes = np.zeros((n, m), dtype=np.uint8)
    for sub in range(m):
        x = data[:, sub, :]
        cent = codebook[sub]
        d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2)
        codes[:, sub] = np.argmin(d2, axis=1).astype(np.uint8)
    return codes


def decode_pq(codes: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """[N, M] codes -> [N, dims] reconstructed vectors (host-side checks
    only: no kernel decodes)."""
    n, m = codes.shape
    dsub = codebook.shape[2]
    out = np.zeros((n, m * dsub), dtype=np.float32)
    for sub in range(m):
        out[:, sub * dsub:(sub + 1) * dsub] = codebook[sub][codes[:, sub]]
    return out
