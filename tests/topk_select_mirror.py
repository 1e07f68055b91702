"""A numpy mirror of the masked top-k family's radix select
(opensearch_tpu_torch/ops/csrc/masked_topk.cu), pass by pass: the 64-bit
lane keys, the six digits (five of 11 bits, the last of 9), the bin fixed
after each pass and the overflow rule; the candidate buffer's room is
ops/topk.py's select_buffer_room. The CPU tests hold its winners against
the plain versions; the card tests hold the kernels' full-read counts
against its count."""

import numpy as np

DIGITS = 6
NEG_INF_ORD = 0x007FFFFF  # ord_key(-inf)


def ord_keys(values: np.ndarray) -> np.ndarray:
    """The order-preserving u32 of f32 values (lax.top_k's total order)."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32)
    return np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(
        np.uint32)


def lane_keys(values: np.ndarray, eligible: np.ndarray) -> np.ndarray:
    """u64 key per lane of one row: ord(value, or -inf where ineligible)
    << 32 | ~index."""
    masked = np.where(eligible, values, np.float32(-np.inf)).astype(
        np.float32)
    idx = np.arange(values.shape[-1], dtype=np.uint64)
    return (ord_keys(masked).astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - idx)


def key_index(keys: np.ndarray) -> np.ndarray:
    """The lane index a key carries in its low 32 bits (~index)."""
    return (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF))).astype(
        np.int64)


def _digit(keys: np.ndarray, p: int) -> np.ndarray:
    shift, bins = (53 - 11 * p, 2048) if p < 5 else (0, 512)
    return ((keys >> np.uint64(shift)) & np.uint64(bins - 1)).astype(
        np.int64), bins


def select(keys: np.ndarray, k: int, room: int, threshold: bool = False):
    """One row's select: (the winners' keys, the passes that read the
    whole input). Pass p + 1 reads the keys of the bin pass p fixed: the
    input for pass 1 and wherever that bin held more than `room` keys
    (select_buffer_room)."""
    if k == 0:
        return keys[:0], 1
    reads = 1                  # pass 0
    cur, cur_buffered = keys, False
    krem = k
    winners = []
    for p in range(DIGITS):
        d, bins = _digit(cur, p)
        counts = np.bincount(d, minlength=bins)
        above = np.cumsum(counts[::-1])
        # the bin holding the krem-th key from the top
        b = bins - 1 - int(np.searchsorted(above, krem))
        cum = int(above[bins - 2 - b]) if b < bins - 1 else 0
        cnt = int(counts[b])
        krem -= cum
        take = cnt == krem or (threshold and p == 0 and b <= 3)
        reads += not cur_buffered          # pass p + 1 reads cur
        winners.append(cur[d > b])
        if take:
            winners.append(cur[d == b])
            break
        cur, cur_buffered = cur[d == b], cnt <= room
    return np.concatenate(winners), reads


def markable(keys: np.ndarray) -> np.ndarray:
    """The threshold entry marks a winner whose masked value is finite."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    vals = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(
        np.uint32).view(np.float32)
    return vals > -np.inf
