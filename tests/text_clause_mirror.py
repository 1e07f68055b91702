"""K2 `score_text_clause`'s schedule in numpy (ops/csrc/score_text_clause.cu):
the tests hold it bit for bit against the plain version, so that the
kernel's order of additions is checked on the CPU too.

1. Buckets: for every real, kept lane (q, j), the least and greatest doc
   of its block in [0, Dp) name a range of chunks of CHUNK docs; bit j is
   set in the bitmap of each. A chunk's set bits in word order are its
   blocks in ascending j.
2. Per (query, chunk): the listed blocks are staged (chunk offset and f32
   partial per lane, the kernel's rounding order) and added to the chunk's
   sums in list order, one block at a time; within a block the lanes hit
   distinct docs.
"""

import numpy as np

CHUNK = 8192   # 2^ops/bm25.py TEXT_CLAUSE_CHUNK_LOG


def chunk_bitmap(ids, keep, post_docs, d_pad, chunk=CHUNK):
    """bits u32 [B, n_chunks, ceil(QB / 32)] as the bucket kernel sets
    them."""
    bsz, qb = ids.shape
    nb = post_docs.shape[0]
    n_chunks = -(-d_pad // chunk)
    bits = np.zeros((bsz, n_chunks, -(-qb // 32)), np.uint32)
    for q in range(bsz):
        for j in range(qb):
            bid = int(ids[q, j])
            if bid < 0 or bid >= nb or (keep is not None and not keep[q, j]):
                continue
            docs = post_docs[bid]
            docs = docs[(docs >= 0) & (docs < d_pad)]
            if docs.size == 0:
                continue
            bits[q, docs.min() // chunk:docs.max() // chunk + 1, j // 32] |= \
                np.uint32(1 << (j % 32))
    return bits


def chunk_list(words):
    """A chunk's bitmap row -> its lanes j in ascending order."""
    return [32 * wi + b for wi, word in enumerate(words) for b in range(32)
            if (int(word) >> b) & 1]


def text_clause_mirror(ids, keep, w, row, avgdl, b, k1, post_docs, post_tf,
                       norms, length_table, d_pad, chunk=CHUNK):
    """scores f32 [B, Dp] and hits i32 [B, Dp] in the kernel's order."""
    f32 = np.float32
    bsz = ids.shape[0]
    bits = chunk_bitmap(ids, keep, post_docs, d_pad, chunk)
    scores = np.zeros((bsz, d_pad), f32)
    hits = np.zeros((bsz, d_pad), np.int32)
    for q in range(bsz):
        bq, aq, kq = f32(b[q]), f32(avgdl[q]), f32(k1[q])
        k1p1 = kq + f32(1.0)
        one_minus_b = f32(1.0) - bq
        for c in range(bits.shape[1]):
            d0, d1 = c * chunk, min((c + 1) * chunk, d_pad)
            sums = np.zeros(chunk, f32)
            cnt = np.zeros(chunk, np.int32)
            for j in chunk_list(bits[q, c]):       # list order
                bid = ids[q, j]
                docs = post_docs[bid]
                inr = (docs >= d0) & (docs < d1)
                tf = post_tf[bid][inr]
                dl = length_table[norms[row[q], docs[inr]]]
                cc = one_minus_b + (bq * dl) / aq
                part = ((f32(w[q, j]) * tf) * k1p1) / (tf + kq * cc)
                off = docs[inr] - d0
                assert np.unique(off).size == off.size   # distinct docs
                sums[off] += part
                cnt[off] += 1
            scores[q, d0:d1] = sums[:d1 - d0]
            hits[q, d0:d1] = cnt[:d1 - d0]
    return scores, hits


# ------------------------------------------------ edge shapes for the tests

EDGE_CASES = ["three_chunks", "keep", "dp_off_chunk", "many_blocks"]


def _image(d_pad, term_docs, n_rows=2, seed=0):
    """A posting image from each term's sorted doc list (blocks of 128,
    -1 padded), random tfs, norms and length table."""
    rng = np.random.default_rng(seed)
    blocks, starts = [], []
    for docs in term_docs:
        docs = np.asarray(sorted(docs), np.int32)
        n = -(-len(docs) // 128)
        starts.append((len(blocks), n))
        padded = np.full(n * 128, -1, np.int32)
        padded[:len(docs)] = docs
        blocks.extend(padded.reshape(n, 128))
    post_docs = np.stack(blocks)
    post_tf = np.where(post_docs >= 0,
                       rng.integers(1, 6, post_docs.shape), 0).astype(
                           np.float32)
    norms = rng.integers(0, 256, (n_rows, d_pad)).astype(np.int32)
    length_table = (rng.random(256) * 40 + 1).astype(np.float32)
    return post_docs, post_tf, norms, length_table, starts


def edge_case(name):
    """(d_pad, the image, blk arrays, keep or None) of one edge case."""
    rng = np.random.default_rng(len(name))
    chunk = CHUNK
    if name == "dp_off_chunk":
        d_pad = 3 * chunk + 640
    else:
        d_pad = 3 * chunk
    terms = [
        [100, chunk + 5, 2 * chunk + 9],                   # spans 3 chunks
        rng.choice(d_pad, 300, replace=False),             # 3 blocks
        rng.choice(d_pad, 40, replace=False),              # a partial block
        np.arange(0, d_pad, 17),                           # a head term
        rng.choice(d_pad, 129, replace=False),             # one doc past
    ]
    if name == "many_blocks":       # 1,100 one-block terms: two windows
        terms = [rng.choice(d_pad, 1 + i % 3, replace=False)
                 for i in range(1100)]                     # of 1,024 lanes
    common = chunk + 1                                     # every term
    terms = [sorted(set(int(d) for d in t) | {common}) for t in terms]
    post_docs, post_tf, norms, lt, starts = _image(d_pad, terms)
    bsz = 3
    lanes = [j for s, n in starts for j in range(s, s + n)]
    qb = len(lanes) + 5                 # not a multiple of 128: padding
    ids = np.full((bsz, qb), -1, np.int32)
    for q in range(bsz):
        order = lanes if q != 1 else lanes[::-1]           # another order
        ids[q, :len(order)] = order
    ids[2, 3] = -1                                         # a padded lane
    w = (rng.random((bsz, qb)) * 3 + 0.5).astype(np.float32)
    keep = None
    if name == "keep":
        keep = rng.random((bsz, qb)) < 0.6
    blk = {"ids": ids, "w": w,
           "row": np.array([0, 1, 0], np.int32),
           "avgdl": np.array([12.5, 7.25, 30.0], np.float32),
           "b": np.array([0.75, 0.0, 0.4], np.float32),
           "k1": np.array([1.2, 1.2, 2.0], np.float32)}
    return d_pad, (post_docs, post_tf, norms, lt), blk, keep
