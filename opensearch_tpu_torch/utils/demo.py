"""Deterministic synthetic corpora for the port's tests and `chip_smoke.py`
(the port's own copy of opensearch_tpu.utils.demo's generators).

An msmarco-passage-shaped workload (zipfian vocabulary, ~60-token passages)
made from a seed: `synth_docs` draws the reference's exact random stream, so
one seed gives the same documents in both packages. `DEMO_MAPPING` and
`build_shards` index every field of those documents: `body` (text), `tag`
(keyword), `views` (integer) and `ts` (date).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import (FieldStats, Segment,
                                                SegmentBuilder, TermMeta,
                                                _hash64, _pad_to,
                                                segment_from_arrays,
                                                smallfloat_int_to_byte4)

DEMO_MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "views": {"type": "integer"},
        "ts": {"type": "date"},
    }
}


def _vocab(size: int) -> List[str]:
    return [f"w{i:05d}" for i in range(size)]


def synth_docs(n_docs: int, vocab_size: int = 5000, avg_len: int = 60,
               seed: int = 42) -> List[dict]:
    """Zipf-distributed token stream chunked into passages + structured
    fields (body, tag, views, ts), identical to the reference's."""
    rng = np.random.default_rng(seed)
    vocab = np.array(_vocab(vocab_size))
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    lens = np.maximum(8, rng.poisson(avg_len, n_docs))
    tags = [f"cat{i}" for i in range(16)]
    docs = []
    base_ts = 1700000000000  # 2023-11-14T22:13:20Z
    for i in range(n_docs):
        toks = rng.choice(vocab, size=int(lens[i]), p=probs)
        docs.append({
            "body": " ".join(toks.tolist()),
            "tag": tags[int(rng.integers(0, len(tags)))],
            "views": int(rng.integers(0, 10000)),
            "ts": int(base_ts + rng.integers(0, 90 * 86400_000)),
        })
    return docs


def build_shards(n_docs: int, n_shards: int = 1, vocab_size: int = 5000,
                 avg_len: int = 60, seed: int = 42,
                 mapper: Optional[MapperService] = None,
                 ) -> Tuple[MapperService, List[Segment]]:
    """Route synthetic docs round-robin into n_shards sealed segments."""
    mapper = mapper or MapperService(DEMO_MAPPING)
    docs = synth_docs(n_docs, vocab_size, avg_len, seed)
    builders = [SegmentBuilder(mapper, f"s{i}") for i in range(n_shards)]
    for i, d in enumerate(docs):
        builders[i % n_shards].add(mapper.parse_document(f"d{i}", d))
    return mapper, [b.seal() for b in builders]


# the structured fields of DEMO_MAPPING (every aggregation body reads only
# these)
STRUCTURED_MAPPING = {
    "properties": {
        "tag": {"type": "keyword"},
        "views": {"type": "integer"},
        "ts": {"type": "date"},
    }
}
BASE_TS = 1700000000000  # 2023-11-14T22:13:20Z, synth_docs' first instant
N_TAGS = 16


def structured_columns(n_docs: int, seed: int = 42):
    """Per-doc tag index, views and ts drawn from synth_docs'
    distributions (16 tags uniform, views uniform in [0, 10000), ts uniform
    over 90 days from BASE_TS), vectorized: int64 arrays of n_docs each."""
    rng = np.random.default_rng(seed)
    tag = rng.integers(0, N_TAGS, n_docs)
    views = rng.integers(0, 10000, n_docs)
    ts = BASE_TS + rng.integers(0, 90 * 86400_000, n_docs)
    return tag, views, ts


def structured_segment(n_docs: int, seed: int = 42, seg_id: str = "s0"
                       ) -> Tuple[MapperService, Segment]:
    """One sealed segment of n_docs docs with only the structured fields
    ({tag: keyword, views: integer, ts: date}, every doc one value of
    each), built from numpy columns through segment_from_arrays: the
    million-doc counterpart of sealing {"tag", "views", "ts"} documents
    one by one. No text field, so the postings are one empty block."""
    mapper = MapperService(STRUCTURED_MAPPING)
    tag, views, ts = structured_columns(n_docs, seed)
    names = [f"cat{i}" for i in range(N_TAGS)]
    dictionary = sorted(names)
    ord_of_tag = np.array([dictionary.index(t) for t in names], np.int32)
    docs = np.arange(n_docs, dtype=np.int32)
    ones = np.ones(n_docs, dtype=bool)

    def numeric(values):
        unique, ranks = np.unique(values.astype(np.float64),
                                  return_inverse=True)
        return {"doc_ids": docs, "values": values.astype(np.float64),
                "exists": ones, "counts": np.ones(n_docs, np.int32),
                "value_ords": ranks.astype(np.int32).reshape(-1),
                "unique": unique}
    arrays = {
        "seg_id": seg_id, "num_docs": n_docs,
        "doc_ids": [f"d{i}" for i in range(n_docs)],
        "sources": [None] * n_docs,
        "term_dict": {},
        "post_docs": np.full((1, 128), -1, np.int32),
        "post_tf": np.zeros((1, 128), np.float32),
        "norms": {}, "field_stats": {},
        "numeric_dv": {"views": numeric(views), "ts": numeric(ts)},
        "ordinal_dv": {"tag": {
            "doc_ids": docs, "ords": ord_of_tag[tag], "exists": ones,
            "dictionary": dictionary,
            "ord_hashes": np.array([_hash64(t) for t in dictionary],
                                   np.uint64)}},
    }
    return mapper, segment_from_arrays(arrays)


def query_terms(n_queries: int, vocab_size: int = 5000, seed: int = 7,
                terms_per_query: int = 2) -> List[str]:
    """Query strings from the mid-frequency band of the zipf vocabulary."""
    rng = np.random.default_rng(seed)
    lo, hi = vocab_size // 50, vocab_size // 2
    out = []
    for _ in range(n_queries):
        ids = rng.integers(lo, hi, size=terms_per_query)
        out.append(" ".join(f"w{i:05d}" for i in ids))
    return out


# SmallFloat encode table for vectorized norms (lengths are clipped below)
_SF_MAX_LEN = 1 << 16


def build_shards_fast(n_docs: int, n_shards: int = 1,
                      vocab_size: int = 20000, avg_len: int = 60,
                      seed: int = 42, materialize_terms: int = 128,
                      mapper: Optional[MapperService] = None,
                      ) -> Tuple[MapperService, List[Segment], List[str]]:
    """Sealed segments at million-doc scale without the per-doc parse loop:
    the same sealed layout as SegmentBuilder (sorted terms, 128-lane blocked
    CSR padded -1/0, SmallFloat norms, field stats), built from vectorized
    per-term sampling for `materialize_terms` mid-band zipf terms; every
    other term exists only through the doc lengths. Queries must draw from
    the returned terms (`fast_query_terms`). The random stream is the
    reference's, so one seed gives the same segments in both packages.
    Returns (mapper, segments, terms); docs round-robin over shards."""
    mapper = mapper or MapperService(DEMO_MAPPING)
    ranks_all = np.arange(1, vocab_size + 1, dtype=np.float64)
    h_v = float(np.sum(1.0 / ranks_all))
    lo, hi = max(vocab_size // 50, 1), max(vocab_size // 2, 2)
    m = min(materialize_terms, hi - lo)
    term_ranks = np.unique(np.linspace(lo, hi - 1, m).astype(np.int64))
    terms = [f"w{r:05d}" for r in term_ranks]
    sf = np.array([smallfloat_int_to_byte4(i) for i in range(_SF_MAX_LEN)],
                  dtype=np.uint8)

    segments: List[Segment] = []
    for s in range(n_shards):
        rng = np.random.default_rng(seed + 1000 * s)
        n = n_docs // n_shards + (1 if s < n_docs % n_shards else 0)
        lengths = np.maximum(8, rng.poisson(avg_len, n)).astype(np.int64)
        term_dict = {}
        rows_docs: List[np.ndarray] = []
        rows_tf: List[np.ndarray] = []
        next_block = 0
        sum_df = 0
        for rank, term in zip(term_ranks, terms):
            p = (1.0 / float(rank)) / h_v
            lam = avg_len * p
            keep = rng.random(n) < (1.0 - np.exp(-lam))
            ords = np.nonzero(keep)[0].astype(np.int32)
            tf = (1.0 + rng.poisson(lam, ords.size)).astype(np.float32)
            df = int(ords.size)
            if df == 0:
                continue
            padded = _pad_to(df, 128)
            docs_p = np.full(padded, -1, dtype=np.int32)
            tfs_p = np.zeros(padded, dtype=np.float32)
            docs_p[:df] = ords
            tfs_p[:df] = tf
            nb = padded // 128
            rows_docs.append(docs_p.reshape(nb, 128))
            rows_tf.append(tfs_p.reshape(nb, 128))
            term_dict[("body", term)] = TermMeta(
                doc_freq=df, total_term_freq=int(tf.sum()),
                start_block=next_block, num_blocks=nb)
            next_block += nb
            sum_df += df
        post_docs = np.concatenate(rows_docs, axis=0) if rows_docs \
            else np.full((1, 128), -1, dtype=np.int32)
        post_tf = np.concatenate(rows_tf, axis=0) if rows_tf \
            else np.zeros((1, 128), dtype=np.float32)
        lengths = np.minimum(lengths, _SF_MAX_LEN - 1)
        norms = {"body": sf[lengths]}
        stats = {"body": FieldStats(
            doc_count=n, sum_total_term_freq=int(lengths.sum()),
            sum_doc_freq=sum_df)}
        doc_ids = [f"d{s + i * n_shards}" for i in range(n)]
        segments.append(Segment(
            f"s{s}", n, doc_ids, [None] * n, term_dict,
            post_docs, post_tf, norms, stats))
    return mapper, segments, terms


def fast_query_terms(n_queries: int, terms: List[str], seed: int = 7,
                     terms_per_query: int = 2) -> List[str]:
    """Query strings over a fast corpus's materialized terms only."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_queries):
        ids = rng.integers(0, len(terms), size=terms_per_query)
        out.append(" ".join(terms[i] for i in ids))
    return out
