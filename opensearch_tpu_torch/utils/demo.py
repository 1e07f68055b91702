"""Deterministic synthetic corpora for the port's tests and `chip_smoke.py`
(the port's own copy of opensearch_tpu.utils.demo's generators).

An msmarco-passage-shaped workload (zipfian vocabulary, ~60-token passages)
made from a seed: `synth_docs` draws the reference's exact random stream, so
one seed gives the same documents in both packages. `DEMO_MAPPING` and
`build_shards` index every field of those documents: `body` (text), `tag`
(keyword), `views` (integer) and `ts` (date). `clustered_vectors` draws
the clustered k-NN corpus of the reference's k-NN benchmark (the same
random stream), and `vector_segment` seals such vectors into a one-field
shard at million-vector scale; `add_vector_field` puts such a column on a
`build_shards_fast` segment (the hybrid corpus), and `add_numeric_field`
a numeric or date doc-value column (the relevance cell's `likes` and
`published`, from `relevance_columns`, searched by
`relevance_bodies`' function_score / script_score / distance_feature /
boosting families). `clustered_tokens` draws
ColBERT-shaped token matrices (unit vectors around clustered centers) and
`rank_vectors_segment` seals them into a one-field `rank_vectors` shard.
`qa_segment` builds StackOverflow-shaped questions with nested answers
(the nested cell) and `geonames_segment` GeoNames-shaped places with a
geo_point, a rank_feature and a country code (the geo cell).
`http_logs_docs` draws web-server log lines after rally-tracks'
`http_logs` (the ingest cell's documents, written through `_bulk`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import (FieldStats, Segment,
                                                SegmentBuilder, TermMeta,
                                                DocValuesColumn, _hash64,
                                                _pad_to, _vector_column,
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


def _structured_arrays(tag, views, ts, lo: int, hi: int,
                       seg_id: str) -> dict:
    """segment_from_arrays' input for docs lo..hi of structured columns
    (every doc one value of each field; `_id`s d{lo}..d{hi - 1})."""
    n_docs = hi - lo
    names = [f"cat{i}" for i in range(N_TAGS)]
    dictionary = sorted(names)
    ord_of_tag = np.array([dictionary.index(t) for t in names], np.int32)
    docs = np.arange(n_docs, dtype=np.int32)
    ones = np.ones(n_docs, dtype=bool)

    def numeric(values):
        values = values[lo:hi]
        unique, ranks = np.unique(values.astype(np.float64),
                                  return_inverse=True)
        return {"doc_ids": docs, "values": values.astype(np.float64),
                "exists": ones, "counts": np.ones(n_docs, np.int32),
                "value_ords": ranks.astype(np.int32).reshape(-1),
                "unique": unique}
    return {
        "seg_id": seg_id, "num_docs": n_docs,
        "doc_ids": [f"d{i}" for i in range(lo, hi)],
        "sources": [None] * n_docs,
        "term_dict": {},
        "post_docs": np.full((1, 128), -1, np.int32),
        "post_tf": np.zeros((1, 128), np.float32),
        "norms": {}, "field_stats": {},
        "numeric_dv": {"views": numeric(views), "ts": numeric(ts)},
        "ordinal_dv": {"tag": {
            "doc_ids": docs, "ords": ord_of_tag[tag[lo:hi]], "exists": ones,
            "dictionary": dictionary,
            "ord_hashes": np.array([_hash64(t) for t in dictionary],
                                   np.uint64)}},
    }


def structured_segment(n_docs: int, seed: int = 42, seg_id: str = "s0"
                       ) -> Tuple[MapperService, Segment]:
    """One sealed segment of n_docs docs with only the structured fields
    ({tag: keyword, views: integer, ts: date}, every doc one value of
    each), built from numpy columns through segment_from_arrays: the
    million-doc counterpart of sealing {"tag", "views", "ts"} documents
    one by one. No text field, so the postings are one empty block."""
    mapper = MapperService(STRUCTURED_MAPPING)
    tag, views, ts = structured_columns(n_docs, seed)
    return mapper, segment_from_arrays(
        _structured_arrays(tag, views, ts, 0, n_docs, seg_id))


def structured_segments(n_docs: int, n_segments: int, seed: int = 42
                        ) -> Tuple[MapperService, List[Segment]]:
    """The docs of structured_segment(n_docs, seed), the same columns and
    `_id`s, split in doc order into n_segments segments: (segment, doc)
    order is then the single segment's doc order, so ties break alike."""
    mapper = MapperService(STRUCTURED_MAPPING)
    tag, views, ts = structured_columns(n_docs, seed)
    bounds = np.linspace(0, n_docs, n_segments + 1).astype(int)
    return mapper, [segment_from_arrays(_structured_arrays(
        tag, views, ts, int(lo), int(hi), f"s{i}"))
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


# structured_segment's fields plus two of nyc_taxis' shapes: a float fare
# (in cents) that ~2% of docs lack and a small integer passenger count
TAXI_MAPPING = {
    "properties": {
        **STRUCTURED_MAPPING["properties"],
        "fare": {"type": "float"},
        "passengers": {"type": "integer"},
    }
}
FARE_MISSING = 0.02


def taxi_columns(n_docs: int, seed: int = 42):
    """structured_columns(n_docs, seed)'s tag / views / ts, then `fare` in
    cents (lognormal, median 1,000 = $10, whole cents capped at 50,000,
    so at most ~50,000 distinct values; NaN for the ~2% of docs without
    one) and `passengers` uniform in 1..6: int64 / float64 arrays."""
    tag, views, ts = structured_columns(n_docs, seed)
    rng = np.random.default_rng(seed + 1)
    fare = np.minimum(np.rint(np.exp(rng.normal(np.log(1000.0), 0.7,
                                                n_docs))), 50_000.0)
    fare = np.maximum(fare, 1.0)
    fare[rng.random(n_docs) < FARE_MISSING] = np.nan
    passengers = rng.integers(1, 7, n_docs)
    return tag, views, ts, fare, passengers


def taxi_docs(n_docs: int, seed: int = 42) -> List[dict]:
    """taxi_columns as `_source` documents (a doc without a fare has no
    `fare` key), for indexing through the REST surface."""
    tag, views, ts, fare, passengers = taxi_columns(n_docs, seed)
    out = []
    for i in range(n_docs):
        d = {"tag": f"cat{int(tag[i])}", "views": int(views[i]),
             "ts": int(ts[i]), "passengers": int(passengers[i])}
        if not np.isnan(fare[i]):
            d["fare"] = float(fare[i])
        out.append(d)
    return out


def taxi_segment(n_docs: int, seed: int = 42, seg_id: str = "s0"
                 ) -> Tuple[MapperService, Segment]:
    """One sealed segment of taxi_columns(n_docs, seed) with TAXI_MAPPING,
    built from numpy columns like structured_segment (whose tag / views /
    ts columns it shares): the 10M-doc counterpart of indexing
    taxi_docs."""
    mapper = MapperService(TAXI_MAPPING)
    tag, views, ts, fare, passengers = taxi_columns(n_docs, seed)
    arrays = _structured_arrays(tag, views, ts, 0, n_docs, seg_id)
    has = ~np.isnan(fare)
    docs = np.nonzero(has)[0].astype(np.int32)
    unique, ranks = np.unique(fare[has], return_inverse=True)
    arrays["numeric_dv"]["fare"] = {
        "doc_ids": docs, "values": fare[has], "exists": has,
        "counts": has.astype(np.int32),
        "value_ords": ranks.astype(np.int32).reshape(-1), "unique": unique}
    unique, ranks = np.unique(passengers.astype(np.float64),
                              return_inverse=True)
    arrays["numeric_dv"]["passengers"] = {
        "doc_ids": np.arange(n_docs, dtype=np.int32),
        "values": passengers.astype(np.float64),
        "exists": np.ones(n_docs, dtype=bool),
        "counts": np.ones(n_docs, np.int32),
        "value_ords": ranks.astype(np.int32).reshape(-1), "unique": unique}
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


def clustered_vectors(n: int, dims: int, n_centers: int = 256,
                      seed: int = 11, n_queries: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A clustered vector corpus (SIFT / GloVe-like local structure):
    f32 [n, dims] points around n_centers Gaussian centers (scale 4, unit
    noise), then f32 [n_queries, dims] queries drawn the same way from the
    same np.random.RandomState stream, after the corpus. The reference's
    k-NN benchmark draws exactly this stream."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, dims).astype(np.float32) * 4
    assign = rng.randint(0, n_centers, size=n)
    vectors = centers[assign] + rng.randn(n, dims).astype(np.float32)
    queries = (centers[rng.randint(0, n_centers, size=n_queries)]
               + rng.randn(n_queries, dims).astype(np.float32))
    return vectors, queries


def vector_segment(vectors: np.ndarray, space: str = "l2", ivf=None,
                   field: str = "vec", seg_id: str = "v0"
                   ) -> Tuple[MapperService, Segment]:
    """One shard holding `vectors` (f32 [n, dims]) as the knn_vector field
    `field` of docs d0..d{n-1}, sealed through segment_from_arrays without
    the per-doc parse loop and with `_source` off. Given an IVF index (an
    IVFIndex), the field maps as an `ivf` method with its nlist and
    nprobes and carries that index; otherwise it is exact."""
    n, dims = vectors.shape
    method_spec = {"space_type": space}
    if ivf is not None:
        method_spec = {"name": "ivf", "space_type": space,
                       "parameters": {"nlist": ivf.nlist,
                                      "nprobes": ivf.nprobe}}
    mapper = MapperService({"properties": {field: {
        "type": "knn_vector", "dimension": dims, "method": method_spec}}})
    arrays = {
        "seg_id": seg_id, "num_docs": n,
        "doc_ids": [f"d{i}" for i in range(n)], "sources": [None] * n,
        "term_dict": {},
        "post_docs": np.full((1, 128), -1, np.int32),
        "post_tf": np.zeros((1, 128), np.float32),
        "norms": {}, "field_stats": {},
        "vector_dv": {field: {"vectors": vectors,
                              "exists": np.ones(n, dtype=bool),
                              "ivf": ivf}},
    }
    return mapper, segment_from_arrays(arrays)


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


def add_vector_field(mapper: MapperService, seg: Segment, vectors: np.ndarray,
                     field: str = "vec", space: str = "l2") -> None:
    """Give every doc of a sealed segment the f32 [num_docs, dims] row of
    `vectors` as an exact knn_vector field `field` (mapped on `mapper`):
    the vector column a segment of `build_shards_fast` lacks."""
    n, dims = vectors.shape
    mapper.merge({"properties": {field: {
        "type": "knn_vector", "dimension": dims,
        "method": {"space_type": space}}}})
    seg.vector_dv[field] = _vector_column(
        field, {"vectors": vectors, "exists": np.ones(n, dtype=bool)},
        seg.num_docs)


def add_numeric_field(mapper: MapperService, seg: Segment, field: str,
                      ftype: str, values: np.ndarray) -> None:
    """Give a sealed segment the doc-value column `field` of type `ftype`
    (a numeric type or `date`, mapped on `mapper`): one value per doc from
    the f64 [num_docs] `values`, NaN where the doc has none (dates in
    epoch millis) - the numeric column a segment of `build_shards_fast`
    lacks."""
    mapper.merge({"properties": {field: {"type": ftype}}})
    values = np.asarray(values, dtype=np.float64)
    if values.shape != (seg.num_docs,):
        raise ValueError(f"[{field}] needs one value per doc: "
                         f"{seg.num_docs}, got {values.shape}")
    exists = ~np.isnan(values)
    docs = np.nonzero(exists)[0].astype(np.int32)
    vals = values[exists]
    unique, ranks = np.unique(vals, return_inverse=True)
    seg.numeric_dv[field] = DocValuesColumn(
        doc_ids=docs, values=vals, exists=exists,
        counts=exists.astype(np.int32),
        value_ords=ranks.astype(np.int32).reshape(-1), unique=unique)


# the relevance cell's columns: `likes` a long, lognormal with median 40,
# capped at 10^6, absent on 5% of docs; `published` a date, uniform over
# 2019-01-01 .. 2024-12-31
RELEVANCE_LIKES_MISSING = 0.05
RELEVANCE_PUBLISHED = (1546300800000, 1735689600000)
RELEVANCE_ORIGIN = "2024-06-01"
RELEVANCE_FAMILIES = ("fvf_log1p", "gauss_date", "three_functions",
                      "script_score", "distance_feature", "boosting")


def relevance_columns(n_docs: int, seed: int = 42
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(likes, published) f64 [n_docs] each, NaN where a doc has no
    likes, drawn 65,536 docs at a time."""
    rng = np.random.default_rng(seed)
    likes = np.empty(n_docs)
    published = np.empty(n_docs)
    for lo in range(0, n_docs, 1 << 16):
        n = min(1 << 16, n_docs - lo)
        part = np.minimum(np.floor(rng.lognormal(np.log(40.0), 1.5, n)),
                          1e6)
        part[rng.random(n) < RELEVANCE_LIKES_MISSING] = np.nan
        likes[lo:lo + n] = part
        published[lo:lo + n] = rng.integers(*RELEVANCE_PUBLISHED, n)
    return likes, published


def relevance_bodies(family: str, n: int, terms: List[str],
                     seed: int = 0) -> List[dict]:
    """n `_search` bodies of one relevance family over `fast_query_terms`
    texts of 2-4 terms, after the OpenSearch documentation's
    function_score and script_score examples: `fvf_log1p`
    (field_value_factor on likes, log1p, factor 1.2, missing 1),
    `gauss_date` (gauss on published: origin 2024-06-01, scale 30d,
    offset 7d, decay 0.5), `three_functions` (a weight of 2 on likes >=
    1000, random_score, exp on published; sum / sum, max_boost 10,
    min_score 5), `script_score` (_score * Math.log(2 + likes) over a bool
    requiring likes), `distance_feature` (published, pivot 7d, a should
    beside the match) and `boosting` (negative_boost 0.5 on a second
    term)."""
    texts = []
    for k in (2, 3, 4):
        texts += fast_query_terms(n // 3 + 1, terms, seed=seed * 10 + k,
                                  terms_per_query=k)
    rng = np.random.default_rng(seed)
    texts = [texts[i] for i in rng.permutation(len(texts))[:n]]
    others = fast_query_terms(n, terms, seed=seed * 10 + 9,
                              terms_per_query=1)
    out = []
    for i, text in enumerate(texts):
        match = {"match": {"body": text}}
        if family == "fvf_log1p":
            q = {"function_score": {"query": match, "field_value_factor": {
                "field": "likes", "factor": 1.2, "modifier": "log1p",
                "missing": 1}}}
        elif family == "gauss_date":
            q = {"function_score": {"query": match, "gauss": {"published": {
                "origin": RELEVANCE_ORIGIN, "scale": "30d",
                "offset": "7d", "decay": 0.5}}}}
        elif family == "three_functions":
            q = {"function_score": {
                "query": match,
                "functions": [
                    {"filter": {"range": {"likes": {"gte": 1000}}},
                     "weight": 2},
                    {"random_score": {"seed": 1000 + i}},
                    {"exp": {"published": {"origin": RELEVANCE_ORIGIN,
                                           "scale": "60d"}}}],
                "score_mode": "sum", "boost_mode": "sum",
                "max_boost": 10, "min_score": 5}}
        elif family == "script_score":
            q = {"script_score": {
                "query": {"bool": {"must": [match], "filter": [
                    {"exists": {"field": "likes"}}]}},
                "script": {"source":
                           "_score * Math.log(2 + doc['likes'].value)"}}}
        elif family == "distance_feature":
            q = {"bool": {"must": [match], "should": [
                {"distance_feature": {"field": "published",
                                      "origin": RELEVANCE_ORIGIN,
                                      "pivot": "7d"}}]}}
        elif family == "boosting":
            q = {"boosting": {"positive": match,
                              "negative": {"match": {"body": others[i]}},
                              "negative_boost": 0.5}}
        else:
            raise ValueError(f"unknown relevance family [{family}]")
        out.append({"query": q, "size": 10})
    return out


def clustered_tokens(n_docs: int, dims: int, min_tokens: int,
                     max_tokens: int, n_centers: int = 1024,
                     noise: float = 0.5, seed: int = 5, n_queries: int = 0,
                     query_tokens: int = 32, device="cpu"):
    """ColBERT-shaped late-interaction data: per doc a [T, dims] f32 token
    matrix (T = pad_bucket(max_tokens, minimum=8)) holding a uniform
    min_tokens..max_tokens real tokens, zero past them; every token is a
    unit vector around one of n_centers clustered unit centers (a center
    plus `noise`-scaled Gaussian noise, normalized), as ColBERT's
    normalized embeddings are. Then [n_queries, query_tokens, dims]
    queries drawn the same way. Returns numpy (tokens, token_count int32,
    queries). Drawn with torch on `device` from a generator seeded with
    `seed` (a seed gives the same data on every run on one device type),
    8,192 docs at a time."""
    import torch
    from opensearch_tpu_torch.index.segment import pad_bucket
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t_bucket = pad_bucket(max_tokens, minimum=8)
    centers = torch.randn(n_centers, dims, generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)
    token_count = torch.randint(min_tokens, max_tokens + 1, (n_docs,),
                                generator=gen, device=dev,
                                dtype=torch.int32)

    def draw(shape):
        x = centers[torch.randint(0, n_centers, shape, generator=gen,
                                  device=dev)]
        x += noise * torch.randn(x.shape, generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    tokens = np.zeros((n_docs, t_bucket, dims), dtype=np.float32)
    lanes = torch.arange(t_bucket, device=dev)[None, :]
    for lo in range(0, n_docs, 8192):
        hi = min(lo + 8192, n_docs)
        block = draw((hi - lo, t_bucket))
        block[lanes >= token_count[lo:hi, None]] = 0.0
        tokens[lo:hi] = block.cpu().numpy()
    queries = draw((n_queries, query_tokens)).cpu().numpy()
    return tokens, token_count.cpu().numpy(), queries


def rank_vectors_segment(tokens: np.ndarray, token_count: np.ndarray,
                         field: str = "tok", max_tokens: int = 128,
                         seg_id: str = "r0"
                         ) -> Tuple[MapperService, Segment]:
    """One shard holding f32 [n, T, dims] token matrices as the
    rank_vectors field `field` of docs d0..d{n-1}, sealed through
    segment_from_arrays without the per-doc parse loop and with `_source`
    off."""
    n, t_bucket, dims = tokens.shape
    spec = {"type": "rank_vectors", "dimension": dims,
            "max_tokens": max_tokens}
    entry = {"tokens": tokens, "token_count": token_count,
             "exists": token_count > 0, "t_bucket": t_bucket}
    mapper = MapperService({"properties": {field: spec}})
    arrays = {
        "seg_id": seg_id, "num_docs": n,
        "doc_ids": [f"d{i}" for i in range(n)], "sources": [None] * n,
        "term_dict": {},
        "post_docs": np.full((1, 128), -1, np.int32),
        "post_tf": np.zeros((1, 128), np.float32),
        "norms": {}, "field_stats": {},
        "rank_vectors_dv": {field: entry},
    }
    return mapper, segment_from_arrays(arrays)


# ------------------------------------------- nested documents and places

QA_MAPPING = {"properties": {
    "tag": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "long"},
        "date": {"type": "date"},
        "score": {"type": "integer"}}}}}
QA_BASE_MS = 1217548800000          # 2008-08-01, StackOverflow's launch
QA_TAGS = 1000
QA_USERS = 200_000


def _zipf_draw(rng, n_values: int, size: int, s: float = 1.07):
    """size draws in [0, n_values) with P(k) proportional to 1/(k+1)^s."""
    p = 1.0 / np.arange(1, n_values + 1) ** s
    cdf = np.cumsum(p)
    return np.searchsorted(cdf, rng.random(size) * cdf[-1]).astype(np.int64)


def _numeric_dv(rows: np.ndarray, values: np.ndarray, n_rows: int) -> dict:
    """segment_from_arrays' numeric column for one value on each of
    `rows` (ascending)."""
    exists = np.zeros(n_rows, dtype=bool)
    exists[rows] = True
    unique, ranks = np.unique(values.astype(np.float64), return_inverse=True)
    return {"doc_ids": rows.astype(np.int32),
            "values": values.astype(np.float64), "exists": exists,
            "counts": exists.astype(np.int32),
            "value_ords": ranks.astype(np.int32).reshape(-1),
            "unique": unique}


def qa_columns(n_questions: int, seed: int = 42):
    """The Q&A corpus as columns, after rally-tracks' `nested` track
    (StackOverflow questions with their answers as nested objects):
    per question a zipf tag of QA_TAGS and a creationDate over five years;
    0-8 answers each (a truncated geometric, mean about 2.5), each a zipf
    user of QA_USERS (a long id), a date after the question and an integer
    score. Returns (n_answers int64 [Q], tag, created, and per answer in
    question order user, date, score)."""
    rng = np.random.default_rng(seed)
    n_ans = np.minimum(rng.geometric(0.28, n_questions) - 1, 8)
    tag = _zipf_draw(rng, QA_TAGS, n_questions)
    created = QA_BASE_MS + rng.integers(0, 5 * 365 * 86400_000,
                                        n_questions)
    total = int(n_ans.sum())
    user = _zipf_draw(rng, QA_USERS, total)
    date = np.repeat(created, n_ans) + rng.integers(60_000, 90 * 86400_000,
                                                    total)
    score = np.round(rng.standard_normal(total) * 4 + 2).astype(np.int64)
    return n_ans, tag, created, user, date, score


def qa_segment(n_questions: int, seed: int = 42, seg_id: str = "qa0"
               ) -> Tuple[MapperService, Segment]:
    """One sealed segment of qa_columns: each question a doc block, its
    answers' rows (path `answers`) before its own row, built from numpy
    columns through segment_from_arrays (no text fields)."""
    mapper = MapperService(QA_MAPPING)
    n_ans, tag, created, user, date, score = qa_columns(n_questions, seed)
    block = n_ans + 1
    start = np.concatenate([[0], np.cumsum(block)[:-1]])
    root = start + n_ans
    n_rows = int(block.sum())
    parent = np.full(n_rows, -1, dtype=np.int32)
    child = np.ones(n_rows, dtype=bool)
    child[root] = False
    child_rows = np.nonzero(child)[0]
    parent[child_rows] = np.repeat(root, n_ans).astype(np.int32)
    path_ords = np.where(child, 0, -1).astype(np.int32)
    doc_ids = [None] * n_rows
    for i, r in enumerate(root.tolist()):
        doc_ids[r] = f"q{i}"
    dictionary = sorted(f"t{i:04d}" for i in range(QA_TAGS))
    ord_of = {t: k for k, t in enumerate(dictionary)}
    tag_ords = np.array([ord_of[f"t{i:04d}"] for i in range(QA_TAGS)],
                        np.int32)[tag]
    root_exists = ~child
    arrays = {
        "seg_id": seg_id, "num_docs": n_rows, "doc_ids": doc_ids,
        "sources": [None] * n_rows, "term_dict": {},
        "post_docs": np.full((1, 128), -1, np.int32),
        "post_tf": np.zeros((1, 128), np.float32),
        "norms": {}, "field_stats": {},
        "parent_ptr": parent, "path_ords": path_ords,
        "nested_paths": ["answers"],
        "numeric_dv": {
            "creationDate": _numeric_dv(root, created, n_rows),
            "answers.user": _numeric_dv(child_rows, user, n_rows),
            "answers.date": _numeric_dv(child_rows, date, n_rows),
            "answers.score": _numeric_dv(child_rows, score, n_rows)},
        "ordinal_dv": {"tag": {
            "doc_ids": root.astype(np.int32), "ords": tag_ords,
            "exists": root_exists, "dictionary": dictionary,
            "ord_hashes": np.array([_hash64(t) for t in dictionary],
                                   np.uint64)}},
    }
    return mapper, segment_from_arrays(arrays)


GEONAMES_MAPPING = {"properties": {
    "location": {"type": "geo_point"},
    "population": {"type": "rank_feature"},
    "country_code": {"type": "keyword"}}}
GEONAMES_CENTRES = 5000
GEONAMES_COUNTRIES = 250


def geonames_columns(n_places: int, seed: int = 42):
    """Places after rally-tracks' `geonames` track: around GEONAMES_CENTRES
    seeded city centres (a zipf share of the places each, 0.3 degrees of
    spread, longitudes wrapped), each centre in one of GEONAMES_COUNTRIES
    country codes; a lognormal population (missing for a tenth). Returns
    (centres f64 [C, 2], lat, lon f64 [N], country int64 [N], population
    f64 [N] with NaN where missing)."""
    rng = np.random.default_rng(seed)
    c_lat = np.degrees(np.arcsin(rng.uniform(-0.9, 0.97, GEONAMES_CENTRES)))
    c_lon = rng.uniform(-180.0, 180.0, GEONAMES_CENTRES)
    c_country = _zipf_draw(rng, GEONAMES_COUNTRIES, GEONAMES_CENTRES, 0.9)
    which = _zipf_draw(rng, GEONAMES_CENTRES, n_places, 0.8)
    lat = np.clip(c_lat[which] + rng.normal(0, 0.3, n_places), -89.9, 89.9)
    lon = (c_lon[which] + rng.normal(0, 0.3, n_places) + 180.0) % 360.0 \
        - 180.0
    pop = np.round(rng.lognormal(7, 2, n_places), 1)
    pop[rng.random(n_places) < 0.1] = np.nan
    return (np.stack([c_lat, c_lon], 1), np.round(lat, 6), np.round(lon, 6),
            c_country[which], pop)


def geonames_segment(n_places: int, seed: int = 42, seg_id: str = "geo0"
                     ) -> Tuple[MapperService, Segment]:
    """One sealed segment of geonames_columns: `location` (its hidden
    .lat / .lon columns, and the field's own lats), `population` and
    `country_code` (doc values and postings), through
    segment_from_arrays."""
    mapper = MapperService(GEONAMES_MAPPING)
    _c, lat, lon, country, pop = geonames_columns(n_places, seed)
    rows = np.arange(n_places)
    has_pop = ~np.isnan(pop)
    dictionary = sorted(f"c{i:03d}" for i in range(GEONAMES_COUNTRIES))
    # country_code's postings (term filters): each code's docs in order,
    # padded to whole blocks of 128
    order = np.argsort(country, kind="stable").astype(np.int32)
    df = np.bincount(country, minlength=GEONAMES_COUNTRIES)
    blocks = -(-df // 128)
    post_docs = np.full((max(int(blocks.sum()), 1), 128), -1, np.int32)
    term_dict, at, blk = {}, 0, 0
    for c in range(GEONAMES_COUNTRIES):
        if df[c]:
            flat = post_docs[blk:blk + blocks[c]].reshape(-1)
            flat[:df[c]] = order[at:at + df[c]]
            term_dict[("country_code", dictionary[c])] = (
                int(df[c]), int(df[c]), blk, int(blocks[c]))
        at += int(df[c])
        blk += int(blocks[c])
    arrays = {
        "seg_id": seg_id, "num_docs": n_places,
        "doc_ids": [f"g{i}" for i in range(n_places)],
        "sources": [None] * n_places, "term_dict": term_dict,
        "post_docs": post_docs,
        "post_tf": (post_docs >= 0).astype(np.float32),
        "norms": {},
        "field_stats": {"country_code": (n_places, n_places, n_places)},
        "numeric_dv": {
            "location": _numeric_dv(rows, lat, n_places),
            "location.lat": _numeric_dv(rows, lat, n_places),
            "location.lon": _numeric_dv(rows, lon, n_places),
            "population": _numeric_dv(rows[has_pop], pop[has_pop],
                                      n_places)},
        "ordinal_dv": {"country_code": {
            "doc_ids": rows.astype(np.int32),
            # f"c{i:03d}" sorts as i
            "ords": country.astype(np.int32),
            "exists": np.ones(n_places, dtype=bool),
            "dictionary": dictionary,
            "ord_hashes": np.array([_hash64(t) for t in dictionary],
                                   np.uint64)}},
    }
    return mapper, segment_from_arrays(arrays)


# rally-tracks' http_logs, cut: `clientip` is a keyword (the `ip` type is
# not ported) and the track's `message` / `geoip` fields are left out
HTTP_LOGS_MAPPING = {"properties": {
    "@timestamp": {"type": "date",
                   "format": "strict_date_optional_time||epoch_second"},
    "clientip": {"type": "keyword"},
    "request": {"type": "text"},
    "status": {"type": "integer"},
    "size": {"type": "integer"}}}
HTTP_LOGS_BASE_S = 893964617        # the track's first instant, 1998-04-30
HTTP_LOGS_STATUS = (200, 304, 404, 206, 500, 302, 400, 403, 401, 503)
_HTTP_STATUS_P = (0.82, 0.1, 0.04, 0.015, 0.008, 0.008, 0.004, 0.003,
                  0.001, 0.001)
_HTTP_DIRS = ("images", "english", "french", "spanish", "german", "news",
              "scripts", "teams", "history", "tickets", "venues",
              "playing", "competition", "member", "cgi-bin")
_HTTP_EXTS = ("gif", "html", "jpg", "htm", "js", "css", "pdf", "txt")


def http_logs_docs(n_docs: int, seed: int = 42) -> List[dict]:
    """`n_docs` lines of a seeded web-server log: `@timestamp` epoch
    seconds, three lines a second; a zipf-skewed `clientip` of 50,000
    clients; a GET `request` over a zipf-skewed file vocabulary; `status`
    from HTTP_LOGS_STATUS (mostly 200); a lognormal `size`, absent from a
    304 and from a tenth of the 200s."""
    rng = np.random.default_rng(seed)
    client = _zipf_draw(rng, 50_000, n_docs, 1.1)
    dirs = _zipf_draw(rng, len(_HTTP_DIRS), n_docs, 1.2)
    files = _zipf_draw(rng, 2000, n_docs, 1.05)
    exts = rng.integers(0, len(_HTTP_EXTS), n_docs)
    status = np.asarray(HTTP_LOGS_STATUS)[
        rng.choice(len(HTTP_LOGS_STATUS), n_docs, p=_HTTP_STATUS_P)]
    size = rng.lognormal(8.5, 1.5, n_docs).astype(np.int64)
    no_size = (status == 304) | ((status == 200)
                                 & (rng.random(n_docs) < 0.1))
    out = []
    for i in range(n_docs):
        c = int(client[i])
        doc = {"@timestamp": HTTP_LOGS_BASE_S + i // 3,
               "clientip": f"{c >> 8 & 255}.{c & 255}.{(c * 7) & 255}."
                           f"{c % 251}",
               "request": f"GET /{_HTTP_DIRS[dirs[i]]}/f{files[i]}."
                          f"{_HTTP_EXTS[exts[i]]} HTTP/1.0",
               "status": int(status[i])}
        if not no_size[i]:
            doc["size"] = int(size[i])
        out.append(doc)
    return out
