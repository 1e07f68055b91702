"""Immutable columnar segments for the BM25 slice (the subset of
opensearch_tpu.index.segment the port needs).

Postings are blocked CSR: one global `[num_blocks, 128]` int32 doc-id matrix
plus a parallel float32 term-frequency matrix, padded with -1 / 0. A
(field, term) entry of the term dictionary points at a contiguous run of
blocks. Norms are Lucene's SmallFloat bytes, decoded at score time through
the 256-entry LENGTH_TABLE. Deletes are a liveness bitmap. The layout is
byte-for-byte the reference's, so `segment_from_arrays` can carry a sealed
reference segment across unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.index.mapper import MapperService, ParsedDocument

BLOCK = 128  # postings block width


# ------------------------------------------------------------- SmallFloat ----

def smallfloat_int_to_byte4(i: int) -> int:
    """Lucene SmallFloat.intToByte4: lossy 8-bit encoding of an int >= 0.
    Values < 16 are exact; larger ones keep 3 mantissa bits."""
    if i < 0:
        raise ValueError(f"only supports positive values, got {i}")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07
    encoded |= (shift + 1) << 3
    return min(encoded, 255)


def smallfloat_byte4_to_int(b: int) -> int:
    """Inverse of intToByte4 (the quantization bucket's lower bound)."""
    bits = b & 0x07
    shift = (b >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


# 256-entry doc-length decode table, identical to BM25Similarity.LENGTH_TABLE
LENGTH_TABLE = np.array([smallfloat_byte4_to_int(b) for b in range(256)],
                        dtype=np.float32)


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_bucket(n: int, minimum: int = 128) -> int:
    """Round up to the next power-of-two bucket."""
    size = max(minimum, 1)
    while size < n:
        size *= 2
    return size


# BM25 parameters the seal-time block bounds are computed against
SEAL_K1 = 1.2
SEAL_B = 0.75
_BOUNDS_CHUNK_ROWS = 1 << 16


def block_score_bounds(seg: "Segment") -> np.ndarray:
    """Per-posting-block BM25 upper bounds: max over the block's lanes of
    tf/(tf + SEAL_K1*(1-SEAL_B+SEAL_B*dl/avgdl)), f32 [NB]. Norm-less fields
    use the omit-norms denominator tf + k1; padding lanes contribute 0.
    Memoized on the (immutable) segment."""
    cached = getattr(seg, "_block_bounds", None)
    if cached is not None:
        return cached
    nb = seg.post_docs.shape[0]
    bounds = np.zeros(nb, dtype=np.float32)
    field_rows: Dict[str, List[np.ndarray]] = {}
    for (field, _term), tm in seg.term_dict.items():
        if tm.num_blocks:
            field_rows.setdefault(field, []).append(
                np.arange(tm.start_block, tm.start_block + tm.num_blocks,
                          dtype=np.int64))
    for field, runs in field_rows.items():
        norm = seg.norms.get(field)
        stats = seg.field_stats.get(field)
        if norm is not None and stats is not None and stats.doc_count > 0:
            avgdl = max(stats.sum_total_term_freq / stats.doc_count, 1e-9)
            dl = LENGTH_TABLE[norm]
            c_doc = (1.0 - SEAL_B + SEAL_B * dl / avgdl).astype(np.float32)
        else:
            c_doc = None
        rows = np.concatenate(runs)
        for lo in range(0, len(rows), _BOUNDS_CHUNK_ROWS):
            chunk = rows[lo:lo + _BOUNDS_CHUNK_ROWS]
            docs = seg.post_docs[chunk]
            tfs = seg.post_tf[chunk]
            c = np.float32(1.0) if c_doc is None \
                else c_doc[np.where(docs >= 0, docs, 0)]
            g = tfs / (tfs + np.float32(SEAL_K1) * c)
            g[docs < 0] = 0.0
            bounds[chunk] = g.max(axis=1)
    seg._block_bounds = bounds
    return bounds


# ------------------------------------------------------------ data classes ---

@dataclass
class TermMeta:
    """Per-(field, term) postings metadata (Lucene TermState analog)."""
    doc_freq: int
    total_term_freq: int
    start_block: int
    num_blocks: int


@dataclass
class FieldStats:
    """Per-field collection statistics feeding BM25 idf / avgdl."""
    doc_count: int = 0
    sum_total_term_freq: int = 0
    sum_doc_freq: int = 0


class Segment:
    """A sealed, immutable columnar segment (host numpy representation)."""

    def __init__(self, seg_id: str, num_docs: int,
                 doc_ids: List[Optional[str]],
                 sources: List[Optional[dict]],
                 term_dict: Dict[Tuple[str, str], TermMeta],
                 post_docs: np.ndarray, post_tf: np.ndarray,
                 norms: Dict[str, np.ndarray],
                 field_stats: Dict[str, FieldStats],
                 parent_ptr: Optional[np.ndarray] = None):
        self.seg_id = seg_id
        self.num_docs = num_docs
        self.doc_ids = doc_ids
        self.sources = sources
        self.term_dict = term_dict
        self.post_docs = post_docs          # int32 [NB, BLOCK], -1 padded
        self.post_tf = post_tf              # float32 [NB, BLOCK]
        self.norms = norms                  # field -> uint8 [D]
        self.field_stats = field_stats
        self.live = np.ones(num_docs, dtype=bool)
        # block-join layout: parent row per row (-1 = root). This slice
        # indexes root documents only, so every row is a root.
        self.parent_ptr = parent_ptr if parent_ptr is not None \
            else np.full(num_docs, -1, dtype=np.int32)
        self.root = self.parent_ptr < 0
        self._id_to_ord = {d: i for i, d in enumerate(doc_ids)
                           if d is not None}
        self.doc_meta: Dict[str, Tuple[int, int, int]] = {}

    def ord_of(self, doc_id: str) -> Optional[int]:
        ord_ = self._id_to_ord.get(doc_id)
        if ord_ is None or not self.live[ord_]:
            return None
        return ord_

    def delete(self, doc_id: str) -> bool:
        ord_ = self._id_to_ord.get(doc_id)
        if ord_ is None or not self.live[ord_]:
            return False
        self.live[ord_] = False
        return True

    def get_term(self, field: str, term: str) -> Optional[TermMeta]:
        return self.term_dict.get((field, term))


def segment_from_arrays(arrays: dict) -> Segment:
    """Build the port's Segment from a sealed segment given as plain numpy
    and Python data, so a segment sealed by another implementation can be
    searched here unchanged (the search engine's counterpart of carrying
    weights across). Keys:

    - seg_id: str; num_docs: int; doc_ids: list of str; sources: list
    - term_dict: {(field, term): (doc_freq, total_term_freq, start_block,
      num_blocks)}
    - post_docs: int32 [NB, 128]; post_tf: float32 [NB, 128]
    - norms: {field: uint8 [num_docs]}
    - field_stats: {field: (doc_count, sum_total_term_freq, sum_doc_freq)}
    - live: bool [num_docs] (optional, default all live)
    - parent_ptr: int32 [num_docs] (optional, default all roots)
    """
    n = int(arrays["num_docs"])
    post_docs = np.ascontiguousarray(arrays["post_docs"], dtype=np.int32)
    post_tf = np.ascontiguousarray(arrays["post_tf"], dtype=np.float32)
    if post_docs.ndim != 2 or post_docs.shape[1] != BLOCK \
            or post_tf.shape != post_docs.shape:
        raise ValueError(
            f"postings must be [NB, {BLOCK}] int32/float32 pairs, got "
            f"{post_docs.shape} and {post_tf.shape}")
    term_dict = {tuple(k): TermMeta(*map(int, v))
                 for k, v in arrays["term_dict"].items()}
    for (field, term), tm in term_dict.items():
        if tm.start_block < 0 or tm.start_block + tm.num_blocks \
                > post_docs.shape[0]:
            raise ValueError(f"term [{field}:{term}] points past the "
                             f"postings matrix")
    norms = {f: np.ascontiguousarray(v, dtype=np.uint8)
             for f, v in arrays["norms"].items()}
    for f, v in norms.items():
        if v.shape != (n,):
            raise ValueError(f"norms of [{f}] must be [{n}], got {v.shape}")
    field_stats = {f: FieldStats(*map(int, v))
                   for f, v in arrays["field_stats"].items()}
    parent_ptr = arrays.get("parent_ptr")
    seg = Segment(str(arrays["seg_id"]), n, list(arrays["doc_ids"]),
                  list(arrays["sources"]), term_dict, post_docs, post_tf,
                  norms, field_stats,
                  parent_ptr=None if parent_ptr is None
                  else np.asarray(parent_ptr, dtype=np.int32))
    live = arrays.get("live")
    if live is not None:
        seg.live = np.array(live, dtype=bool)
    return seg


# ------------------------------------------------------------ the builder ----

class SegmentBuilder:
    """In-memory segment under construction (Lucene IndexWriter's RAM buffer
    analog); `seal()` produces the immutable columnar arrays."""

    def __init__(self, mapper: MapperService, seg_id: str = "seg_0"):
        self.mapper = mapper
        self.seg_id = seg_id
        self.doc_ids: List[Optional[str]] = []
        self.sources: List[Optional[dict]] = []
        # (field, term) -> [(doc_ord, tf)] in insertion (= doc) order
        self._postings: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        self._field_lengths: Dict[str, Dict[int, int]] = {}
        self._field_stats: Dict[str, FieldStats] = {}

    def __len__(self):
        return len(self.doc_ids)

    @property
    def num_docs(self):
        return len(self.doc_ids)

    def add(self, doc: ParsedDocument) -> int:
        ord_ = len(self.doc_ids)
        self.doc_ids.append(doc.doc_id)
        self.sources.append(doc.source)
        for field, pf in doc.fields.items():
            ft = self.mapper.get_field(field)
            if ft is None or not ft.index:
                continue
            if pf.terms is not None:
                tf_map: Dict[str, int] = {}
                for term, _pos in pf.terms:
                    tf_map[term] = tf_map.get(term, 0) + 1
                for term, tf in tf_map.items():
                    self._postings.setdefault((field, term), []).append(
                        (ord_, tf))
                self._field_lengths.setdefault(field, {})[ord_] = pf.length
                stats = self._field_stats.setdefault(field, FieldStats())
                stats.doc_count += 1
                stats.sum_total_term_freq += pf.length
                stats.sum_doc_freq += len(tf_map)
            if pf.exact_values is not None:
                seen = set()
                for v in pf.exact_values:
                    if v not in seen:
                        seen.add(v)
                        self._postings.setdefault((field, v), []).append(
                            (ord_, 1))
                stats = self._field_stats.setdefault(field, FieldStats())
                stats.doc_count += 1
                stats.sum_total_term_freq += len(pf.exact_values)
                stats.sum_doc_freq += len(seen)
        return ord_

    def seal(self) -> Segment:
        n_docs = len(self.doc_ids)
        term_dict: Dict[Tuple[str, str], TermMeta] = {}
        rows_docs: List[np.ndarray] = []
        rows_tf: List[np.ndarray] = []
        next_block = 0
        # sorted (field, term) keys give the deterministic block layout
        for key in sorted(self._postings.keys()):
            plist = self._postings[key]
            docs = np.fromiter((d for d, _ in plist), dtype=np.int32,
                               count=len(plist))
            tfs = np.fromiter((t for _, t in plist), dtype=np.float32,
                              count=len(plist))
            padded = _pad_to(len(plist), BLOCK)
            docs_p = np.full(padded, -1, dtype=np.int32)
            tfs_p = np.zeros(padded, dtype=np.float32)
            docs_p[:len(plist)] = docs
            tfs_p[:len(plist)] = tfs
            nb = padded // BLOCK
            rows_docs.append(docs_p.reshape(nb, BLOCK))
            rows_tf.append(tfs_p.reshape(nb, BLOCK))
            term_dict[key] = TermMeta(doc_freq=len(plist),
                                      total_term_freq=int(tfs.sum()),
                                      start_block=next_block, num_blocks=nb)
            next_block += nb
        if rows_docs:
            post_docs = np.concatenate(rows_docs, axis=0)
            post_tf = np.concatenate(rows_tf, axis=0)
        else:
            post_docs = np.full((1, BLOCK), -1, dtype=np.int32)
            post_tf = np.zeros((1, BLOCK), dtype=np.float32)

        norms: Dict[str, np.ndarray] = {}
        for field, lengths in self._field_lengths.items():
            arr = np.zeros(n_docs, dtype=np.uint8)
            for ord_, length in lengths.items():
                arr[ord_] = smallfloat_int_to_byte4(length)
            norms[field] = arr

        return Segment(self.seg_id, n_docs, list(self.doc_ids),
                       list(self.sources), term_dict, post_docs, post_tf,
                       norms, self._field_stats)
