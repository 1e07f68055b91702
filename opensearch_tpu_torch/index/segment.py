"""Immutable columnar segments (the subset of opensearch_tpu.index.segment
the port needs).

Postings are blocked CSR: one global `[num_blocks, 128]` int32 doc-id matrix
plus a parallel float32 term-frequency matrix, padded with -1 / 0. A
(field, term) entry of the term dictionary points at a contiguous run of
blocks. Norms are Lucene's SmallFloat bytes, decoded at score time through
the 256-entry LENGTH_TABLE. Doc values are value-pair columns sorted by
doc: numeric/date/boolean values rank-encoded into a sorted f64 `unique`
table (`DocValuesColumn`), keyword values ordinal-encoded into a sorted
dictionary (`OrdinalsColumn`). Deletes are a liveness bitmap. The layout is
byte-for-byte the reference's, so `segment_from_arrays` can carry a sealed
reference segment across unchanged.
"""

from __future__ import annotations

import hashlib
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


def ident_pairs(col) -> bool:
    """True when a doc-value column's (doc, value) pairs are the identity
    layout (single-valued dense column: doc k <-> lane k, -1 tail): device
    code then slices or pads per-lane results into doc space instead of
    gathering and scattering. Memoized on the (immutable) column."""
    cached = getattr(col, "_ident_pairs", None)
    if cached is not None:
        return cached
    d = col.doc_ids
    nv = int((d >= 0).sum())
    out = bool(np.array_equal(d[:nv], np.arange(nv, dtype=d.dtype))
               and (d[nv:] < 0).all())
    col._ident_pairs = out
    return out


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


@dataclass
class DocValuesColumn:
    """Value-pair doc values of one numeric/date/boolean field: (doc, value)
    pairs sorted by doc. `value_ords` rank-encodes each value into `unique`
    (sorted distinct f64s); device code sees only the int32 ranks, and
    range bounds become ranks through a host searchsorted."""
    doc_ids: np.ndarray      # int32 [NV]
    values: np.ndarray       # float64 [NV] exact values (host only)
    exists: np.ndarray       # bool [D]
    counts: np.ndarray       # int32 [D] values per doc
    value_ords: np.ndarray   # int32 [NV] rank into `unique`
    unique: np.ndarray       # float64 [U] sorted distinct values (host)


@dataclass
class OrdinalsColumn:
    """Ordinal-encoded string doc values: a sorted dictionary and (doc, ord)
    pairs sorted by doc."""
    doc_ids: np.ndarray      # int32 [NV]
    ords: np.ndarray         # int32 [NV]
    exists: np.ndarray       # bool [D]
    dictionary: List[str]    # ord -> term, lexicographically sorted
    ord_hashes: np.ndarray   # uint64 [card] hash per dictionary entry


def _hash64(s: str) -> int:
    """Stable 64-bit hash of a dictionary entry (seal time)."""
    return int.from_bytes(hashlib.blake2b(s.encode("utf-8"),
                                          digest_size=8).digest(), "little")


class Segment:
    """A sealed, immutable columnar segment (host numpy representation)."""

    def __init__(self, seg_id: str, num_docs: int,
                 doc_ids: List[Optional[str]],
                 sources: List[Optional[dict]],
                 term_dict: Dict[Tuple[str, str], TermMeta],
                 post_docs: np.ndarray, post_tf: np.ndarray,
                 norms: Dict[str, np.ndarray],
                 field_stats: Dict[str, FieldStats],
                 parent_ptr: Optional[np.ndarray] = None,
                 numeric_dv: Optional[Dict[str, DocValuesColumn]] = None,
                 ordinal_dv: Optional[Dict[str, OrdinalsColumn]] = None):
        self.seg_id = seg_id
        self.num_docs = num_docs
        self.doc_ids = doc_ids
        self.sources = sources
        self.term_dict = term_dict
        self.post_docs = post_docs          # int32 [NB, BLOCK], -1 padded
        self.post_tf = post_tf              # float32 [NB, BLOCK]
        self.norms = norms                  # field -> uint8 [D]
        self.field_stats = field_stats
        self.numeric_dv = numeric_dv or {}
        self.ordinal_dv = ordinal_dv or {}
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
    - numeric_dv: {field: {doc_ids, values, exists, counts, value_ords,
      unique}} (optional): DocValuesColumn fields as arrays
    - ordinal_dv: {field: {doc_ids, ords, exists, dictionary,
      ord_hashes}} (optional): OrdinalsColumn fields
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
    numeric_dv = {}
    for f, c in (arrays.get("numeric_dv") or {}).items():
        col = DocValuesColumn(
            doc_ids=np.ascontiguousarray(c["doc_ids"], dtype=np.int32),
            values=np.ascontiguousarray(c["values"], dtype=np.float64),
            exists=np.ascontiguousarray(c["exists"], dtype=bool),
            counts=np.ascontiguousarray(c["counts"], dtype=np.int32),
            value_ords=np.ascontiguousarray(c["value_ords"], dtype=np.int32),
            unique=np.ascontiguousarray(c["unique"], dtype=np.float64))
        nv = col.doc_ids.shape[0]
        if col.values.shape != (nv,) or col.value_ords.shape != (nv,) \
                or col.exists.shape != (n,) or col.counts.shape != (n,):
            raise ValueError(f"numeric doc values of [{f}] have mismatched "
                             f"shapes")
        if nv and (col.doc_ids.min() < 0 or col.doc_ids.max() >= n
                   or np.any(np.diff(col.doc_ids) < 0)
                   or col.value_ords.min() < 0
                   or col.value_ords.max() >= len(col.unique)):
            raise ValueError(f"numeric doc values of [{f}] must be (doc, "
                             f"rank) pairs sorted by doc, inside the "
                             f"segment and the unique table")
        numeric_dv[f] = col
    ordinal_dv = {}
    for f, c in (arrays.get("ordinal_dv") or {}).items():
        dictionary = [str(t) for t in c["dictionary"]]
        col = OrdinalsColumn(
            doc_ids=np.ascontiguousarray(c["doc_ids"], dtype=np.int32),
            ords=np.ascontiguousarray(c["ords"], dtype=np.int32),
            exists=np.ascontiguousarray(c["exists"], dtype=bool),
            dictionary=dictionary,
            ord_hashes=np.ascontiguousarray(
                c["ord_hashes"] if c.get("ord_hashes") is not None
                else [_hash64(t) for t in dictionary], dtype=np.uint64))
        nv = col.doc_ids.shape[0]
        if col.ords.shape != (nv,) or col.exists.shape != (n,):
            raise ValueError(f"ordinal doc values of [{f}] have mismatched "
                             f"shapes")
        if nv and (col.doc_ids.min() < 0 or col.doc_ids.max() >= n
                   or np.any(np.diff(col.doc_ids) < 0)
                   or col.ords.min() < 0
                   or col.ords.max() >= len(dictionary)):
            raise ValueError(f"ordinal doc values of [{f}] must be (doc, "
                             f"ord) pairs sorted by doc, inside the segment "
                             f"and the dictionary")
        ordinal_dv[f] = col
    seg = Segment(str(arrays["seg_id"]), n, list(arrays["doc_ids"]),
                  list(arrays["sources"]), term_dict, post_docs, post_tf,
                  norms, field_stats,
                  parent_ptr=None if parent_ptr is None
                  else np.asarray(parent_ptr, dtype=np.int32),
                  numeric_dv=numeric_dv, ordinal_dv=ordinal_dv)
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
        self._numeric: Dict[str, List[Tuple[int, float]]] = {}
        self._ordinal_raw: Dict[str, List[Tuple[int, str]]] = {}
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
            if ft is None:
                continue
            if pf.terms is not None and ft.index:
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
                if ft.index:
                    seen = set()
                    for v in pf.exact_values:
                        if v not in seen:
                            seen.add(v)
                            self._postings.setdefault((field, v),
                                                      []).append((ord_, 1))
                    stats = self._field_stats.setdefault(field,
                                                         FieldStats())
                    stats.doc_count += 1
                    stats.sum_total_term_freq += len(pf.exact_values)
                    stats.sum_doc_freq += len(seen)
                if ft.doc_values and ft.has_ordinals:
                    raw = self._ordinal_raw.setdefault(field, [])
                    raw.extend((ord_, v) for v in pf.exact_values)
            if pf.numeric_values is not None and ft.doc_values:
                nums = self._numeric.setdefault(field, [])
                nums.extend((ord_, v) for v in pf.numeric_values)
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

        # numeric doc values: (doc, value) pairs, stable-sorted by doc
        numeric_dv: Dict[str, DocValuesColumn] = {}
        for field, pairs in self._numeric.items():
            pairs.sort(key=lambda p: p[0])
            doc_arr = np.fromiter((d for d, _ in pairs), dtype=np.int32,
                                  count=len(pairs))
            val_arr = np.fromiter((v for _, v in pairs), dtype=np.float64,
                                  count=len(pairs))
            exists = np.zeros(n_docs, dtype=bool)
            if len(doc_arr):
                exists[doc_arr] = True
            counts = np.bincount(doc_arr, minlength=n_docs).astype(np.int32)
            unique, value_ords = np.unique(val_arr, return_inverse=True)
            numeric_dv[field] = DocValuesColumn(
                doc_arr, val_arr, exists, counts,
                value_ords.astype(np.int32).reshape(-1), unique)

        # ordinal doc values: sorted dictionary, (doc, ord) pairs
        ordinal_dv: Dict[str, OrdinalsColumn] = {}
        for field, pairs in self._ordinal_raw.items():
            dictionary = sorted({v for _, v in pairs})
            ord_of = {v: i for i, v in enumerate(dictionary)}
            pairs.sort(key=lambda p: p[0])
            doc_arr = np.fromiter((d for d, _ in pairs), dtype=np.int32,
                                  count=len(pairs))
            ords = np.fromiter((ord_of[v] for _, v in pairs),
                               dtype=np.int32, count=len(pairs))
            exists = np.zeros(n_docs, dtype=bool)
            if len(doc_arr):
                exists[doc_arr] = True
            hashes = np.array([_hash64(v) for v in dictionary],
                              dtype=np.uint64) \
                if dictionary else np.zeros(0, dtype=np.uint64)
            ordinal_dv[field] = OrdinalsColumn(doc_arr, ords, exists,
                                               dictionary, hashes)

        return Segment(self.seg_id, n_docs, list(self.doc_ids),
                       list(self.sources), term_dict, post_docs, post_tf,
                       norms, self._field_stats, numeric_dv=numeric_dv,
                       ordinal_dv=ordinal_dv)
