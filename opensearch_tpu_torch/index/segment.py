"""Immutable columnar segments (the subset of opensearch_tpu.index.segment
the port needs).

Postings are blocked CSR: one global `[num_blocks, 128]` int32 doc-id matrix
plus a parallel float32 term-frequency matrix, padded with -1 / 0. A
(field, term) entry of the term dictionary points at a contiguous run of
blocks. Norms are Lucene's SmallFloat bytes, decoded at score time through
the 256-entry LENGTH_TABLE. Doc values are value-pair columns sorted by
doc: numeric/date/boolean values rank-encoded into a sorted f64 `unique`
table (`DocValuesColumn`), keyword values ordinal-encoded into a sorted
dictionary (`OrdinalsColumn`). Vectors are a dense f32 `[D, dims]` matrix
per field (`VectorColumn`), with an IVF index built at seal time for ANN
mappings; late-interaction token matrices a padded f32 `[D, T, dims]`
block per field (`RankVectorsColumn`), with product-quantization codes
trained at seal time for `compression: pq`. Deletes are a liveness
bitmap. The layout is
byte-for-byte the reference's, so `segment_from_arrays` can carry a sealed
reference segment across unchanged.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

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


def token_mask_rows(token_count: np.ndarray, t_bucket: int) -> np.ndarray:
    """Host mask of the real (non-padded) rows of a flattened [D*T, dims]
    token block: seal-time PQ trains on real token vectors only."""
    lanes = np.arange(t_bucket)[None, :] < token_count[:, None]
    return lanes.reshape(-1)


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


@dataclass
class VectorColumn:
    vectors: np.ndarray      # float32 [D, dims]
    exists: np.ndarray       # bool [D]
    ivf: Any = None          # Optional[opensearch_tpu_torch.ops.knn.IVFIndex]


@dataclass
class RankVectorsColumn:
    """Late-interaction multi-vector doc values (rank_vectors fields): one
    padded [T_bucket, dims] token matrix per doc. `t_bucket` is the
    segment's power-of-two token bucket (pad_bucket of the longest stored
    doc, capped by the mapping's max_tokens bucket). PQ mappings also
    carry seal-trained uint8 codes and their codebook."""
    tokens: np.ndarray       # float32 [D, T_bucket, dims], padded lanes 0
    token_count: np.ndarray  # int32 [D] real tokens per doc
    exists: np.ndarray       # bool [D] doc has >= 1 token vector
    t_bucket: int
    codes: Optional[np.ndarray] = None      # uint8 [D, T_bucket, M]
    codebook: Optional[np.ndarray] = None   # float32 [M, 256, dsub]


def _hash64(s: str) -> int:
    """Stable 64-bit hash of a dictionary entry (seal time)."""
    return int.from_bytes(hashlib.blake2b(s.encode("utf-8"),
                                          digest_size=8).digest(), "little")


# process-unique segment identities (the filter cache's key): never reused
_SEGMENT_UID = itertools.count(1)


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
                 path_ords: Optional[np.ndarray] = None,
                 nested_paths: Optional[List[str]] = None,
                 numeric_dv: Optional[Dict[str, DocValuesColumn]] = None,
                 ordinal_dv: Optional[Dict[str, OrdinalsColumn]] = None,
                 vector_dv: Optional[Dict[str, VectorColumn]] = None,
                 rank_vectors_dv: Optional[Dict[str, RankVectorsColumn]]
                 = None,
                 positions: Optional[Dict[Tuple[str, str],
                                          List[np.ndarray]]] = None):
        self.seg_id = seg_id
        self.uid = next(_SEGMENT_UID)
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
        self.vector_dv = vector_dv or {}
        self.rank_vectors_dv = rank_vectors_dv or {}
        # host-only term positions per (field, term): one sorted int32
        # array per posting, parallel to the term's postings (phrase
        # queries); the device image does not carry them
        self.positions = positions or {}
        self.live = np.ones(num_docs, dtype=bool)
        # block-join layout (Lucene's doc blocks): a nested object's row
        # points at its root row (-1 = a root) and carries the ordinal of
        # its nested path in `nested_paths` (-1 = a root)
        self.parent_ptr = parent_ptr if parent_ptr is not None \
            else np.full(num_docs, -1, dtype=np.int32)
        self.path_ords = path_ords if path_ords is not None \
            else np.full(num_docs, -1, dtype=np.int32)
        self.nested_paths = list(nested_paths or [])
        self.root = self.parent_ptr < 0
        self._id_to_ord = {d: i for i, d in enumerate(doc_ids)
                           if d is not None}
        self.doc_meta: Dict[str, Tuple[int, int, int]] = {}

    @property
    def live_doc_count(self) -> int:
        return int(self.live.sum())

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
        if self.nested_paths:
            # the whole block dies with its root
            self.live[self.parent_ptr == ord_] = False
        return True

    def get_term(self, field: str, term: str) -> Optional[TermMeta]:
        return self.term_dict.get((field, term))

    def _positions_for(self, field: str, term: str
                       ) -> Optional[Dict[int, np.ndarray]]:
        """doc ord -> positions of one term (host phrase matching),
        memoized per term."""
        key = (field, term)
        pos_lists = self.positions.get(key)
        meta = self.term_dict.get(key)
        if pos_lists is None or meta is None:
            return None
        cache = getattr(self, "_pos_cache", None)
        if cache is None:
            cache = self._pos_cache = {}
        if key not in cache:
            docs = self.post_docs[
                meta.start_block:meta.start_block + meta.num_blocks].ravel()
            docs = docs[docs >= 0]
            cache[key] = {int(d): pos_lists[i] for i, d in enumerate(docs)}
        return cache[key]

    def terms_for_field(self, field: str) -> List[str]:
        """The field's terms in the term dictionary, in its (sorted)
        order: what prefix, wildcard, regexp and fuzzy queries expand
        against."""
        return [t for (f, t) in self.term_dict if f == field]

    def memory_bytes(self) -> int:
        """Host bytes of the segment's columns (postings, norms, doc
        values, vectors)."""
        total = self.post_docs.nbytes + self.post_tf.nbytes
        for arr in self.norms.values():
            total += arr.nbytes
        for col in self.numeric_dv.values():
            total += (col.doc_ids.nbytes + col.values.nbytes
                      + col.exists.nbytes + col.counts.nbytes
                      + col.value_ords.nbytes + col.unique.nbytes)
        for col in self.ordinal_dv.values():
            total += (col.doc_ids.nbytes + col.ords.nbytes
                      + col.exists.nbytes + col.ord_hashes.nbytes)
        for col in self.vector_dv.values():
            total += col.vectors.nbytes + col.exists.nbytes
        for col in self.rank_vectors_dv.values():
            total += (col.tokens.nbytes + col.token_count.nbytes
                      + col.exists.nbytes)
            if col.codes is not None:
                total += col.codes.nbytes + col.codebook.nbytes
        for pos_lists in self.positions.values():
            total += sum(p.nbytes for p in pos_lists)
        return total


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
    - parent_ptr: int32 [num_docs] (optional, default all roots): a
      nested row's root row, -1 for a root
    - path_ords: int32 [num_docs] (optional, default -1): a nested row's
      ordinal in nested_paths, -1 for a root
    - nested_paths: list of str (optional): the segment's nested paths
    - numeric_dv: {field: {doc_ids, values, exists, counts, value_ords,
      unique}} (optional): DocValuesColumn fields as arrays
    - ordinal_dv: {field: {doc_ids, ords, exists, dictionary,
      ord_hashes}} (optional): OrdinalsColumn fields
    - vector_dv: {field: {vectors, exists, ivf}} (optional): float32
      [num_docs, dims] rows and their bool [num_docs] presence; `ivf` is
      None, an IVFIndex or {centroids, lists, block_centroid, nlist,
      nprobe}. A doc ord may stand in the lists once at most: the probe
      stores each candidate's score without atomics.
    - rank_vectors_dv: {field: {tokens, token_count, exists, t_bucket,
      codes, codebook}} (optional): float32 [num_docs, t_bucket, dims]
      token matrices (lanes past a doc's token_count zero), int32 / bool
      [num_docs]; for a PQ field uint8 [num_docs, t_bucket, M] codes and a
      float32 [M, 256, dims / M] codebook, carried across as they are.
    - positions: {(field, term): [int32 positions per posting]}
      (optional): the host-only positions phrase queries read, one
      sorted array per posting of the term, in postings order.
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
    path_ords = arrays.get("path_ords")
    nested_paths = [str(p) for p in arrays.get("nested_paths") or []]
    if parent_ptr is not None:
        parent_ptr = np.asarray(parent_ptr, dtype=np.int32)
        kids = parent_ptr[parent_ptr >= 0] if parent_ptr.shape == (n,) \
            else None
        if kids is None or (n and (
                parent_ptr.max() >= n or parent_ptr.min() < -1
                or np.any(parent_ptr[kids] >= 0))):
            raise ValueError("parent_ptr must point each nested row at a "
                             "root row of the segment")
    if path_ords is not None:
        path_ords = np.asarray(path_ords, dtype=np.int32)
        if path_ords.shape != (n,) or (n and (
                path_ords.max() >= len(nested_paths)
                or path_ords.min() < -1)):
            raise ValueError("path_ords must index nested_paths (-1 for a "
                             "root)")
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
    vector_dv = {f: _vector_column(f, c, n)
                 for f, c in (arrays.get("vector_dv") or {}).items()}
    rank_vectors_dv = {f: _rank_vectors_column(f, c, n) for f, c in
                       (arrays.get("rank_vectors_dv") or {}).items()}
    positions = {}
    for key, lists in (arrays.get("positions") or {}).items():
        tm = term_dict.get(tuple(key))
        if tm is None or len(lists) != tm.doc_freq:
            raise ValueError(f"positions of {tuple(key)} must hold one array "
                             f"per posting of a term in the dictionary")
        positions[tuple(key)] = [np.asarray(p, dtype=np.int32)
                                 for p in lists]
    seg = Segment(str(arrays["seg_id"]), n, list(arrays["doc_ids"]),
                  list(arrays["sources"]), term_dict, post_docs, post_tf,
                  norms, field_stats,
                  parent_ptr=parent_ptr, path_ords=path_ords,
                  nested_paths=nested_paths,
                  numeric_dv=numeric_dv, ordinal_dv=ordinal_dv,
                  vector_dv=vector_dv, rank_vectors_dv=rank_vectors_dv,
                  positions=positions)
    live = arrays.get("live")
    if live is not None:
        seg.live = np.array(live, dtype=bool)
    return seg


def _vector_column(field: str, c: dict, n: int) -> VectorColumn:
    """One `vector_dv` entry of segment_from_arrays, checked."""
    from opensearch_tpu_torch.ops.knn import IVF_BLOCK, ivf_index_from
    vectors = np.ascontiguousarray(c["vectors"], dtype=np.float32)
    exists = np.ascontiguousarray(c["exists"], dtype=bool)
    if vectors.ndim != 2 or vectors.shape[0] != n or exists.shape != (n,):
        raise ValueError(f"vectors of [{field}] must be [{n}, dims] with a "
                         f"[{n}] exists mask, got {vectors.shape} and "
                         f"{exists.shape}")
    ivf = ivf_index_from(c.get("ivf"))
    if ivf is not None:
        nlist = ivf.centroids.shape[0]
        nb = ivf.block_centroid.shape[0]
        if ivf.centroids.shape != (nlist, vectors.shape[1]) \
                or ivf.lists.shape != (nb, IVF_BLOCK) or nb == 0 \
                or ivf.block_centroid.min() < 0 \
                or ivf.block_centroid.max() >= nlist:
            raise ValueError(f"IVF index of [{field}] must hold [nlist, "
                             f"dims] centroids, [n_blocks, {IVF_BLOCK}] "
                             f"lists and an owning centroid per block")
        ids = ivf.lists[ivf.lists >= 0]
        if len(ids) and (ids.max() >= n or np.any(
                np.bincount(ids, minlength=n) > 1)):
            raise ValueError(f"IVF lists of [{field}] must name docs of the "
                             f"segment, each at most once")
    return VectorColumn(vectors, exists, ivf)


def _rank_vectors_column(field: str, c: dict, n: int) -> RankVectorsColumn:
    """One `rank_vectors_dv` entry of segment_from_arrays, checked."""
    tokens = np.ascontiguousarray(c["tokens"], dtype=np.float32)
    token_count = np.ascontiguousarray(c["token_count"], dtype=np.int32)
    exists = np.ascontiguousarray(c["exists"], dtype=bool)
    t_bucket = int(c["t_bucket"])
    if tokens.ndim != 3 or tokens.shape[:2] != (n, t_bucket) \
            or token_count.shape != (n,) or exists.shape != (n,) \
            or (n and (token_count.min() < 0
                       or token_count.max() > t_bucket)):
        raise ValueError(f"rank_vectors of [{field}] must be [{n}, "
                         f"t_bucket, dims] tokens with [{n}] token counts "
                         f"in [0, t_bucket] and a [{n}] exists mask")
    col = RankVectorsColumn(tokens, token_count, exists, t_bucket)
    if c.get("codes") is not None:
        col.codes = np.ascontiguousarray(c["codes"], dtype=np.uint8)
        col.codebook = np.ascontiguousarray(c["codebook"], dtype=np.float32)
        m = col.codes.shape[2] if col.codes.ndim == 3 else 0
        if col.codes.shape[:2] != (n, t_bucket) or m == 0 \
                or col.codebook.ndim != 3 \
                or col.codebook.shape[:2] != (m, 256) \
                or m * col.codebook.shape[2] != tokens.shape[2]:
            raise ValueError(f"PQ codes of [{field}] must be [{n}, "
                             f"t_bucket, M] with an [M, 256, dims / M] "
                             f"codebook")
    return col


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
        self._vectors: Dict[str, Dict[int, List[float]]] = {}
        self._rank_vectors: Dict[str, Dict[int, List[List[float]]]] = {}
        self._field_stats: Dict[str, FieldStats] = {}
        # (field, term) -> sorted positions per posting, parallel to
        # _postings
        self._positions: Dict[Tuple[str, str], List[np.ndarray]] = {}
        # doc blocks: each row's root row (-1 = a root) and nested-path
        # ordinal (-1 = a root); a document's nested rows come before it
        self._parent_ptr: List[int] = []
        self._path_ords: List[int] = []
        self._nested_paths: List[str] = []

    def __len__(self):
        return len(self.doc_ids)

    @property
    def num_docs(self):
        return len(self.doc_ids)

    def add(self, doc: ParsedDocument) -> int:
        """Append a document's block: one row per nested object, then the
        root row. Returns the root row's ordinal."""
        child_ords = []
        for path, child_fields in doc.children:
            if path not in self._nested_paths:
                self._nested_paths.append(path)
            child_ords.append(self._add_row(
                None, None, child_fields, self._nested_paths.index(path)))
        ord_ = self._add_row(doc.doc_id, doc.source, doc.fields, -1)
        for c in child_ords:
            self._parent_ptr[c] = ord_
        return ord_

    def _add_row(self, doc_id, source, fields, path_ord: int) -> int:
        ord_ = len(self.doc_ids)
        self.doc_ids.append(doc_id)
        self.sources.append(source)
        self._parent_ptr.append(-1)
        self._path_ords.append(path_ord)
        for field, pf in fields.items():
            ft = self.mapper.get_field(field)
            if ft is None:
                continue
            if pf.terms is not None and ft.index:
                tf_map: Dict[str, int] = {}
                pos_map: Dict[str, List[int]] = {}
                for term, pos in pf.terms:
                    tf_map[term] = tf_map.get(term, 0) + 1
                    pos_map.setdefault(term, []).append(pos)
                for term, tf in tf_map.items():
                    self._postings.setdefault((field, term), []).append(
                        (ord_, tf))
                    self._positions.setdefault((field, term), []).append(
                        np.asarray(sorted(pos_map[term]), dtype=np.int32))
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
            if pf.vector is not None:
                self._vectors.setdefault(field, {})[ord_] = pf.vector
            if pf.token_vectors is not None:
                self._rank_vectors.setdefault(field, {})[ord_] = \
                    pf.token_vectors
        return ord_

    def seal(self, device=None) -> Segment:
        """The immutable columnar segment. An ANN (`ivf`) vector field with
        at least 256 vectors gets its IVF index here: the k-means runs on
        `device` (the card unless the caller names another)."""
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

        # vectors: dense [D, dims]; IVF built at seal for ANN mappings
        vector_dv: Dict[str, VectorColumn] = {}
        for field, rows in self._vectors.items():
            ft = self.mapper.get_field(field)
            mat = np.zeros((n_docs, ft.dims), dtype=np.float32)
            exists = np.zeros(n_docs, dtype=bool)
            for ord_, vec in rows.items():
                mat[ord_] = np.asarray(vec, dtype=np.float32)
                exists[ord_] = True
            col = VectorColumn(mat, exists)
            if ft.knn_method == "ivf" and int(exists.sum()) >= 256:
                from opensearch_tpu_torch.ops.knn import build_ivf
                col.ivf = build_ivf(mat, exists, nlist=ft.knn_nlist,
                                    nprobe=ft.knn_nprobe, device=device)
            vector_dv[field] = col

        # rank_vectors: padded [D, T_bucket, dims] token matrices; a PQ
        # mapping trains its codebook here (host numpy, as in the
        # reference), once per segment
        rank_vectors_dv: Dict[str, RankVectorsColumn] = {}
        for field, rows in self._rank_vectors.items():
            ft = self.mapper.get_field(field)
            max_seen = max((len(toks) for toks in rows.values()), default=0)
            t_bucket = min(pad_bucket(max(max_seen, 1), minimum=8),
                           pad_bucket(ft.max_tokens, minimum=8))
            tokens = np.zeros((n_docs, t_bucket, ft.dims), dtype=np.float32)
            token_count = np.zeros(n_docs, dtype=np.int32)
            exists = np.zeros(n_docs, dtype=bool)
            for ord_, toks in rows.items():
                nt = len(toks)
                if nt:
                    tokens[ord_, :nt] = np.asarray(toks, dtype=np.float32)
                token_count[ord_] = nt
                exists[ord_] = nt > 0
            col = RankVectorsColumn(tokens, token_count, exists, t_bucket)
            if ft.compression == "pq":
                from opensearch_tpu_torch.ops.maxsim import (encode_pq,
                                                             train_pq)
                flat = tokens.reshape(-1, ft.dims)
                real = flat[token_mask_rows(token_count, t_bucket)]
                col.codebook = train_pq(real, ft.pq_m)
                col.codes = encode_pq(flat, col.codebook).reshape(
                    n_docs, t_bucket, ft.pq_m)
            rank_vectors_dv[field] = col

        return Segment(self.seg_id, n_docs, list(self.doc_ids),
                       list(self.sources), term_dict, post_docs, post_tf,
                       norms, self._field_stats,
                       parent_ptr=np.asarray(self._parent_ptr, np.int32),
                       path_ords=np.asarray(self._path_ords, np.int32),
                       nested_paths=list(self._nested_paths),
                       numeric_dv=numeric_dv,
                       ordinal_dv=ordinal_dv, vector_dv=vector_dv,
                       rank_vectors_dv=rank_vectors_dv,
                       positions=dict(self._positions))


def merge_segments(mapper: MapperService, segments: List[Segment],
                   seg_id: str, device=None) -> Segment:
    """One segment of the live documents of `segments`, in their order:
    each live root's `_source` is parsed again into one SegmentBuilder, so
    its nested rows are rebuilt from it, and its (version, seq_no, term)
    carries across. Deleted documents leave the term and field
    statistics. `device` seals as `SegmentBuilder.seal` does."""
    builder = SegmentBuilder(mapper, seg_id=seg_id)
    doc_meta = {}
    for seg in segments:
        for ord_ in range(seg.num_docs):
            did = seg.doc_ids[ord_]
            if not seg.live[ord_] or did is None:
                continue
            builder.add(mapper.parse_document(did, seg.sources[ord_] or {}))
            if did in seg.doc_meta:
                doc_meta[did] = seg.doc_meta[did]
    merged = builder.seal(device=device)
    merged.doc_meta = doc_meta
    return merged
