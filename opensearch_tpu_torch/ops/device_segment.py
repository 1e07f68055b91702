"""Device-resident segment: the card's image of a sealed columnar segment
(the BM25 subset of opensearch_tpu.ops.device_segment).

Layout, with the reference's dtypes, power-of-two padding buckets and fill
values:
- `post_docs` int32 / `post_tf` float32 `[NBp, 128]`, padded -1 / 0, and
  `post_bound` float32 `[NBp]` (seal-time block score bounds, 0 padding);
- `norms` int32 `[F, Dp]`, one row per normed text field (row index in
  `DeviceSegmentMeta.norm_rows`), and `length_table` float32 `[256]`;
- `live`, `root` bool `[Dp]`, `parent_ptr`, `nested_path` int32 `[Dp]`;
- `numeric[field]`: value-pair leaves `doc_ids` / `val_ords` int32 and
  `values_f32` float32 `[NVp]` (padded -1 / 0 / 0), per-doc `exists` bool,
  `min_rank` / `max_rank` int32 `[Dp]` (INT32_MAX / -1 where absent), and
  the rank -> value decode table `unique_f32` `[Up]`;
- `ordinal[field]`: `doc_ids` / `ords` int32 `[NVp]` and `exists` `[Dp]`;
- `vector[field]`: `vectors` float32 `[Dp, dims]` (zero rows past the
  segment) and `exists` bool `[Dp]`; for an IVF field also
  `ivf_centroids` `[nlist, dims]`, `ivf_block_centroid` int32 `[n_blocks]`
  and the list-major packed copy `ivf_packed_vecs` `[n_blocks * 256,
  dims]` / `ivf_packed_ids` int32 `[n_blocks * 256]` (-1 padding);
- `rank_vectors[field]`: `token_count` int32 and `exists` bool `[Dp]`,
  then `tokens` float32 `[Dp, T, dims]` or, for a PQ field, `codes` uint8
  `[Dp, T, M]` and `codebook` float32 `[M, 256, dsub]` (zero past the
  segment; T is the segment's token bucket).

The image is built host-side in numpy and uploaded once to the chosen
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import (LENGTH_TABLE, Segment,
                                                block_score_bounds,
                                                pad_bucket)
from opensearch_tpu_torch.ops.knn import pack_ivf_lists

INT32_MAX = np.int32(2 ** 31 - 1)
_F32_MAX = float(np.finfo(np.float32).max)


def _to_f32_finite(values: np.ndarray) -> np.ndarray:
    """float64 -> float32, saturating at the f32 range instead of
    overflowing to inf (metric kernels over the decode tables never see
    inf)."""
    return np.clip(values, -_F32_MAX, _F32_MAX).astype(np.float32)


@dataclass(frozen=True)
class DeviceSegmentMeta:
    """Static shape/layout facts of one uploaded segment."""
    seg_id: str
    num_docs: int
    d_pad: int
    nb_pad: int
    norm_rows: Tuple[Tuple[str, int], ...]   # field -> row in norms stack
    numeric_fields: Tuple[str, ...] = ()
    ordinal_fields: Tuple[str, ...] = ()
    vector_fields: Tuple[str, ...] = ()
    # (field, token bucket, compression) per rank_vectors field: the
    # bucket and the storage variant shape the kernels' launches
    rank_vector_fields: Tuple[Tuple[str, int, str], ...] = ()
    block_bounds: bool = True

    def norm_row(self, field: str) -> Optional[int]:
        for f, r in self.norm_rows:
            if f == field:
                return r
        return None

    def compile_key(self) -> tuple:
        """Every shape-shaping fact of the image, seg_id excluded: two
        segments equal on this key run the same kernel configurations."""
        return (self.num_docs, self.d_pad, self.nb_pad, self.norm_rows,
                self.numeric_fields, self.ordinal_fields,
                self.vector_fields, self.rank_vector_fields,
                self.block_bounds)


def segment_image(seg: Segment) -> Tuple[Dict[str, np.ndarray],
                                         DeviceSegmentMeta]:
    """The host numpy image of a segment and its static meta."""
    d_pad = pad_bucket(max(seg.num_docs, 1))
    nb = seg.post_docs.shape[0]
    nb_pad = pad_bucket(nb, minimum=8)

    post_docs = np.full((nb_pad, seg.post_docs.shape[1]), -1, dtype=np.int32)
    post_docs[:nb] = seg.post_docs
    post_tf = np.zeros((nb_pad, seg.post_tf.shape[1]), dtype=np.float32)
    post_tf[:nb] = seg.post_tf
    post_bound = np.zeros(nb_pad, dtype=np.float32)
    post_bound[:nb] = block_score_bounds(seg)

    norm_fields = sorted(seg.norms.keys())
    norms = np.zeros((max(len(norm_fields), 1), d_pad), dtype=np.int32)
    for row, fname in enumerate(norm_fields):
        norms[row, :seg.num_docs] = seg.norms[fname]

    live = np.zeros(d_pad, dtype=bool)
    live[:seg.num_docs] = seg.live
    root = np.zeros(d_pad, dtype=bool)
    root[:seg.num_docs] = seg.root
    parent_ptr = np.full(d_pad, -1, dtype=np.int32)
    parent_ptr[:seg.num_docs] = seg.parent_ptr
    # every row of this slice is a root document: path ordinal -1
    nested_path = np.full(d_pad, -1, dtype=np.int32)

    arrays = {
        "post_docs": post_docs,
        "post_tf": post_tf,
        "post_bound": post_bound,
        "norms": norms,
        "length_table": LENGTH_TABLE.copy(),
        "live": live,
        "root": root,
        "parent_ptr": parent_ptr,
        "nested_path": nested_path,
        "numeric": {},
        "ordinal": {},
        "vector": {},
        "rank_vectors": {},
    }

    for fname, col in seg.numeric_dv.items():
        nv = len(col.doc_ids)
        nv_pad = pad_bucket(max(nv, 1))
        doc_ids = np.full(nv_pad, -1, dtype=np.int32)
        doc_ids[:nv] = col.doc_ids
        val_ords = np.zeros(nv_pad, dtype=np.int32)
        val_ords[:nv] = col.value_ords
        values_f32 = np.zeros(nv_pad, dtype=np.float32)
        values_f32[:nv] = _to_f32_finite(col.values)
        exists = np.zeros(d_pad, dtype=bool)
        exists[:seg.num_docs] = col.exists
        min_rank = np.full(d_pad, INT32_MAX, dtype=np.int32)
        max_rank = np.full(d_pad, -1, dtype=np.int32)
        if nv:
            np.minimum.at(min_rank, col.doc_ids, col.value_ords)
            np.maximum.at(max_rank, col.doc_ids, col.value_ords)
        u_pad = pad_bucket(max(len(col.unique), 1), minimum=8)
        unique_f32 = np.zeros(u_pad, dtype=np.float32)
        unique_f32[:len(col.unique)] = _to_f32_finite(col.unique)
        arrays["numeric"][fname] = {
            "doc_ids": doc_ids, "val_ords": val_ords,
            "values_f32": values_f32, "exists": exists,
            "min_rank": min_rank, "max_rank": max_rank,
            "unique_f32": unique_f32,
        }

    for fname, col in seg.ordinal_dv.items():
        nv = len(col.doc_ids)
        nv_pad = pad_bucket(max(nv, 1))
        doc_ids = np.full(nv_pad, -1, dtype=np.int32)
        doc_ids[:nv] = col.doc_ids
        ords = np.zeros(nv_pad, dtype=np.int32)
        ords[:nv] = col.ords
        exists = np.zeros(d_pad, dtype=bool)
        exists[:seg.num_docs] = col.exists
        arrays["ordinal"][fname] = {"doc_ids": doc_ids, "ords": ords,
                                    "exists": exists}

    for fname, col in seg.vector_dv.items():
        vecs = np.zeros((d_pad, col.vectors.shape[1]), dtype=np.float32)
        vecs[:seg.num_docs] = col.vectors
        exists = np.zeros(d_pad, dtype=bool)
        exists[:seg.num_docs] = col.exists
        entry = {"vectors": vecs, "exists": exists}
        if col.ivf is not None:
            packed, flat_ids = pack_ivf_lists(col.vectors, col.ivf.lists)
            entry["ivf_centroids"] = np.array(col.ivf.centroids)
            entry["ivf_block_centroid"] = np.array(col.ivf.block_centroid)
            entry["ivf_packed_vecs"] = packed
            entry["ivf_packed_ids"] = flat_ids
        arrays["vector"][fname] = entry

    # PQ fields ship codes and the codebook instead of the f32 matrices
    rank_vector_fields = []
    for fname, col in sorted(seg.rank_vectors_dv.items()):
        token_count = np.zeros(d_pad, dtype=np.int32)
        token_count[:seg.num_docs] = col.token_count
        exists = np.zeros(d_pad, dtype=bool)
        exists[:seg.num_docs] = col.exists
        entry = {"token_count": token_count, "exists": exists}
        if col.codes is not None:
            codes = np.zeros((d_pad,) + col.codes.shape[1:], dtype=np.uint8)
            codes[:seg.num_docs] = col.codes
            entry["codes"] = codes
            entry["codebook"] = np.array(col.codebook)
            compression = "pq"
        else:
            tokens = np.zeros((d_pad,) + col.tokens.shape[1:],
                              dtype=np.float32)
            tokens[:seg.num_docs] = col.tokens
            entry["tokens"] = tokens
            compression = "none"
        arrays["rank_vectors"][fname] = entry
        rank_vector_fields.append((fname, col.t_bucket, compression))

    meta = DeviceSegmentMeta(
        seg_id=seg.seg_id, num_docs=seg.num_docs, d_pad=d_pad, nb_pad=nb_pad,
        norm_rows=tuple((f, i) for i, f in enumerate(norm_fields)),
        numeric_fields=tuple(sorted(seg.numeric_dv)),
        ordinal_fields=tuple(sorted(seg.ordinal_dv)),
        vector_fields=tuple(sorted(seg.vector_dv)),
        rank_vector_fields=tuple(rank_vector_fields))
    return arrays, meta


def upload_segment(seg: Segment, device: torch.device
                   ) -> Tuple[Dict[str, torch.Tensor], DeviceSegmentMeta]:
    """Build a segment's image and upload it once to `device`."""
    arrays, meta = segment_image(seg)
    return _tree_to(arrays, device), meta


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device)


def live_mask(seg: Segment, d_pad: int) -> np.ndarray:
    """The padded `live` leaf for a segment whose deletes changed."""
    live = np.zeros(d_pad, dtype=bool)
    live[:seg.num_docs] = seg.live
    return live


def tree_nbytes(tree) -> int:
    """Total tensor bytes of a device image."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())
