"""Device-resident segment: the card's image of a sealed columnar segment
(the BM25 subset of opensearch_tpu.ops.device_segment).

Layout, with the reference's dtypes, power-of-two padding buckets and fill
values:
- `post_docs` int32 / `post_tf` float32 `[NBp, 128]`, padded -1 / 0, and
  `post_bound` float32 `[NBp]` (seal-time block score bounds, 0 padding);
- `norms` int32 `[F, Dp]`, one row per normed text field (row index in
  `DeviceSegmentMeta.norm_rows`), and `length_table` float32 `[256]`;
- `live`, `root` bool `[Dp]`, `parent_ptr`, `nested_path` int32 `[Dp]`
  (a nested row's root row and path ordinal, -1 for a root), and K22's
  static per-root child CSR: `child_start` int32 `[Dp + 1]` and
  `child_rows` int32 `[NCp]`, a root's nested rows in row order (-1
  padded);
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
device. `publish_segment` is the refresh's and the merge's upload: with the
delta gate on (the node setting `indices.publish.delta`, off by default) it
sends only the populated prefix of every leaf whose padded tail is a
constant fill (`compact_spec`), and the device expands each prefix to its
padded shape (row 16, `expand_pad`: a CUDA kernel for a tensor on the card,
its plain version on the CPU). The image is the same either way; only the
bytes that cross from the host differ.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import (LENGTH_TABLE, Segment,
                                                block_score_bounds,
                                                pad_bucket)
from opensearch_tpu_torch.ops import _build
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
    nested_path = np.full(d_pad, -1, dtype=np.int32)
    nested_path[:seg.num_docs] = seg.path_ords
    child_start, child_rows = root_child_csr(seg.parent_ptr, d_pad)

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
        "child_start": child_start,
        "child_rows": child_rows,
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


def root_child_csr(parent_ptr: np.ndarray, d_pad: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """K22's static CSR: the nested rows of each row (only roots have
    any) in row order, whatever their place in the segment: (start int32
    [Dp + 1], rows int32 [NCp], -1 padded)."""
    kids = np.nonzero(parent_ptr >= 0)[0].astype(np.int32)
    order = np.argsort(parent_ptr[kids], kind="stable")
    rows = np.full(pad_bucket(max(len(kids), 1)), -1, dtype=np.int32)
    rows[:len(kids)] = kids[order]
    counts = np.bincount(parent_ptr[kids], minlength=d_pad)
    start = np.zeros(d_pad + 1, dtype=np.int32)
    np.cumsum(counts, out=start[1:])
    return start, rows


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


def refresh_live(arrays: Dict, seg: Segment) -> Dict:
    """A copy of a device image whose `live` leaf is uploaded again from
    the segment's bitmap (the other leaves are shared)."""
    live = arrays["live"]
    out = dict(arrays)
    out["live"] = torch.from_numpy(
        live_mask(seg, live.shape[0])).to(live.device)
    return out


def compact_spec(seg: Segment) -> Dict[tuple, tuple]:
    """Tree path -> (compact extents, None = the whole axis; pad fill) for
    every leaf whose padded tail is a constant fill (the reference's
    _compact_spec). Leaves absent from it cross in full: length_table, the
    IVF packings, the PQ codebook and K22's `child_start` (whose tail is a
    running total) and `child_rows`."""
    nd = seg.num_docs
    nb = seg.post_docs.shape[0]
    # a term's doc list never exceeds num_docs: on a small segment the
    # postings' width axis is mostly fill
    spec: Dict[tuple, tuple] = {
        ("post_docs",): ((nb, nd), -1),
        ("post_tf",): ((nb, nd), 0.0),
        ("post_bound",): ((nb,), 0.0),
        ("norms",): ((None, nd), 0),
        ("live",): ((nd,), False),
        ("root",): ((nd,), False),
        ("parent_ptr",): ((nd,), -1),
        ("nested_path",): ((nd,), -1),
    }
    for fname, col in seg.numeric_dv.items():
        nv = len(col.doc_ids)
        spec[("numeric", fname, "doc_ids")] = ((nv,), -1)
        spec[("numeric", fname, "val_ords")] = ((nv,), 0)
        spec[("numeric", fname, "values_f32")] = ((nv,), 0.0)
        spec[("numeric", fname, "exists")] = ((nd,), False)
        # minimum.at / maximum.at touch only rows < num_docs: the tail
        # keeps the initial fill
        spec[("numeric", fname, "min_rank")] = ((nd,), int(INT32_MAX))
        spec[("numeric", fname, "max_rank")] = ((nd,), -1)
        spec[("numeric", fname, "unique_f32")] = ((len(col.unique),), 0.0)
    for fname, col in seg.ordinal_dv.items():
        nv = len(col.doc_ids)
        spec[("ordinal", fname, "doc_ids")] = ((nv,), -1)
        spec[("ordinal", fname, "ords")] = ((nv,), 0)
        spec[("ordinal", fname, "exists")] = ((nd,), False)
    for fname in seg.vector_dv:
        spec[("vector", fname, "vectors")] = ((nd, None), 0.0)
        spec[("vector", fname, "exists")] = ((nd,), False)
    for fname, col in seg.rank_vectors_dv.items():
        spec[("rank_vectors", fname, "token_count")] = ((nd,), 0)
        spec[("rank_vectors", fname, "exists")] = ((nd,), False)
        if col.codes is not None:
            spec[("rank_vectors", fname, "codes")] = ((nd, None, None), 0)
        else:
            spec[("rank_vectors", fname, "tokens")] = ((nd, None, None), 0.0)
    return spec


# the leaf dtypes expand_pad takes, by element width
_EXPAND_DTYPES = {torch.int32: 4, torch.float32: 4, torch.bool: 1,
                  torch.uint8: 1}


def expand_pad_plain(x: torch.Tensor, full_shape, fill) -> torch.Tensor:
    """Plain version of row 16 (the reference's _expand_fn): a tensor of
    `full_shape` filled with `fill`, with `x` in its leading corner."""
    out = torch.full(tuple(full_shape), fill, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def _fill_bits(dtype: torch.dtype, fill) -> int:
    """The fill's raw bits in the leaf's element width."""
    if dtype == torch.float32:
        # the C cast from double, as the plain version's torch.full makes
        # it (a NaN keeps the payload bits the cast keeps)
        return int(np.array(fill, dtype=np.float32).view(np.uint32))
    if dtype == torch.int32:
        return int(fill) & 0xFFFFFFFF
    return int(fill) & 0xFF


def fold_axes(compact, full) -> Tuple[tuple, tuple]:
    """The (compact, padded) extents of an expand_pad with every inner
    axis whose compact extent equals its padded one merged into the axis
    outside it, and leading axes of extent 1 dropped: [100,000, 128, 32]
    into [131,072, 128, 32] becomes [409,600,000] into [536,870,912]. An
    axis whose compact extent is smaller than its padded one is never
    merged into, so the prefix is the same elements in either form."""
    out_c, out_f = [int(compact[-1])], [int(full[-1])]
    for c, f in zip(reversed(compact[:-1]), reversed(full[:-1])):
        c, f = int(c), int(f)
        if out_c[0] == out_f[0]:
            out_c[0] *= c
            out_f[0] *= f
        elif c != 1 or f != 1:
            out_c.insert(0, c)
            out_f.insert(0, f)
    return tuple(out_c), tuple(out_f)


def expand_pad(x: torch.Tensor, full_shape, fill) -> torch.Tensor:
    """Row 16: fill-pad a compact prefix out to its padded shape on the
    device. Replaces opensearch_tpu/ops/device_segment.py:_expand_fn.

    x: a contiguous int32 / float32 / bool / uint8 tensor of 1-3 dims, each
    extent at most full_shape's. Returns a new tensor of `full_shape`:
    `fill` everywhere, `x` in the leading corner. The kernel sees the
    extents after `fold_axes`."""
    full_shape = tuple(int(f) for f in full_shape)
    if not x.is_cuda:
        return expand_pad_plain(x, full_shape, fill)
    width = _EXPAND_DTYPES.get(x.dtype)
    if width is None:
        raise ValueError(f"expand_pad takes int32, float32, bool or uint8, "
                         f"got {x.dtype}")
    if not 1 <= x.dim() <= 3 or len(full_shape) != x.dim():
        raise ValueError(f"expand_pad takes 1-3 dims of the same count, got "
                         f"{tuple(x.shape)} into {full_shape}")
    if any(c > f for c, f in zip(x.shape, full_shape)) or x.numel() == 0:
        raise ValueError(f"expand_pad: {tuple(x.shape)} does not fit in "
                         f"{full_shape}")
    if not x.is_contiguous():
        raise ValueError("expand_pad takes a contiguous tensor")
    c, f = fold_axes(tuple(x.shape), full_shape)
    c = (1,) * (3 - len(c)) + c
    f = (1,) * (3 - len(f)) + f
    out = torch.empty(full_shape, dtype=x.dtype, device=x.device)
    fn = _build.entry("expand_pad", [ctypes.c_void_p, ctypes.c_void_p]
                      + [ctypes.c_int] + [ctypes.c_longlong] * 6
                      + [ctypes.c_uint, ctypes.c_void_p])
    code = fn(_build.ptr(x), _build.ptr(out), width, *c, *f,
              _fill_bits(x.dtype, fill), _build.stream_of(x.device))
    _build.LAUNCHES["expand_pad"] += 1
    _build.check("expand_pad", code)
    return out


def _delta_tree(host, spec: Dict[tuple, tuple], device, sent: list,
                path: tuple = ()):
    """The device image of a host tree: each specced leaf sent as its
    compact prefix and expanded on the device, every other leaf in full.
    `sent[0]` adds up the bytes that crossed from the host."""
    if isinstance(host, dict):
        return {k: _delta_tree(v, spec, device, sent, path + (k,))
                for k, v in host.items()}
    full = tuple(int(s) for s in host.shape)
    entry = spec.get(path)
    if entry is not None:
        raw, fill = entry
        # compact extents are power-of-two bucketed, as the reference's
        cshape = tuple(
            f if c is None else min(pad_bucket(max(int(c), 1), minimum=8), f)
            for c, f in zip(raw, full))
        if cshape != full:
            compact = np.ascontiguousarray(
                host[tuple(slice(0, s) for s in cshape)])
            sent[0] += int(compact.nbytes)
            return expand_pad(torch.from_numpy(compact).to(device), full,
                              fill)
    sent[0] += int(host.nbytes)
    return torch.from_numpy(host).to(device)


def publish_segment(seg: Segment, device: torch.device, delta: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], DeviceSegmentMeta,
                               int]:
    """upload_segment with its transfer counted: (arrays, meta, bytes sent
    from the host). With `delta` off this is upload_segment and the bytes
    are the image's; with it on only the compact prefixes cross and the
    device expands them, to the same image."""
    host, meta = segment_image(seg)
    if not delta:
        arrays = _tree_to(host, device)
        return arrays, meta, tree_nbytes(arrays)
    sent = [0]
    arrays = _delta_tree(host, compact_spec(seg), device, sent)
    return arrays, meta, sent[0]


def tree_nbytes(tree) -> int:
    """Total tensor bytes of a device image."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())
