"""Search execution: the shard reader, the msearch envelope and the device
query phases (the subset of opensearch_tpu.search.executor the port
needs).

`multi_search` groups same-shaped score-sorted queries and runs each group
against each segment as one batch: the group's plan inputs pack into ONE
pinned int32 host buffer that uploads once (the leaves are views of it on
the device), the kernel class is chosen per group exactly as the reference
chooses it (`_candidate_kernel_fits`), and every group's packed result rows
come back to the host in ONE device-to-host copy per batch. Bodies with
aggregations always take the dense path: the aggregation pass reads the
dense eligibility mask, and its partials are bit-cast onto the same packed
f32 rows, so an agg batch is still one copy. The host then merges segments
(score desc, segment asc, doc asc), reduces the agg partials and renders
responses in the reference's JSON shape.

A top-level `hybrid` body runs through the fused hybrid query phase
instead (`build_hybrid_query_phase`): per segment, every sub-query's plan
and its K3 window, then K12's bounds and union total, one packed row per
query; same-shaped hybrid bodies of an `_msearch` batch the same way, and
searchpipeline/hybrid.py normalizes and combines the windows.

Every other body (a field sort, `search_after`, `track_total_hits`,
`highlight`, `explain`, `docvalue_fields`, `version`, ...) takes the
general path: search/controller.py drives `execute_query_phase`, which
per segment compiles the plan with the segment filter cache installed
(indices/query_cache.py), builds the field sort's key (K13,
ops/sort_key.py), runs the plan and K3's keyed top-k over k + 128 lanes
(`build_query_phase`), and fetches every segment's row in ONE
device-to-host copy; the host then finds each winner's exact sort values.
With the node setting `search.result_page.enabled`, a single numeric /
date / boolean sort (or a score sort) merges the segments' winners on the
device instead (K14, ops/page.py) and the copy is the packed page.
"""

from __future__ import annotations

import fnmatch
import functools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError,
                                                QueryShardError)
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import Segment, pad_bucket
from opensearch_tpu_torch.ops.bm25 import (BLOCKMAX_MIN_BLOCKS,
                                           BLOCKMAX_SLICE_BLOCKS,
                                           CANDIDATE_MAX_LANES,
                                           CANDIDATE_MAX_TERMS,
                                           blockmax_keep_mask,
                                           bm25_candidate)
from opensearch_tpu_torch.ops.device_segment import (DeviceSegmentMeta,
                                                     live_mask, tree_nbytes,
                                                     upload_segment)
from opensearch_tpu_torch.ops.hybrid import hybrid_window
from opensearch_tpu_torch.ops.page import page_merge
from opensearch_tpu_torch.ops.sort_key import build_sort_key
from opensearch_tpu_torch.ops.topk import (NEG_INF, f32_sortable,
                                           masked_topk, masked_topk_keyed,
                                           single_valued, unpack_keyed_rows,
                                           unpack_rows)
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.aggs.engine import (_decode_agg_row,
                                                     agg_out_layout,
                                                     agg_statics,
                                                     compile_aggs,
                                                     device_nodes, eval_aggs,
                                                     pack_agg_rows,
                                                     unsupported_aggs)
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
from opensearch_tpu_torch.search.aggs.pipeline import apply_pipelines
from opensearch_tpu_torch.search.aggs.reduce import (decode_outputs,
                                                     reduce_aggs)
from opensearch_tpu_torch.search.compile import (Compiler, Plan, ShardStats,
                                                 plan_struct)
from opensearch_tpu_torch.search.plan_eval import _eval_plan


class ShardReader:
    """A shard's sealed segments and their device images. `segments` and
    `device` are published together as one tuple, so a search holding a
    `stats_snapshot()` never pairs a segment with another segment's
    image."""

    def __init__(self, mapper: MapperService, device: torch.device,
                 index_name: str = "_index"):
        self.mapper = mapper
        self.torch_device = torch.device(device)
        self.index_name = index_name
        self._published: Tuple[List[Segment],
                               List[Tuple[Dict, DeviceSegmentMeta]]] = \
            ([], [])
        self._stats: Optional[ShardStats] = None
        self._lock = threading.Lock()

    @property
    def segments(self) -> List[Segment]:
        return self._published[0]

    @property
    def device(self) -> List[Tuple[Dict, DeviceSegmentMeta]]:
        return self._published[1]

    def stats_snapshot(self) -> Tuple[ShardStats, List[Segment], list]:
        segs, dev = self._published
        stats = self._stats
        if stats is None or stats.segments != segs:
            stats = self._stats = ShardStats(segs)
        return stats, segs, dev

    def device_bytes(self) -> int:
        return sum(tree_nbytes(arrays) for arrays, _ in self.device)

    def add_segment(self, seg: Segment) -> None:
        arrays, meta = upload_segment(seg, self.torch_device)
        with self._lock:
            segs, dev = self._published
            self._published = (segs + [seg], dev + [(arrays, meta)])

    def update_live(self, seg: Segment) -> None:
        """Re-upload one segment's live mask after deletes."""
        with self._lock:
            segs, dev = self._published
            for i, s in enumerate(segs):
                if s is seg:
                    arrays, meta = dev[i]
                    arrays = dict(arrays)
                    arrays["live"] = torch.from_numpy(
                        live_mask(seg, meta.d_pad)).to(self.torch_device)
                    self._published = (list(segs), dev[:i]
                                       + [(arrays, meta)] + dev[i + 1:])
                    return


# ---------------------------------------------------- packed input envelope

def pack_leaves(leaves: List[np.ndarray], pin: bool = False):
    """Concatenate i32 / f32 / bool leaves into one int32 host buffer (a
    torch tensor, pinned when `pin`) + the static layout."""
    total = 0
    metas = []
    for leaf in leaves:
        n = int(np.prod(leaf.shape)) if leaf.ndim else 1
        metas.append((total, tuple(leaf.shape), str(leaf.dtype)))
        total += n
    buf_t = torch.empty(max(total, 1), dtype=torch.int32, pin_memory=pin)
    buf = buf_t.numpy()
    for leaf, (off, shape, dtype) in zip(leaves, metas):
        n = int(np.prod(shape)) if shape else 1
        flat = np.ascontiguousarray(leaf).reshape(-1)
        if leaf.dtype == np.float32:
            flat = flat.view(np.int32)
        elif leaf.dtype == np.bool_:
            flat = flat.astype(np.int32)
        elif leaf.dtype != np.int32:
            raise ValueError(f"unsupported envelope dtype [{leaf.dtype}]")
        buf[off:off + n] = flat
    return buf_t, tuple(metas)


def unpack_leaves(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """Device-side inverse of pack_leaves: every i32 / f32 leaf is a view of
    the uploaded buffer (bool leaves are one small compare)."""
    out = []
    for off, shape, dtype in layout:
        n = int(np.prod(shape)) if shape else 1
        piece = buf[off:off + n]
        if dtype == "float32":
            piece = piece.view(torch.float32)
        elif dtype == "bool":
            piece = piece != 0
        out.append(piece.reshape(shape))
    return out


# fill values for leaves grown to a common shape (inert lanes)
_PAD_FILL = {"ids": -1, "avgdl": 1.0}


def stack_flat_inputs(flats: List[List[Dict[str, np.ndarray]]]):
    """Batch-stack per-query flat input trees, growing each leaf to the
    per-position max shape with inert fill. Returns (stacked leaves,
    treedef) where treedef is the per-node key list."""
    treedef = tuple(tuple(d.keys()) for d in flats[0])
    stacked = []
    for node_i, keys in enumerate(treedef):
        for key in keys:
            arrs = [np.asarray(f[node_i][key]) for f in flats]
            a0 = arrs[0]
            shape = tuple(max(a.shape[d] for a in arrs)
                          for d in range(a0.ndim))
            if all(a.shape == shape for a in arrs):
                stacked.append(np.stack(arrs))
                continue
            out = np.full((len(arrs), *shape), _PAD_FILL.get(key, 0),
                          dtype=a0.dtype)
            for qi, a in enumerate(arrs):
                out[(qi, *map(slice, a.shape))] = a
            stacked.append(out)
    return stacked, treedef


def stage_inputs(flats: List[List[Dict[str, np.ndarray]]],
                 min_scores: np.ndarray, dev: torch.device):
    """A group's per-query flat inputs stacked, packed into one (pinned)
    host buffer, uploaded once and unpacked into views: (per-node input
    dicts, min_score [B])."""
    stacked, treedef = stack_flat_inputs(flats)
    stacked.append(min_scores)
    buf, layout = pack_leaves(stacked, pin=dev.type == "cuda")
    leaves = unpack_leaves(buf.to(dev, non_blocking=True), layout)
    return unflatten_inputs(treedef, leaves[:-1]), leaves[-1]


def stage_single(flat: List[Dict[str, np.ndarray]], min_score: float,
                 dev: torch.device):
    """One query's plan inputs for the general path (B=1): the small
    leaves through the packed envelope (one upload), and each bool leaf
    as long as a segment (a cached filter mask) apart, as bytes rather
    than as int32 lanes of the envelope."""
    small, apart = [], {}
    for node_i, d in enumerate(flat):
        keep = {}
        for key, v in d.items():
            v = np.asarray(v)
            if v.dtype == np.bool_ and v.size > 4096:
                apart[(node_i, key)] = torch.from_numpy(v[None]).to(dev)
            else:
                keep[key] = v
        small.append(keep)
    inputs, ms = stage_inputs([small], np.asarray([min_score], np.float32),
                              dev)
    for (node_i, key), t in apart.items():
        inputs[node_i][key] = t
    return inputs, ms


def stage_rows(flats: List[List[Dict[str, np.ndarray]]], min_score: float,
               dev: torch.device):
    """The multi-shard query phase's inputs: every row's plan inputs (B=1
    each) packed into ONE (pinned) host buffer and uploaded once. Returns
    (per-row input dicts, per-row min_score f32 [1] views)."""
    leaves: List[np.ndarray] = []
    parts = []
    for flat in flats:
        stacked, treedef = stack_flat_inputs([flat])
        parts.append((treedef, len(stacked)))
        leaves.extend(stacked)
    leaves.append(np.full(len(flats), min_score, dtype=np.float32))
    buf, layout = pack_leaves(leaves, pin=dev.type == "cuda")
    views = unpack_leaves(buf.to(dev, non_blocking=True), layout)
    out, i = [], 0
    for treedef, n in parts:
        out.append(unflatten_inputs(treedef, views[i:i + n]))
        i += n
    ms = views[-1]
    return out, [ms[r:r + 1] for r in range(len(flats))]


def unflatten_inputs(treedef, leaves: List[torch.Tensor]):
    """Inverse of stack_flat_inputs' flattening: one input dict per plan
    node, in flatten order."""
    out, i = [], 0
    for keys in treedef:
        out.append(dict(zip(keys, leaves[i:i + len(keys)])))
        i += len(keys)
    return out


# ------------------------------------------------------------ kernel choice

def _candidate_kernel_fits(kind: str, n_terms: int, qb_lanes: int) -> bool:
    """THE candidate-vs-dense decision: the candidate-buffer kernel serves a
    plain text clause of at most 16 terms and 16,384 lanes."""
    return kind == "text" and n_terms <= CANDIDATE_MAX_TERMS \
        and 0 < qb_lanes <= CANDIDATE_MAX_LANES


def _envelope_kernel(plan: Plan) -> str:
    """The kernel class that serves one item's plan: `candidate` or
    `dense`."""
    n_terms = plan.static[1] if plan.kind == "text" \
        and len(plan.static) > 1 else 1 << 30
    ids = plan.inputs.get("ids")
    qb128 = ids.shape[-1] * 128 if ids is not None else 0
    return "candidate" \
        if _candidate_kernel_fits(plan.kind, n_terms, qb128) else "dense"


def _blockmax_admitted(plan: Optional[Plan], k: int) -> bool:
    """Block-max admission in the envelope, shared by the runner (which
    kernels launch) and the decode (whether the packed rows carry the
    pruned-count lane): a non-constant text clause compiled with the gate
    on (it carries `tid`), on the candidate kernel, with enough lanes for
    a slice pass and a k the slice can cover."""
    if plan is None or plan.kind != "text" or plan.static[0] \
            or "tid" not in plan.inputs:
        return False
    n_blocks = plan.inputs["ids"].shape[-1]
    return (n_blocks >= BLOCKMAX_MIN_BLOCKS
            and 0 < k <= BLOCKMAX_SLICE_BLOCKS * 128
            and _envelope_kernel(plan) == "candidate")


def build_candidate_query_phase(plan: Plan, k: int, bm: bool = False):
    """B single-text-clause queries against one segment through the
    candidate-buffer kernel (K1); with `bm` (block-max admitted) K20's
    keep mask first, and each packed row gains the pruned-count lane."""
    constant = plan.static[0]
    n_terms = plan.static[1]

    def run(seg, inputs, min_score):
        if bm:
            keep, pruned = blockmax_keep_mask(seg, inputs[0], n_terms, k,
                                              min_score)
            return bm25_candidate(seg, inputs[0], n_terms, constant, k,
                                  min_score, block_keep=keep, pruned=pruned)
        return bm25_candidate(seg, inputs[0], n_terms, constant, k,
                              min_score)
    return run


def build_batched_query_phase(plan: Plan, meta: DeviceSegmentMeta, k: int):
    """B same-shaped queries against one segment through the dense path:
    plan evaluation (K2 per text clause) then the masked top-k (K3)."""

    def run(seg, inputs, min_score):
        bsz = min_score.shape[0]
        scores, matches = _eval_plan(plan, seg, inputs, [0], bsz)
        k_eff = min(k, seg["live"].shape[0])
        return masked_topk(scores, matches, seg["live"], seg["root"],
                           meta.num_docs, min_score, k_eff)
    return run


def build_query_phase(plan: Plan, meta: DeviceSegmentMeta, k: int,
                      agg_plans=(), seg_host: Optional[Segment] = None):
    """The general path's single-segment query phase (B=1): plan
    evaluation, then K3's keyed entry over the field sort's key (K13's
    output; the scores for a score sort), k up to 65,536, and for a body
    with aggregations the aggregation pass over the same eligibility, its
    partials appended to the row. Returns (run, agg out_layout)."""
    out_layout = agg_out_layout(list(agg_plans))[0] if agg_plans else None

    def run(seg, inputs, sort_key, min_score):
        cursor = [0]
        scores, matches = _eval_plan(plan, seg, inputs, cursor, 1)
        scores, matches = scores.contiguous(), matches.contiguous()
        d_pad = seg["live"].shape[0]
        row = masked_topk_keyed(scores, matches, seg["live"], seg["root"],
                                meta.num_docs, min_score, sort_key,
                                min(k, d_pad))
        if not agg_plans:
            return row
        in_seg = torch.arange(d_pad, device=scores.device) < meta.num_docs
        eligible = matches & seg["live"] & seg["root"] & in_seg \
            & (scores >= min_score[:, None])
        outs: List[dict] = []
        eval_aggs(list(agg_plans), seg, inputs, cursor, eligible, outs,
                  agg_statics(seg_host, list(agg_plans), scores.device))
        return torch.cat([row, pack_agg_rows(outs, out_layout, 1,
                                             scores.device)], dim=1)
    return run, out_layout


def build_batched_agg_query_phase(plan: Plan, meta: DeviceSegmentMeta,
                                  k: int, agg_plans, seg_host: Segment):
    """B same-shaped queries WITH aggregations against one segment: plan
    evaluation, the masked top-k (K3; k=0 gives the size-0 totals), then
    the aggregation pass over the dense eligibility mask. Every agg partial
    is bit-cast to f32 and appended to the packed hit row, so the group
    still fetches as ONE [B, 2k+1+W] array. Returns (rows, out_layout)."""
    out_layout, _width = agg_out_layout(agg_plans)

    def run(seg, inputs, min_score):
        bsz = min_score.shape[0]
        cursor = [0]
        scores, matches = _eval_plan(plan, seg, inputs, cursor, bsz)
        d_pad = seg["live"].shape[0]
        in_seg = torch.arange(d_pad, device=scores.device) < meta.num_docs
        eligible = matches & seg["live"] & seg["root"] & in_seg \
            & (scores >= min_score[:, None])
        rows = masked_topk(scores, eligible, seg["live"], seg["root"],
                           meta.num_docs, min_score, min(k, d_pad))
        outs: List[dict] = []
        eval_aggs(agg_plans, seg, inputs, cursor, eligible, outs,
                  agg_statics(seg_host, agg_plans, scores.device))
        tail = pack_agg_rows(outs, out_layout, bsz, scores.device)
        return torch.cat([rows, tail], dim=1)
    return run, out_layout


def build_hybrid_query_phase(plans: List[Plan], meta: DeviceSegmentMeta,
                             k: int):
    """B same-shaped hybrid queries against one segment: each sub-query's
    plan, its eligibility (matches & live & root & in-segment & score >=
    min_score) and its K3 window, then K12's per-sub-query count / min /
    max / sum of squares over the window and the union total of the
    eligibilities. Returns f32 [B, n_sub * (2k + 4) + 1] rows, the
    reference's fused row layout."""

    def run(seg, inputs, min_score):
        bsz = min_score.shape[0]
        cursor = [0]
        d_pad = seg["live"].shape[0]
        dev = seg["live"].device
        in_seg = torch.arange(d_pad, device=dev) < meta.num_docs
        base = seg["live"] & seg["root"] & in_seg
        eligible = torch.empty(len(plans), bsz, d_pad, dtype=torch.bool,
                               device=dev)
        k_eff = min(k, d_pad)
        rows = []
        for i, plan in enumerate(plans):
            scores, matches = _eval_plan(plan, seg, inputs, cursor, bsz)
            torch.logical_and(matches & base,
                              scores >= min_score[:, None], out=eligible[i])
            rows.append(masked_topk(scores.contiguous(), eligible[i],
                                    seg["live"], seg["root"], meta.num_docs,
                                    min_score, k_eff))
        return hybrid_window(torch.stack(rows), eligible, k_eff)
    return run


def _decode_hybrid_row(row: np.ndarray, k_seg: int, n_sub: int):
    """Invert one segment's fused hybrid row: per-sub (scores, ords,
    count, min, max, sum_sq) channels + the trailing union total."""
    out = []
    off = 0
    for _ in range(n_sub):
        scores = row[off:off + k_seg]
        ords = row[off + k_seg:off + 2 * k_seg].view(np.int32)
        off += 2 * k_seg
        cnt = int(row[off:off + 1].view(np.int32)[0])
        mn, mx, ssq = (float(row[off + 1]), float(row[off + 2]),
                       float(row[off + 3]))
        off += 4
        out.append((scores, ords, cnt, mn, mx, ssq))
    total = int(row[off:off + 1].view(np.int32)[0])
    return out, total


# body keys the batched hybrid wave fully renders (weights and techniques
# come from the default spec, not the body)
_HYBRID_BATCHABLE_KEYS = frozenset({"query", "size", "from", "min_score",
                                    "_source", "track_total_hits"})


def _contains_hybrid(query_spec) -> bool:
    """A top-level hybrid clause, detected on the raw body."""
    return isinstance(query_spec, dict) and "hybrid" in query_spec


def _hybrid_msearch_batchable(body: dict) -> bool:
    return (_contains_hybrid(body.get("query"))
            and set(body) <= _HYBRID_BATCHABLE_KEYS)


class HybridShardResult:
    """One shard's fused hybrid query phase output: per-sub-query candidate
    lists, per-sub-query (min, max, sum_sq, count) bounds, the union total
    and the segments snapshot the candidates index into."""
    __slots__ = ("per_sub", "bounds", "total", "segments")

    def __init__(self, per_sub, bounds, total, segments=None):
        self.per_sub = per_sub      # [sub][(score, seg_i, ord), ...]
        self.bounds = bounds        # [sub](min, max, sum_sq, count)
        self.total = total
        self.segments = segments


def _empty_hybrid_result(n_sub: int, segments=None) -> HybridShardResult:
    return HybridShardResult(
        [[] for _ in range(n_sub)],
        [[float("inf"), float("-inf"), 0.0, 0] for _ in range(n_sub)], 0,
        segments)


def _accumulate_hybrid_row(result: HybridShardResult, row: np.ndarray,
                           seg_i: int, k_seg: int, n_sub: int) -> None:
    channels, total = _decode_hybrid_row(row, k_seg, n_sub)
    for i, (scores, ords, cnt, mn, mx, ssq) in enumerate(channels):
        # the window is score-desc with padding last: its first cnt lanes
        # are the valid candidates
        for sc, o in zip(scores[:cnt].tolist(), ords[:cnt].tolist()):
            result.per_sub[i].append((sc, seg_i, o))
        if cnt:
            b = result.bounds[i]
            b[0] = min(b[0], mn)
            b[1] = max(b[1], mx)
            b[2] += ssq
            b[3] += cnt
    result.total += total


def _envelope_runner(plan: Plan, meta: DeviceSegmentMeta, k: int):
    if _envelope_kernel(plan) == "candidate":
        return build_candidate_query_phase(
            plan, k, bm=_blockmax_admitted(plan, k))
    return build_batched_query_phase(plan, meta, k)


# ------------------------------------------- general path: sorts, the page

class _Candidate:
    __slots__ = ("score", "seg_i", "ord", "sort_values", "shard_i",
                 "dv_page")

    def __init__(self, score, seg_i, ord_, sort_values, shard_i=0):
        self.score = score
        self.seg_i = seg_i
        self.ord = ord_
        self.sort_values = sort_values  # parallel to the sort specs; None = missing
        self.shard_i = shard_i          # coordinator-side shard index
        # result-page prefetch: {field: [raw values]} decoded from the
        # fused docvalue lanes; None = no page rode this candidate (fetch
        # scans the host column)
        self.dv_page = None


def _compare_candidates(specs):
    """Multi-key comparator with missing-last semantics. Final tie-break
    (shard, segment, doc) asc: mergeTopDocs order."""
    def cmp(a: _Candidate, b: _Candidate) -> int:
        for i, (field, order) in enumerate(specs):
            va, vb = a.sort_values[i], b.sort_values[i]
            if va is None and vb is None:
                continue
            if va is None:
                return 1   # missing sorts last
            if vb is None:
                return -1
            if va != vb:
                lt = va < vb
                if order == "desc":
                    lt = not lt
                return -1 if lt else 1
        if a.shard_i != b.shard_i:
            return -1 if a.shard_i < b.shard_i else 1
        if a.seg_i != b.seg_i:
            return -1 if a.seg_i < b.seg_i else 1
        return -1 if a.ord < b.ord else 1
    return functools.cmp_to_key(cmp)


def sort_candidates(candidates: List[_Candidate], specs) -> None:
    """Sort in place in _compare_candidates' order. When every sort value
    is a number (or missing) the order is a plain tuple key, (missing,
    value or -value) per spec then (shard, segment, doc), which Python
    sorts without a comparator call per pair; keyword values keep the
    comparator."""
    if all(v is None or isinstance(v, (int, float))
           for c in candidates for v in c.sort_values):
        desc = [order == "desc" for _f, order in specs]

        def key(c: _Candidate):
            parts = []
            for d, v in zip(desc, c.sort_values):
                parts.append((1, 0) if v is None else (0, -v if d else v))
            return (*parts, c.shard_i, c.seg_i, c.ord)
        candidates.sort(key=key)
    else:
        candidates.sort(key=_compare_candidates(specs))


def _parse_sort(sort_body) -> List[Tuple[str, str]]:
    """Normalize the sort body to [(field | '_score', order), ...].
    Default (None / empty / '_score') is score-descending."""
    if sort_body is None:
        return [("_score", "desc")]
    specs = sort_body if isinstance(sort_body, list) else [sort_body]
    out: List[Tuple[str, str]] = []
    for spec in specs:
        if isinstance(spec, str):
            if spec == "_score":
                out.append(("_score", "desc"))
            elif spec == "_doc":
                continue  # doc order is the built-in final tie-break
            else:
                out.append((spec, "asc"))
        elif isinstance(spec, dict):
            field, opts = next(iter(spec.items()))
            if field == "_score":
                order = opts.get("order", "desc") if isinstance(opts, dict) \
                    else str(opts)
                out.append(("_score", order))
            else:
                order = opts.get("order", "asc") if isinstance(opts, dict) \
                    else str(opts)
                out.append((field, order))
    if not out:
        return [("_score", "desc")]
    return out


def _doc_slice(doc_ids: np.ndarray, ord_: int) -> slice:
    """The doc's (doc, value) pairs: columns keep their pairs sorted by doc
    (segment_from_arrays refuses any other order), so two binary searches
    find them, not a scan of the column."""
    # the probe in the column's own dtype: a Python int would make numpy
    # cast the whole column first
    probe = doc_ids.dtype.type(ord_)
    return slice(int(np.searchsorted(doc_ids, probe, "left")),
                 int(np.searchsorted(doc_ids, probe, "right")))


def _sort_value(seg: Segment, field: str, order: str, ord_: int):
    """The exact (host) sort value of one doc, for the cross-segment merge
    and the response: the min (asc) or max (desc) of its values; None when
    it has none."""
    col = seg.numeric_dv.get(field)
    if col is not None:
        vals = col.values[_doc_slice(col.doc_ids, ord_)]
        if len(vals) == 0:
            return None
        v = float(vals.min() if order == "asc" else vals.max())
        return int(v) if v.is_integer() else v
    ocol = seg.ordinal_dv.get(field)
    if ocol is not None:
        ords = ocol.ords[_doc_slice(ocol.doc_ids, ord_)]
        if len(ords) == 0:
            return None
        o = int(ords.min() if order == "asc" else ords.max())
        return ocol.dictionary[o]
    return None


def _sort_values(seg: Segment, specs, ords: np.ndarray,
                 scores: List[float]) -> List[list]:
    """_sort_value of every winner of one segment, per sort spec; a
    single-valued numeric column takes one vectorized lookup."""
    cols = []
    for field, order in specs:
        if field == "_score":
            cols.append(scores)
            continue
        col = seg.numeric_dv.get(field)
        if col is not None and len(col.doc_ids) and single_valued(col):
            lo = np.searchsorted(col.doc_ids, ords, "left")
            has = lo < np.searchsorted(col.doc_ids, ords, "right")
            vals = col.values[np.minimum(lo, len(col.values) - 1)]
            cols.append([(int(v) if v.is_integer() else v) if h else None
                         for v, h in zip(vals.tolist(), has.tolist())])
            continue
        cols.append([_sort_value(seg, field, order, o)
                     for o in ords.tolist()])
    return [list(vs) for vs in zip(*cols)]


def _page_sort_mode(sort_specs, mapper):
    """Static result-page admission: ("score",) / ("field", name, order)
    when the request's result assembly can ride the on-device merge, None
    for the host merge: one sort key only, a numeric / date / boolean
    field (keyword ordinals do not compare across segments)."""
    if len(sort_specs) != 1:
        return None
    field, order = sort_specs[0]
    if field == "_score":
        return ("score",)
    ft = mapper.get_field(field)
    if ft is None or not (ft.is_numeric or ft.is_date or ft.is_bool):
        return None
    return ("field", field, order)


def _page_dv_fields(body: dict, mapper) -> tuple:
    """The docvalue_fields a result page can fuse: numeric-typed fields
    (decoded as rank -> host unique[], exact f64). Keyword fields keep the
    host scan; multi-valued columns fall back per segment."""
    out = []
    for spec in body.get("docvalue_fields") or []:
        field = spec["field"] if isinstance(spec, dict) else spec
        ft = mapper.get_field(field)
        if ft is not None and (ft.is_numeric or ft.is_date or ft.is_bool) \
                and field not in out:
            out.append(field)
    return tuple(out)


def _page_segment_admit(seg: Segment, arrays, meta: DeviceSegmentMeta,
                        mode, dv_fields):
    """Per-segment page admission and the columns the segment contributes.
    None disqualifies the whole request (a sort column whose values are
    not exactly f32-representable: selection by the f32 key would diverge
    from the host's exact keys). Per docvalue field: `col` (device gather
    + host unique[] decode), `absent` (no column: no values) or `host`
    (multi-valued: the fetch phase's host scan)."""
    out = {"d_pad": meta.d_pad, "sort_col": None, "sort_host": None,
           "dv_state": {}}
    if mode[0] == "field":
        field = mode[1]
        host = seg.numeric_dv.get(field)
        if host is not None and not f32_sortable(host):
            return None
        out["sort_col"] = arrays["numeric"].get(field)
        out["sort_host"] = host
    for f in dv_fields:
        host = seg.numeric_dv.get(f)
        dev = arrays["numeric"].get(f)
        if host is None and f not in seg.ordinal_dv:
            out["dv_state"][f] = ("absent", None, None)
        elif host is not None and dev is not None and single_valued(host):
            out["dv_state"][f] = ("col", dev, host)
        else:
            out["dv_state"][f] = ("host", None, None)
    return out


# --------------------------------------------------------------- responses

_BATCHABLE_KEYS = frozenset({"query", "size", "from", "min_score", "sort",
                             "_source", "aggs", "aggregations"})


def _contains_inner_hits(obj) -> bool:
    if isinstance(obj, dict):
        return "inner_hits" in obj or any(_contains_inner_hits(v)
                                          for v in obj.values())
    if isinstance(obj, list):
        return any(_contains_inner_hits(v) for v in obj)
    return False


def _msearch_batchable(body: dict) -> bool:
    """A plain score-sorted body the envelope renders whole (a hybrid body
    runs its own fused phase; inner_hits need the general path's fetch
    phase)."""
    return set(body) <= _BATCHABLE_KEYS \
        and body.get("sort") in (None, "_score", ["_score"]) \
        and not _contains_inner_hits(body.get("query")) \
        and not _contains_hybrid(body.get("query"))


def _base_response(took_ms: int, total: int, max_score, hits: list) -> dict:
    return {
        "took": took_ms,
        "timed_out": False,
        "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": "eq"},
                 "max_score": max_score, "hits": hits},
    }


def _item_error(e: OpenSearchTpuError) -> dict:
    return {"error": e.to_xcontent(), "status": e.status}


def _req_int(body: dict, key: str, default: int) -> int:
    try:
        return int(body.get(key, default))
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"Failed to parse int parameter [{key}] with value "
            f"[{body.get(key)!r}]")


def _req_min_score(body: dict) -> float:
    raw = body.get("min_score")
    if raw is None:
        return NEG_INF
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"Failed to parse float parameter [min_score] with value "
            f"[{raw!r}]")


class SearchExecutor:
    """Executes search requests against one shard (query + fetch)."""

    def __init__(self, reader: ShardReader, result_page: bool = False,
                 blockmax: bool = False):
        self.reader = reader
        self.max_result_window = 10000
        # the node's static `search.result_page.enabled`: field-sorted
        # pages merge their segments on the device (K14)
        self.result_page = result_page
        # the node's static `search.blockmax.enabled`: text clauses compile
        # with block-max phase A's inputs, and the envelope's candidate
        # kernel and the multi-shard program prune blocks (K20)
        self.blockmax = blockmax

    def search(self, body: Optional[dict] = None,
               phase_spec: Optional[dict] = None,
               _direct: bool = False) -> dict:
        """One search: a score-sorted plain body runs the msearch envelope
        at B=1; a hybrid body runs the fused hybrid phase at B=1 and
        merges under `phase_spec` (a search pipeline's normalization spec;
        None: the defaults); every other body (or any body with
        `_direct`) takes the general path of search/controller.py. Errors
        raise."""
        body = body or {}
        if not _direct and _msearch_batchable(body):
            return self.multi_search([body],
                                     _raise_item_errors=True)["responses"][0]
        from opensearch_tpu_torch.search.controller import execute_search
        return execute_search([self], body, phase_spec)

    def multi_search(self, bodies: List[dict],
                     _raise_item_errors: bool = False) -> dict:
        """_msearch: same-shaped queries run as one batch per segment. A
        malformed sub-request renders as a per-item error object (or raises
        with `_raise_item_errors`, the single-search contract)."""
        start = time.monotonic()
        responses: List[Optional[dict]] = [None] * len(bodies)
        batchable = []
        hybrid_items = []
        for i, body in enumerate(bodies):
            body = body or {}
            try:
                if _hybrid_msearch_batchable(body):
                    hybrid_items.append((i, body))
                elif not _msearch_batchable(body):
                    # a hybrid companion the wave does not render, a field
                    # sort, search_after, fetch options...: the general
                    # path answers it (or its error), one item at a time
                    responses[i] = self.search(body, _direct=True)
                else:
                    batchable.append(self._parse_one(i, body))
            except OpenSearchTpuError as e:
                if _raise_item_errors:
                    raise
                responses[i] = _item_error(e)
        if batchable:
            self._run_batch(batchable, responses, start, _raise_item_errors)
        if hybrid_items:
            self._run_hybrid_wave(hybrid_items, responses, start,
                                  _raise_item_errors)
        return {"took": int((time.monotonic() - start) * 1000),
                "responses": responses}

    def execute_hybrid_query_phase(self, body: dict,
                                   k: int) -> HybridShardResult:
        """This shard's fused hybrid query phase for one body: every
        sub-query's window and bounds, per segment, through the batched
        wave's programs at B=1 (so a single search and an `_msearch` item
        compute the same bits)."""
        node = dsl.parse_query(body.get("query"))
        if not isinstance(node, dsl.HybridQuery):
            raise IllegalArgumentError(
                "execute_hybrid_query_phase requires a top-level [hybrid] "
                "query")
        return self._hybrid_results([(0, node, _req_min_score(body), k)],
                                    {}, True)[0]

    def _run_hybrid_wave(self, items, responses, start: float,
                         raise_item_errors: bool) -> None:
        """The `_msearch` hybrid wave: same-shaped hybrid bodies run as one
        batch per segment and render under the default normalization spec
        (a named or index pipeline routes its items through the REST
        search path instead)."""
        from opensearch_tpu_torch.searchpipeline import hybrid as hyb
        prepared = []
        for i, body in items:
            try:
                node = dsl.parse_query(body.get("query"))
                _s, _f, k = hyb.validate_hybrid_request(
                    body, len(node.queries), hyb.DEFAULT_SPEC, [self])
                prepared.append((i, node, _req_min_score(body), k))
            except OpenSearchTpuError as e:
                if raise_item_errors:
                    raise
                responses[i] = _item_error(e)
        results = self._hybrid_results(prepared, responses,
                                       raise_item_errors)
        body_of = dict(items)
        for i, node, _ms, _k in prepared:
            if i in results:
                responses[i] = hyb.merge_and_render(
                    [self], body_of[i], [results[i]], hyb.DEFAULT_SPEC,
                    start, len(node.queries))

    def _hybrid_results(self, items, responses, raise_item_errors: bool
                        ) -> Dict[int, HybridShardResult]:
        """Fused hybrid query phases of items [(i, HybridQuery, min_score,
        k)]: grouped by plan structure, input shapes and window, each group
        one batch per segment, every group's rows fetched in ONE copy."""
        stats, segments, device = self.reader.stats_snapshot()
        compiler = Compiler(self.reader.mapper, stats,
                            blockmax=self.blockmax)
        dev = self.reader.torch_device
        groups: Dict[Any, List[int]] = {}
        prepared: Dict[int, tuple] = {}
        for i, node, min_score, k in items:
            try:
                plans_per_seg = [
                    [compiler.compile(q, seg, meta) for q in node.queries]
                    if seg.num_docs else None
                    for seg, (_a, meta) in zip(segments, device)]
            except OpenSearchTpuError as e:
                if raise_item_errors:
                    raise
                responses[i] = _item_error(e)
                continue
            flats = []
            for plans in plans_per_seg:
                flat = None
                if plans is not None:
                    flat = []
                    for p in plans:
                        p.flatten_inputs(flat)
                flats.append(flat)
            struct = tuple(None if plans is None
                           else tuple(plan_struct(p) for p in plans)
                           for plans in plans_per_seg)
            shape_sig = tuple(
                None if f is None else tuple(
                    (key, v.shape, v.dtype.num)
                    for d in f for key, v in d.items())
                for f in flats)
            k_fetch = min(k, 1 << 16)
            prepared[i] = (len(node.queries), min_score, plans_per_seg,
                           flats)
            groups.setdefault((struct, shape_sig, k_fetch), []).append(i)
        pending = []
        for (_struct, _shape, k_fetch), idxs in groups.items():
            min_scores = np.asarray([prepared[i][1] for i in idxs],
                                    dtype=np.float32)
            for seg_i, (seg, (arrays, meta)) in enumerate(
                    zip(segments, device)):
                if seg.num_docs == 0:
                    continue
                inputs, ms = stage_inputs(
                    [prepared[i][3][seg_i] for i in idxs], min_scores, dev)
                k_seg = min(k_fetch, pad_bucket(max(seg.num_docs, 1)))
                plans0 = prepared[idxs[0]][2][seg_i]
                out = build_hybrid_query_phase(plans0, meta, k_seg)(
                    arrays, inputs, ms)
                pending.append((idxs, seg_i, k_seg, len(plans0), out))
        results = {i: _empty_hybrid_result(prepared[i][0], segments)
                   for i in prepared}
        if pending:
            fetched = _fetch_rows([p[4] for p in pending])
            for (idxs, seg_i, k_seg, n_sub, _), rows in zip(pending,
                                                            fetched):
                for row_i, i in enumerate(idxs):
                    _accumulate_hybrid_row(results[i], rows[row_i], seg_i,
                                           k_seg, n_sub)
        for result in results.values():
            result.bounds = [tuple(b) for b in result.bounds]
        return results

    def _parse_one(self, i: int, body: dict):
        node = dsl.parse_query(body.get("query"))
        size = _req_int(body, "size", 10)
        from_ = _req_int(body, "from", 0)
        if size < 0 or from_ < 0:
            raise IllegalArgumentError(
                "[from] parameter cannot be negative" if from_ < 0
                else "[size] parameter cannot be negative")
        if from_ + size > self.max_result_window:
            raise IllegalArgumentError(
                f"Result window is too large, from + size must be "
                f"less than or equal to: [{self.max_result_window}] "
                f"but was [{from_ + size}]. See the scroll api for a "
                f"more efficient way to request large data sets. This "
                f"limit can be set by changing the "
                f"[index.max_result_window] index level setting.")
        agg_spec = body.get("aggs") or body.get("aggregations")
        agg_nodes = parse_aggs(agg_spec)
        missing = unsupported_aggs(agg_nodes)
        if missing is not None:
            raise QueryShardError(
                f"aggregation type [{missing}] is not supported")
        agg_json = json.dumps(agg_spec, sort_keys=True, default=str) \
            if agg_nodes else None
        return (i, body, node, size, from_, _req_min_score(body), agg_nodes,
                agg_json)

    def _run_batch(self, batchable, responses, start: float,
                   raise_item_errors: bool) -> None:
        stats, segments, device = self.reader.stats_snapshot()
        compiler = Compiler(self.reader.mapper, stats,
                            blockmax=self.blockmax)
        dev = self.reader.torch_device
        groups: Dict[Any, List[int]] = {}
        plans_by_i: Dict[int, List[Optional[Plan]]] = {}
        aggs_by_i: Dict[int, list] = {}
        flats_by_i: Dict[int, List[Optional[list]]] = {}
        entry_by_i = {e[0]: e for e in batchable}
        for i, body, node, size, from_, _ms, agg_nodes, agg_json \
                in batchable:
            try:
                plans = [compiler.compile(node, seg, meta)
                         if seg.num_docs else None
                         for seg, (_a, meta) in zip(segments, device)]
                agg_plans = [
                    self._agg_plans(stats, compiler, agg_nodes, agg_json,
                                    seg, meta)
                    if agg_nodes and seg.num_docs else []
                    for seg, (_a, meta) in zip(segments, device)]
            except OpenSearchTpuError as e:
                if raise_item_errors:
                    raise
                responses[i] = _item_error(e)
                continue
            # no tie overfetch: per-segment top-k (score desc, doc asc)
            # merges to the exact global page
            k = 0 if from_ + size == 0 else max(from_ + size, 10)
            if not agg_nodes and all(p is None or p.kind == "match_none"
                                     for p in plans):
                # nothing can match: no device work (an agg body still
                # runs, for its empty buckets)
                responses[i] = _base_response(
                    int((time.monotonic() - start) * 1000), 0, None, [])
                continue
            flats = []
            for p, aplans in zip(plans, agg_plans):
                flat = None
                if p is not None:
                    flat = p.flatten_inputs([])
                    for ap in aplans:
                        ap.flatten_inputs(flat)
                flats.append(flat)
            struct = tuple(plan_struct(p) if p is not None else None
                           for p in plans)
            shape_sig = tuple(
                None if f is None else tuple(
                    (key, v.shape, v.dtype.num)
                    for d in f for key, v in d.items())
                for f in flats)
            agg_sig = tuple(tuple(ap.sig() for ap in aplans)
                            for aplans in agg_plans) if agg_nodes else None
            plans_by_i[i] = plans
            flats_by_i[i] = flats
            if agg_nodes:
                aggs_by_i[i] = agg_plans
            groups.setdefault((struct, agg_sig, shape_sig, min(k, 1 << 16)),
                              []).append(i)

        pending = []
        for (_struct, agg_sig, _shape, k_fetch), idxs in groups.items():
            min_scores = np.asarray([entry_by_i[i][5] for i in idxs],
                                    dtype=np.float32)
            for seg_i, (seg, (arrays, meta)) in enumerate(
                    zip(segments, device)):
                if seg.num_docs == 0:
                    continue
                inputs, ms = stage_inputs(
                    [flats_by_i[i][seg_i] for i in idxs], min_scores, dev)
                k_seg = min(k_fetch, pad_bucket(max(seg.num_docs, 1)))
                plan0 = plans_by_i[idxs[0]][seg_i]
                if agg_sig is not None:
                    run, out_layout = build_batched_agg_query_phase(
                        plan0, meta, k_seg, aggs_by_i[idxs[0]][seg_i], seg)
                else:
                    run = _envelope_runner(plan0, meta, k_seg)
                    out_layout = None
                out = run(arrays, inputs, ms)
                # bm: the packed rows carry the pruned-count lane (the
                # runner's own admission on the same plan and k)
                pending.append((idxs, seg_i, k_seg, out, out_layout,
                                agg_sig is None
                                and _blockmax_admitted(plan0, k_seg)))
        if pending:
            fetched = _fetch_rows([p[3] for p in pending])
            self._respond(pending, fetched, entry_by_i, aggs_by_i, segments,
                          responses, start)
        for i in plans_by_i:
            if responses[i] is None:
                # every segment of the snapshot is empty
                responses[i] = _base_response(
                    int((time.monotonic() - start) * 1000), 0, None, [])
                if i in aggs_by_i:
                    aggregations = {}
                    apply_pipelines(entry_by_i[i][6], aggregations)
                    responses[i]["aggregations"] = aggregations

    def execute_query_phase(self, body: dict, k: int, stats_override=None):
        """This shard's query phase on the general path: (candidates with
        their exact sort values, per-segment decoded agg partials, total
        hits) for the controller's merge. Per segment: the plan compiled
        with the filter cache installed, the sort key (K13), the plan and
        K3's keyed top-k of k + 128 lanes (and the agg pass), all on the
        device; every segment's row comes back in ONE copy, or, on the
        result page, the packed page (K14) does. `stats_override`: a DFS
        request's merged statistics (compile.StaticStats), which score in
        place of the shard's own."""
        from opensearch_tpu_torch.indices.query_cache import \
            FilterCacheContext
        node = dsl.parse_query(body.get("query"))
        min_score = _req_min_score(body)
        sort_specs = _parse_sort(body.get("sort"))
        score_sorted = sort_specs[0][0] == "_score"
        primary = None if score_sorted else sort_specs[0]
        stats, segments, device = self.reader.stats_snapshot()
        if stats_override is not None:
            stats = stats_override
        mapper = self.reader.mapper
        compiler = Compiler(mapper, stats, blockmax=self.blockmax)
        agg_spec = body.get("aggs") or body.get("aggregations")
        agg_nodes = parse_aggs(agg_spec)
        missing = unsupported_aggs(agg_nodes)
        if missing is not None:
            raise QueryShardError(
                f"aggregation type [{missing}] is not supported")
        agg_json = json.dumps(agg_spec, sort_keys=True, default=str) \
            if agg_nodes else None
        # over-fetch for ties and the cross-segment merge
        k_fetch = min(k + 128, 1 << 16)
        page_mode = _page_sort_mode(sort_specs, mapper) \
            if self.result_page else None
        page_dv = _page_dv_fields(body, mapper) \
            if page_mode is not None else ()
        page_rows: Optional[list] = [] if page_mode is not None else None
        dev = self.reader.torch_device
        launched = []
        for seg_i, (seg, (arrays, meta)) in enumerate(zip(segments,
                                                          device)):
            if seg.num_docs == 0:
                continue
            compiler.filter_ctx = FilterCacheContext(seg, arrays)
            try:
                plan = compiler.compile(node, seg, meta)
            finally:
                compiler.filter_ctx = None
            agg_plans = self._agg_plans(stats, compiler, agg_nodes,
                                        agg_json, seg, meta) \
                if agg_nodes else []
            if page_rows is not None:
                prow = _page_segment_admit(seg, arrays, meta, page_mode,
                                           page_dv)
                if prow is None:
                    page_rows = None
                else:
                    page_rows.append(prow)
            sort_key = build_sort_key(arrays, primary)
            k_seg = min(k_fetch, pad_bucket(max(seg.num_docs, 1)),
                        meta.d_pad)
            flat = plan.flatten_inputs([])
            for ap in agg_plans:
                ap.flatten_inputs(flat)
            inputs, ms = stage_single(flat, min_score, dev)
            run, out_layout = build_query_phase(plan, meta, k_seg,
                                                agg_plans, seg)
            launched.append((seg_i, seg, agg_plans, k_seg, out_layout,
                             run(arrays, inputs, sort_key, ms)))
        if not launched:
            return [], [], 0
        if page_rows is not None:
            page = self._page_build(launched, page_rows, page_mode, page_dv,
                                    k_fetch)
            if page is not None:
                return self._decode_page(page, launched, agg_nodes)
        fetched = _fetch_rows([out for *_, out in launched])
        candidates: List[_Candidate] = []
        per_segment_decoded = []
        total = 0
        for (seg_i, seg, agg_plans, k_seg, out_layout, _), rows in zip(
                launched, fetched):
            keys, scores, idx, totals = unpack_keyed_rows(
                rows[:, :3 * k_seg + 1], k_seg)
            if agg_nodes:
                per_segment_decoded.append(decode_outputs(
                    agg_plans, _decode_agg_row(rows[0, 3 * k_seg + 1:],
                                               out_layout)))
            total += int(totals[0])
            valid = keys[0] != NEG_INF      # ineligible / padding lanes
            ords = idx[0][valid]
            sc = scores[0][valid].tolist()
            values = _sort_values(seg, sort_specs, ords, sc)
            candidates.extend(
                _Candidate(score, seg_i, o, sv)
                for score, o, sv in zip(sc, ords.tolist(), values))
        return candidates, per_segment_decoded, total

    def _page_build(self, launched, page_rows, page_mode, page_dv,
                    k_fetch: int):
        """Run the page merge (K14) over the launched segments' rows: the
        packed int32 page on the device and its layout, or None when the
        gid packing cannot cover the segments in int32 (the host merge
        takes over)."""
        stride = max(r["d_pad"] for r in page_rows)
        if len(launched) * stride >= (1 << 31):
            return None
        rows = [out[0, :3 * k_seg + 1]
                for (_i, _s, _a, k_seg, _l, out) in launched]
        lanes = sum(k_seg for (_i, _s, _a, k_seg, _l, _o) in launched)
        k_page = min(k_fetch, lanes)
        order = page_mode[2] if page_mode[0] == "field" else None
        dv_cols = [[prow["dv_state"][f][1]
                    if prow["dv_state"][f][0] == "col" else None
                    for f in page_dv] for prow in page_rows]
        page = page_merge(rows, order, [r["sort_col"] for r in page_rows],
                          dv_cols, k_page, stride)
        lay = {"mode": page_mode, "k_page": k_page, "stride": stride,
               "dv_fields": page_dv, "rows_meta": page_rows}
        return page, lay

    def _decode_page(self, page, launched, agg_nodes):
        """Host decode of one packed result page: candidates with exact
        sort values (rank -> host unique[], f64: no f32 value reaches a
        response) and the fused docvalue prefetch per candidate, plus the
        totals and the decoded agg partials. The page and the agg tails
        come back in one copy."""
        page_t, lay = page
        tails = [out[:, 3 * k_seg + 1:]
                 for (_i, _s, _a, k_seg, _l, out) in launched] \
            if agg_nodes else []
        fetched = _fetch_rows([page_t.view(torch.float32)[None, :],
                               *tails])
        buf = fetched[0][0].view(np.int32)
        k_page, stride = lay["k_page"], lay["stride"]
        off = 0

        def take(n):
            nonlocal off
            part = buf[off:off + n]
            off += n
            return part

        mk = take(k_page).view(np.float32)
        msc = take(k_page).view(np.float32)
        mg = take(k_page)
        field_mode = lay["mode"][0] == "field"
        srank = sexists = None
        if field_mode:
            srank, sexists = take(k_page), take(k_page)
        dv_cols = [(f, take(k_page), take(k_page))
                   for f in lay["dv_fields"]]
        totals = take(len(launched))
        total = int(totals.sum())
        per_segment_decoded = []
        for (_seg_i, _seg, agg_plans, _k, out_layout, _), tail in zip(
                launched, fetched[1:]):
            per_segment_decoded.append(decode_outputs(
                agg_plans, _decode_agg_row(tail[0], out_layout)))
        candidates: List[_Candidate] = []
        for j in range(k_page):
            if mk[j] == NEG_INF:
                continue  # ineligible / padding
            pos, ord_ = divmod(int(mg[j]), stride)
            seg_i = launched[pos][0]
            score = float(msc[j])
            if field_mode:
                if sexists[j]:
                    # the f32 key selected; the host's f64 table answers
                    host = lay["rows_meta"][pos]["sort_host"]
                    v = float(host.unique[int(srank[j])])
                    sv = [int(v) if v.is_integer() else v]
                else:
                    sv = [None]
            else:
                sv = [score]
            cand = _Candidate(score, seg_i, ord_, sv)
            if dv_cols:
                prow = lay["rows_meta"][pos]
                dvm = {}
                for f, ranks, exists in dv_cols:
                    state, _dev, host = prow["dv_state"][f]
                    if state == "host":
                        continue  # the fetch phase's host scan
                    if state == "col" and exists[j]:
                        dvm[f] = [float(host.unique[int(ranks[j])])]
                    else:
                        dvm[f] = []
                cand.dv_page = dvm
            candidates.append(cand)
        return candidates, per_segment_decoded, total

    def _agg_plans(self, stats: ShardStats, compiler: Compiler, agg_nodes,
                   agg_json: str, seg: Segment, meta: DeviceSegmentMeta):
        """Compiled agg plans of one (agg spec, segment), memoized on the
        snapshot's stats: a dashboard's repeated agg shapes skip the
        per-query bucket-table work. Top-level sibling pipelines have no
        plan: they run on the reduced tree."""
        key = ("aggc", id(seg), agg_json)
        plans = stats.memo.get(key)
        if plans is None:
            plans = stats.memo[key] = compile_aggs(
                device_nodes(agg_nodes), self.reader.mapper, seg, meta,
                compiler)
        return plans

    def _respond(self, pending, fetched, entry_by_i, aggs_by_i, segments,
                 responses, start: float) -> None:
        per_query_segs: Dict[int, list] = {}
        per_query_total: Dict[int, int] = {}
        per_query_decoded: Dict[int, list] = {}
        per_query_pruned: Dict[int, int] = {}
        for (idxs, seg_i, k_seg, _, out_layout, bm), packed in zip(pending,
                                                                   fetched):
            scores_b, idx_b, total_b = unpack_rows(packed, k_seg)
            totals = total_b.tolist()
            if bm:
                # K20's pruned lanes ride the packed row's trailing lane
                pruned = packed[:, 2 * k_seg + 1].copy().view(np.int32)
                for row, i in enumerate(idxs):
                    per_query_pruned[i] = per_query_pruned.get(i, 0) \
                        + int(pruned[row])
            for row, i in enumerate(idxs):
                per_query_total[i] = per_query_total.get(i, 0) + totals[row]
                per_query_segs.setdefault(i, []).append(
                    (seg_i, scores_b[row], idx_b[row]))
                if out_layout is not None:
                    outs = _decode_agg_row(packed[row, 2 * k_seg + 1:],
                                           out_layout)
                    per_query_decoded.setdefault(i, []).append(
                        decode_outputs(aggs_by_i[i][seg_i], outs))
        took_ms = int((time.monotonic() - start) * 1000)
        for i, seg_results in per_query_segs.items():
            body, size, from_ = entry_by_i[i][1], entry_by_i[i][3], \
                entry_by_i[i][4]
            if len(seg_results) == 1:
                # one segment: the device's top-k is already score desc
                # with doc-asc ties and -inf padding last
                seg_i, scores, ords = seg_results[0]
                n_valid = int((scores > NEG_INF).sum())
                hi = min(from_ + size, n_valid)
                page = [(seg_i, o, s) for o, s in zip(
                    ords[from_:hi].tolist(), scores[from_:hi].tolist())]
                max_score = float(scores[0]) if n_valid else None
            else:
                all_scores = np.concatenate([s for _, s, _ in seg_results])
                all_ords = np.concatenate([o for _, _, o in seg_results])
                all_segs = np.concatenate(
                    [np.full(len(s), si, np.int32)
                     for si, s, _ in seg_results])
                valid = all_scores > NEG_INF
                all_scores, all_ords, all_segs = (
                    all_scores[valid], all_ords[valid], all_segs[valid])
                # score desc, segment asc, doc asc: mergeTopDocs order
                order = np.lexsort((all_ords, all_segs, -all_scores))
                sel = order[from_:from_ + size]
                page = list(zip(all_segs[sel].tolist(),
                                all_ords[sel].tolist(),
                                all_scores[sel].tolist()))
                max_score = float(all_scores.max()) \
                    if len(all_scores) else None
            hits = [self._hit_dict(seg_i, o, s, body, segments)
                    for seg_i, o, s in page]
            responses[i] = _base_response(took_ms, per_query_total[i],
                                          max_score, hits)
            if per_query_pruned.get(i):
                # pruned blocks never reach the hit count: the total is a
                # lower bound (the page itself is rank-exact)
                responses[i]["hits"]["total"]["relation"] = "gte"
            if i in aggs_by_i:
                aggregations = reduce_aggs(per_query_decoded.get(i, []))
                apply_pipelines(entry_by_i[i][6], aggregations)
                responses[i]["aggregations"] = aggregations


    def _hit_dict(self, seg_i: int, ord_: int, score: Optional[float],
                  body: dict, segments: Optional[List[Segment]] = None
                  ) -> dict:
        """One search hit of the query phase's segments snapshot (the
        reader's current segments when None); `score` None renders a
        field-sorted hit's null `_score`."""
        seg = (segments if segments is not None
               else self.reader.segments)[seg_i]
        h = {"_index": self.reader.index_name, "_id": seg.doc_ids[ord_],
             "_score": score}
        src = _filter_source(seg.sources[ord_], body.get("_source", True))
        if src is not None:
            h["_source"] = src
        return h


def _fetch_rows(outs: List[torch.Tensor]) -> List[np.ndarray]:
    """ONE device-to-host copy for every program of the batch: rows are
    column-padded and concatenated on the device first."""
    if len(outs) == 1:
        return [outs[0].cpu().numpy()]
    width = max(o.shape[1] for o in outs)
    combined = torch.cat([F.pad(o, (0, width - o.shape[1])) for o in outs],
                         dim=0).cpu().numpy()
    fetched, row = [], 0
    for o in outs:
        fetched.append(combined[row:row + o.shape[0], :o.shape[1]])
        row += o.shape[0]
    return fetched


def _filter_source(source: Optional[dict], source_spec) -> Optional[dict]:
    """_source filtering per the reference's FetchSourceContext: an include
    pattern selects its whole subtree; excludes override includes."""
    if source is None or source_spec is True or source_spec is None:
        return source
    if source_spec is False:
        return None
    if isinstance(source_spec, str):
        includes, excludes = [source_spec], []
    elif isinstance(source_spec, list):
        includes, excludes = list(source_spec), []
    elif isinstance(source_spec, dict):
        includes = source_spec.get("includes",
                                   source_spec.get("include", []))
        excludes = source_spec.get("excludes",
                                   source_spec.get("exclude", []))
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]
    else:
        return source

    def matches_any(path: str, patterns) -> bool:
        parts = path.split(".")
        prefixes = [".".join(parts[:i + 1]) for i in range(len(parts))]
        return any(fnmatch.fnmatchcase(prefix, p)
                   for prefix in prefixes for p in patterns)

    def walk(obj, path=""):
        if not isinstance(obj, dict):
            return obj
        out = {}
        for k, v in obj.items():
            full = f"{path}{k}"
            if isinstance(v, dict):
                sub = walk(v, f"{full}.")
                if sub:
                    out[k] = sub
                continue
            if matches_any(full, includes) if includes else True:
                if not matches_any(full, excludes):
                    out[k] = v
        return out

    return walk(source)
