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
"""

from __future__ import annotations

import fnmatch
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
from opensearch_tpu_torch.ops.bm25 import (CANDIDATE_MAX_LANES,
                                           CANDIDATE_MAX_TERMS,
                                           bm25_candidate)
from opensearch_tpu_torch.ops.device_segment import (DeviceSegmentMeta,
                                                     live_mask, tree_nbytes,
                                                     upload_segment)
from opensearch_tpu_torch.ops.topk import NEG_INF, masked_topk, unpack_rows
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.aggs.engine import (_decode_agg_row,
                                                     agg_out_layout,
                                                     agg_statics,
                                                     compile_aggs, eval_aggs,
                                                     pack_agg_rows,
                                                     unsupported_aggs)
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
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


def build_candidate_query_phase(plan: Plan, k: int):
    """B single-text-clause queries against one segment through the
    candidate-buffer kernel (K1)."""
    constant = plan.static[0]
    n_terms = plan.static[1]

    def run(seg, inputs, min_score):
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


def _envelope_runner(plan: Plan, meta: DeviceSegmentMeta, k: int):
    if _envelope_kernel(plan) == "candidate":
        return build_candidate_query_phase(plan, k)
    return build_batched_query_phase(plan, meta, k)


# --------------------------------------------------------------- responses

_BATCHABLE_KEYS = frozenset({"query", "size", "from", "min_score", "sort",
                             "_source", "aggs", "aggregations"})


def _msearch_batchable(body: dict) -> bool:
    return set(body) <= _BATCHABLE_KEYS \
        and body.get("sort") in (None, "_score", ["_score"])


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

    def __init__(self, reader: ShardReader):
        self.reader = reader
        self.max_result_window = 10000

    def search(self, body: Optional[dict] = None) -> dict:
        """One search: the msearch envelope at B=1; errors raise."""
        return self.multi_search([body or {}],
                                 _raise_item_errors=True)["responses"][0]

    def multi_search(self, bodies: List[dict],
                     _raise_item_errors: bool = False) -> dict:
        """_msearch: same-shaped queries run as one batch per segment. A
        malformed sub-request renders as a per-item error object (or raises
        with `_raise_item_errors`, the single-search contract)."""
        start = time.monotonic()
        responses: List[Optional[dict]] = [None] * len(bodies)
        batchable = []
        for i, body in enumerate(bodies):
            try:
                batchable.append(self._parse_one(i, body or {}))
            except OpenSearchTpuError as e:
                if _raise_item_errors:
                    raise
                responses[i] = _item_error(e)
        if batchable:
            self._run_batch(batchable, responses, start, _raise_item_errors)
        return {"took": int((time.monotonic() - start) * 1000),
                "responses": responses}

    def _parse_one(self, i: int, body: dict):
        if not _msearch_batchable(body):
            extra = sorted(set(body) - _BATCHABLE_KEYS)
            raise IllegalArgumentError(
                f"request {'keys ' + str(extra) if extra else 'sort'} "
                f"not supported by opensearch_tpu_torch yet: it serves "
                f"score-sorted query/size/from/min_score/_source/aggs "
                f"bodies")
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
        compiler = Compiler(self.reader.mapper, stats)
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
                stacked, treedef = stack_flat_inputs(
                    [flats_by_i[i][seg_i] for i in idxs])
                stacked.append(min_scores)
                buf, layout = pack_leaves(stacked, pin=dev.type == "cuda")
                leaves = unpack_leaves(buf.to(dev, non_blocking=True),
                                       layout)
                k_seg = min(k_fetch, pad_bucket(max(seg.num_docs, 1)))
                plan0 = plans_by_i[idxs[0]][seg_i]
                inputs = unflatten_inputs(treedef, leaves[:-1])
                if agg_sig is not None:
                    run, out_layout = build_batched_agg_query_phase(
                        plan0, meta, k_seg, aggs_by_i[idxs[0]][seg_i], seg)
                else:
                    run = _envelope_runner(plan0, meta, k_seg)
                    out_layout = None
                out = run(arrays, inputs, leaves[-1])
                pending.append((idxs, seg_i, k_seg, out, out_layout))
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
                    responses[i]["aggregations"] = {}

    def _agg_plans(self, stats: ShardStats, compiler: Compiler, agg_nodes,
                   agg_json: str, seg: Segment, meta: DeviceSegmentMeta):
        """Compiled agg plans of one (agg spec, segment), memoized on the
        snapshot's stats: a dashboard's repeated agg shapes skip the
        per-query bucket-table work."""
        key = ("aggc", id(seg), agg_json)
        plans = stats.memo.get(key)
        if plans is None:
            plans = stats.memo[key] = compile_aggs(
                agg_nodes, self.reader.mapper, seg, meta, compiler)
        return plans

    def _respond(self, pending, fetched, entry_by_i, aggs_by_i, segments,
                 responses, start: float) -> None:
        per_query_segs: Dict[int, list] = {}
        per_query_total: Dict[int, int] = {}
        per_query_decoded: Dict[int, list] = {}
        for (idxs, seg_i, k_seg, _, out_layout), packed in zip(pending,
                                                               fetched):
            scores_b, idx_b, total_b = unpack_rows(packed, k_seg)
            totals = total_b.tolist()
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
        index_name = self.reader.index_name
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
            source_spec = body.get("_source", True)
            hits = []
            for seg_i, o, s in page:
                seg = segments[seg_i]
                h = {"_index": index_name, "_id": seg.doc_ids[o],
                     "_score": s}
                src = _filter_source(seg.sources[o], source_spec)
                if src is not None:
                    h["_source"] = src
                hits.append(h)
            responses[i] = _base_response(took_ms, per_query_total[i],
                                          max_score, hits)
            if i in aggs_by_i:
                responses[i]["aggregations"] = reduce_aggs(
                    per_query_decoded.get(i, []))


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
