"""The multi-shard query phase's routing and host side (the port's copy of
opensearch_tpu.search.spmd): which requests run every (shard, segment)
row as one device program with an on-device merge
(parallel/distributed.py), and the decode of its result.

Every row with documents of every target shard is one row, ordered shard
ascending, then segment. A request takes the program when it has 2 to
SPMD_MAX_PACK rows (the reference packs up to 8 rows per device and the
port runs on one card), is not hybrid or DFS, and its sort is the score or
a single numeric field whose values are exactly f32-representable
(`_spmd_sort_spec`); then its rows must compile to one plan structure and
share one field layout, which is checked before anything launches. Every
other request runs the controller's host loop, as in the reference, so
the same request takes the same route in both packages (the route decides
how many candidates `max_score` sees under `track_scores`).

The request cache and the telemetry of the reference's module are not
ported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

import numpy as np

from opensearch_tpu_torch.ops.spmd import unpack_merged
from opensearch_tpu_torch.ops.topk import NEG_INF, f32_sortable
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.aggs.engine import (_decode_agg_row,
                                                     compile_aggs,
                                                     device_nodes,
                                                     unsupported_aggs)
from opensearch_tpu_torch.search.aggs.parse import parse_aggs
from opensearch_tpu_torch.search.aggs.reduce import decode_outputs
from opensearch_tpu_torch.search.compile import Compiler

# rows one request packs onto the card before it takes the host loop (the
# reference's per-device pack; the port has one device)
SPMD_MAX_PACK = 8

# requests answered by the multi-shard program (tests read it)
SPMD_QUERIES = [0]

# requests whose multi-shard program raised and that took the per-shard
# host loop instead (search/controller.py; chip_smoke requires 0)
HOST_FALLBACKS = [0]


def spmd_rows(executors: List) -> List[Tuple[int, int]]:
    """(executor index, segment index) pairs with documents."""
    rows = []
    for shard_i, ex in enumerate(executors):
        for seg_i, seg in enumerate(ex.reader.segments):
            if seg.num_docs > 0:
                rows.append((shard_i, seg_i))
    return rows


def _spmd_sort_spec(executors: List, sort_specs):
    """None for the score sort; (field, order) for a single numeric / date
    / boolean field sort whose every column is f32_sortable; False when
    the sort needs the host loop (a keyword or multi-key sort: keyword
    ordinals do not compare across rows)."""
    specs = list(sort_specs)
    if specs == [("_score", "desc")]:
        return None
    if len(specs) != 1:
        return False
    field, order = specs[0]
    if field == "_score":
        return False
    ft = executors[0].reader.mapper.get_field(field)
    if ft is None or not (ft.is_numeric or ft.is_date or ft.is_bool):
        return False
    for ex in executors:
        for seg in ex.reader.segments:
            col = seg.numeric_dv.get(field)
            if col is not None and not f32_sortable(col):
                return False
    return (field, order)


class force_host_loop:
    """Context manager pinning searches to the host loop (tests of the
    host loop's behaviour and ground-truth comparisons)."""

    def __enter__(self):
        self._orig = globals()["eligible"]
        globals()["eligible"] = lambda *a, **k: False
        return self

    def __exit__(self, *exc):
        globals()["eligible"] = self._orig
        return False


def merge_hybrid_bounds(per_shard_bounds: List[List[Tuple[float, float,
                                                          float, int]]],
                        n_sub: int) -> List[Tuple[float, float, float,
                                                  int]]:
    """Reduce per-shard per-sub-query hybrid score bounds to global bounds:
    min of mins, max of maxes, sum of the sums of squares and of the
    counts, so the normalization-processor normalizes over the union of
    every shard's windows, as the reference does."""
    out = []
    for i in range(n_sub):
        mn, mx, ssq, count = float("inf"), float("-inf"), 0.0, 0
        for bounds in per_shard_bounds:
            b_mn, b_mx, b_ssq, b_count = bounds[i]
            if b_count:
                mn = min(mn, b_mn)
                mx = max(mx, b_mx)
                ssq += b_ssq
                count += b_count
        out.append((mn, mx, ssq, count))
    return out


def eligible(executors: List, body: dict, rows: List[Tuple[int, int]],
             sort_specs) -> bool:
    """Whether a request's query phase runs as the multi-shard program.
    Hybrid bodies take their own phase, and slice, collapse and rescore
    answer 400 (`controller._refuse_unported`) before this is asked."""
    if len(rows) < 2 or len(rows) > SPMD_MAX_PACK:
        return False
    if _spmd_sort_spec(executors, sort_specs) is False:
        return False
    # DFS pins per-shard statistics (host loop)
    return body.get("search_type") != "dfs_query_then_fetch"


def _copy_plan(plan):
    """A copy of an agg plan tree whose statics align_agg_plans may edit
    (inputs and filter plans stay shared: nothing edits them)."""
    return dataclasses.replace(
        plan, children=[_copy_plan(c) for c in plan.children])


def _row_agg_plans(stats, compiler, agg_nodes, agg_json: str, seg, meta):
    """A row's unfused agg plans, compiled once per (agg spec, segment) on
    the snapshot's stats (the bucket tables are host work over the whole
    column) and copied for this request's alignment."""
    key = ("aggc_rows", id(seg), agg_json)
    plans = stats.memo.get(key)
    if plans is None:
        plans = stats.memo[key] = compile_aggs(
            agg_nodes, compiler.mapper, seg, meta, compiler,
            allow_fused=False)
    return [_copy_plan(p) for p in plans]


def spmd_query_phase(executors: List, body: dict, k: int,
                     rows: List[Tuple[int, int]]):
    """The query phase over every (shard, segment) row as one program.
    Returns (candidates, decoded agg partials, total, pruned lanes), shaped
    like the host loop's, pruned > 0 meaning block-max dropped lanes (the
    total is then a lower bound); None when the rows do not share one plan
    structure and field layout (decided before any launch: the request
    then takes the host loop)."""
    from opensearch_tpu_torch.parallel.distributed import (
        align_agg_plans, layout_compatible, plan_struct, run_rows,
        spmd_blockmax_admitted)
    from opensearch_tpu_torch.search.executor import (_Candidate,
                                                      _parse_sort,
                                                      _req_min_score,
                                                      _sort_value,
                                                      stage_rows)
    from opensearch_tpu_torch.common.errors import QueryShardError

    node = dsl.parse_query(body.get("query"))
    min_score = _req_min_score(body)
    agg_nodes = parse_aggs(body.get("aggs") or body.get("aggregations"))
    missing = unsupported_aggs(agg_nodes)
    if missing is not None:
        raise QueryShardError(
            f"aggregation type [{missing}] is not supported")
    dev_agg_nodes = device_nodes(agg_nodes)
    agg_json = json.dumps(body.get("aggs") or body.get("aggregations"),
                          sort_keys=True, default=str) if agg_nodes else None
    sort_specs = _parse_sort(body.get("sort"))
    sort_spec = _spmd_sort_spec(executors, sort_specs)
    if sort_spec is False:
        return None

    snaps = [ex.reader.stats_snapshot() for ex in executors]
    plans, agg_rows, images, segs = [], [], [], []
    for shard_i, seg_i in rows:
        ex = executors[shard_i]
        stats, seg_list, device = snaps[shard_i]
        seg = seg_list[seg_i]
        arrays, meta = device[seg_i]
        compiler = Compiler(ex.reader.mapper, stats,
                            blockmax=ex.blockmax)
        plans.append(compiler.compile(node, seg, meta))
        agg_rows.append(_row_agg_plans(stats, compiler, dev_agg_nodes,
                                       agg_json, seg, meta)
                        if agg_nodes else [])
        images.append((arrays, meta))
        segs.append(seg)
    if agg_nodes:
        try:
            align_agg_plans(agg_rows)
        except ValueError:
            return None
    struct0 = (plan_struct(plans[0]),
               tuple(plan_struct(a) for a in agg_rows[0]))
    for p, aps in zip(plans[1:], agg_rows[1:]):
        if (plan_struct(p), tuple(plan_struct(a) for a in aps)) != struct0:
            return None
    if not layout_compatible(images):
        return None
    flats = []
    for plan, aps in zip(plans, agg_rows):
        flat = plan.flatten_inputs([])
        for ap in aps:
            ap.flatten_inputs(flat)
        flats.append(flat)
    if any(tuple(tuple(sorted(d)) for d in f)
           != tuple(tuple(sorted(d)) for d in flats[0]) for f in flats[1:]):
        return None     # the rows' inputs do not stack (another structure)

    d_pad = max(meta.d_pad for _a, meta in images)
    block_bounds = all(meta.block_bounds for _a, meta in images)
    bm = None
    if spmd_blockmax_admitted(plans[0], d_pad, block_bounds, k, sort_spec,
                              agg_rows[0]):
        bm = (plans[0].static[1], min(k, d_pad))
    dev = executors[0].reader.torch_device
    staged, mss = stage_rows(flats, min_score, dev)
    launched = run_rows(
        [{"plan": p, "agg_plans": aps, "arrays": a, "meta": m, "seg": s,
          "inputs": inp, "ms": ms}
         for p, aps, (a, m), s, inp, ms in zip(plans, agg_rows, images,
                                               segs, staged, mss)],
        k, sort_spec, bm, dev)
    packed, tails = launched.fetch()
    keys, scores, row_idx, ords, total, pruned = unpack_merged(
        packed, launched.k, launched.n_rows)
    SPMD_QUERIES[0] += 1

    candidates = []
    for key, score, r, ord_ in zip(keys.tolist(), scores.tolist(),
                                   row_idx.tolist(), ords.tolist()):
        if key == NEG_INF:
            continue
        shard_i, seg_i = rows[r]
        if sort_spec is None:
            sort_values = [float(score)]
        else:
            # the device merged on f32 values; the final order uses the
            # exact column values
            seg = segs[r]
            sort_values = [float(score) if f == "_score"
                           else _sort_value(seg, f, o, ord_)
                           for f, o in sort_specs]
        candidates.append(_Candidate(float(score), seg_i, ord_, sort_values,
                                     shard_i=shard_i))
    decoded = []
    if agg_nodes:
        for aps, layout, tail in zip(agg_rows, launched.agg_layouts, tails):
            decoded.append(decode_outputs(
                list(aps), [] if tail is None
                else _decode_agg_row(tail[0], layout)))
    return candidates, decoded, total, int(np.sum(pruned))
