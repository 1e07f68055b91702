"""Aggregation engine: builder tree -> per-segment `AggPlan` -> batched
device partials (the port of opensearch_tpu.search.aggs.engine, without
`ip_range`, `top_hits` and `scripted_metric`).

Every bucket aggregation becomes a lookup from the field's value rank (or
keyword ordinal) to a bucket, a segment-STATIC lane -> bin assignment, and
a masked binned reduction into flat [parent_card * own_card] bins. Bucket
membership is factored as in the reference: the bin a (doc, value) lane
lands in is static for a plan and a segment, while every query-dependent
condition lives in a dynamic mask. The static side (bin lanes, popcount
bitmasks, CSRs, child bins) is built once per (plan, segment) and kept on
the segment (`agg_statics`); per query only the masks move:

- bool contributions (bucket counts, doc counts, presence) with at most
  AGG_GEMM_MAX_BINS bins and at most AGG_POPCOUNT_MAX_ELEMS lane-bins go
  through K5 `binned_popcount`, the reference's popcount route;
- every other reduction -- f32 sums and sums of squares (the reference's
  one-hot GEMM and scatter routes), min / max, counts over many bins, and
  the static child-bin max -- goes through K6 `binned_reduce`.

Plans evaluate for a batch of B queries: the eligibility mask is bool
[B, Dp] and every partial is [B, bins].

`nested` and `reverse_nested` (K23) hand their sub-aggregations buckets
that depend on the query: a dynamic context whose bins are int32 [B, Dp].
Under it every kind folds its eligibility into per-query lane bins and
reduces through K24 `binned_scatter` (the reference's scatter route);
geo_bounds / geo_centroid (`geo_metric`) take K24 in any context.
geohash_grid / geotile_grid compute each doc's cell on the host at
compile (numpy forms of the reference's per-doc functions) and bucket
like composite.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import math
import re
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field, replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ParsingError,
                                                QueryShardError)
from opensearch_tpu_torch.index.mapper import (MapperService,
                                               format_date_millis,
                                               parse_date_millis)
from opensearch_tpu_torch.index.segment import (Segment, ident_pairs,
                                                pad_bucket)
from opensearch_tpu_torch.ops.agg_kernels import (adjacency_counts,
                                                  matrix_moments,
                                                  matrix_stats_names,
                                                  matrix_stats_partials,
                                                  moment_groups, moments_csr)
from opensearch_tpu_torch.ops.binned import (BinCSR, bin_csr,
                                             binned_popcount, binned_reduce,
                                             binned_scatter, lane_bits)
from opensearch_tpu_torch.ops.nested import nested_agg, reverse_nested_agg
from opensearch_tpu_torch.search import dsl
from opensearch_tpu_torch.search.aggs.parse import PIPELINE_TYPES, AggNode
from opensearch_tpu_torch.search.compile import (Compiler, Plan,
                                                 _resolve_date_math)
from opensearch_tpu_torch.search.plan_eval import _eval_plan, dense_numeric

MAX_AGG_BINS = 1 << 24  # guard for presence / child-bin bins
# bool reductions with at most this many bins take the popcount route ...
AGG_GEMM_MAX_BINS = 256
# ... (the reference's one-hot GEMM bound on lanes x bins: f32 sums over
# more elements take its scatter route; both routes are K6 here)
AGG_GEMM_MAX_ELEMS = 1 << 25
# ... and at most this many lanes x bins
AGG_POPCOUNT_MAX_ELEMS = 1 << 30

# Input arrays that are segment/node-static by construction (host-computed
# lookup tables): their content is part of the plan signature, so one
# signature group shares them. The port reads them on the host when it
# builds the static side, so they never ride the per-batch envelope.
CONST_INPUT_KEYS = frozenset({"table", "doc_bucket"})

# static sides kept per segment (least recently used first out): a
# dashboard repeats a handful of agg shapes, and at 10M docs one static
# side holds a few hundred MB of device memory
STATICS_PER_SEGMENT = 8

_FIXED_MS = {"ms": 1, "1ms": 1, "s": 1000, "1s": 1000, "second": 1000,
             "m": 60000, "1m": 60000, "minute": 60000,
             "h": 3600000, "1h": 3600000, "hour": 3600000,
             "d": 86400000, "1d": 86400000, "day": 86400000,
             "w": 604800000, "1w": 604800000, "week": 604800000}


@dataclass
class AggPlan:
    """Compiled aggregation node for one segment."""
    name: str
    kind: str
    static: tuple = ()
    inputs: Dict[str, np.ndarray] = dc_field(default_factory=dict)
    children: List["AggPlan"] = dc_field(default_factory=list)
    query_plan: Optional[Plan] = None      # filter aggs
    query_plans: List[Plan] = dc_field(default_factory=list)  # adjacency
    render: Dict[str, Any] = dc_field(default_factory=dict)  # host-only
    # segment-static arrays of the fused bucket_bits / presence_bits kinds
    # (their content is hashed into sig())
    const_inputs: Dict[str, np.ndarray] = dc_field(default_factory=dict)

    def sig(self):
        cached = getattr(self, "_sig", None)
        if cached is not None:
            return cached

        def digest(v):
            return hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()

        def leaf_sig(k, v):
            if k in CONST_INPUT_KEYS:
                return (k, v.shape, str(v.dtype), digest(v))
            return (k, v.shape, str(v.dtype))

        out = (self.kind, self.static,
               tuple(sorted(leaf_sig(k, v) for k, v in self.inputs.items())),
               self.query_plan.sig() if self.query_plan is not None else None,
               tuple(q.sig() for q in self.query_plans),
               tuple(c.sig() for c in self.children),
               tuple(sorted((k, v.shape, str(v.dtype), digest(v))
                            for k, v in self.const_inputs.items())))
        object.__setattr__(self, "_sig", out)
        return out

    def flatten_inputs(self, out):
        out.append({k: v for k, v in self.inputs.items()
                    if k not in CONST_INPUT_KEYS})
        if self.query_plan is not None:
            self.query_plan.flatten_inputs(out)
        for q in self.query_plans:
            q.flatten_inputs(out)
        for c in self.children:
            c.flatten_inputs(out)
        return out


@dataclass(frozen=True)
class _Ctx:
    mapper: MapperService
    seg: Segment
    meta: Any
    compiler: Compiler
    d_pad: int
    # True only while compiling a top-level agg node: the precondition of
    # the fused bucket_bits / presence_bits kinds
    root: bool = False
    fused: bool = True


def compile_aggs(nodes: List[AggNode], mapper: MapperService, seg: Segment,
                 meta, compiler: Compiler,
                 allow_fused: bool = True) -> List[AggPlan]:
    ctx = _Ctx(mapper, seg, meta, compiler, pad_bucket(max(seg.num_docs, 1)),
               fused=allow_fused)
    return [_compile_node(n, ctx, root=True) for n in nodes]


def _num_col(ctx: _Ctx, field: str):
    return ctx.seg.numeric_dv.get(field)


def _bucket_lookup_plan(node: AggNode, ctx: _Ctx, kind: str,
                        bucket_of_rank: np.ndarray, card: int,
                        render: dict) -> AggPlan:
    u_pad = pad_bucket(max(len(bucket_of_rank), 1), minimum=8)
    table = np.full(u_pad, -1, dtype=np.int32)
    table[:len(bucket_of_rank)] = bucket_of_rank
    children = [_compile_node(c, ctx) for c in node.children]
    col = (ctx.seg.ordinal_dv.get(node.field)
           if kind == "bucket_ord" else _num_col(ctx, node.field))
    return AggPlan(name=node.name, kind=kind,
                   static=(node.field, card,
                           col is not None and ident_pairs(col)),
                   inputs={"table": table},
                   children=children, render=render)


# ------------------------------------------------- fused leaf bucketing
#
# Root-level bucket aggregations with no sub-aggregations compile to ONE
# popcount reduction against per-bucket lane bitmasks computed on the host
# at (agg, segment) compile time.

def _pack_lane_bits(bins: np.ndarray, card: int, n_pad: int) -> np.ndarray:
    """Host bit-pack: lane -> bin assignment (int, <0 = none) -> uint32
    [card, n_pad/32] per-bucket lane masks, bit j of word w = lane
    w*32 + j."""
    words = np.zeros((card, n_pad // 32), dtype=np.uint32)
    lanes = np.nonzero((bins >= 0) & (bins < card))[0].astype(np.int64)
    if len(lanes):
        np.bitwise_or.at(
            words, (bins[lanes], lanes // 32),
            np.left_shift(np.uint32(1), (lanes % 32).astype(np.uint32)))
    return words


def _fused_gate(ctx: _Ctx, node: AggNode, card: int, nv_pad: int) -> bool:
    return (ctx.root and ctx.fused and not node.children and card >= 1
            and card <= AGG_GEMM_MAX_BINS and nv_pad % 32 == 0
            and card * nv_pad <= AGG_POPCOUNT_MAX_ELEMS)


def _fused_bits_plan(node: AggNode, ctx: _Ctx, col, src: str,
                     lane_bins: np.ndarray, card: int, render: dict,
                     kind: str = "bucket_bits") -> AggPlan:
    nv_pad = pad_bucket(max(len(col.doc_ids), 1))
    bins = np.full(nv_pad, -1, dtype=np.int64)
    bins[:len(lane_bins)] = lane_bins
    binbits = _pack_lane_bits(bins, card, nv_pad)
    return AggPlan(node.name, kind,
                   static=(node.field, card, ident_pairs(col), src),
                   const_inputs={"binbits": binbits}, render=render)


def _parse_duration_ms(v) -> int:
    """Date-histogram offset: "1h" / "-30m" / raw millis."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    s = str(v).strip()
    sign = 1
    if s[:1] in ("+", "-"):
        sign = -1 if s[0] == "-" else 1
        s = s[1:]
    if s in _FIXED_MS:
        return sign * _FIXED_MS[s]
    if s[-2:] == "ms" and s[:-2].isdigit():
        return sign * int(s[:-2])
    if s[:-1].isdigit() and s[-1:] in "smhdw":
        return sign * int(s[:-1]) * _FIXED_MS[s[-1]]
    if s.isdigit():
        return sign * int(s)
    raise ParsingError(f"failed to parse [offset]: [{v}]")


def _parse_time_zone(tz) -> int:
    """time_zone -> fixed UTC offset in ms. Fixed offsets exact; named
    zones use their standard offset at a representative instant."""
    if tz in (None, "", "UTC", "Z"):
        return 0
    s = str(tz)
    m = re.match(r"^([+-])(\d{1,2})(?::?(\d{2}))?$", s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        return sign * (int(m.group(2)) * 3600_000
                       + int(m.group(3) or 0) * 60_000)
    try:
        from zoneinfo import ZoneInfo
        off = ZoneInfo(s).utcoffset(
            _dt.datetime(2024, 1, 15, tzinfo=_dt.timezone.utc))
        return int(off.total_seconds() * 1000)
    except (KeyError, ValueError, OSError, ImportError):
        raise ParsingError(f"failed to parse time zone [{tz}]")


def hist_step_shift(body: dict, kind: str):
    """(step, shift) of a fixed-interval histogram / date_histogram body,
    where bucket key = floor((v + shift) / step) * step - shift; None for
    calendar intervals."""
    if kind == "histogram":
        interval = float(body.get("interval", 0) or 0)
        if interval <= 0:
            return None
        return interval, -float(body.get("offset", 0.0))
    unit = str(body.get("calendar_interval") or body.get("fixed_interval")
               or body.get("interval") or "")
    if unit in _FIXED_MS:
        step = _FIXED_MS[unit]
    elif unit[:-1].isdigit() and unit[-1:] in "smhdw":
        step = int(unit[:-1]) * _FIXED_MS[unit[-1]]
    else:
        return None
    shift = (_parse_time_zone(body.get("time_zone"))
             - _parse_duration_ms(body.get("offset", 0)))
    return step, shift


def _compile_node(node: AggNode, ctx: _Ctx, root: bool = False) -> AggPlan:
    fn = _COMPILERS.get(node.type)
    if fn is None:
        raise QueryShardError(f"aggregation type [{node.type}] is not "
                              f"supported")
    if ctx.root != root:
        ctx = dc_replace(ctx, root=root)
    return fn(node, ctx)


# ----------------------------------------------------------------- buckets

def _c_terms(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    if field is None:
        raise ParsingError(f"[terms] aggregation [{node.name}] requires a "
                           f"field")
    ocol = ctx.seg.ordinal_dv.get(field)
    if ocol is not None:
        card = max(len(ocol.dictionary), 1)
        children = [_compile_node(c, ctx) for c in node.children]
        return AggPlan(node.name, "bucket_ord",
                       static=(field, card, ident_pairs(ocol)),
                       children=children,
                       render={"keys": list(ocol.dictionary),
                               "body": node.body, "kind": "terms"})
    col = _num_col(ctx, field)
    if col is None:
        return AggPlan(node.name, "empty", render={"body": node.body,
                                                   "kind": "terms",
                                                   "keys": []})
    card = max(len(col.unique), 1)
    bucket_of_rank = np.arange(len(col.unique), dtype=np.int32)
    ft = ctx.mapper.get_field(field)
    keys = [_render_numeric_key(v, ft) for v in col.unique]
    return _bucket_lookup_plan(node, ctx, "bucket_num", bucket_of_rank, card,
                               render={"keys": keys, "body": node.body,
                                       "kind": "terms"})


def _render_numeric_key(v: float, ft) -> Any:
    if ft is not None and ft.is_bool:
        return bool(v)
    if ft is not None and ft.is_date:
        return int(v)
    return int(v) if float(v).is_integer() else float(v)


def _c_histogram(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    interval = node.body.get("interval")
    if not field or not interval:
        raise ParsingError("[histogram] requires [field] and [interval]")
    interval = float(interval)
    if interval <= 0:
        raise ParsingError("[interval] must be > 0")
    offset = float(node.body.get("offset", 0.0))
    col = _num_col(ctx, field)
    if col is None or len(col.unique) == 0:
        return AggPlan(node.name, "empty",
                       render={"body": node.body, "kind": "histogram",
                               "interval": interval, "offset": offset,
                               "step": interval, "shift": -offset,
                               "keys": []})
    lo_key = np.floor((col.unique[0] - offset) / interval)
    buckets = np.floor((col.unique - offset) / interval) - lo_key
    card = int(buckets[-1]) + 1
    keys = [float(lo_key + i) * interval + offset for i in range(card)]
    render = {"keys": keys, "body": node.body, "kind": "histogram",
              "step": interval, "shift": -offset}
    nv_pad = pad_bucket(max(len(col.doc_ids), 1))
    if _fused_gate(ctx, node, card, nv_pad):
        lane_bins = buckets.astype(np.int64)[col.value_ords]
        return _fused_bits_plan(node, ctx, col, "numeric", lane_bins, card,
                                render)
    return _bucket_lookup_plan(node, ctx, "bucket_num",
                               buckets.astype(np.int32), card, render)


def _calendar_boundaries(lo_ms: float, hi_ms: float, unit: str) -> List[int]:
    """Host-generated calendar-aware bucket boundaries (month / quarter /
    year)."""
    start = _dt.datetime.fromtimestamp(lo_ms / 1000.0, tz=_dt.timezone.utc)
    out = []
    if unit in ("M", "1M", "month"):
        cur = start.replace(day=1, hour=0, minute=0, second=0,
                            microsecond=0)
        step_months = 1
    elif unit in ("q", "1q", "quarter"):
        cur = start.replace(month=((start.month - 1) // 3) * 3 + 1, day=1,
                            hour=0, minute=0, second=0, microsecond=0)
        step_months = 3
    else:  # year
        cur = start.replace(month=1, day=1, hour=0, minute=0, second=0,
                            microsecond=0)
        step_months = 12
    while cur.timestamp() * 1000 <= hi_ms:
        out.append(int(cur.timestamp() * 1000))
        month = cur.month - 1 + step_months
        cur = cur.replace(year=cur.year + month // 12, month=month % 12 + 1)
    out.append(int(cur.timestamp() * 1000))
    return out


def _c_date_histogram(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    interval = (node.body.get("calendar_interval")
                or node.body.get("fixed_interval")
                or node.body.get("interval"))
    if not field or not interval:
        raise ParsingError("[date_histogram] requires [field] and an "
                           "interval")
    # shift = tz - offset: a timestamp's bucket ordinal is
    # floor((ts + shift) / step) and its UTC key ordinal * step - shift
    tz = _parse_time_zone(node.body.get("time_zone"))
    off = _parse_duration_ms(node.body.get("offset", 0))
    shift = tz - off
    col = _num_col(ctx, field)
    unit = str(interval)
    fixed = hist_step_shift(node.body, "date_histogram")
    empty_render = {"body": node.body, "kind": "date_histogram",
                    "keys": [], "interval": interval}
    if fixed is not None:
        empty_render["step"], empty_render["shift"] = fixed
    else:
        empty_render["calendar"] = True
    if col is None or len(col.unique) == 0:
        return AggPlan(node.name, "empty", render=empty_render)
    if fixed is not None:
        step, _ = fixed
        b_abs = np.floor((col.unique + shift) / step).astype(np.int64)
        lo_key = int(b_abs[0])
        buckets = b_abs - lo_key
        card = int(buckets[-1]) + 1
        keys = [(lo_key + i) * step - shift for i in range(card)]
        render = {"keys": keys, "body": node.body, "kind": "date_histogram",
                  "step": step, "shift": shift}
    else:
        bounds = _calendar_boundaries(float(col.unique[0]) + shift,
                                      float(col.unique[-1]) + shift, unit)
        bounds = [b - shift for b in bounds]
        buckets = np.searchsorted(np.asarray(bounds, dtype=np.float64),
                                  col.unique, side="right") - 1
        card = len(bounds) - 1
        keys = bounds[:-1]
        render = {"keys": keys, "body": node.body, "kind": "date_histogram",
                  "calendar": True}
    render["keys_str"] = [format_date_millis(int(k)) for k in keys]
    nv_pad = pad_bucket(max(len(col.doc_ids), 1))
    if _fused_gate(ctx, node, card, nv_pad):
        lane_bins = buckets.astype(np.int64)[col.value_ords]
        return _fused_bits_plan(node, ctx, col, "numeric", lane_bins, card,
                                render)
    return _bucket_lookup_plan(node, ctx, "bucket_num",
                               buckets.astype(np.int32), card, render)


def _c_filter(node: AggNode, ctx: _Ctx) -> AggPlan:
    qnode = dsl.parse_query(node.body if node.body else {"match_all": {}})
    qplan = ctx.compiler.compile(qnode, ctx.seg, ctx.meta)
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "filter", query_plan=qplan, children=children,
                   render={"kind": "filter"})


def _c_range(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    ranges = node.body.get("ranges")
    if not field or not ranges:
        raise ParsingError("[range] aggregation requires [field] and "
                           "[ranges]")
    ft = ctx.mapper.get_field(field)
    col = _num_col(ctx, field)
    is_date = node.type == "date_range" or (ft is not None and ft.is_date)

    def conv(v):
        if v is None:
            return None
        if is_date and isinstance(v, str):
            v = _resolve_date_math(v)
            return float(parse_date_millis(v) if isinstance(v, str) else v)
        return float(ft.to_comparable(v)) if ft is not None else float(v)

    specs = []
    for r in ranges:
        frm, to = conv(r.get("from")), conv(r.get("to"))
        key = r.get("key")
        if key is None:
            f_str = "*" if frm is None else (
                format_date_millis(int(frm)) if is_date else _fmt_num(frm))
            t_str = "*" if to is None else (
                format_date_millis(int(to)) if is_date else _fmt_num(to))
            key = f"{f_str}-{t_str}"
        specs.append((key, frm, to))
    render = {"kind": node.type, "specs": specs, "body": node.body,
              "is_date": is_date}
    if col is None or len(col.unique) == 0:
        return AggPlan(node.name, "empty", render=render)
    u = col.unique
    nv_pad = pad_bucket(max(len(col.doc_ids), 1))
    if _fused_gate(ctx, node, max(len(specs), 1), nv_pad):
        # fused leaf ranges: one bitmask row per range (rows are
        # independent, so ranges may overlap), one popcount reduction
        words = np.zeros((len(specs), nv_pad // 32), dtype=np.uint32)
        lanes = np.arange(len(col.doc_ids), dtype=np.int64)
        vo = col.value_ords
        for i, (_, frm, to) in enumerate(specs):
            lo = 0 if frm is None else int(np.searchsorted(u, frm, "left"))
            hi = len(u) if to is None else int(np.searchsorted(u, to,
                                                               "left"))
            sel = lanes[(vo >= lo) & (vo < hi)]
            if len(sel):
                np.bitwise_or.at(
                    words[i], sel // 32,
                    np.left_shift(np.uint32(1),
                                  (sel % 32).astype(np.uint32)))
        return AggPlan(node.name, "bucket_bits",
                       static=(field, len(specs), ident_pairs(col),
                               "numeric"),
                       const_inputs={"binbits": words}, render=render)
    # ranges may overlap: one sub-plan per range over a rank-interval table
    sub_plans = []
    for i, (_, frm, to) in enumerate(specs):
        lo = 0 if frm is None else int(np.searchsorted(u, frm, "left"))
        hi = len(u) if to is None else int(np.searchsorted(u, to, "left"))
        u_pad = pad_bucket(max(len(u), 1), minimum=8)
        table = np.full(u_pad, -1, dtype=np.int32)
        table[lo:hi] = 0
        sub_plans.append(AggPlan(f"{node.name}#{i}", "bucket_num",
                                 static=(field, 1, ident_pairs(col)),
                                 inputs={"table": table},
                                 children=[_compile_node(c, ctx)
                                           for c in node.children]))
    return AggPlan(node.name, "multi", static=(len(sub_plans),),
                   children=sub_plans, render=render)


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def _c_filters(node: AggNode, ctx: _Ctx) -> AggPlan:
    filters = node.body.get("filters")
    if filters is None:
        raise ParsingError("[filters] aggregation requires [filters]")
    if isinstance(filters, dict):
        names = list(filters.keys())
        queries = [filters[n] for n in names]
        keyed = True
    else:
        names = [str(i) for i in range(len(filters))]
        queries = list(filters)
        keyed = False
    subs = []
    for n, q in zip(names, queries):
        qplan = ctx.compiler.compile(dsl.parse_query(q), ctx.seg, ctx.meta)
        subs.append(AggPlan(n, "filter", query_plan=qplan,
                            children=[_compile_node(c, ctx)
                                      for c in node.children]))
    return AggPlan(node.name, "multi", static=(len(subs),), children=subs,
                   render={"kind": "filters", "names": names,
                           "keyed": keyed})


def _c_global(node: AggNode, ctx: _Ctx) -> AggPlan:
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "global", children=children,
                   render={"kind": "global"})


def _c_missing(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    if field is None:
        raise ParsingError("[missing] aggregation requires a field")
    if field in ctx.seg.numeric_dv:
        static = ("numeric", field)
    elif field in ctx.seg.ordinal_dv:
        static = ("ordinal", field)
    elif field in ctx.seg.vector_dv:
        static = ("vector", field)
    else:
        static = ("none", field)
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "missing", static=static, children=children,
                   render={"kind": "missing"})


# ----------------------------------------------------------------- metrics

# which device partials each metric render consumes (reduce._merge_metric);
# cnt also powers the has-any-value null handling for min/max/avg
_METRIC_NEEDS = {
    "min": ("cnt", "min"), "max": ("cnt", "max"), "avg": ("cnt", "sum"),
    "sum": ("cnt", "sum"), "value_count": ("cnt",),
    "stats": ("cnt", "max", "min", "sum"),
    "extended_stats": ("cnt", "max", "min", "sum", "sumsq"),
}


def _c_metric(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    if field is None:
        raise ParsingError(f"[{node.type}] aggregation [{node.name}] "
                           f"requires a field")
    render = {"kind": node.type, "body": node.body}
    needs = _METRIC_NEEDS[node.type]
    if field in ctx.seg.numeric_dv:
        ft = ctx.mapper.get_field(field)
        render["is_date"] = bool(ft is not None and ft.is_date)
        missing = node.body.get("missing")
        return AggPlan(node.name, "metric_num",
                       static=(field, needs,
                               ident_pairs(ctx.seg.numeric_dv[field]),
                               None if missing is None else float(missing)),
                       render=render)
    if node.body.get("missing") is not None \
            and field not in ctx.seg.ordinal_dv:
        # no value of the field in the segment: every doc contributes the
        # missing substitute
        return AggPlan(node.name, "metric_missing_only",
                       static=(needs, float(node.body["missing"])),
                       render=render)
    if field in ctx.seg.ordinal_dv and node.type == "value_count":
        return AggPlan(node.name, "count_ord",
                       static=(field, ident_pairs(ctx.seg.ordinal_dv[field])),
                       render=render)
    return AggPlan(node.name, "empty", render=render)


def _c_cardinality(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    if field is None:
        raise ParsingError("[cardinality] aggregation requires a field")
    render = {"kind": "cardinality", "body": node.body}
    if field in ctx.seg.ordinal_dv:
        col = ctx.seg.ordinal_dv[field]
        card = max(len(col.dictionary), 1)
        render["keys"] = list(col.dictionary)
        nv_pad = pad_bucket(max(len(col.doc_ids), 1))
        if _fused_gate(ctx, node, card, nv_pad):
            return _fused_bits_plan(node, ctx, col, "ordinal",
                                    col.ords.astype(np.int64), card, render,
                                    kind="presence_bits")
        return AggPlan(node.name, "presence_ord",
                       static=(field, card, ident_pairs(col)),
                       render=render)
    if field in ctx.seg.numeric_dv:
        col = ctx.seg.numeric_dv[field]
        u = col.unique
        render["values"] = u
        card = max(len(u), 1)
        nv_pad = pad_bucket(max(len(col.doc_ids), 1))
        if _fused_gate(ctx, node, card, nv_pad):
            return _fused_bits_plan(node, ctx, col, "numeric",
                                    col.value_ords.astype(np.int64), card,
                                    render, kind="presence_bits")
        return AggPlan(node.name, "presence_num",
                       static=(field, card, ident_pairs(col)),
                       render=render)
    return AggPlan(node.name, "empty", render=render)


def _c_percentiles(node: AggNode, ctx: _Ctx) -> AggPlan:
    field = node.field
    if field is None:
        raise ParsingError(f"[{node.type}] aggregation requires a field")
    render = {"kind": node.type, "body": node.body}
    if field in ctx.seg.numeric_dv:
        u = ctx.seg.numeric_dv[field].unique
        render["values"] = u
        return AggPlan(node.name, "value_hist",
                       static=(field, max(len(u), 1),
                               ident_pairs(ctx.seg.numeric_dv[field])),
                       render=render)
    return AggPlan(node.name, "empty", render=render)


def _c_weighted_avg(node: AggNode, ctx: _Ctx) -> AggPlan:
    vspec = node.body.get("value", {})
    wspec = node.body.get("weight", {})
    vf, wf = vspec.get("field"), wspec.get("field")
    if not vf or not wf:
        raise ParsingError("[weighted_avg] requires value.field and "
                           "weight.field")
    render = {"kind": "weighted_avg", "body": node.body}
    if vf in ctx.seg.numeric_dv and wf in ctx.seg.numeric_dv:
        return AggPlan(node.name, "weighted_avg",
                       static=(vf, wf, ident_pairs(ctx.seg.numeric_dv[vf])),
                       render=render)
    return AggPlan(node.name, "empty", render=render)


# ---------------------------------------------------- dense-bucket family
#
# A host-computed per-doc bucket id (int32 [Dp], -1 = no bucket) feeds one
# device kind, `bucket_dense`: the host does the irregular tuple work once
# per (agg, segment) compile, the card the regular count. Composite tuples,
# multi_terms and their sub-aggregations ride it.

_CALENDAR_APPROX_MS = {"M": 2_592_000_000, "1M": 2_592_000_000,
                       "month": 2_592_000_000,
                       "q": 7_776_000_000, "1q": 7_776_000_000,
                       "quarter": 7_776_000_000,
                       "y": 31_536_000_000, "1y": 31_536_000_000,
                       "year": 31_536_000_000}


def _interval_ms(body: dict) -> int:
    """Interval in ms of a composite date_histogram source: calendar
    month / quarter / year take fixed 30 / 90 / 365 days, as the
    reference's composite sources do."""
    unit = str(body.get("calendar_interval") or body.get("fixed_interval")
               or body.get("interval") or "1d")
    if unit in _FIXED_MS:
        return _FIXED_MS[unit]
    if unit in _CALENDAR_APPROX_MS:
        return _CALENDAR_APPROX_MS[unit]
    if unit[:-1].isdigit() and unit[-1] in "smhdw":
        return int(unit[:-1]) * _FIXED_MS[unit[-1]]
    raise ParsingError(f"unknown date interval [{unit}]")


def _dense_first_value(ctx: _Ctx, field: str):
    """Per-doc first numeric value and exists (host numpy)."""
    col = _num_col(ctx, field)
    d = ctx.seg.num_docs
    if col is None:
        return None, np.zeros(d, dtype=bool)
    value = np.zeros(d, dtype=np.float64)
    # doc_ids are grouped ascending: the first of a run is the smallest
    first_idx = _run_starts(col.doc_ids)
    value[col.doc_ids[first_idx]] = col.values[first_idx]
    return value, col.exists.copy()


def _run_starts(doc_ids: np.ndarray) -> np.ndarray:
    """The first index of each run of equal doc ids (grouped ascending)."""
    return np.flatnonzero(np.r_[True, doc_ids[1:] != doc_ids[:-1]]) \
        if len(doc_ids) else np.zeros(0, dtype=np.int64)


def _dense_first_ord(ctx: _Ctx, field: str):
    col = ctx.seg.ordinal_dv.get(field)
    d = ctx.seg.num_docs
    if col is None:
        return None, np.zeros(d, dtype=bool), []
    ords = np.zeros(d, dtype=np.int64)
    first_idx = _run_starts(col.doc_ids)
    ords[col.doc_ids[first_idx]] = col.ords[first_idx]
    return ords, col.exists.copy(), list(col.dictionary)


def _bucket_dense_plan(node: AggNode, ctx: _Ctx, doc_bucket: np.ndarray,
                       card: int, render: dict) -> AggPlan:
    padded = np.full(ctx.d_pad, -1, dtype=np.int32)
    padded[:len(doc_bucket)] = doc_bucket
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "bucket_dense", static=(card,),
                   inputs={"doc_bucket": padded}, children=children,
                   render=render)


def _source_encoding(ctx: _Ctx, name: str, spec: dict):
    """One composite / multi_terms source -> (per-doc code, exists, keys).
    A doc's code is the rank of its key among the segment's distinct keys
    (a binary search over them; -1 for a doc without the field)."""
    stype, body = next(iter(spec.items())) if len(spec) == 1 \
        else ("terms", spec)
    field = body.get("field")
    ocol = ctx.seg.ordinal_dv.get(field)
    if ocol is not None:
        ords, exists, keys = _dense_first_ord(ctx, field)
        return ords, exists, keys
    value, exists = _dense_first_value(ctx, field)
    if value is None:
        return None, exists, []
    ft = ctx.mapper.get_field(field)
    if stype == "histogram":
        interval = float(body["interval"])
        codes_raw = np.floor(value / interval) * interval
    elif stype == "date_histogram":
        iv = _interval_ms(body)
        codes_raw = np.floor(value / iv) * iv
    else:
        codes_raw = value
    uniq = np.unique(codes_raw[exists]) if exists.any() else np.array([])
    codes = np.where(exists, np.searchsorted(uniq, codes_raw), -1) \
        .astype(np.int64)
    keys = [_render_numeric_key(v, ft) for v in uniq]
    return codes, exists, keys


def _c_composite(node: AggNode, ctx: _Ctx) -> AggPlan:
    sources = node.body.get("sources")
    if not sources:
        raise ParsingError(f"[composite] aggregation [{node.name}] requires "
                           f"[sources]")
    source_specs = []
    for src in sources:
        if len(src) != 1:
            raise ParsingError("[composite] source must have one name")
        sname, sbody = next(iter(src.items()))
        source_specs.append((sname, sbody))
    d = ctx.seg.num_docs
    combined = np.zeros(d, dtype=np.int64)
    all_exist = np.ones(d, dtype=bool)
    key_lists = []
    names = []
    for sname, sbody in source_specs:
        codes, exists, keys = _source_encoding(ctx, sname, sbody)
        names.append(sname)
        key_lists.append(keys)
        if codes is None or not keys:
            all_exist[:] = False
            combined[:] = -1
            continue
        combined = combined * len(keys) + np.where(exists, codes, 0)
        all_exist &= exists
    card = max(int(np.prod([max(len(k), 1) for k in key_lists])), 1)
    doc_bucket = np.where(all_exist, combined, -1).astype(np.int32)
    render = {"kind": node.type, "body": node.body, "sources": names,
              "key_lists": key_lists}
    return _bucket_dense_plan(node, ctx, doc_bucket, card, render)


def _c_multi_terms(node: AggNode, ctx: _Ctx) -> AggPlan:
    terms = node.body.get("terms")
    if not terms or len(terms) < 2:
        raise ParsingError(f"[multi_terms] aggregation [{node.name}] "
                           f"requires at least 2 [terms]")
    synthetic = AggNode(node.name, "multi_terms",
                        {"sources": [{f"t{i}": {"terms": t}}
                                     for i, t in enumerate(terms)],
                         **node.body},
                        children=node.children)
    plan = _c_composite(synthetic, ctx)
    plan.render["kind"] = "multi_terms"
    return plan


def _c_auto_date_histogram(node: AggNode, ctx: _Ctx) -> AggPlan:
    """The smallest interval of a fixed ladder that keeps the segment's
    bucket count within `buckets`, then a date_histogram at it."""
    target = int(node.body.get("buckets", 10))
    col = _num_col(ctx, node.field)
    if col is None or not len(col.unique):
        return AggPlan(node.name, "empty",
                       render={"kind": "auto_date_histogram", "keys": [],
                               "body": node.body})
    lo, hi = float(col.unique[0]), float(col.unique[-1])
    candidates = [("1s", 1000), ("1m", 60_000), ("1h", 3_600_000),
                  ("1d", 86_400_000), ("7d", 7 * 86_400_000),
                  ("1M", 30 * 86_400_000), ("3M", 90 * 86_400_000),
                  ("1y", 365 * 86_400_000)]
    chosen_label, chosen_ms = candidates[-1]
    for label, ms in candidates:
        if (hi - lo) / ms + 1 <= target:
            chosen_label, chosen_ms = label, ms
            break
    clone = AggNode(node.name, "date_histogram",
                    {**node.body,
                     "fixed_interval": f"{chosen_ms // 1000}s"},
                    children=node.children)
    plan = _c_date_histogram(clone, ctx)
    plan.render["kind"] = "auto_date_histogram"
    plan.render["interval"] = chosen_label
    return plan


def _c_significant_terms(node: AggNode, ctx: _Ctx) -> AggPlan:
    """Foreground counts on the card; background doc counts (distinct
    (doc, term) pairs per term, counted with numpy) at compile. The reduce
    scores with JLH."""
    field = node.field
    ocol = ctx.seg.ordinal_dv.get(field)
    if ocol is None:
        return AggPlan(node.name, "empty",
                       render={"kind": "significant_terms", "keys": [],
                               "body": node.body})
    plan = _c_terms(node, ctx)
    n_ords = len(ocol.dictionary)
    pairs = np.unique(ocol.doc_ids.astype(np.int64) * max(n_ords, 1)
                      + ocol.ords.astype(np.int64))
    bg = np.bincount(pairs % max(n_ords, 1), minlength=n_ords)[:n_ords]
    plan.render = {"kind": "significant_terms",
                   "keys": list(ocol.dictionary), "body": node.body,
                   "bg": bg.tolist(), "bg_total": int(ctx.seg.num_docs)}
    return plan


def _c_adjacency_matrix(node: AggNode, ctx: _Ctx) -> AggPlan:
    filters = node.body.get("filters")
    if not isinstance(filters, dict) or not filters:
        raise ParsingError(f"[adjacency_matrix] aggregation [{node.name}] "
                           f"requires [filters]")
    names = sorted(filters)
    plans = [ctx.compiler.compile(dsl.parse_query(filters[name]), ctx.seg,
                                  ctx.meta) for name in names]
    return AggPlan(node.name, "adjacency", static=(len(names),),
                   query_plans=plans,
                   render={"kind": "adjacency_matrix", "names": names,
                           "body": node.body})


def _c_matrix_stats(node: AggNode, ctx: _Ctx) -> AggPlan:
    fields = node.body.get("fields")
    if not fields:
        raise ParsingError(f"[matrix_stats] aggregation [{node.name}] "
                           f"requires [fields]")
    # the fields with a column in this segment: the others contribute
    # no partials
    present = tuple(f for f in fields if f in ctx.seg.numeric_dv)
    return AggPlan(node.name, "matrix_stats", static=(tuple(fields), present),
                   render={"kind": "matrix_stats", "fields": list(fields),
                           "body": node.body})


def _c_nested(node: AggNode, ctx: _Ctx) -> AggPlan:
    """The doc set becomes the path's nested rows whose root is in the
    current buckets; each row takes its root's bucket (K23)."""
    path = (node.body or {}).get("path")
    paths = ctx.seg.nested_paths
    path_ord = paths.index(path) if path in paths else -1
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "nested",
                   inputs={"path_ord": np.asarray(path_ord, np.int32)},
                   children=children, render={"kind": "filter"})


def _c_reverse_nested(node: AggNode, ctx: _Ctx) -> AggPlan:
    if (node.body or {}).get("path"):
        # joining back to an intermediate level needs parent pointers the
        # flat block layout does not keep: refused, as in the reference
        raise QueryShardError(
            "[reverse_nested] with an explicit [path] is not supported; "
            "omit path to join back to the root level")
    children = [_compile_node(c, ctx) for c in node.children]
    return AggPlan(node.name, "reverse_nested", children=children,
                   render={"kind": "filter"})


def _c_geo_bounds(node: AggNode, ctx: _Ctx) -> AggPlan:
    """geo_bounds and geo_centroid: one geo_metric node whose partials
    are the kind's own (extrema, or the coordinate sums), per bucket."""
    present = f"{node.field}.lat" in ctx.seg.numeric_dv
    return AggPlan(node.name, "geo_metric",
                   static=(node.field, node.type, present),
                   render={"kind": node.type, "body": node.body})


def _geo_metric_names(kind: str, present: bool) -> List[str]:
    if not present:
        return []
    if kind == "geo_centroid":
        return ["cnt", "sum_lat", "sum_lon"]
    return ["cnt", "max_lat", "max_lon", "min_lat", "min_lon"]


def _c_geohash_grid(node: AggNode, ctx: _Ctx) -> AggPlan:
    """geohash_grid / geotile_grid: each doc's cell key (of its first lat
    and first lon) on the host, then the bucket_dense plan."""
    precision = int(node.body.get("precision", 5))
    lat, lat_exists = _dense_first_value(ctx, f"{node.field}.lat")
    lon, _ = _dense_first_value(ctx, f"{node.field}.lon")
    if lat is None or lon is None:
        return AggPlan(node.name, "empty",
                       render={"kind": "grid", "keys": [], "body": node.body})
    keys, doc_bucket = grid_buckets(node.type, lat, lon, lat_exists,
                                    precision)
    return _bucket_dense_plan(node, ctx, doc_bucket, max(len(keys), 1),
                              render={"kind": "grid", "keys": keys,
                                      "body": node.body})


_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_BYTES = np.frombuffer(_BASE32.encode(), dtype=np.uint8)


def geohash_key(lat: float, lon: float, precision: int) -> str:
    """One point's geohash (the reference's scalar loop)."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                ch = ch * 2 + 1
                lon_lo = mid
            else:
                ch = ch * 2
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = ch * 2 + 1
                lat_lo = mid
            else:
                ch = ch * 2
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_BASE32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def geotile_key(lat: float, lon: float, zoom: int) -> str:
    """One point's geotile "zoom/x/y" (the reference's scalar form)."""
    n = 2 ** zoom
    x = int((lon + 180.0) / 360.0 * n)
    lat_r = math.radians(max(min(lat, 85.0511), -85.0511))
    y = int((1.0 - math.log(math.tan(lat_r) + 1 / math.cos(lat_r))
             / math.pi) / 2.0 * n)
    return f"{zoom}/{min(x, n - 1)}/{min(y, n - 1)}"


def geohash_codes(lat: np.ndarray, lon: np.ndarray,
                  precision: int) -> np.ndarray:
    """geohash_key over f64 columns as int64 codes (5 bits a character):
    the same halvings and comparisons, each midpoint exact in f64, so the
    codes spell geohash_key's strings; fixed-length codes sort as those
    strings do (the base-32 alphabet is in ASCII order)."""
    lo = [np.full(len(lat), -180.0), np.full(len(lat), -90.0)]
    hi = [np.full(len(lat), 180.0), np.full(len(lat), 90.0)]
    pts = (lon, lat)
    code = np.zeros(len(lat), dtype=np.int64)
    for i in range(5 * precision):
        axis = i % 2
        mid = (lo[axis] + hi[axis]) / 2
        up = pts[axis] >= mid
        code = code * 2 + up
        lo[axis] = np.where(up, mid, lo[axis])
        hi[axis] = np.where(up, hi[axis], mid)
    return code


def _geohash_strings(codes: np.ndarray, precision: int) -> List[str]:
    """geohash_codes' int64 codes spelled as strings, one base-32
    character per 5 bits, most significant first."""
    shifts = 5 * np.arange(precision - 1, -1, -1, dtype=np.int64)
    chars = _BASE32_BYTES[(codes[:, None] >> shifts[None, :]) & 31]
    return chars.view(f"S{precision}").reshape(-1) \
        .astype(f"U{precision}").tolist()


def geotile_xy(lat: np.ndarray, lon: np.ndarray, zoom: int):
    """geotile_key's (x, y) over f64 columns. x takes the same f64
    operations; y's log / tan / cos are numpy's, which may differ from
    the math module's by an ulp, so every y within 1e-6 of a tile edge is
    recomputed by geotile_key's own formula."""
    n = 2 ** zoom
    x = np.trunc((lon + 180.0) / 360.0 * n).astype(np.int64)
    lat_r = np.clip(lat, -85.0511, 85.0511) * (math.pi / 180.0)
    yf = (1.0 - np.log(np.tan(lat_r) + 1 / np.cos(lat_r)) / math.pi) \
        / 2.0 * n
    y = np.trunc(yf).astype(np.int64)
    for i in np.nonzero(np.abs(yf - np.round(yf)) < 1e-6)[0]:
        la = math.radians(max(min(float(lat[i]), 85.0511), -85.0511))
        y[i] = int((1.0 - math.log(math.tan(la) + 1 / math.cos(la))
                    / math.pi) / 2.0 * n)
    return np.minimum(x, n - 1), np.minimum(y, n - 1)


def grid_buckets(kind: str, lat: np.ndarray, lon: np.ndarray,
                 exists: np.ndarray, precision: int):
    """(sorted cell keys, per-doc bucket int32: the key's rank, -1 where
    the doc has no point) of geohash_grid / geotile_grid, as the
    reference's per-doc loop computes them."""
    if kind == "geotile_grid":
        x, y = geotile_xy(lat, lon, precision)
        code = x * (2 ** precision) + y
    else:
        code = geohash_codes(lat, lon, precision)
    uniq, inverse = np.unique(code[exists], return_inverse=True)
    if kind == "geotile_grid":
        n = 2 ** precision
        names = [f"{precision}/{c // n}/{c % n}" for c in uniq.tolist()]
        order = sorted(range(len(names)), key=names.__getitem__)
        keys = [names[i] for i in order]
        rank = np.empty(len(order), dtype=np.int32)
        rank[order] = np.arange(len(order), dtype=np.int32)
    else:
        keys = _geohash_strings(uniq, precision)
        rank = np.arange(len(uniq), dtype=np.int32)
    doc_bucket = np.full(len(lat), -1, dtype=np.int32)
    if len(uniq):
        doc_bucket[exists] = rank[inverse.reshape(-1)]
    return keys, doc_bucket


# the reference's compilers but ip_range (it waits for the ip type),
# top_hits and scripted_metric
_COMPILERS = {
    "terms": _c_terms,
    "histogram": _c_histogram,
    "date_histogram": _c_date_histogram,
    "range": _c_range,
    "date_range": _c_range,
    "filter": _c_filter,
    "filters": _c_filters,
    "global": _c_global,
    "missing": _c_missing,
    "min": _c_metric, "max": _c_metric, "sum": _c_metric, "avg": _c_metric,
    "value_count": _c_metric, "stats": _c_metric, "extended_stats": _c_metric,
    "median_absolute_deviation": _c_percentiles,
    "cardinality": _c_cardinality,
    "percentiles": _c_percentiles,
    "percentile_ranks": _c_percentiles,
    "weighted_avg": _c_weighted_avg,
    "composite": _c_composite,
    "multi_terms": _c_multi_terms,
    "auto_date_histogram": _c_auto_date_histogram,
    "significant_terms": _c_significant_terms,
    "adjacency_matrix": _c_adjacency_matrix,
    "matrix_stats": _c_matrix_stats,
    "nested": _c_nested,
    "reverse_nested": _c_reverse_nested,
    "geo_bounds": _c_geo_bounds,
    "geo_centroid": _c_geo_bounds,
    "geohash_grid": _c_geohash_grid,
    "geotile_grid": _c_geohash_grid,
}


def device_nodes(nodes: Sequence[AggNode]) -> List[AggNode]:
    """The top-level nodes that run on the device: every one but the
    sibling pipelines, which run on the reduced tree."""
    return [n for n in nodes if n.type not in PIPELINE_TYPES]


def unsupported_aggs(nodes: Sequence[AggNode]) -> Optional[str]:
    """The first aggregation type in the tree that is not ported (every
    pipeline type is)."""
    for n in nodes:
        if n.type not in _COMPILERS and n.type not in PIPELINE_TYPES:
            return n.type
        sub = unsupported_aggs(n.children)
        if sub is not None:
            return sub
    return None


# ------------------------------------------------------------ static side

class _Bins:
    """A static lane -> bin map (int32 [n], lanes outside [0, total) drop)
    and, built on first use, its K5 bitmasks and K6 CSR."""

    def __init__(self, lanes: torch.Tensor, total: int):
        self.lanes = lanes.to(torch.int32).contiguous()
        self.total = total
        self._bits: Optional[torch.Tensor] = None
        self._csr: Optional[BinCSR] = None

    @property
    def n(self) -> int:
        return self.lanes.shape[0]

    def bits(self) -> torch.Tensor:
        if self._bits is None:
            self._bits = lane_bits(self.lanes, self.total)
        return self._bits

    def csr(self) -> BinCSR:
        if self._csr is None:
            self._csr = bin_csr(self.lanes, self.total)
        return self._csr


class AggStatics:
    """The static side of one (agg plan list, segment, device): one dict
    per agg node, in evaluation order."""

    def __init__(self):
        self.nodes: List[Dict[str, Any]] = []
        self._next = 0

    def start(self) -> "AggStatics":
        self._next = 0
        return self

    def node(self) -> Dict[str, Any]:
        if self._next == len(self.nodes):
            self.nodes.append({})
        out = self.nodes[self._next]
        self._next += 1
        return out


def agg_statics(seg: Segment, plans: List[AggPlan], device) -> AggStatics:
    """The cached static side of `plans` on segment `seg` (kept on the
    segment, STATICS_PER_SEGMENT entries, least recently used out)."""
    cache = getattr(seg, "_agg_statics", None)
    if cache is None:
        cache = seg._agg_statics = OrderedDict()
    key = (tuple(p.sig() for p in plans), str(device))
    st = cache.get(key)
    if st is None:
        st = cache[key] = AggStatics()
        while len(cache) > STATICS_PER_SEGMENT:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return st.start()


def _take_doc(arr: torch.Tensor, safe_doc: torch.Tensor, ident: bool):
    """arr[safe_doc], or a slice on the identity layout (lane k <-> doc k;
    tail lanes then carry arr[k] for padding k, which the static bin_ok
    masks)."""
    if ident:
        n = safe_doc.shape[0]
        m = arr.shape[-1]
        if n == m:
            return arr
        if n < m:
            return arr[..., :n]
    return arr[safe_doc]


def _pairs_bins(node: dict, col, ords, pbin, card: int, total: int,
                ident: bool, table=None, base_card: bool = True) -> _Bins:
    """Static bins of a pairs-space node: lane -> parent bucket * card +
    own bucket (or the parent bucket alone when base_card is False)."""
    bins = node.get("bins")
    if bins is not None:
        return bins
    doc_ids = col["doc_ids"]
    valid = doc_ids >= 0
    safe_doc = torch.where(valid, doc_ids, 0).long()
    if table is not None:
        b = torch.from_numpy(table).to(doc_ids.device)[ords.long()]
        bin_ok = valid & (b >= 0)
    elif ords is not None:
        b = ords
        bin_ok = valid
    else:
        b = torch.zeros_like(doc_ids)
        bin_ok = valid
    lanes = b
    if pbin is not None:
        pb = _take_doc(pbin, safe_doc, ident)
        bin_ok = bin_ok & (pb >= 0)
        lanes = pb * card + b if base_card else pb
    node["bins"] = bins = _Bins(torch.where(bin_ok, lanes, total), total)
    node["safe_doc"] = torch.where(bin_ok, safe_doc, -1)
    return bins


def _doc_bins(node: dict, pbin, parent_card: int, d_pad: int, dev,
              drop=None) -> _Bins:
    """Static bins of a doc-space node: doc -> its parent bucket (bucket 0
    at the root), docs in `drop` excluded."""
    bins = node.get("bins")
    if bins is not None:
        return bins
    lanes = torch.zeros(d_pad, dtype=torch.int32, device=dev) \
        if pbin is None else torch.where(pbin >= 0, pbin, parent_card)
    if drop is not None:
        lanes = torch.where(drop, parent_card, lanes)
    node["bins"] = bins = _Bins(lanes, parent_card)
    return bins


def _child_bins(node: dict, bins: _Bins, d_pad: int) -> torch.Tensor:
    """Per-doc child bucket from the static pair structure: the max bin of
    the doc's binned lanes, -1 for none (K6 max with one bin per doc)."""
    child = node.get("child_bin")
    if child is not None:
        return child
    if bins.total > MAX_AGG_BINS:
        raise IllegalArgumentError(
            f"a bucket aggregation with sub-aggregations needs "
            f"{bins.total} bins (> {MAX_AGG_BINS}); reduce the bucket count")
    doc_of_lane = node["safe_doc"]
    per_doc = _Bins(doc_of_lane, d_pad)
    binned = binned_reduce(per_doc.csr(), None, None, None,
                           bins.lanes.to(torch.float32), 0.0, ("max",), 1)
    mx = binned["max"][0]
    child = torch.where(mx > float("-inf"), mx, -1.0).to(torch.int32)
    node["child_bin"] = child
    return child


def binned_route(n: int, total: int, need: str) -> str:
    """The reference's reduction route for one statistic over n lanes
    into `total` static bins: "popcount" (bool counts, K5 here), "gemm"
    (the one-hot matmul) or "scatter"; the last two are K6 here, as are
    min / max ("scatter")."""
    if need in ("min", "max") or total > AGG_GEMM_MAX_BINS:
        return "scatter"
    if need == "cnt" and n % 32 == 0 \
            and n * total <= AGG_POPCOUNT_MAX_ELEMS:
        return "popcount"
    return "gemm" if n * total <= AGG_GEMM_MAX_ELEMS else "scatter"


def _binned_sums(bins: _Bins, mask, pmask, doc_ids, needs: Sequence[str],
                 values=None, cval: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per-bin statistics of each query's eligible lanes, routed by shape
    as the reference routes them: counts over at most AGG_GEMM_MAX_BINS bins
    and AGG_POPCOUNT_MAX_ELEMS lane-bins take the popcount route (K5);
    everything else -- f32 sums (the one-hot GEMM and scatter routes),
    min / max, counts over many bins -- takes K6."""
    if pmask is mask:
        pmask = None
    out: Dict[str, torch.Tensor] = {}
    rest = list(needs)
    if "cnt" in rest and binned_route(bins.n, bins.total, "cnt") \
            == "popcount":
        out["cnt"] = binned_popcount(mask, pmask, doc_ids, bins.n,
                                     bins.bits(), bins.total)
        rest.remove("cnt")
    if rest:
        out.update(binned_reduce(bins.csr(), mask, pmask, doc_ids, values,
                                 cval, rest, mask.shape[0]))
    return out


# ---------------------------------------------------------------- device eval

def eval_aggs(plans: List[AggPlan], seg: Dict, inputs: List[Dict],
              cursor: List[int], mask: torch.Tensor, outs: List,
              statics: AggStatics) -> None:
    """Evaluate the collection program for B queries. mask: the eligible
    docs bool [B, Dp] (the queries' result sets). Appends each node's
    partials dict ([B, bins] tensors) to `outs` in traversal order.

    The context (pbin, pmask, parent_card) is the reference's factored
    bucket context: `pbin` int32 [Dp] the parent bucket of each doc (-1 =
    none; static, None at the root), `pmask` bool [B, Dp] the accumulated
    dynamic parent condition (None at the root)."""
    ctx = (None, None, 1)
    for plan in plans:
        _eval_agg(plan, seg, inputs, cursor, mask, ctx, outs, statics)


def _and_pmask(pmask, extra):
    return extra if pmask is None else (pmask & extra)


def _eval_agg(plan: AggPlan, seg: Dict, inputs: List[Dict],
              cursor: List[int], mask, ctx, outs: List,
              statics: AggStatics) -> None:
    my = inputs[cursor[0]]
    cursor[0] += 1
    node = statics.node()
    d_pad = seg["live"].shape[0]
    dev = seg["live"].device
    bsz = mask.shape[0]
    kind = plan.kind
    pbin, pmask, parent_card = ctx

    def children(child_ctx):
        for c in plan.children:
            _eval_agg(c, seg, inputs, cursor, mask, child_ctx, outs, statics)

    if kind in _SCATTER_KINDS or _dynamic(pbin):
        _eval_dynamic(plan, seg, inputs, cursor, mask, ctx, outs, statics,
                      node, my)
        return

    if kind == "empty":
        outs.append({})
        if plan.children:
            if "pbin" not in node:
                node["pbin"] = torch.full((d_pad,), -1, dtype=torch.int32,
                                          device=dev)
            children((node["pbin"], pmask, parent_card))
        return

    if kind in ("bucket_bits", "presence_bits"):
        # fused leaf bucketing: the bin bitmasks were built at compile
        field, card, ident, src = plan.static
        col = seg[src][field]
        bits = node.get("binbits")
        if bits is None:
            bits = node["binbits"] = torch.from_numpy(
                plan.const_inputs["binbits"].view(np.int32)).to(dev)
        counts = binned_popcount(mask, pmask, None if ident
                                 else col["doc_ids"],
                                 col["doc_ids"].shape[0], bits, card)
        outs.append({"counts": counts} if kind == "bucket_bits"
                    else {"present": counts > 0})
        return

    if kind in ("bucket_ord", "bucket_num"):
        field, card, ident = plan.static
        is_ord = kind == "bucket_ord"
        col = seg["ordinal" if is_ord else "numeric"][field]
        total = parent_card * card
        bins = _pairs_bins(node, col, col["ords"] if is_ord
                           else col["val_ords"], pbin, card, total, ident,
                           table=None if is_ord else plan.inputs["table"])
        doc_ids = None if ident else col["doc_ids"]
        counts = _binned_sums(bins, mask, pmask, doc_ids, ("cnt",))["cnt"]
        outs.append({"counts": counts})
        if plan.children:
            child_bin = _child_bins(node, bins, d_pad)
            children((child_bin, _and_pmask(pmask, mask), total))
        return

    if kind == "filter":
        _scores, matches = _eval_plan(plan.query_plan, seg, inputs, cursor,
                                      bsz)
        bins = _doc_bins(node, pbin, parent_card, d_pad, dev)
        counts = _binned_sums(bins, matches & mask, pmask, None,
                              ("cnt",))["cnt"]
        outs.append({"counts": counts})
        children((pbin, _and_pmask(pmask, mask & matches), parent_card))
        return

    if kind == "metric_missing_only":
        needs, missing = plan.static
        bins = _doc_bins(node, pbin, parent_card, d_pad, dev)
        res = _binned_sums(bins, mask, pmask, None, needs, cval=missing)
        outs.append({k: res[k] for k in needs})
        return

    if kind == "metric_num":
        field, needs, ident, missing = plan.static
        col = seg["numeric"][field]
        bins = _pairs_bins(node, col, None, pbin, 1, parent_card, ident,
                           base_card=False)
        out = _binned_sums(bins, mask, pmask, None if ident
                           else col["doc_ids"], needs,
                           values=col["values_f32"])
        if missing is not None:
            # docs WITHOUT the field contribute the substitute value
            sub = node.setdefault("missing", {})
            mbins = _doc_bins(sub, pbin, parent_card, d_pad, dev,
                              drop=col["exists"])
            res = _binned_sums(mbins, mask, pmask, None, needs, cval=missing)
            for k in needs:
                if k == "min":
                    out[k] = torch.minimum(out[k], res[k])
                elif k == "max":
                    out[k] = torch.maximum(out[k], res[k])
                else:
                    out[k] = out[k] + res[k]
        outs.append({k: out[k] for k in needs})
        return

    if kind == "count_ord":
        field, ident = plan.static
        col = seg["ordinal"][field]
        bins = _pairs_bins(node, col, None, pbin, 1, parent_card, ident,
                           base_card=False)
        outs.append(_binned_sums(bins, mask, pmask, None if ident
                                 else col["doc_ids"], ("cnt",)))
        return

    if kind in ("presence_ord", "presence_num"):
        field, card, ident = plan.static
        is_ord = kind == "presence_ord"
        col = seg["ordinal" if is_ord else "numeric"][field]
        total = parent_card * card
        if total > MAX_AGG_BINS:
            raise IllegalArgumentError(
                f"aggregation [{plan.name}] needs {total} bins "
                f"(> {MAX_AGG_BINS}); reduce bucket count or cardinality")
        bins = _pairs_bins(node, col, col["ords"] if is_ord
                           else col["val_ords"], pbin, card, total, ident)
        hist = _binned_sums(bins, mask, pmask, None if ident
                            else col["doc_ids"], ("cnt",))["cnt"]
        outs.append({"present": hist > 0})
        return

    if kind == "multi":
        # range sub-plans / filters buckets: each child sees this context
        outs.append({})
        children(ctx)
        return

    if kind == "global":
        # every live doc, whatever the query (GlobalAggregator); the
        # parent condition and bins stay. `live` changes with deletes, so
        # it is read per call, never kept with the static side
        gmask = seg["live"][None, :].expand(bsz, d_pad).contiguous()
        bins = _doc_bins(node, pbin, parent_card, d_pad, dev)
        counts = _binned_sums(bins, gmask, pmask, None, ("cnt",))["cnt"]
        outs.append({"counts": counts})
        for c in plan.children:
            _eval_agg(c, seg, inputs, cursor, gmask, ctx, outs, statics)
        return

    if kind == "missing":
        ctype, field = plan.static
        miss_bin = node.get("miss_bin")
        if miss_bin is None:
            if ctype == "none":
                exists = torch.zeros(d_pad, dtype=torch.bool, device=dev)
            else:
                exists = seg[ctype][field]["exists"]
            # field existence is static: it folds into the bins
            base = torch.zeros(d_pad, dtype=torch.int32, device=dev) \
                if pbin is None else pbin
            miss_bin = node["miss_bin"] = torch.where(exists, -1, base)
        bins = _doc_bins(node, miss_bin, parent_card, d_pad, dev)
        counts = _binned_sums(bins, mask, pmask, None, ("cnt",))["cnt"]
        outs.append({"counts": counts})
        children((miss_bin, _and_pmask(pmask, mask), parent_card))
        return

    if kind == "bucket_dense":
        card, = plan.static
        total = parent_card * card
        bins = node.get("bins")
        if bins is None:
            b = torch.from_numpy(plan.inputs["doc_bucket"]).to(dev)
            bin_ok = b >= 0
            lanes = b
            if pbin is not None:
                bin_ok = bin_ok & (pbin >= 0)
                lanes = pbin * card + b
            lanes = torch.where(bin_ok, lanes, total)
            bins = node["bins"] = _Bins(lanes, total)
            node["child_bin"] = torch.where(bin_ok, lanes, -1)
        counts = _binned_sums(bins, mask, pmask, None, ("cnt",))["cnt"]
        outs.append({"counts": counts})
        children((node["child_bin"], _and_pmask(pmask, mask), total))
        return

    if kind == "value_hist":
        field, card, ident = plan.static
        col = seg["numeric"][field]
        total = parent_card * card
        if total > MAX_AGG_BINS:
            raise IllegalArgumentError(
                f"aggregation [{plan.name}] needs {total} bins "
                f"(> {MAX_AGG_BINS}); reduce bucket count or cardinality")
        bins = _pairs_bins(node, col, col["val_ords"], pbin, card, total,
                           ident)
        hist = _binned_sums(bins, mask, pmask, None if ident
                            else col["doc_ids"], ("cnt",))["cnt"]
        outs.append({"hist": hist})
        return

    if kind == "weighted_avg":
        vf, wf, ident = plan.static
        vcol = seg["numeric"][vf]
        bins = node.get("bins")
        if bins is None:
            wcol = seg["numeric"][wf]
            doc_ids = vcol["doc_ids"]
            valid = doc_ids >= 0
            safe_doc = torch.where(valid, doc_ids, 0).long()
            # the doc's first (smallest) weight, through its min rank
            up = wcol["unique_f32"].shape[0]
            w_dense = wcol["unique_f32"][wcol["min_rank"].clamp(
                0, up - 1).long()]
            has_w = wcol["exists"][safe_doc]
            w = torch.where(has_w, w_dense[safe_doc], 0.0)
            # a lane whose doc has no weight belongs to no bin (static)
            bin_ok = valid & has_w
            lanes = torch.zeros_like(doc_ids)
            if pbin is not None:
                pb = _take_doc(pbin, safe_doc, ident)
                bin_ok = bin_ok & (pb >= 0)
                lanes = pb
            bins = node["bins"] = _Bins(
                torch.where(bin_ok, lanes, parent_card), parent_card)
            node["wv"] = (vcol["values_f32"] * w).contiguous()
            node["w"] = w.contiguous()
        doc_ids = None if ident else vcol["doc_ids"]
        sum_wv = _binned_sums(bins, mask, pmask, doc_ids, ("sum",),
                              values=node["wv"])["sum"]
        sum_w = _binned_sums(bins, mask, pmask, doc_ids, ("sum",),
                             values=node["w"])["sum"]
        outs.append({"sum_wv": sum_wv, "sum_w": sum_w})
        return

    if kind == "adjacency":
        # the parent condition folds into the eligibility; the parent
        # bins stay static (K17)
        masks = [_eval_plan(qp, seg, inputs, cursor, bsz)[1].contiguous()
                 for qp in plan.query_plans]
        pairs = adjacency_counts(masks, mask.contiguous(), pmask, pbin,
                                 parent_card)
        n = plan.static[0]
        k = 0
        out = {}
        for i in range(n):
            for j in range(i, n):
                out[f"c_{i}_{j}"] = pairs[:, k]
                k += 1
        outs.append(out)
        return

    if kind == "matrix_stats":
        fields = plan.static[1]
        if not fields:
            outs.append({})
            return
        dense = [dense_numeric(seg, f, d_pad) for f in fields]
        vals = torch.stack([v for v, _e, _c in dense])
        exists = torch.stack([e for _v, e, _c in dense])
        csr = node.get("csr")
        if csr is None:
            bins = _doc_bins(node, pbin, parent_card, d_pad, dev)
            csr = node["csr"] = moments_csr(bins.lanes, bins.total)
        cnt, sums = matrix_moments(csr, mask.contiguous(), pmask, vals,
                                   exists)
        outs.append(matrix_stats_partials(fields, cnt, sums))
        return

    raise QueryShardError(f"aggregation kind [{kind}] is not supported by "
                          f"opensearch_tpu_torch yet")


# -------------------------------------------------- the dynamic context
#
# Under `nested` and `reverse_nested` a bucket is per query: the context's
# `pbin` is int32 [B, Dp]. Every kind then folds its eligibility into
# per-query lane bins, int32 [B, n] (a dropped lane: the bin `total`), and
# reduces them through K24 (`binned_scatter`), the reference's scatter
# route; its child contexts stay dynamic. nested, reverse_nested (K23)
# and geo_metric read the collapsed per-query parent bins in any context,
# as the reference's scatter-path kinds do.

_SCATTER_KINDS = frozenset({"nested", "reverse_nested", "geo_metric"})


def _dynamic(pbin) -> bool:
    return pbin is not None and pbin.dim() == 2


def _cols(arr: torch.Tensor, safe_doc: torch.Tensor, ident: bool):
    """arr[:, safe_doc] of a [B, Dp] tensor, or a slice on the identity
    layout (lane k <-> doc k)."""
    if ident:
        n = safe_doc.shape[0]
        if n == arr.shape[1]:
            return arr
        if n < arr.shape[1]:
            return arr[:, :n]
    return arr[:, safe_doc]


def _parent_eff(pbin, pmask, bsz: int, d_pad: int, dev) -> torch.Tensor:
    """The context collapsed to each query's parent bin per doc, int32
    [B, Dp] (-1: none): the reference's _ctx_parent_eff."""
    if pbin is None and pmask is None:
        return torch.zeros(bsz, d_pad, dtype=torch.int32, device=dev)
    if pbin is None:
        return torch.where(pmask, 0, -1).to(torch.int32)
    base = pbin if pbin.dim() == 2 else pbin[None, :].expand(bsz, d_pad)
    if pmask is None:
        return base.contiguous()
    return torch.where(pmask & (base >= 0), base, -1).to(torch.int32)


def _doc_lanes(pbin, ok, total: int) -> torch.Tensor:
    """Per-query doc-space lanes: the parent bin where `ok` and the doc
    has one, else `total`."""
    return torch.where(ok & (pbin >= 0), pbin, total).to(torch.int32)


def _dyn_pairs(col, ident: bool, mask, pmask, pbin, card: int, total: int,
               b=None, b_ok=None):
    """Per-query lanes of a pairs-space node (one lane per (doc, value)
    pair): (lanes int32 [B, n], bin_ok bool [B, n]: the lane has a bin,
    lane_bin int32 [B, n]: parent bin * card + the lane's own bucket b, or
    the parent bin alone where b is None, safe_doc long [n])."""
    doc_ids = col["doc_ids"]
    valid = doc_ids >= 0
    safe_doc = torch.where(valid, doc_ids, 0).long()
    pb = _cols(pbin, safe_doc, ident)
    bin_ok = (valid if b_ok is None else valid & b_ok)[None, :] & (pb >= 0)
    lane_bin = pb if b is None else pb * card + b[None, :]
    ok = _cols(mask, safe_doc, ident)
    if pmask is not None:
        ok = ok & _cols(pmask, safe_doc, ident)
    lanes = torch.where(bin_ok & ok, lane_bin, total).to(torch.int32)
    return lanes, bin_ok, lane_bin, safe_doc


def _dyn_child_bins(lane_bin, bin_ok, safe_doc, total: int,
                    d_pad: int) -> torch.Tensor:
    """Per-query child bucket of each doc: the largest bin of its binned
    lanes, -1 for none (K24 max with one bin per doc)."""
    if total > MAX_AGG_BINS:
        raise IllegalArgumentError(
            f"a bucket aggregation with sub-aggregations needs {total} "
            f"bins (> {MAX_AGG_BINS}); reduce the bucket count")
    docs = torch.where(bin_ok, safe_doc[None, :], d_pad).to(torch.int32)
    mx = binned_scatter(docs.contiguous(), d_pad,
                        lane_bin.to(torch.float32).contiguous(),
                        ("max",))["max"]
    return torch.where(mx > float("-inf"), mx, -1.0).to(torch.int32)


def _k24(lanes, total: int, needs, values=None, cval: float = 0.0):
    return binned_scatter(lanes.contiguous(), total, values, needs, cval)


def _eval_dynamic(plan: AggPlan, seg: Dict, inputs: List[Dict],
                  cursor: List[int], mask, ctx, outs: List,
                  statics: AggStatics, node: Dict, my: Dict) -> None:
    """One agg node under a dynamic context (pbin [B, Dp]), or a
    scatter-path kind in any context."""
    d_pad = seg["live"].shape[0]
    dev = seg["live"].device
    bsz = mask.shape[0]
    kind = plan.kind
    pbin, pmask, parent_card = ctx

    def children(child_mask, child_ctx):
        for c in plan.children:
            _eval_agg(c, seg, inputs, cursor, child_mask, child_ctx, outs,
                      statics)

    if kind == "nested":
        peff = _parent_eff(pbin, pmask, bsz, d_pad, dev)
        own, child_eff, counts = nested_agg(mask.contiguous(), peff, seg,
                                            my["path_ord"], parent_card)
        outs.append({"counts": counts})
        children(own, (child_eff, None, parent_card))
        return

    if kind == "reverse_nested":
        peff = _parent_eff(pbin, pmask, bsz, d_pad, dev)
        own, root_eff, counts = reverse_nested_agg(mask.contiguous(), peff,
                                                   seg, parent_card)
        outs.append({"counts": counts})
        children(own, (root_eff, None, parent_card))
        return

    if kind == "geo_metric":
        field, gkind, present = plan.static
        if not present:
            outs.append({})
            return
        peff = _parent_eff(pbin, pmask, bsz, d_pad, dev)
        lat, exists, _ = dense_numeric(seg, f"{field}.lat", d_pad)
        lon, _, _ = dense_numeric(seg, f"{field}.lon", d_pad)
        lanes = _doc_lanes(peff, mask & exists[None, :], parent_card)
        if gkind == "geo_centroid":
            a = _k24(lanes, parent_card, ("cnt", "sum"), lat)
            b = _k24(lanes, parent_card, ("sum",), lon)
            outs.append({"cnt": a["cnt"], "sum_lat": a["sum"],
                         "sum_lon": b["sum"]})
        else:
            a = _k24(lanes, parent_card, ("cnt", "min", "max"), lat)
            b = _k24(lanes, parent_card, ("min", "max"), lon)
            outs.append({"cnt": a["cnt"], "min_lat": a["min"],
                         "max_lat": a["max"], "min_lon": b["min"],
                         "max_lon": b["max"]})
        return

    okm = mask if pmask is None else mask & pmask

    if kind == "empty":
        outs.append({})
        if plan.children:
            if "pbin" not in node:
                node["pbin"] = torch.full((d_pad,), -1, dtype=torch.int32,
                                          device=dev)
            children(mask, (node["pbin"], pmask, parent_card))
        return

    if kind in ("bucket_ord", "bucket_num"):
        field, card, ident = plan.static
        is_ord = kind == "bucket_ord"
        col = seg["ordinal" if is_ord else "numeric"][field]
        total = parent_card * card
        b = node.get("dyn_b")
        if b is None:
            b = node["dyn_b"] = col["ords"] if is_ord else torch.from_numpy(
                plan.inputs["table"]).to(dev)[col["val_ords"].long()]
        lanes, bin_ok, lane_bin, safe_doc = _dyn_pairs(
            col, ident, mask, pmask, pbin, card, total, b,
            None if is_ord else b >= 0)
        outs.append({"counts": _k24(lanes, total, ("cnt",))["cnt"]})
        if plan.children:
            child = _dyn_child_bins(lane_bin, bin_ok, safe_doc, total,
                                    d_pad)
            children(mask, (child, okm, total))
        return

    if kind == "filter":
        _scores, matches = _eval_plan(plan.query_plan, seg, inputs, cursor,
                                      bsz)
        lanes = _doc_lanes(pbin, okm & matches, parent_card)
        outs.append({"counts": _k24(lanes, parent_card, ("cnt",))["cnt"]})
        children(mask, (pbin, okm & matches, parent_card))
        return

    if kind == "metric_missing_only":
        needs, missing = plan.static
        res = _k24(_doc_lanes(pbin, okm, parent_card), parent_card, needs,
                   cval=missing)
        outs.append({k: res[k] for k in needs})
        return

    if kind == "metric_num":
        field, needs, ident, missing = plan.static
        col = seg["numeric"][field]
        lanes, *_ = _dyn_pairs(col, ident, mask, pmask, pbin, 1,
                               parent_card)
        out = _k24(lanes, parent_card, needs, col["values_f32"])
        if missing is not None:
            # docs WITHOUT the field contribute the substitute value
            res = _k24(_doc_lanes(pbin, okm & ~col["exists"][None, :],
                                  parent_card), parent_card, needs,
                       cval=missing)
            for k in needs:
                if k == "min":
                    out[k] = torch.minimum(out[k], res[k])
                elif k == "max":
                    out[k] = torch.maximum(out[k], res[k])
                else:
                    out[k] = out[k] + res[k]
        outs.append({k: out[k] for k in needs})
        return

    if kind == "count_ord":
        field, ident = plan.static
        col = seg["ordinal"][field]
        lanes, *_ = _dyn_pairs(col, ident, mask, pmask, pbin, 1,
                               parent_card)
        outs.append(_k24(lanes, parent_card, ("cnt",)))
        return

    if kind in ("presence_ord", "presence_num", "value_hist"):
        field, card, ident = plan.static
        col = seg["ordinal" if kind == "presence_ord" else "numeric"][field]
        total = parent_card * card
        if total > MAX_AGG_BINS:
            raise IllegalArgumentError(
                f"aggregation [{plan.name}] needs {total} bins "
                f"(> {MAX_AGG_BINS}); reduce bucket count or cardinality")
        ords = col["ords"] if kind == "presence_ord" else col["val_ords"]
        lanes, *_ = _dyn_pairs(col, ident, mask, pmask, pbin, card, total,
                               ords)
        hist = _k24(lanes, total, ("cnt",))["cnt"]
        outs.append({"hist": hist} if kind == "value_hist"
                    else {"present": hist > 0})
        return

    if kind == "multi":
        outs.append({})
        children(mask, ctx)
        return

    if kind == "global":
        gmask = seg["live"][None, :].expand(bsz, d_pad)
        gok = gmask if pmask is None else gmask & pmask
        outs.append({"counts": _k24(_doc_lanes(pbin, gok, parent_card),
                                    parent_card, ("cnt",))["cnt"]})
        children(gmask.contiguous(), ctx)
        return

    if kind == "missing":
        ctype, field = plan.static
        if ctype == "none":
            exists = torch.zeros(d_pad, dtype=torch.bool, device=dev)
        else:
            exists = seg[ctype][field]["exists"]
        miss_bin = torch.where(exists[None, :], -1, pbin).to(torch.int32)
        outs.append({"counts": _k24(_doc_lanes(miss_bin, okm, parent_card),
                                    parent_card, ("cnt",))["cnt"]})
        children(mask, (miss_bin, okm, parent_card))
        return

    if kind == "bucket_dense":
        card, = plan.static
        total = parent_card * card
        b = node.get("dyn_b")
        if b is None:
            b = node["dyn_b"] = torch.from_numpy(
                plan.inputs["doc_bucket"]).to(dev)
        bin_ok = (b >= 0)[None, :] & (pbin >= 0)
        lane = pbin * card + b[None, :]
        lanes = torch.where(bin_ok & okm, lane, total).to(torch.int32)
        outs.append({"counts": _k24(lanes, total, ("cnt",))["cnt"]})
        children(mask, (torch.where(bin_ok, lane, -1).to(torch.int32), okm,
                        total))
        return

    if kind == "weighted_avg":
        vf, wf, ident = plan.static
        vcol = seg["numeric"][vf]
        if "wv" not in node:
            wcol = seg["numeric"][wf]
            safe_doc = torch.where(vcol["doc_ids"] >= 0, vcol["doc_ids"],
                                   0).long()
            up = wcol["unique_f32"].shape[0]
            w_dense = wcol["unique_f32"][wcol["min_rank"].clamp(
                0, up - 1).long()]
            has_w = wcol["exists"][safe_doc]
            w = torch.where(has_w, w_dense[safe_doc], 0.0)
            node["has_w"] = has_w
            node["wv"] = (vcol["values_f32"] * w).contiguous()
            node["w"] = w.contiguous()
        lanes, *_ = _dyn_pairs(vcol, ident, mask, pmask, pbin, 1,
                               parent_card, b_ok=node["has_w"])
        outs.append({
            "sum_wv": _k24(lanes, parent_card, ("sum",), node["wv"])["sum"],
            "sum_w": _k24(lanes, parent_card, ("sum",), node["w"])["sum"]})
        return

    if kind == "adjacency":
        peff = _parent_eff(pbin, pmask, bsz, d_pad, dev)
        masks = [_eval_plan(qp, seg, inputs, cursor, bsz)[1] & mask
                 for qp in plan.query_plans]
        n = plan.static[0]
        out = {}
        for i in range(n):
            for j in range(i, n):
                out[f"c_{i}_{j}"] = _k24(
                    _doc_lanes(peff, masks[i] & masks[j], parent_card),
                    parent_card, ("cnt",))["cnt"]
        outs.append(out)
        return

    if kind == "matrix_stats":
        fields = plan.static[1]
        peff = _parent_eff(pbin, pmask, bsz, d_pad, dev)
        dense = [dense_numeric(seg, f, d_pad) for f in fields]
        out = {}
        for name, g, k in matrix_stats_names(fields):
            fa, fb = moment_groups(len(fields))[g]
            own = mask & dense[fa][1][None, :] & dense[fb][1][None, :]
            lanes = _doc_lanes(peff, own, parent_card)
            if k < 0:
                out[name] = _k24(lanes, parent_card, ("cnt",))["cnt"]
                continue
            x = torch.where(own, dense[fa][0][None, :], 0.0)
            if fa == fb:
                x2 = x * x
                term = (x, x2, x2 * x, x2 * x2)[k]
            else:
                y = torch.where(own, dense[fb][0][None, :], 0.0)
                term = (x * y, x, y)[k]
            out[name] = _k24(lanes, parent_card, ("sum",),
                             term.contiguous())["sum"]
        outs.append(out)
        return

    raise QueryShardError(f"aggregation kind [{kind}] is not supported by "
                          f"opensearch_tpu_torch yet")


# ------------------------------------------------------- envelope layout

_OUT_DTYPE = {"counts": "int32", "cnt": "int32", "present": "bool",
              "sum": "float32", "sumsq": "float32", "min": "float32",
              "max": "float32", "hist": "int32", "sum_wv": "float32",
              "sum_w": "float32", "sum_lat": "float32",
              "sum_lon": "float32", "min_lat": "float32",
              "max_lat": "float32", "min_lon": "float32",
              "max_lon": "float32"}


def _out_dtype(key: str) -> str:
    """dtype of an output partial: the fixed names above, adjacency cells
    `c_i_j` (int32) and matrix_stats partials (`...::cnt` int32, every
    other `...::sum*` float32)."""
    if key in _OUT_DTYPE:
        return _OUT_DTYPE[key]
    if key.startswith("c_") or key.endswith("::cnt"):
        return "int32"
    return "float32"


def agg_out_layout(plans: List[AggPlan]) -> Tuple[tuple, int]:
    """Host-side layout of one query's agg partials -- for each eval_aggs
    output dict, its sorted keys with shapes and dtypes -- derived from the
    plans' statics alone. Returns (layout, width in 32-bit words)."""
    entries: List[tuple] = []

    def put(names, size):
        entries.append(tuple((k, (size,), _out_dtype(k))
                             for k in sorted(names)))

    def walk(p: AggPlan, parent_card: int):
        kind = p.kind
        if kind == "empty":
            entries.append(())
            for c in p.children:
                walk(c, parent_card)
        elif kind in ("bucket_bits", "presence_bits"):
            put(["counts" if kind == "bucket_bits" else "present"],
                p.static[1])
        elif kind in ("bucket_ord", "bucket_num"):
            total = parent_card * p.static[1]
            put(["counts"], total)
            for c in p.children:
                walk(c, total)
        elif kind == "filter":
            put(["counts"], parent_card)
            for c in p.children:
                walk(c, parent_card)
        elif kind == "metric_missing_only":
            put(p.static[0], parent_card)
        elif kind == "metric_num":
            put(p.static[1], parent_card)
        elif kind == "count_ord":
            put(["cnt"], parent_card)
        elif kind in ("presence_ord", "presence_num"):
            put(["present"], parent_card * p.static[1])
        elif kind == "multi":
            entries.append(())
            for c in p.children:
                walk(c, parent_card)
        elif kind in ("global", "missing"):
            put(["counts"], parent_card)
            for c in p.children:
                walk(c, parent_card)
        elif kind == "bucket_dense":
            total = parent_card * p.static[0]
            put(["counts"], total)
            for c in p.children:
                walk(c, total)
        elif kind == "value_hist":
            put(["hist"], parent_card * p.static[1])
        elif kind == "weighted_avg":
            put(["sum_wv", "sum_w"], parent_card)
        elif kind == "adjacency":
            n = p.static[0]
            put([f"c_{i}_{j}" for i in range(n) for j in range(i, n)],
                parent_card)
        elif kind == "matrix_stats":
            fields = p.static[1]
            put([k for k, _g, _i in matrix_stats_names(fields)],
                parent_card)
        elif kind in ("nested", "reverse_nested"):
            put(["counts"], parent_card)
            for c in p.children:
                walk(c, parent_card)
        elif kind == "geo_metric":
            put(_geo_metric_names(p.static[1], p.static[2]), parent_card)
        else:
            raise QueryShardError(f"aggregation kind [{kind}] is not "
                                  f"supported by opensearch_tpu_torch yet")

    for p in plans:
        walk(p, 1)
    width = sum(int(np.prod(s)) for e in entries for _, s, _ in e)
    return tuple(entries), width


def _flatten_agg_out(out: Dict[str, Any]) -> List[Any]:
    """Deterministic (sorted-key) leaf order of one eval_aggs output dict:
    the device-side packer and the host-side unpacker agree on it."""
    return [out[k] for k in sorted(out)]


def pack_agg_rows(outs: List[dict], out_layout, bsz: int,
                  device) -> torch.Tensor:
    """The agg partials of B queries bit-cast into one f32 [B, W] tail
    (ints and bools as int32 bits), in `out_layout` order."""
    pieces = []
    for out, entry in zip(outs, out_layout):
        if tuple(sorted(out)) != tuple(k for k, _, _ in entry):
            raise AssertionError(f"agg partials {sorted(out)} do not match "
                                 f"the layout {entry}")
        for v, (_k, shape, _dt) in zip(_flatten_agg_out(out), entry):
            v = v.reshape(bsz, -1)
            if v.shape[1] != shape[0]:
                raise AssertionError(f"agg partial of width {v.shape[1]}, "
                                     f"layout says {shape[0]}")
            if v.dtype == torch.bool:
                v = v.to(torch.int32)
            if v.dtype != torch.float32:
                v = v.to(torch.int32).view(torch.float32)
            pieces.append(v)
    if not pieces:
        return torch.empty(bsz, 0, dtype=torch.float32, device=device)
    return torch.cat(pieces, dim=1)


def _decode_agg_row(row: np.ndarray, out_layout) -> List[dict]:
    """Invert the f32 packing of one query row's agg tail back into
    eval_aggs-ordered output dicts."""
    outs = []
    off = 0
    for entry in out_layout:
        d = {}
        for key, shape, dtype in entry:
            n = int(np.prod(shape)) if shape else 1
            piece = row[off:off + n]
            off += n
            if dtype == "float32":
                arr = piece
            elif dtype == "bool":
                arr = piece.view(np.int32).astype(np.bool_)
            else:
                arr = piece.view(np.int32)
                if dtype != "int32":
                    arr = arr.astype(dtype)
            d[key] = arr.reshape(shape)
        outs.append(d)
    return outs
