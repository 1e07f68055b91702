"""Host-side aggregation reduce and response rendering (the subset of
opensearch_tpu.search.aggs.reduce the port needs): per-segment partials
arrive as flat numpy arrays per (segment, node); they merge by bucket key
across segments and render the REST "aggregations" shapes of `terms`,
`histogram` / `date_histogram`, `filter`, the metrics and `cardinality`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentError
from opensearch_tpu_torch.index.mapper import (format_date_millis,
                                               parse_date_millis)
from opensearch_tpu_torch.search.aggs.engine import AggPlan
from opensearch_tpu_torch.search.compile import _resolve_date_math


class Decoded:
    """One segment's decoded partials for one plan node."""
    __slots__ = ("plan", "out", "children")

    def __init__(self, plan: AggPlan, out: dict, children: List["Decoded"]):
        self.plan = plan
        self.out = out
        self.children = children


def decode_outputs(plans: List[AggPlan], outs: List[dict]) -> List[Decoded]:
    cursor = [0]

    def walk(plan: AggPlan) -> Decoded:
        out = {k: np.asarray(v) for k, v in outs[cursor[0]].items()}
        cursor[0] += 1
        children = [walk(c) for c in plan.children]
        return Decoded(plan, out, children)

    return [walk(p) for p in plans]


def reduce_aggs(per_segment: List[List[Decoded]]) -> Dict[str, Any]:
    """per_segment: one decoded top-level list per segment, same node
    order."""
    if not per_segment:
        return {}
    n_top = len(per_segment[0])
    result: Dict[str, Any] = {}
    for i in range(n_top):
        entries = [(seg_nodes[i], 0) for seg_nodes in per_segment]
        name = per_segment[0][i].plan.name
        result[name] = _merge_node(entries)
    return result


def _merge_node(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    """entries: (decoded node, parent bucket index within that segment)."""
    plan = entries[0][0].plan
    kind = plan.kind
    render = plan.render

    if kind == "empty":
        return _render_empty(render)

    if kind in ("bucket_ord", "bucket_num", "bucket_bits"):
        if render.get("kind", "terms") == "terms":
            return _merge_terms(entries)
        return _merge_histogram(entries)

    if kind == "filter":
        count = sum(int(d.out["counts"][p]) for d, p in entries
                    if "counts" in d.out)
        result = {"doc_count": count}
        result.update(_merge_children(entries, lambda p: p))
        return result

    if kind in ("metric_num", "metric_missing_only"):
        return _merge_metric(entries)

    if kind == "count_ord":
        cnt = sum(int(d.out["cnt"][p]) for d, p in entries if "cnt" in d.out)
        return {"value": cnt}

    if kind in ("presence_ord", "presence_num", "presence_bits"):
        return _merge_cardinality(entries)

    raise IllegalArgumentError(f"cannot reduce aggregation kind [{kind}]")


def _merge_children(entries: List[Tuple[Decoded, int]], child_index_fn
                    ) -> Dict[str, Any]:
    """Merge each child slot across segments; child_index_fn maps this
    node's parent index to the child's flattened parent index."""
    first = entries[0][0]
    out: Dict[str, Any] = {}
    for j, child in enumerate(first.children):
        child_entries = [(d.children[j], child_index_fn(p))
                         for d, p in entries]
        out[child.plan.name] = _merge_node(child_entries)
    return out


def _render_empty(render: dict) -> Dict[str, Any]:
    rkind = render.get("kind", "")
    if rkind == "terms":
        return {"doc_count_error_upper_bound": 0, "sum_other_doc_count": 0,
                "buckets": []}
    if rkind in ("histogram", "date_histogram"):
        body = render.get("body", {})
        if int(body.get("min_doc_count", 0)) == 0 \
                and body.get("extended_bounds"):
            eb = _hist_eb_keys(render, body)
            step = render.get("step")
            if eb is not None and None not in eb and step:
                lo, hi = eb
                is_date = rkind == "date_histogram"
                buckets = []
                k = lo
                while k <= hi + step / 2:
                    b: Dict[str, Any] = {"key": int(k) if is_date else k,
                                         "doc_count": 0}
                    if is_date:
                        b["key_as_string"] = format_date_millis(int(k))
                    buckets.append(b)
                    k += step
                return {"buckets": buckets}
        return {"buckets": []}
    if rkind in ("min", "max", "avg"):
        return {"value": None}
    if rkind in ("sum", "value_count", "cardinality"):
        return {"value": 0}
    if rkind == "stats":
        return {"count": 0, "min": None, "max": None, "avg": None,
                "sum": 0.0}
    if rkind == "extended_stats":
        return {"count": 0, "min": None, "max": None, "avg": None,
                "sum": 0.0, "sum_of_squares": None, "variance": None,
                "std_deviation": None}
    return {"doc_count": 0}


# ------------------------------------------------------------------ buckets

def _merge_terms(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    body = plan.render.get("body", {})
    size = int(body.get("size", 10))
    min_doc_count = int(body.get("min_doc_count", 1))
    order = body.get("order", {"_count": "desc"})
    if isinstance(order, list):
        order = order[0] if order else {"_count": "desc"}
    (order_key, order_dir), = order.items() if order \
        else (("_count", "desc"),)

    acc: Dict[Any, Dict[str, Any]] = {}
    for d, p in entries:
        if "counts" not in d.out:
            continue
        keys = d.plan.render["keys"]
        card = d.plan.static[1]
        counts = d.out["counts"]
        base = p * card
        for c in range(min(card, len(keys))):
            n = int(counts[base + c])
            if n <= 0:
                continue
            slot = acc.setdefault(keys[c], {"doc_count": 0, "segments": []})
            slot["doc_count"] += n
            slot["segments"].append((d, p, c))

    total = sum(v["doc_count"] for v in acc.values())

    def sort_key(item):
        key, slot = item
        if order_key == "_key":
            return key
        return slot["doc_count"]
    reverse = (order_dir == "desc")
    items = sorted(acc.items(), key=sort_key, reverse=reverse)
    if order_key == "_count":  # secondary: key ascending
        items = sorted(items, key=lambda kv: _orderable(kv[0]))
        items = sorted(items, key=lambda kv: kv[1]["doc_count"],
                       reverse=reverse)

    buckets = []
    taken = 0
    for key, slot in items:
        if slot["doc_count"] < min_doc_count:
            continue
        if taken >= size:
            break
        taken += 1
        bucket: Dict[str, Any] = {"key": key,
                                  "doc_count": slot["doc_count"]}
        first = entries[0][0]
        for j, child in enumerate(first.children):
            child_entries = [(d.children[j], p * d.plan.static[1] + c)
                             for d, p, c in slot["segments"]]
            bucket[child.plan.name] = _merge_node(child_entries)
        buckets.append(bucket)
    shown = sum(b["doc_count"] for b in buckets)
    return {"doc_count_error_upper_bound": 0,
            "sum_other_doc_count": total - shown,
            "buckets": buckets}


def _orderable(key):
    return (0, key) if isinstance(key, (int, float, bool)) \
        else (1, str(key))


def _hist_eb_keys(render: dict, body: dict):
    """extended_bounds clamped onto the bucket-key lattice -> (lo, hi) keys
    (either side may be None). Fixed-step histograms only."""
    eb = body.get("extended_bounds")
    step = render.get("step")
    if not eb or not step or render.get("calendar"):
        return None

    def conv(v):
        if v is None:
            return None
        if isinstance(v, str):
            v = _resolve_date_math(v)
            if isinstance(v, str):
                v = parse_date_millis(v)
        return float(v)

    shift = float(render.get("shift", 0.0))
    lo, hi = conv(eb.get("min")), conv(eb.get("max"))

    def key_of(v):
        return math.floor((v + shift) / step) * step - shift

    return ((None if lo is None else key_of(lo)),
            (None if hi is None else key_of(hi)))


def _trim_zero_edges(buckets: List[dict], min_doc_count: int,
                     eb_keys) -> List[dict]:
    """Histogram buckets exist between the min and max collected buckets
    (plus extended_bounds): a query-filtered histogram drops the leading
    and trailing zero-count buckets of the segment-wide key table."""
    if min_doc_count != 0 or not buckets:
        return buckets
    nz = [i for i, b in enumerate(buckets) if b["doc_count"] > 0]
    lo = buckets[nz[0]]["key"] if nz else None
    hi = buckets[nz[-1]]["key"] if nz else None
    if eb_keys is not None:
        eb_lo, eb_hi = eb_keys
        if eb_lo is not None:
            lo = eb_lo if lo is None else min(lo, eb_lo)
        if eb_hi is not None:
            hi = eb_hi if hi is None else max(hi, eb_hi)
    if lo is None:
        return []
    return [b for b in buckets if lo <= b["key"] <= hi]


def _merge_histogram(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    render = plan.render
    body = render.get("body", {})
    min_doc_count = int(body.get("min_doc_count", 0))
    is_date = render.get("kind") == "date_histogram"
    eb_keys = _hist_eb_keys(render, body) if body.get("extended_bounds") \
        else None

    # single-segment leaf histogram: render straight from the counts
    if (len(entries) == 1 and not entries[0][0].children and eb_keys is None
            and "counts" in entries[0][0].out):
        d, p = entries[0]
        card = d.plan.static[1]
        keys = d.plan.render["keys"]
        keys_str = d.plan.render.get("keys_str")
        counts = np.asarray(d.out["counts"])[p * card:(p + 1) * card]
        counts = counts[:len(keys)].tolist()
        if is_date:
            if keys_str is None:
                keys_str = [format_date_millis(int(k)) for k in keys]
            buckets = [{"key": int(k), "doc_count": c, "key_as_string": ks}
                       for k, ks, c in zip(keys, keys_str, counts)
                       if c >= min_doc_count]
        else:
            buckets = [{"key": k, "doc_count": c}
                       for k, c in zip(keys, counts) if c >= min_doc_count]
        return {"buckets": _trim_zero_edges(buckets, min_doc_count, None)}

    acc: Dict[float, Dict[str, Any]] = {}
    for d, p in entries:
        if "counts" not in d.out:
            continue
        keys = d.plan.render["keys"]
        card = d.plan.static[1]
        counts = d.out["counts"]
        base = p * card
        for c in range(min(card, len(keys))):
            n = int(counts[base + c])
            slot = acc.setdefault(keys[c], {"doc_count": 0, "segments": []})
            slot["doc_count"] += n
            slot["segments"].append((d, p, c))

    if not acc and eb_keys is None:
        return {"buckets": []}
    all_keys = sorted(acc.keys())
    # fill gaps for min_doc_count == 0 between observed bounds (fixed step
    # only) and out to extended_bounds when given
    if min_doc_count == 0 and not render.get("calendar"):
        step = render.get("step")
        if step is None and len(all_keys) >= 2:
            steps = sorted({round(b - a, 9)
                            for a, b in zip(all_keys, all_keys[1:])})
            step = steps[0] if steps and steps[0] > 0 else None
        if step:
            lo = all_keys[0] if all_keys else None
            hi = all_keys[-1] if all_keys else None
            if eb_keys is not None:
                eb_lo, eb_hi = eb_keys
                lo = eb_lo if lo is None else \
                    (lo if eb_lo is None else min(lo, eb_lo))
                hi = eb_hi if hi is None else \
                    (hi if eb_hi is None else max(hi, eb_hi))
            if lo is not None and hi is not None:
                base_key = lo
                seen = {round((ak - base_key) / step) for ak in all_keys}
                q = 0
                k = base_key
                while k <= hi + step / 2:
                    if q not in seen:
                        acc[k] = {"doc_count": 0, "segments": []}
                    q += 1
                    k = base_key + q * step
                all_keys = sorted(acc.keys())

    first = entries[0][0]
    buckets = []
    for key in all_keys:
        slot = acc[key]
        if slot["doc_count"] < min_doc_count:
            continue
        bucket: Dict[str, Any] = {"key": int(key) if is_date else key,
                                  "doc_count": slot["doc_count"]}
        if is_date:
            bucket["key_as_string"] = format_date_millis(int(key))
        for j, child in enumerate(first.children):
            child_entries = [(d.children[j], p * d.plan.static[1] + c)
                             for d, p, c in slot["segments"]]
            if child_entries:
                bucket[child.plan.name] = _merge_node(child_entries)
            else:
                bucket[child.plan.name] = _render_empty(child.plan.render)
        buckets.append(bucket)
    return {"buckets": _trim_zero_edges(buckets, min_doc_count, eb_keys)}


# ------------------------------------------------------------------ metrics

def _merge_metric(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    mtype = plan.render.get("kind", "stats")
    is_date = plan.render.get("is_date", False)
    total_sum = 0.0
    total_cnt = 0
    total_sumsq = 0.0
    vmin, vmax = math.inf, -math.inf
    for d, p in entries:
        if not d.out:
            continue
        if "sum" in d.out:
            total_sum += float(d.out["sum"][p])
        if "cnt" in d.out:
            total_cnt += int(d.out["cnt"][p])
        if "sumsq" in d.out:
            total_sumsq += float(d.out["sumsq"][p])
        if "min" in d.out:
            vmin = min(vmin, float(d.out["min"][p]))
        if "max" in d.out:
            vmax = max(vmax, float(d.out["max"][p]))
    has = total_cnt > 0

    if mtype == "min":
        out = {"value": vmin if has else None}
    elif mtype == "max":
        out = {"value": vmax if has else None}
    elif mtype == "sum":
        out = {"value": total_sum}
    elif mtype == "avg":
        out = {"value": (total_sum / total_cnt) if has else None}
    elif mtype == "value_count":
        out = {"value": total_cnt}
    elif mtype in ("stats", "extended_stats"):
        out = {"count": total_cnt,
               "min": vmin if has else None,
               "max": vmax if has else None,
               "avg": (total_sum / total_cnt) if has else None,
               "sum": total_sum}
        if mtype == "extended_stats":
            if has:
                mean = total_sum / total_cnt
                variance = max(total_sumsq / total_cnt - mean * mean, 0.0)
                std = math.sqrt(variance)
                out.update({
                    "sum_of_squares": total_sumsq,
                    "variance": variance,
                    "std_deviation": std,
                    "std_deviation_bounds": {"upper": mean + 2 * std,
                                             "lower": mean - 2 * std},
                })
            else:
                out.update({"sum_of_squares": None, "variance": None,
                            "std_deviation": None,
                            "std_deviation_bounds": {"upper": None,
                                                     "lower": None}})
    else:
        raise IllegalArgumentError(f"unknown metric type [{mtype}]")
    if is_date and mtype in ("min", "max") and out.get("value") is not None:
        out["value_as_string"] = format_date_millis(int(out["value"]))
    return out


def _merge_cardinality(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    live = [(d, p) for d, p in entries if "present" in d.out]
    if len(live) == 1:
        # single segment: the presence bitmap's popcount is the exact
        # cardinality
        d, p = live[0]
        card = d.plan.static[1]
        present = np.asarray(d.out["present"][p * card:(p + 1) * card])
        n_keys = len(d.plan.render["keys"]
                     if "keys" in d.plan.render
                     else d.plan.render.get("values", ()))
        return {"value": int(np.count_nonzero(present[:n_keys]))}
    distinct = set()
    for d, p in live:
        card = d.plan.static[1]
        present = d.out["present"][p * card:(p + 1) * card]
        if "keys" in d.plan.render:
            keys = d.plan.render["keys"]
            for c in np.nonzero(present)[0]:
                if c < len(keys):
                    distinct.add(keys[int(c)])
        else:
            values = d.plan.render.get("values", ())
            for c in np.nonzero(present)[0]:
                if c < len(values):
                    distinct.add(float(values[int(c)]))
    return {"value": len(distinct)}
