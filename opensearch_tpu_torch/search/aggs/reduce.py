"""Host-side aggregation reduce and response rendering (the port's copy of
opensearch_tpu.search.aggs.reduce):
per-segment partials arrive as flat numpy arrays per (segment, node); they
merge by bucket key across segments and render the REST "aggregations"
shapes. Pipeline aggregations then run on the reduced tree
(search/aggs/pipeline.py).
"""

from __future__ import annotations

import heapq
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentError
from opensearch_tpu_torch.index.mapper import (format_date_millis,
                                               parse_date_millis)
from opensearch_tpu_torch.search.aggs.engine import AggPlan
from opensearch_tpu_torch.search.compile import _resolve_date_math

DEFAULT_PERCENTS = [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]


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
        rkind = render.get("kind", "terms")
        if rkind == "terms":
            return _merge_terms(entries)
        if rkind == "significant_terms":
            return _merge_significant_terms(entries)
        if rkind in ("range", "date_range"):
            return _merge_ranges_fused(entries)
        out = _merge_histogram(entries)
        if rkind == "auto_date_histogram":
            out["interval"] = render.get("interval")
        return out

    if kind == "bucket_dense":
        rkind = render.get("kind")
        if rkind in ("composite", "multi_terms"):
            return _merge_composite(entries, multi=rkind == "multi_terms")
        return _merge_grid(entries)

    if kind == "geo_metric":
        return _merge_geo(entries)

    if kind == "adjacency":
        return _merge_adjacency(entries)

    if kind == "matrix_stats":
        return _merge_matrix_stats(entries)

    if kind == "multi":
        if render.get("kind") == "filters":
            return _merge_filters(entries)
        return _merge_ranges(entries)

    if kind in ("filter", "global", "missing", "nested", "reverse_nested"):
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

    if kind == "value_hist":
        return _merge_value_hist(entries)

    if kind == "weighted_avg":
        sum_wv = sum(float(d.out["sum_wv"][p]) for d, p in entries
                     if "sum_wv" in d.out)
        sum_w = sum(float(d.out["sum_w"][p]) for d, p in entries
                    if "sum_w" in d.out)
        return {"value": (sum_wv / sum_w) if sum_w else None}

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
    if rkind in ("range", "date_range"):
        buckets = []
        for key, frm, to in render.get("specs", []):
            b = {"key": key, "doc_count": 0}
            if frm is not None:
                b["from"] = frm
            if to is not None:
                b["to"] = to
            buckets.append(b)
        return {"buckets": buckets}
    if rkind in ("min", "max", "avg", "median_absolute_deviation"):
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
    if rkind in ("percentiles", "percentile_ranks"):
        return {"values": {}}
    if rkind == "weighted_avg":
        return {"value": None}
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

    reverse = (order_dir == "desc")
    # each segment's non-zero counts: (partials, parent bin, card
    # indices, counts)
    parts = []
    for d, p in entries:
        if "counts" not in d.out:
            continue
        card = d.plan.static[1]
        run = d.out["counts"].reshape(-1)[
            p * card:p * card + min(card, len(d.plan.render["keys"]))]
        nz = np.flatnonzero(run > 0)
        parts.append((d, p, nz, run[nz]))
    total = sum(int(cnt.sum()) for *_, cnt in parts)
    if len(parts) == 1 and order_key == "_count":
        # one segment (its keys are distinct): only the counts that can
        # reach the first `size` (at or past the size-th count) need a key
        d, p, nz, cnt = parts[0]
        ok = cnt >= min_doc_count
        nz, cnt = nz[ok], cnt[ok]
        if 0 < size < len(cnt):
            kth = np.partition(cnt, len(cnt) - size)[len(cnt) - size] \
                if reverse else np.partition(cnt, size - 1)[size - 1]
            near = cnt >= kth if reverse else cnt <= kth
            nz, cnt = nz[near], cnt[near]
        parts = [(d, p, nz, cnt)]
    # key -> [doc_count, [(partials, parent bin, card index)]]
    acc: Dict[Any, list] = {}
    for d, p, nz, cnt in parts:
        keys = d.plan.render["keys"]
        for c, n in zip(nz.tolist(), cnt.tolist()):
            slot = acc.get(keys[c])
            if slot is None:
                acc[keys[c]] = [n, [(d, p, c)]]
            else:
                slot[0] += n
                slot[1].append((d, p, c))

    eligible = [kv for kv in acc.items() if kv[1][0] >= min_doc_count]
    # the first `size` of the full order: by count with ties by key
    # ascending, or by key, or (other order keys) by count, stable
    if order_key == "_count":
        sign = -1 if reverse else 1
        items = heapq.nsmallest(size, eligible, key=lambda kv: (
            sign * kv[1][0], _orderable(kv[0])))
    elif order_key == "_key":
        items = (heapq.nlargest if reverse else heapq.nsmallest)(
            size, eligible, key=lambda kv: kv[0])
    else:
        items = sorted(eligible, key=lambda kv: kv[1][0],
                       reverse=reverse)[:size]

    buckets = []
    first = entries[0][0]
    for key, (doc_count, segments) in items:
        bucket: Dict[str, Any] = {"key": key, "doc_count": doc_count}
        for j, child in enumerate(first.children):
            child_entries = [(d.children[j], p * d.plan.static[1] + c)
                             for d, p, c in segments]
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


def _merge_ranges(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    render = plan.render
    specs = render.get("specs", [])
    is_date = render.get("is_date", False)
    buckets = []
    for i, (key, frm, to) in enumerate(specs):
        sub_entries = [(d.children[i], p) for d, p in entries
                       if i < len(d.children)]
        count = sum(int(d.out["counts"][p]) for d, p in sub_entries
                    if "counts" in d.out)
        bucket: Dict[str, Any] = {"key": key, "doc_count": count}
        if frm is not None:
            bucket["from"] = frm
            if is_date:
                bucket["from_as_string"] = format_date_millis(int(frm))
        if to is not None:
            bucket["to"] = to
            if is_date:
                bucket["to_as_string"] = format_date_millis(int(to))
        bucket.update(_merge_children(sub_entries, lambda p: p))
        buckets.append(bucket)
    return {"buckets": buckets}


def _merge_ranges_fused(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    """Range buckets from the fused bucket_bits kind: one counts row per
    range spec (overlap-safe), no per-range sub-plans to walk."""
    plan = entries[0][0].plan
    render = plan.render
    specs = render.get("specs", [])
    is_date = render.get("is_date", False)
    buckets = []
    for i, (key, frm, to) in enumerate(specs):
        count = 0
        for d, p in entries:
            if d.plan.kind == "bucket_bits" and "counts" in d.out:
                count += int(d.out["counts"][i])
            elif d.plan.kind == "multi" and i < len(d.children) \
                    and "counts" in d.children[i].out:
                count += int(d.children[i].out["counts"][p])
        bucket: Dict[str, Any] = {"key": key, "doc_count": count}
        if frm is not None:
            bucket["from"] = frm
            if is_date:
                bucket["from_as_string"] = format_date_millis(int(frm))
        if to is not None:
            bucket["to"] = to
            if is_date:
                bucket["to_as_string"] = format_date_millis(int(to))
        buckets.append(bucket)
    return {"buckets": buckets}


def _merge_filters(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    names = plan.render["names"]
    keyed = plan.render["keyed"]
    results = []
    for i, name in enumerate(names):
        sub_entries = [(d.children[i], p) for d, p in entries]
        results.append(_merge_node(sub_entries))
    if keyed:
        return {"buckets": {n: r for n, r in zip(names, results)}}
    return {"buckets": results}


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


def _value_counts(entries: List[Tuple[Decoded, int]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct values of the entries' value histograms, ascending,
    with their summed counts (merged by value across segments)."""
    vals, counts = [], []
    for d, p in entries:
        if "hist" not in d.out:
            continue
        card = d.plan.static[1]
        hist = np.asarray(d.out["hist"][p * card:(p + 1) * card])
        values = np.asarray(d.plan.render["values"], dtype=np.float64)
        nz = np.nonzero(hist[:len(values)])[0]
        vals.append(values[nz])
        counts.append(hist[nz].astype(np.int64))
    if not vals or not sum(len(v) for v in vals):
        return np.zeros(0), np.zeros(0, dtype=np.int64)
    uniq, inv = np.unique(np.concatenate(vals), return_inverse=True)
    return uniq, np.bincount(inv.reshape(-1), weights=np.concatenate(
        counts), minlength=len(uniq)).astype(np.int64)


def percentile_from_counts(vals: np.ndarray, counts: np.ndarray,
                           q: float) -> Optional[float]:
    """Exact linear-interpolated percentile over a weighted multiset
    (numpy 'linear' method, in place of OpenSearch's TDigest
    approximation)."""
    n = int(counts.sum())
    if n == 0:
        return None
    pos = (q / 100.0) * (n - 1)
    lo_i = int(math.floor(pos))
    hi_i = min(lo_i + 1, n - 1)
    frac = pos - lo_i
    cum = np.cumsum(counts)
    lo_v = float(vals[np.searchsorted(cum, lo_i + 1)])
    hi_v = float(vals[np.searchsorted(cum, hi_i + 1)])
    return lo_v + (hi_v - lo_v) * frac


def _merge_value_hist(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    kind = plan.render.get("kind", "percentiles")
    body = plan.render.get("body", {})
    vals, counts = _value_counts(entries)
    if kind == "percentiles":
        percents = body.get("percents", DEFAULT_PERCENTS)
        return {"values": {f"{float(q)}": percentile_from_counts(vals, counts, q)
                           for q in percents}}
    if kind == "percentile_ranks":
        targets = body.get("values", [])
        n = int(counts.sum())
        out = {}
        for t in targets:
            if n == 0:
                out[f"{float(t)}"] = None
            else:
                below = int(counts[vals <= float(t)].sum())
                out[f"{float(t)}"] = 100.0 * below / n
        return {"values": out}
    if kind == "median_absolute_deviation":
        if counts.sum() == 0:
            return {"value": None}
        median = percentile_from_counts(vals, counts, 50.0)
        dev = np.abs(vals - median)
        order = np.argsort(dev)
        return {"value": percentile_from_counts(dev[order], counts[order], 50.0)}
    raise IllegalArgumentError(f"unknown value-hist agg [{kind}]")


# ------------------------------------------------- extended bucket mergers

def _merge_composite(entries: List[Tuple[Decoded, int]],
                     multi: bool) -> Dict[str, Any]:
    """Composite (paginated multi-source tuples) and multi_terms share the
    mixed-radix bucket layout; they differ only in rendering/sort/paging."""
    plan = entries[0][0].plan
    render = plan.render
    sources = render["sources"]
    merged: Dict[tuple, Tuple[int, List[Tuple[Decoded, int, int]]]] = {}
    for d, p in entries:
        counts = d.out.get("counts")
        if counts is None:
            continue
        # key lists are per segment (each segment has its own dictionary)
        key_lists = d.plan.render["key_lists"]
        radices = [max(len(k), 1) for k in key_lists]
        card = int(np.prod(radices))
        base = p * card
        arr = np.asarray(counts[base:base + card])
        nz = np.nonzero(arr)[0]
        if not len(nz):
            continue
        # mixed-radix digits of each non-empty bucket (the first source
        # most significant), then its key tuple
        digits = np.unravel_index(nz, radices)
        keys = zip(*[np.asarray(kl, dtype=object)[dg]
                     for kl, dg in zip(key_lists, digits)])
        for key, n, flat in zip(keys, arr[nz].tolist(), nz.tolist()):
            cnt, members = merged.get(key, (0, []))
            merged[key] = (cnt + n, members + [(d, p, flat)])
    body = render.get("body", {})
    size = int(body.get("size", 10))
    if multi:
        items = sorted(merged.items(), key=lambda kv: (-kv[1][0], kv[0]))
        buckets = []
        for key, (cnt, members) in items[:size]:
            b = {"key": list(key),
                 "key_as_string": "|".join(str(k) for k in key),
                 "doc_count": cnt}
            b.update(_merge_composite_children(plan, members))
            buckets.append(b)
        return {"doc_count_error_upper_bound": 0, "sum_other_doc_count":
                sum(c for _, (c, _) in items[size:]),
                "buckets": buckets}
    # composite: key-ordered pagination with after_key
    after = body.get("after")
    after_t = None if after is None else tuple(after[s] for s in sources)
    try:
        # a source's keys share one type, so the tuples' own order is
        # _tuple_sort_key's; a mixed comparison raises and takes it instead
        items = sorted(merged.items(), key=lambda kv: kv[0])
        if after_t is not None:
            items = [kv for kv in items if kv[0] > after_t]
    except TypeError:
        items = sorted(merged.items(), key=lambda kv: _tuple_sort_key(kv[0]))
        if after_t is not None:
            after_key = _tuple_sort_key(after_t)
            items = [kv for kv in items
                     if _tuple_sort_key(kv[0]) > after_key]
    page = items[:size]
    buckets = []
    for key, (cnt, members) in page:
        b = {"key": dict(zip(sources, key)), "doc_count": cnt}
        b.update(_merge_composite_children(plan, members))
        buckets.append(b)
    out: Dict[str, Any] = {"buckets": buckets}
    if page:
        out["after_key"] = dict(zip(sources, page[-1][0]))
    return out


def _tuple_sort_key(key: tuple):
    return tuple((0, v) if isinstance(v, (int, float, bool))
                 else (1, str(v)) for v in key)


def _merge_composite_children(plan, members) -> Dict[str, Any]:
    if not plan.children:
        return {}
    out: Dict[str, Any] = {}
    for j, child in enumerate(plan.children):
        child_entries = []
        for d, p, flat in members:
            total_card = int(np.prod([max(len(k), 1)
                                      for k in d.plan.render["key_lists"]]))
            child_entries.append((d.children[j], p * total_card + flat))
        out[child.name] = _merge_node(child_entries)
    return out


def _merge_significant_terms(entries: List[Tuple[Decoded, int]]
                             ) -> Dict[str, Any]:
    """JLH significance scoring (OpenSearch's default heuristic:
    (fg% - bg%) * (fg% / bg%))."""
    plan = entries[0][0].plan
    # fg and bg accumulate by KEY across segments (per-segment dictionaries)
    fg_by_key: Dict[Any, int] = {}
    bg_by_key: Dict[Any, int] = {}
    bg_total = 0
    for d, p in entries:
        keys = d.plan.render.get("keys", [])
        bg = d.plan.render.get("bg", [])
        bg_total += max(d.plan.render.get("bg_total", 0), 0)
        card = max(len(keys), 1)
        counts = d.out.get("counts")
        for i, key in enumerate(keys):
            bg_by_key[key] = bg_by_key.get(key, 0) \
                + (int(bg[i]) if i < len(bg) else 0)
            if counts is not None:
                fg_by_key[key] = fg_by_key.get(key, 0) \
                    + int(counts[p * card + i])
    bg_total = max(bg_total, 1)
    subset_size = max(sum(fg_by_key.values()), 1)
    body = plan.render.get("body", {})
    min_doc_count = int(body.get("min_doc_count", 3))
    size = int(body.get("size", 10))
    scored = []
    for key, fg_count in fg_by_key.items():
        if fg_count < min_doc_count:
            continue
        fg_pct = fg_count / subset_size
        bg_pct = max(bg_by_key.get(key, 0), 1) / bg_total
        if fg_pct <= bg_pct:
            continue
        score = (fg_pct - bg_pct) * (fg_pct / bg_pct)
        scored.append({"key": key, "doc_count": int(fg_count),
                       "score": float(score),
                       "bg_count": int(bg_by_key.get(key, 0))})
    scored.sort(key=lambda b: -b["score"])
    return {"doc_count": subset_size, "bg_count": bg_total,
            "buckets": scored[:size]}


def _merge_grid(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    """geohash_grid / geotile_grid: counts summed by cell key across
    segments, by count descending then key."""
    body = entries[0][0].plan.render.get("body", {})
    totals: Dict[str, int] = {}
    for d, p in entries:
        counts = d.out.get("counts")
        if counts is None:
            continue
        keys = d.plan.render.get("keys", [])  # per-segment key table
        card = max(len(keys), 1)
        arr = np.asarray(counts[p * card:(p + 1) * card])
        for i in np.nonzero(arr)[0]:
            if i < len(keys):
                totals[keys[i]] = totals.get(keys[i], 0) + int(arr[i])
    size = int(body.get("size", 10000))
    buckets = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:size]
    return {"buckets": [{"key": k, "doc_count": c} for k, c in buckets]}


def _merge_geo(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    """geo_bounds (top_left / bottom_right of the extrema) and
    geo_centroid (the mean point, f32 sums added across segments in
    f64)."""
    kind = entries[0][0].plan.render.get("kind", "geo_bounds")
    cnt = sum(int(d.out["cnt"][p]) for d, p in entries if "cnt" in d.out)
    if cnt == 0:
        return {"doc_count": 0} if kind == "geo_centroid" else {}
    if kind == "geo_centroid":
        sum_lat = sum(float(d.out["sum_lat"][p]) for d, p in entries
                      if "sum_lat" in d.out)
        sum_lon = sum(float(d.out["sum_lon"][p]) for d, p in entries
                      if "sum_lon" in d.out)
        return {"location": {"lat": sum_lat / cnt, "lon": sum_lon / cnt},
                "count": cnt}

    def agg(key, fn, init):
        return fn([float(d.out[key][p]) for d, p in entries
                   if key in d.out] or [init])
    return {"bounds": {
        "top_left": {"lat": agg("max_lat", max, 0.0),
                     "lon": agg("min_lon", min, 0.0)},
        "bottom_right": {"lat": agg("min_lat", min, 0.0),
                         "lon": agg("max_lon", max, 0.0)},
    }}


def _merge_adjacency(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    names = plan.render["names"]
    totals: Dict[str, int] = {}
    for d, p in entries:
        for i in range(len(names)):
            for j in range(i, len(names)):
                arr = d.out.get(f"c_{i}_{j}")
                if arr is None:
                    continue
                key = names[i] if i == j else f"{names[i]}&{names[j]}"
                totals[key] = totals.get(key, 0) + int(arr[p])
    buckets = [{"key": k, "doc_count": c}
               for k, c in sorted(totals.items()) if c > 0]
    return {"buckets": buckets}


def _merge_matrix_stats(entries: List[Tuple[Decoded, int]]) -> Dict[str, Any]:
    plan = entries[0][0].plan
    fields = plan.render["fields"]

    def total(key):
        return sum(float(d.out[key][p]) for d, p in entries
                   if key in d.out)

    out_fields = []
    moments = {}
    for f in fields:
        cnt = int(total(f"{f}::cnt"))
        if cnt == 0:
            continue
        s1 = total(f"{f}::sum")
        s2 = total(f"{f}::sum2")
        s3 = total(f"{f}::sum3")
        s4 = total(f"{f}::sum4")
        mean = s1 / cnt
        var = max(s2 / cnt - mean ** 2, 0.0)
        std = var ** 0.5
        # central moments from raw moments
        m3 = s3 / cnt - 3 * mean * s2 / cnt + 2 * mean ** 3
        m4 = (s4 / cnt - 4 * mean * s3 / cnt + 6 * mean ** 2 * s2 / cnt
              - 3 * mean ** 4)
        moments[f] = (cnt, mean, var)
        entry = {
            "name": f, "count": cnt, "mean": mean,
            "variance": var * cnt / max(cnt - 1, 1),  # sample variance
            "skewness": (m3 / std ** 3) if std > 0 else 0.0,
            "kurtosis": (m4 / var ** 2) if var > 0 else 0.0,
            "covariance": {}, "correlation": {},
        }
        out_fields.append(entry)
    by_name = {e["name"]: e for e in out_fields}
    for i, fa in enumerate(fields):
        for fb in fields[i + 1:]:
            key = f"{fa}*{fb}"
            if fa not in by_name or fb not in by_name:
                continue
            n = int(total(f"{key}::cnt"))
            if n == 0:
                continue
            sxy = total(f"{key}::sumxy")
            sx = total(f"{key}::sumx")
            sy = total(f"{key}::sumy")
            cov = sxy / n - (sx / n) * (sy / n)
            cov_sample = cov * n / max(n - 1, 1)
            _, _, var_a = moments[fa]
            _, _, var_b = moments[fb]
            corr = cov / ((var_a ** 0.5) * (var_b ** 0.5)) \
                if var_a > 0 and var_b > 0 else 0.0
            for a, b in ((fa, fb), (fb, fa)):
                by_name[a]["covariance"][b] = cov_sample
                by_name[a]["correlation"][b] = corr
    for e in out_fields:
        e["covariance"][e["name"]] = e["variance"]
        e["correlation"][e["name"]] = 1.0
    return {"doc_count": max((e["count"] for e in out_fields), default=0),
            "fields": out_fields}
