"""Pipeline aggregations: run on the reduced bucket tree (the port's copy of
opensearch_tpu.search.aggs.pipeline).

OpenSearch's search/aggregations/pipeline/ (17 types): parent pipelines
(derivative, cumulative_sum, moving_avg/fn, serial_diff, bucket_script/
selector/sort) transform a parent bucket agg's bucket list; sibling pipelines
(avg/max/min/sum/stats/extended_stats/percentiles_bucket) summarize a sibling
path into a single value. bucket_script uses a restricted arithmetic
expression evaluator instead of painless.
"""

from __future__ import annotations

import ast
import math
import operator
from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ParsingError)
from opensearch_tpu_torch.search.aggs.parse import AggNode, PIPELINE_TYPES


def resolve_bucket_path(bucket: Dict[str, Any], path: str) -> Optional[float]:
    """Resolve a buckets_path within one bucket: '_count', 'metric',
    'metric.property' (e.g. 'stats.avg')."""
    if path == "_count":
        return float(bucket.get("doc_count", 0))
    parts = path.split(".")
    node = bucket.get(parts[0])
    if node is None:
        return None
    if len(parts) == 1:
        if isinstance(node, dict):
            return node.get("value")
        return node
    val = node
    for p in parts[1:]:
        if not isinstance(val, dict):
            return None
        val = val.get(p)
    return val


# -------------------------------------------------- restricted script eval

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
           ast.Div: operator.truediv, ast.Mod: operator.mod,
           ast.Pow: operator.pow, ast.FloorDiv: operator.floordiv}
_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_CMPOPS = {ast.Gt: operator.gt, ast.GtE: operator.ge, ast.Lt: operator.lt,
           ast.LtE: operator.le, ast.Eq: operator.eq, ast.NotEq: operator.ne}
_FUNCS = {"abs": abs, "min": min, "max": max, "log": math.log,
          "log10": math.log10, "sqrt": math.sqrt, "floor": math.floor,
          "ceil": math.ceil, "round": round, "exp": math.exp}


def safe_eval(expr: str, variables: Dict[str, float]) -> Any:
    """Arithmetic-only expression evaluator (the bucket_script 'painless'
    subset). Supports params.x variables, arithmetic, comparisons, ternary."""
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ParsingError(f"invalid script [{expr}]: {e}")

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, bool)):
                return node.value
            raise ParsingError(f"unsupported literal in script [{expr}]")
        if isinstance(node, ast.Name):
            if node.id in variables:
                return variables[node.id]
            if node.id == "params":
                return variables
            raise ParsingError(f"unknown variable [{node.id}] in script")
        if isinstance(node, ast.Attribute):
            base = ev(node.value)
            if isinstance(base, dict) and node.attr in base:
                return base[node.attr]
            raise ParsingError(f"unknown variable [params.{node.attr}]")
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
            return _UNARY[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and type(node.ops[0]) in _CMPOPS:
            return _CMPOPS[type(node.ops[0])](ev(node.left),
                                              ev(node.comparators[0]))
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.BoolOp):
            vals = [ev(v) for v in node.values]
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _FUNCS:
            return _FUNCS[node.func.id](*[ev(a) for a in node.args])
        raise ParsingError(f"unsupported construct in script [{expr}]")

    return ev(tree)


# ----------------------------------------------------------- application

def apply_pipelines(nodes: List[AggNode], aggs_result: Dict[str, Any]):
    """Mutates aggs_result in place: nested parent pipelines inside bucket
    aggs, then top-level sibling pipelines."""
    for node in nodes:
        if node.type in PIPELINE_TYPES:
            continue  # handled after non-pipeline siblings resolve
        result = aggs_result.get(node.name)
        if result is not None:
            _apply_nested(node, result)
    for node in nodes:
        if node.type in PIPELINE_TYPES:
            aggs_result[node.name] = _sibling_value(node, aggs_result)


def _bucket_list(result: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
    buckets = result.get("buckets")
    if buckets is None:
        return None
    if isinstance(buckets, dict):
        return list(buckets.values())
    return buckets


def _apply_nested(node: AggNode, result: Dict[str, Any]):
    buckets = _bucket_list(result)
    if buckets is None:
        # single-bucket aggs (filter/global/missing) carry children inline
        for child in node.children:
            sub = result.get(child.name)
            if sub is not None:
                _apply_nested(child, sub)
        for p in node.pipelines:
            if p.type in _SIBLING:
                result[p.name] = _sibling_value(p, result)
        return
    for b in buckets:
        for child in node.children:
            sub = b.get(child.name)
            if sub is not None:
                _apply_nested(child, sub)
    for p in node.pipelines:
        if p.type in _SIBLING:
            result[p.name] = _sibling_value(p, result)
        else:
            _apply_parent_pipeline(p, node, result)


def _apply_parent_pipeline(p: AggNode, parent: AggNode, result: Dict[str, Any]):
    buckets = _bucket_list(result)
    if buckets is None:
        return
    path = p.body.get("buckets_path")
    gap_policy = p.body.get("gap_policy", "skip")

    if p.type == "bucket_script":
        paths = path or {}
        if not isinstance(paths, dict):
            raise ParsingError("[bucket_script] requires a buckets_path map")
        script = _script_source(p.body)
        for b in buckets:
            variables = {k: resolve_bucket_path(b, v) for k, v in paths.items()}
            if any(v is None for v in variables.values()):
                if gap_policy == "insert_zeros":
                    variables = {k: (0.0 if v is None else v)
                                 for k, v in variables.items()}
                else:
                    continue
            b[p.name] = {"value": safe_eval(script, variables)}
        return

    if p.type == "bucket_selector":
        paths = path or {}
        script = _script_source(p.body)
        keep = []
        for b in buckets:
            variables = {k: resolve_bucket_path(b, v) for k, v in paths.items()}
            if any(v is None for v in variables.values()):
                continue
            if safe_eval(script, variables):
                keep.append(b)
        _replace_buckets(result, keep)
        return

    if p.type == "bucket_sort":
        sort_specs = p.body.get("sort", [])
        frm = int(p.body.get("from", 0))
        size = p.body.get("size")
        ordered = list(buckets)
        for spec in reversed(sort_specs):
            if isinstance(spec, str):
                field, order = spec, "asc"
            else:
                field, opts = next(iter(spec.items()))
                order = opts.get("order", "asc") if isinstance(opts, dict) \
                    else str(opts)
            ordered.sort(key=lambda b: (resolve_bucket_path(b, field) is None,
                                        resolve_bucket_path(b, field) or 0),
                         reverse=(order == "desc"))
        ordered = ordered[frm:frm + int(size)] if size is not None \
            else ordered[frm:]
        _replace_buckets(result, ordered)
        return

    # sequence pipelines over a single metric path
    if not path:
        raise ParsingError(f"[{p.type}] requires [buckets_path]")
    values = [resolve_bucket_path(b, path) for b in buckets]

    if p.type == "derivative":
        prev = None
        for b, v in zip(buckets, values):
            if prev is not None and v is not None:
                b[p.name] = {"value": v - prev}
            prev = v if v is not None else prev
        return
    if p.type == "cumulative_sum":
        acc = 0.0
        for b, v in zip(buckets, values):
            acc += v or 0.0
            b[p.name] = {"value": acc}
        return
    if p.type == "serial_diff":
        lag = int(p.body.get("lag", 1))
        for i, b in enumerate(buckets):
            if i >= lag and values[i] is not None and values[i - lag] is not None:
                b[p.name] = {"value": values[i] - values[i - lag]}
        return
    if p.type in ("moving_avg", "moving_fn"):
        window = int(p.body.get("window", 5))
        shift = int(p.body.get("shift", 0))
        for i, b in enumerate(buckets):
            lo = max(0, i - window + shift)
            hi = max(0, i + shift)
            vals = [v for v in values[lo:hi] if v is not None]
            if not vals:
                continue
            if p.type == "moving_avg":
                b[p.name] = {"value": sum(vals) / len(vals)}
            else:
                script = _script_source(p.body)
                b[p.name] = {"value": safe_eval(
                    script, {"values_sum": sum(vals), "values_len": len(vals),
                             "values_min": min(vals), "values_max": max(vals)})}
        return
    raise IllegalArgumentError(f"unsupported pipeline aggregation [{p.type}]")


def _script_source(body: dict) -> str:
    script = body.get("script", "")
    if isinstance(script, dict):
        script = script.get("source", "")
    return str(script)


def _replace_buckets(result: Dict[str, Any], new_buckets):
    if isinstance(result.get("buckets"), dict):
        # keyed filters buckets — rebuild preserving keys is not meaningful
        return
    result["buckets"] = new_buckets


_SIBLING = {"avg_bucket", "max_bucket", "min_bucket", "sum_bucket",
            "stats_bucket", "extended_stats_bucket", "percentiles_bucket"}


def _sibling_value(p: AggNode, scope: Dict[str, Any]) -> Dict[str, Any]:
    path = p.body.get("buckets_path", "")
    if ">" not in path and p.type in _SIBLING:
        raise ParsingError(f"[{p.type}] buckets_path must reference a "
                           f"sibling bucket aggregation (agg>metric)")
    agg_name, _, metric_path = path.partition(">")
    sibling = scope.get(agg_name)
    if sibling is None:
        return {"value": None}
    buckets = _bucket_list(sibling) or []
    values = [resolve_bucket_path(b, metric_path or "_count") for b in buckets]
    values = [v for v in values if v is not None]
    if p.type == "avg_bucket":
        return {"value": (sum(values) / len(values)) if values else None}
    if p.type == "max_bucket":
        if not values:
            return {"value": None, "keys": []}
        best = max(values)
        keys = [str(b.get("key_as_string", b.get("key"))) for b, v in
                zip(buckets, [resolve_bucket_path(b, metric_path or "_count")
                              for b in buckets]) if v == best]
        return {"value": best, "keys": keys}
    if p.type == "min_bucket":
        if not values:
            return {"value": None, "keys": []}
        best = min(values)
        keys = [str(b.get("key_as_string", b.get("key"))) for b, v in
                zip(buckets, [resolve_bucket_path(b, metric_path or "_count")
                              for b in buckets]) if v == best]
        return {"value": best, "keys": keys}
    if p.type == "sum_bucket":
        return {"value": sum(values) if values else 0.0}
    if p.type in ("stats_bucket", "extended_stats_bucket"):
        if not values:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        out = {"count": len(values), "min": min(values), "max": max(values),
               "avg": sum(values) / len(values), "sum": sum(values)}
        if p.type == "extended_stats_bucket":
            mean = out["avg"]
            var = sum((v - mean) ** 2 for v in values) / len(values)
            out.update({"sum_of_squares": sum(v * v for v in values),
                        "variance": var, "std_deviation": math.sqrt(var)})
        return out
    if p.type == "percentiles_bucket":
        percents = p.body.get("percents", [1.0, 5.0, 25.0, 50.0, 75.0, 95.0,
                                           99.0])
        if not values:
            return {"values": {f"{float(q)}": None for q in percents}}
        import numpy as _np
        arr = _np.asarray(sorted(values))
        return {"values": {f"{float(q)}": float(_np.percentile(arr, q))
                           for q in percents}}
    raise IllegalArgumentError(f"unsupported pipeline aggregation [{p.type}]")
