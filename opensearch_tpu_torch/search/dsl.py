"""Query DSL (the subset of opensearch_tpu.search.dsl the port needs), with
the reference's REST wire shapes and error types:

- full text: `match` (with `fuzziness`), `match_phrase`,
  `match_phrase_prefix`, `match_bool_prefix`, `multi_match`,
  `query_string`, `simple_query_string`;
- term level: `term`, `terms`, `terms_set`, `range`, `exists`, `ids`,
  `prefix`, `wildcard`, `regexp`, `fuzzy`;
- compound and scoring: `bool`, `dis_max`, `constant_score`, `boosting`,
  `function_score`, `script_score`, `distance_feature` (numeric, date or
  geo_point), `rank_feature`, `match_all`, `match_none`;
- nested documents: `nested` (with `inner_hits`);
- geo: `geo_distance`, `geo_bounding_box`;
- vectors: `knn`, `maxsim` and the top-level `hybrid`.

The reference's other query kinds (`NOT_PORTED`) answer a 400 naming them
as not supported by the port yet; any other name raises the reference's
`unknown query` parsing error."""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence

from opensearch_tpu_torch.common.errors import ParsingError
from opensearch_tpu_torch.index.mapper import parse_geo_point

# query kinds of the reference the port does not serve yet (the join
# queries wait for the join field type, geo_shape for its type)
NOT_PORTED = frozenset({
    "has_child", "has_parent", "parent_id", "geo_shape", "span_term",
    "span_near", "span_first", "span_or", "span_not", "span_containing",
    "span_within", "span_multi", "field_masking_span", "intervals",
    "more_like_this", "percolate"})


@dataclass
class QueryNode:
    boost: float = 1.0


@dataclass
class MatchAllQuery(QueryNode):
    pass


@dataclass
class MatchNoneQuery(QueryNode):
    pass


@dataclass
class MatchQuery(QueryNode):
    field: str = ""
    query: Any = None
    operator: str = "or"              # or | and
    minimum_should_match: Optional[str] = None
    analyzer: Optional[str] = None
    fuzziness: Optional[str] = None


@dataclass
class MatchPhraseQuery(QueryNode):
    field: str = ""
    query: Any = None
    slop: int = 0
    analyzer: Optional[str] = None


@dataclass
class MatchBoolPrefixQuery(QueryNode):
    field: str = ""
    query: Any = None
    analyzer: Optional[str] = None


@dataclass
class MultiMatchQuery(QueryNode):
    fields: Sequence[str] = ()
    query: Any = None
    type: str = "best_fields"   # best_fields | most_fields | cross_fields
    operator: str = "or"        # | phrase
    tie_breaker: float = 0.0
    minimum_should_match: Optional[str] = None


@dataclass
class TermQuery(QueryNode):
    field: str = ""
    value: Any = None
    case_insensitive: bool = False


@dataclass
class TermsQuery(QueryNode):
    field: str = ""
    values: Sequence[Any] = ()


@dataclass
class RangeQuery(QueryNode):
    field: str = ""
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None
    fmt: Optional[str] = None
    time_zone: Optional[str] = None


@dataclass
class ExistsQuery(QueryNode):
    field: str = ""


@dataclass
class IdsQuery(QueryNode):
    values: Sequence[str] = ()


@dataclass
class PrefixQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class WildcardQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class RegexpQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class FuzzyQuery(QueryNode):
    field: str = ""
    value: str = ""
    fuzziness: str = "AUTO"
    prefix_length: int = 0
    max_expansions: int = 50


@dataclass
class ConstantScoreQuery(QueryNode):
    filter: Optional[QueryNode] = None


@dataclass
class BoostingQuery(QueryNode):
    positive: Optional[QueryNode] = None
    negative: Optional[QueryNode] = None
    negative_boost: float = 0.0


@dataclass
class QueryStringQuery(QueryNode):
    query: str = ""
    default_field: Optional[str] = None
    fields: Sequence[str] = ()
    default_operator: str = "or"


@dataclass
class SimpleQueryStringQuery(QueryNode):
    query: str = ""
    fields: Sequence[str] = ()
    default_operator: str = "or"


@dataclass
class ScriptScoreQuery(QueryNode):
    query: Optional[QueryNode] = None
    script_source: str = ""
    script_params: dict = dc_field(default_factory=dict)


@dataclass
class FunctionScoreQuery(QueryNode):
    query: Optional[QueryNode] = None
    functions: List[dict] = dc_field(default_factory=list)
    score_mode: str = "multiply"     # multiply|sum|avg|first|max|min
    boost_mode: str = "multiply"     # multiply|replace|sum|avg|max|min
    max_boost: float = 3.4e38
    min_score: Optional[float] = None


@dataclass
class MatchPhrasePrefixQuery(QueryNode):
    field: str = ""
    query: Any = None
    slop: int = 0
    max_expansions: int = 50
    analyzer: Optional[str] = None


@dataclass
class TermsSetQuery(QueryNode):
    field: str = ""
    terms: List[Any] = dc_field(default_factory=list)
    minimum_should_match_field: Optional[str] = None


@dataclass
class DistanceFeatureQuery(QueryNode):
    field: str = ""
    origin: Any = None
    pivot: Any = None


@dataclass
class RankFeatureQuery(QueryNode):
    field: str = ""
    function: str = "saturation"     # saturation | log | sigmoid | linear
    pivot: Optional[float] = None
    scaling_factor: float = 1.0
    exponent: float = 1.0


@dataclass
class GeoDistanceQuery(QueryNode):
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0


@dataclass
class GeoBoundingBoxQuery(QueryNode):
    field: str = ""
    top: float = 90.0
    left: float = -180.0
    bottom: float = -90.0
    right: float = 180.0


@dataclass
class NestedQuery(QueryNode):
    """Block-join of a nested path's rows to their root rows."""
    path: str = ""
    query: Optional[QueryNode] = None
    score_mode: str = "avg"          # avg | sum | min | max | none
    ignore_unmapped: bool = False
    inner_hits: Optional[Dict[str, Any]] = None


_DISTANCE_UNITS_M = {
    "mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0, "mi": 1609.344,
    "miles": 1609.344, "yd": 0.9144, "ft": 0.3048, "in": 0.0254,
    "nm": 1852.0, "nmi": 1852.0, "nauticalmiles": 1852.0,
}


def parse_distance(value: Any) -> float:
    """A distance ("12km", "500m", bare meters) in meters."""
    if isinstance(value, (int, float)):
        return float(value)
    m = re.fullmatch(r"\s*([\d.]+)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        raise ParsingError(f"failed to parse distance [{value}]")
    unit = m.group(2).lower() or "m"
    if unit not in _DISTANCE_UNITS_M:
        raise ParsingError(f"unknown distance unit [{unit}]")
    return float(m.group(1)) * _DISTANCE_UNITS_M[unit]


def _parse_inner_hits(body: dict) -> Optional[Dict[str, Any]]:
    ih = body.get("inner_hits")
    if ih is not None and not isinstance(ih, dict):
        raise ParsingError("[inner_hits] must be an object")
    return ih


@dataclass
class DisMaxQuery(QueryNode):
    queries: List[QueryNode] = dc_field(default_factory=list)
    tie_breaker: float = 0.0


@dataclass
class KnnQuery(QueryNode):
    field: str = ""
    vector: Sequence[float] = ()
    k: int = 10
    filter: Optional[QueryNode] = None
    nprobe: int = 0          # IVF probe override (method_parameters.nprobes)


@dataclass
class MaxSimQuery(QueryNode):
    """Late-interaction leaf query over a `rank_vectors` field: the query
    brings one vector per query token, and docs are scored by MaxSim
    (ops/maxsim.py)."""
    field: str = ""
    query_vectors: Sequence[Sequence[float]] = ()
    k: int = 10
    filter: Optional[QueryNode] = None


@dataclass
class HybridQuery(QueryNode):
    """Hybrid clause (the neural-search plugin's HybridQueryBuilder): N
    independently scored sub-queries whose scores stay separate through
    the query phase and merge in the search pipeline's
    normalization-processor. Top-level only."""
    queries: List["QueryNode"] = dc_field(default_factory=list)


# reference: HybridQueryBuilder.MAX_NUMBER_OF_SUB_QUERIES
MAX_HYBRID_SUB_QUERIES = 5


@dataclass
class BoolQuery(QueryNode):
    must: List[QueryNode] = dc_field(default_factory=list)
    filter: List[QueryNode] = dc_field(default_factory=list)
    should: List[QueryNode] = dc_field(default_factory=list)
    must_not: List[QueryNode] = dc_field(default_factory=list)
    minimum_should_match: Optional[Any] = None


def _field_body(body: dict, query_name: str):
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingError(
            f"[{query_name}] query malformed, no field specified"
            if not body else
            f"[{query_name}] query doesn't support multiple fields")
    return next(iter(body.items()))


def _as_list(nodes) -> list:
    if nodes is None:
        return []
    if isinstance(nodes, list):
        return [parse_query(n) for n in nodes]
    return [parse_query(nodes)]


def parse_query(q: Any) -> QueryNode:
    if q is None:
        return MatchAllQuery()
    if not isinstance(q, dict) or len(q) != 1:
        raise ParsingError(
            "[_na] query malformed, must have exactly one query clause")
    name, body = next(iter(q.items()))

    if name == "match_all":
        return MatchAllQuery(boost=float((body or {}).get("boost", 1.0)))
    if name == "match_none":
        return MatchNoneQuery()

    if name == "match":
        field, spec = _field_body(body, "match")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        return MatchQuery(field=field, query=spec.get("query"),
                          operator=str(spec.get("operator", "or")).lower(),
                          minimum_should_match=spec.get(
                              "minimum_should_match"),
                          analyzer=spec.get("analyzer"),
                          fuzziness=spec.get("fuzziness"),
                          boost=float(spec.get("boost", 1.0)))

    if name == "match_phrase":
        field, spec = _field_body(body, "match_phrase")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        return MatchPhraseQuery(field=field, query=spec.get("query"),
                                slop=int(spec.get("slop", 0)),
                                analyzer=spec.get("analyzer"),
                                boost=float(spec.get("boost", 1.0)))

    if name == "match_bool_prefix":
        field, spec = _field_body(body, "match_bool_prefix")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        return MatchBoolPrefixQuery(field=field, query=spec.get("query"),
                                    analyzer=spec.get("analyzer"),
                                    boost=float(spec.get("boost", 1.0)))

    if name == "multi_match":
        return MultiMatchQuery(
            fields=tuple(body.get("fields", [])), query=body.get("query"),
            type=body.get("type", "best_fields"),
            operator=str(body.get("operator", "or")).lower(),
            tie_breaker=float(body.get("tie_breaker", 0.0)),
            minimum_should_match=body.get("minimum_should_match"),
            boost=float(body.get("boost", 1.0)))

    if name == "match_phrase_prefix":
        field, spec = _field_body(body, "match_phrase_prefix")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        return MatchPhrasePrefixQuery(
            field=field, query=spec.get("query"),
            slop=int(spec.get("slop", 0)),
            max_expansions=int(spec.get("max_expansions", 50)),
            analyzer=spec.get("analyzer"),
            boost=float(spec.get("boost", 1.0)))

    if name == "term":
        field, spec = _field_body(body, "term")
        if isinstance(spec, dict):
            return TermQuery(field=field, value=spec.get("value"),
                             case_insensitive=bool(
                                 spec.get("case_insensitive", False)),
                             boost=float(spec.get("boost", 1.0)))
        return TermQuery(field=field, value=spec)

    if name == "terms":
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        if len(body) != 1:
            raise ParsingError("[terms] query requires exactly one field")
        field, values = next(iter(body.items()))
        if not isinstance(values, (list, tuple)):
            raise ParsingError("[terms] query requires an array of terms")
        return TermsQuery(field=field, values=list(values), boost=boost)

    if name == "range":
        field, spec = _field_body(body, "range")
        if not isinstance(spec, dict):
            raise ParsingError("[range] query malformed")
        # `relation` shapes range-typed fields only, which are not ported:
        # on the ported types it is accepted and has no effect
        known = {"gte", "gt", "lte", "lt", "boost", "format", "time_zone",
                 "from", "to", "include_lower", "include_upper", "relation"}
        unknown = set(spec) - known
        if unknown:
            raise ParsingError(f"[range] query does not support "
                               f"[{sorted(unknown)[0]}]")
        gte, gt = spec.get("gte"), spec.get("gt")
        lte, lt = spec.get("lte"), spec.get("lt")
        if "from" in spec:  # legacy shape
            if spec.get("include_lower", True):
                gte = spec["from"]
            else:
                gt = spec["from"]
        if "to" in spec:
            if spec.get("include_upper", True):
                lte = spec["to"]
            else:
                lt = spec["to"]
        return RangeQuery(field=field, gte=gte, gt=gt, lte=lte, lt=lt,
                          fmt=spec.get("format"),
                          time_zone=spec.get("time_zone"),
                          boost=float(spec.get("boost", 1.0)))

    if name == "exists":
        if "field" not in body:
            raise ParsingError("[exists] must be provided with a [field]")
        return ExistsQuery(field=body["field"],
                           boost=float(body.get("boost", 1.0)))

    if name == "dis_max":
        return DisMaxQuery(queries=_as_list(body.get("queries")),
                           tie_breaker=float(body.get("tie_breaker", 0.0)),
                           boost=float(body.get("boost", 1.0)))

    if name == "ids":
        return IdsQuery(values=list(body.get("values", [])),
                        boost=float(body.get("boost", 1.0)))

    if name in ("prefix", "wildcard", "regexp"):
        field, spec = _field_body(body, name)
        cls = {"prefix": PrefixQuery, "wildcard": WildcardQuery,
               "regexp": RegexpQuery}[name]
        if isinstance(spec, dict):
            value = spec.get("value", spec.get(name))
            return cls(field=field, value=str(value),
                       case_insensitive=bool(
                           spec.get("case_insensitive", False)),
                       boost=float(spec.get("boost", 1.0)))
        return cls(field=field, value=str(spec))

    if name == "fuzzy":
        field, spec = _field_body(body, "fuzzy")
        if isinstance(spec, dict):
            return FuzzyQuery(
                field=field, value=str(spec.get("value")),
                fuzziness=str(spec.get("fuzziness", "AUTO")),
                prefix_length=int(spec.get("prefix_length", 0)),
                max_expansions=int(spec.get("max_expansions", 50)),
                boost=float(spec.get("boost", 1.0)))
        return FuzzyQuery(field=field, value=str(spec))

    if name == "constant_score":
        if "filter" not in body:
            raise ParsingError("[constant_score] requires a filter element")
        return ConstantScoreQuery(filter=parse_query(body["filter"]),
                                  boost=float(body.get("boost", 1.0)))

    if name == "boosting":
        return BoostingQuery(
            positive=parse_query(body.get("positive")),
            negative=parse_query(body.get("negative")),
            negative_boost=float(body.get("negative_boost", 0.0)),
            boost=float(body.get("boost", 1.0)))

    if name == "query_string":
        return QueryStringQuery(
            query=body.get("query", ""),
            default_field=body.get("default_field"),
            fields=tuple(body.get("fields", [])),
            default_operator=str(body.get("default_operator",
                                          "or")).lower(),
            boost=float(body.get("boost", 1.0)))

    if name == "simple_query_string":
        return SimpleQueryStringQuery(
            query=body.get("query", ""),
            fields=tuple(body.get("fields", [])),
            default_operator=str(body.get("default_operator",
                                          "or")).lower(),
            boost=float(body.get("boost", 1.0)))

    if name == "function_score":
        functions = body.get("functions")
        if functions is None:
            # single-function short form
            functions = [{k: v for k, v in body.items()
                          if k in ("weight", "field_value_factor",
                                   "script_score", "random_score", "gauss",
                                   "exp", "linear", "filter")}]
        parsed_fns = []
        for fn in functions:
            fn = dict(fn)
            if "filter" in fn:
                fn["filter"] = parse_query(fn["filter"])
            parsed_fns.append(fn)
        return FunctionScoreQuery(
            query=parse_query(body.get("query")),
            functions=parsed_fns,
            score_mode=str(body.get("score_mode", "multiply")).lower(),
            boost_mode=str(body.get("boost_mode", "multiply")).lower(),
            max_boost=float(body.get("max_boost", 3.4e38)),
            min_score=(float(body["min_score"])
                       if body.get("min_score") is not None else None),
            boost=float(body.get("boost", 1.0)))

    if name == "script_score":
        script = body.get("script", {})
        if isinstance(script, str):
            script = {"source": script}
        return ScriptScoreQuery(query=parse_query(body.get("query")),
                                script_source=script.get("source", ""),
                                script_params=script.get("params", {}),
                                boost=float(body.get("boost", 1.0)))

    if name == "terms_set":
        field, spec = _field_body(body, "terms_set")
        if not isinstance(spec, dict) or "terms" not in spec:
            raise ParsingError("[terms_set] requires a [terms] array")
        if spec.get("minimum_should_match_script") is not None:
            raise ParsingError(
                "[terms_set] query option [minimum_should_match_script] is "
                "not supported by opensearch_tpu_torch yet")
        return TermsSetQuery(
            field=field, terms=list(spec["terms"]),
            minimum_should_match_field=spec.get(
                "minimum_should_match_field"),
            boost=float(spec.get("boost", 1.0)))

    if name == "distance_feature":
        if "field" not in body or "origin" not in body \
                or "pivot" not in body:
            raise ParsingError("[distance_feature] requires [field], "
                               "[origin] and [pivot]")
        return DistanceFeatureQuery(field=body["field"],
                                    origin=body["origin"],
                                    pivot=body["pivot"],
                                    boost=float(body.get("boost", 1.0)))

    if name == "rank_feature":
        if "field" not in body:
            raise ParsingError("[rank_feature] requires a [field]")
        fn, params = "saturation", {}
        for candidate in ("saturation", "log", "sigmoid", "linear"):
            if candidate in body:
                fn, params = candidate, body[candidate] or {}
        return RankFeatureQuery(
            field=body["field"], function=fn,
            pivot=(float(params["pivot"]) if params.get("pivot") is not None
                   else None),
            scaling_factor=float(params.get("scaling_factor", 1.0)),
            exponent=float(params.get("exponent", 1.0)),
            boost=float(body.get("boost", 1.0)))

    if name == "nested":
        if "path" not in body or "query" not in body:
            raise ParsingError("[nested] requires [path] and [query]")
        return NestedQuery(path=body["path"],
                           query=parse_query(body["query"]),
                           score_mode=str(body.get("score_mode", "avg")),
                           ignore_unmapped=bool(body.get("ignore_unmapped",
                                                         False)),
                           inner_hits=_parse_inner_hits(body),
                           boost=float(body.get("boost", 1.0)))

    if name == "geo_distance":
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        distance = body.pop("distance", None)
        body.pop("distance_type", None)
        body.pop("validation_method", None)
        if distance is None or len(body) != 1:
            raise ParsingError("[geo_distance] requires [distance] and "
                               "exactly one field")
        field, point = next(iter(body.items()))
        lat, lon = parse_geo_point(point)
        return GeoDistanceQuery(field=field, lat=lat, lon=lon,
                                distance_m=parse_distance(distance),
                                boost=boost)

    if name == "geo_bounding_box":
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        body.pop("validation_method", None)
        if len(body) != 1:
            raise ParsingError("[geo_bounding_box] requires exactly one "
                               "field")
        field, spec = next(iter(body.items()))
        if "top_left" in spec:
            top, left = parse_geo_point(spec["top_left"])
            bottom, right = parse_geo_point(spec["bottom_right"])
        else:
            top, left = float(spec["top"]), float(spec["left"])
            bottom, right = float(spec["bottom"]), float(spec["right"])
        return GeoBoundingBoxQuery(field=field, top=top, left=left,
                                   bottom=bottom, right=right, boost=boost)

    if name == "knn":
        field, spec = _field_body(body, "knn")
        mp = spec.get("method_parameters", {}) or {}
        return KnnQuery(field=field, vector=list(spec.get("vector", [])),
                        k=int(spec.get("k", 10)),
                        filter=parse_query(spec["filter"])
                        if "filter" in spec else None,
                        nprobe=int(mp.get("nprobes", mp.get("nprobe", 0))),
                        boost=float(spec.get("boost", 1.0)))

    if name == "maxsim":
        field, spec = _field_body(body, "maxsim")
        qv = spec.get("query_vectors")
        if not isinstance(qv, list) or not qv \
                or not all(isinstance(t, list) and t for t in qv):
            raise ParsingError("[maxsim] query requires a non-empty "
                               "[query_vectors] list of token vectors")
        return MaxSimQuery(field=field,
                           query_vectors=[list(t) for t in qv],
                           k=int(spec.get("k", 10)),
                           filter=parse_query(spec["filter"])
                           if "filter" in spec else None,
                           boost=float(spec.get("boost", 1.0)))

    if name == "hybrid":
        subs = body.get("queries")
        if not isinstance(subs, list) or not subs:
            raise ParsingError("[hybrid] query requires a non-empty "
                               "[queries] array")
        if len(subs) > MAX_HYBRID_SUB_QUERIES:
            raise ParsingError(
                f"Number of sub-queries exceeds maximum supported by "
                f"[hybrid] query [{MAX_HYBRID_SUB_QUERIES}]")
        unknown = set(body) - {"queries", "boost"}
        if unknown:
            raise ParsingError(
                f"[hybrid] query does not support [{sorted(unknown)[0]}]")
        return HybridQuery(queries=[parse_query(s) for s in subs],
                           boost=float(body.get("boost", 1.0)))

    if name == "bool":
        return BoolQuery(
            must=_as_list(body.get("must")),
            filter=_as_list(body.get("filter")),
            should=_as_list(body.get("should")),
            must_not=_as_list(body.get("must_not")),
            minimum_should_match=body.get("minimum_should_match"),
            boost=float(body.get("boost", 1.0)))

    if name in NOT_PORTED:
        raise ParsingError(f"[{name}] query is not supported by "
                           f"opensearch_tpu_torch yet")
    raise ParsingError(f"unknown query [{name}]")


def parse_minimum_should_match(msm: Any, n_optional: int) -> int:
    """Queries.calculateMinShouldMatch: integers, negative integers and
    percentages ('75%', '-25%')."""
    if msm is None:
        return 1 if n_optional > 0 else 0
    text = str(msm).strip()
    try:
        if text.endswith("%"):
            pct = float(text[:-1])
            if pct < 0:
                result = n_optional - int(-pct / 100.0 * n_optional)
            else:
                result = int(pct / 100.0 * n_optional)
        else:
            val = int(text)
            result = n_optional + val if val < 0 else val
    except ValueError:
        raise ParsingError(f"Invalid minimum_should_match [{msm}]")
    return max(0, min(result, n_optional))
