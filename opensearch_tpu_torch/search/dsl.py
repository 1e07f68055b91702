"""Query DSL: `match`, `term`, `terms` (text, keyword, numeric, date and
boolean values), `range`, `exists`, `match_all`, `match_none`, `bool`,
`dis_max`, `knn`, `maxsim` and the top-level `hybrid` (the subset of opensearch_tpu.search.dsl the port
needs), with the reference's REST wire shapes and error types. Any other
query kind raises the reference's parsing error."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional, Sequence

from opensearch_tpu_torch.common.errors import ParsingError


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


@dataclass
class TermQuery(QueryNode):
    field: str = ""
    value: Any = None


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
        if spec.get("fuzziness") is not None:
            raise ParsingError(
                "[match] query option [fuzziness] is not supported by "
                "opensearch_tpu_torch yet")
        return MatchQuery(field=field, query=spec.get("query"),
                          operator=str(spec.get("operator", "or")).lower(),
                          minimum_should_match=spec.get(
                              "minimum_should_match"),
                          analyzer=spec.get("analyzer"),
                          boost=float(spec.get("boost", 1.0)))

    if name == "term":
        field, spec = _field_body(body, "term")
        if isinstance(spec, dict):
            if spec.get("case_insensitive"):
                raise ParsingError(
                    "[term] query option [case_insensitive] is not "
                    "supported by opensearch_tpu_torch yet")
            return TermQuery(field=field, value=spec.get("value"),
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
