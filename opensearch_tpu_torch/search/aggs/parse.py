"""Aggregation request parsing: REST "aggs" body → typed builder tree.

Reference: search/aggregations/AggregatorFactories.java parseAggregators and
the per-type Builder parsers. Bucket aggs may nest sub-aggregations under
"aggs"/"aggregations"; pipeline aggs reference sibling paths via buckets_path.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import ParsingError

BUCKET_TYPES = {"terms", "histogram", "date_histogram", "range", "date_range",
                "filter", "filters", "global", "missing", "ip_range",
                "composite", "multi_terms", "significant_terms",
                "auto_date_histogram", "adjacency_matrix", "geohash_grid",
                "geotile_grid", "nested", "reverse_nested"}
METRIC_TYPES = {"min", "max", "sum", "avg", "value_count", "stats",
                "extended_stats", "cardinality", "percentiles",
                "percentile_ranks", "weighted_avg",
                "median_absolute_deviation",
                "top_hits", "geo_centroid", "scripted_metric", "matrix_stats",
                "geo_bounds"}
PIPELINE_TYPES = {"derivative", "cumulative_sum", "bucket_script",
                  "bucket_selector", "bucket_sort", "avg_bucket", "max_bucket",
                  "min_bucket", "sum_bucket", "stats_bucket",
                  "extended_stats_bucket", "percentiles_bucket", "serial_diff",
                  "moving_avg", "moving_fn"}


@dataclass
class AggNode:
    name: str
    type: str
    body: Dict[str, Any]
    children: List["AggNode"] = dc_field(default_factory=list)
    pipelines: List["AggNode"] = dc_field(default_factory=list)

    @property
    def field(self) -> Optional[str]:
        return self.body.get("field")


def parse_aggs(aggs_body: Optional[dict]) -> List[AggNode]:
    if not aggs_body:
        return []
    if not isinstance(aggs_body, dict):
        raise ParsingError("Found [aggs] but expected an object")
    out: List[AggNode] = []
    for name, spec in aggs_body.items():
        if not isinstance(spec, dict):
            raise ParsingError(f"aggregation [{name}] must be an object")
        sub_body = spec.get("aggs", spec.get("aggregations"))
        type_keys = [k for k in spec
                     if k not in ("aggs", "aggregations", "meta")]
        if len(type_keys) != 1:
            raise ParsingError(
                f"Expected exactly one aggregation type for [{name}], "
                f"found {sorted(type_keys)}")
        agg_type = type_keys[0]
        if agg_type not in BUCKET_TYPES | METRIC_TYPES | PIPELINE_TYPES:
            raise ParsingError(f"Unknown aggregation type [{agg_type}]")
        node = AggNode(name=name, type=agg_type, body=spec[agg_type] or {})
        if sub_body:
            if agg_type in METRIC_TYPES:
                raise ParsingError(
                    f"Aggregator [{name}] of type [{agg_type}] cannot accept "
                    f"sub-aggregations")
            subs = parse_aggs(sub_body)
            node.children = [s for s in subs if s.type not in PIPELINE_TYPES]
            node.pipelines = [s for s in subs if s.type in PIPELINE_TYPES]
        out.append(node)
    return out
