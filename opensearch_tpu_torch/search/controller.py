"""The search controller for one shard (the subset of
opensearch_tpu.search.controller the port needs).

A single-shard score-sorted `_search` runs as the msearch envelope at B=1,
as the reference's does (opensearch_tpu/search/controller.py:431-448),
aggregations included: `from`/`size` (k = from + size, bounded by
`index.max_result_window`), `hits.total` {value, relation}, `max_score`,
`_source` and `aggregations`, with the doc-id ascending tie-break finished
on the host. A top-level `hybrid` query runs through the fused hybrid
phase and the normalization merge (searchpipeline/hybrid.py) under the
request's pipeline spec."""

from __future__ import annotations

from typing import List, Optional

from opensearch_tpu_torch.common.errors import IllegalArgumentError


def execute_search(executors: List, body: Optional[dict],
                   phase_spec: Optional[dict] = None) -> dict:
    if len(executors) != 1:
        raise IllegalArgumentError(
            f"opensearch_tpu_torch searches one shard per request so far, "
            f"got {len(executors)}")
    return executors[0].search(body or {}, phase_spec)
