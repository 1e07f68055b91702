"""SearchPipelineService: named pipeline CRUD and per-request resolution
(the subset of opensearch_tpu.searchpipeline.service the port serves).
Pipelines live in the node's memory; they are resolved per request from
the `search_pipeline` request parameter, an inline definition in the body,
or the target index's `index.search.default_pipeline` setting ("_none"
disables)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ResourceNotFoundError)
from opensearch_tpu_torch.searchpipeline.processors import \
    build_processors

_PIPELINE_KEYS = frozenset({"request_processors", "response_processors",
                            "phase_results_processors", "description",
                            "version"})


class SearchPipeline:
    """One validated pipeline: its parsed processor chains and the raw body
    (returned as given by GET)."""

    def __init__(self, pipeline_id: str, body: Dict[str, Any]):
        if not isinstance(body, dict):
            raise IllegalArgumentError("pipeline body must be an object")
        unknown = set(body) - _PIPELINE_KEYS
        if unknown:
            raise IllegalArgumentError(
                f"pipeline [{pipeline_id}] doesn't support one or more "
                f"provided configuration parameters {sorted(unknown)}")
        self.pipeline_id = pipeline_id
        self.body = body
        for kind in ("request_processors", "response_processors"):
            build_processors(kind, body.get(kind))       # validates
        self.phase_results_processors = build_processors(
            "phase_results_processors",
            body.get("phase_results_processors"))

    def phase_spec(self) -> Optional[dict]:
        """The normalization-processor's merge spec (None: hybrid queries
        use the defaults)."""
        for proc in self.phase_results_processors:
            return proc.spec()
        return None


class SearchPipelineService:
    """All named search pipelines on this node."""

    def __init__(self):
        self.pipelines: Dict[str, SearchPipeline] = {}

    def put(self, pipeline_id: str, body: Dict[str, Any]) -> SearchPipeline:
        if not pipeline_id:
            raise IllegalArgumentError("pipeline id cannot be empty")
        pipeline = SearchPipeline(pipeline_id, body)   # validates
        self.pipelines[pipeline_id] = pipeline
        return pipeline

    def get(self, pipeline_id: str) -> SearchPipeline:
        pipeline = self.pipelines.get(pipeline_id)
        if pipeline is None:
            raise ResourceNotFoundError(
                f"pipeline [{pipeline_id}] does not exist")
        return pipeline

    def delete(self, pipeline_id: str) -> None:
        if pipeline_id not in self.pipelines:
            raise ResourceNotFoundError(
                f"pipeline [{pipeline_id}] does not exist")
        del self.pipelines[pipeline_id]

    def resolve(self, param: Optional[Any],
                index_services: Optional[List] = None
                ) -> Optional[SearchPipeline]:
        """The pipeline of one search request: the request's pipeline (a
        name or an inline definition) wins; otherwise, for a request on
        exactly one index, that index's `index.search.default_pipeline`;
        "_none" disables at either level."""
        if param is not None:
            if isinstance(param, dict):
                return SearchPipeline("_ad_hoc_pipeline", param)
            name = str(param)
            if name == "_none":
                return None
            return self.get(name)
        if index_services and len(index_services) == 1:
            default = index_services[0].settings.get(
                "search.default_pipeline")
            if default and default != "_none":
                return self.get(str(default))
        return None
