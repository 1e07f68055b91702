"""Node: the top-level container wiring the indices service, the search
pipelines and the REST routes (the subset of opensearch_tpu.node the port
needs). `Node().request(method, path, body)` is the in-process client."""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from opensearch_tpu_torch import resolve_device
from opensearch_tpu_torch.common.errors import SettingsError
from opensearch_tpu_torch.indices.service import IndicesService
from opensearch_tpu_torch.rest.actions import register_actions
from opensearch_tpu_torch.rest.controller import (RestController,
                                                  RestRequest, RestResponse)
from opensearch_tpu_torch.searchpipeline import SearchPipelineService


def _parse_bool(value: Any, key: str) -> bool:
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text == "true":
        return True
    if text == "false":
        return False
    raise SettingsError(f"Failed to parse value [{value}] as only [true] or "
                        f"[false] are allowed for setting [{key}]")


class Node:
    def __init__(self, node_name: str = "node-0", device=None,
                 settings: Optional[Dict[str, Any]] = None):
        """`device=None` serves on the card and raises without CUDA;
        `device="cpu"` runs every kernel's plain PyTorch version.
        `settings`: node-start settings; `search.result_page.enabled`
        (static, default false) merges a field-sorted page's segments on
        the device (K14) for every index of this node;
        `search.blockmax.enabled` (static, default false) prunes posting
        blocks that cannot reach a text query's top k (K20) on the
        envelope's candidate kernel and the multi-shard program;
        `indices.publish.delta` (static, default false) publishes a
        refreshed or merged segment as its compact prefixes, expanded on
        the device (row 16, `expand_pad`), and sends a live mask only when
        it changed; `action.auto_create_index` (default true) creates a
        missing index on a document write."""
        self.node_name = node_name
        self.settings = dict(settings or {})
        self.device = resolve_device(device)
        raw_page = self.settings.get("search.result_page.enabled")
        self.result_page = False if raw_page is None else _parse_bool(
            raw_page, "search.result_page.enabled")
        raw_bm = self.settings.get("search.blockmax.enabled")
        self.blockmax = False if raw_bm is None else _parse_bool(
            raw_bm, "search.blockmax.enabled")
        raw_delta = self.settings.get("indices.publish.delta")
        self.delta = False if raw_delta is None else _parse_bool(
            raw_delta, "indices.publish.delta")
        self.indices = IndicesService(self.device,
                                      result_page=self.result_page,
                                      blockmax=self.blockmax,
                                      delta=self.delta)
        self.search_pipelines = SearchPipelineService()
        self.controller = RestController()
        register_actions(self, self.controller)

    def handle(self, method: str, path: str,
               params: Optional[Dict[str, str]] = None,
               body: Any = None) -> RestResponse:
        raw_body = None
        if isinstance(body, (str, bytes)) and body:
            raw_body = body if isinstance(body, bytes) else body.encode()
            try:
                body = json.loads(body)
            except (json.JSONDecodeError, UnicodeDecodeError):
                body = None
        req = RestRequest(method=method.upper(), path=path,
                          params=dict(params or {}), body=body,
                          raw_body=raw_body)
        return self.controller.dispatch(req)

    def request(self, method: str, path: str, body: Any = None,
                **params) -> dict:
        """Like handle() but returns the parsed body with its `_status`."""
        resp = self.handle(method, path,
                           params={k: str(v) for k, v in params.items()},
                           body=body)
        out = dict(resp.body) if isinstance(resp.body, dict) \
            else {"_body": resp.body}
        out["_status"] = resp.status
        return out
