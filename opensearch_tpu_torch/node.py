"""Node: the top-level container wiring the indices service and the REST
routes of the BM25 slice (the subset of opensearch_tpu.node the port
needs). `Node().request(method, path, body)` is the in-process client."""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from opensearch_tpu_torch import resolve_device
from opensearch_tpu_torch.indices.service import IndicesService
from opensearch_tpu_torch.rest.actions import register_actions
from opensearch_tpu_torch.rest.controller import (RestController,
                                                  RestRequest, RestResponse)


class Node:
    def __init__(self, node_name: str = "node-0", device=None):
        """`device=None` serves on the card and raises without CUDA;
        `device="cpu"` runs every kernel's plain PyTorch version."""
        self.node_name = node_name
        self.device = resolve_device(device)
        self.indices = IndicesService(self.device)
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
