"""IndexService: one index's mapping, its shard, and the document and search
operations on it (the subset of opensearch_tpu.index.service the port
needs). The port serves one shard per index so far; the index setting
`index.search.default_pipeline` names the search pipeline of its
searches."""

from __future__ import annotations

import secrets
import time
from typing import List, Optional

import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError)
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard


def _auto_id() -> str:
    """Auto-generated doc id: 20 url-safe characters, as the reference's."""
    return secrets.token_urlsafe(15)


class IndexService:
    def __init__(self, index_name: str, device: torch.device,
                 mapping: Optional[dict] = None,
                 settings: Optional[dict] = None,
                 result_page: bool = False):
        settings = dict(settings or {})
        self.index_name = index_name
        self.settings = settings
        self.num_shards = int(settings.get("number_of_shards", 1))
        self.num_replicas = int(settings.get("number_of_replicas", 0))
        if self.num_shards != 1:
            raise IllegalArgumentError(
                f"number_of_shards [{self.num_shards}]: opensearch_tpu_torch "
                f"serves one shard per index so far")
        self.mapper = MapperService(mapping)
        self.shards: List[IndexShard] = [
            IndexShard(0, self.mapper, device, index_name=index_name,
                       result_page=result_page)]
        window = int(settings.get("max_result_window", 10000))
        for shard in self.shards:
            shard.executor.max_result_window = window

    def _write_response(self, res, result: str) -> dict:
        return {
            "_index": self.index_name,
            "_id": res.doc_id,
            "_version": res.version,
            "result": result,
            "_shards": {"total": 1 + self.num_replicas,
                        "successful": 1, "failed": 0},
            "_seq_no": res.seq_no,
            "_primary_term": res.primary_term,
        }

    def index_doc(self, doc_id: Optional[str], source: dict,
                  op_type: str = "index") -> dict:
        if doc_id is None:
            doc_id = _auto_id()
            op_type = "create"
        res = self.shards[0].index_doc(doc_id, source, op_type=op_type)
        return self._write_response(res,
                                    "created" if res.created else "updated")

    def delete_doc(self, doc_id: str) -> dict:
        res = self.shards[0].delete_doc(doc_id)
        return self._write_response(res,
                                    "deleted" if res.found else "not_found")

    def bulk(self, operations: List[dict]) -> dict:
        """Execute parsed bulk items [{action, id, source}] in order."""
        start = time.monotonic()
        items = []
        errors = False
        for op in operations:
            action = op["action"]
            try:
                if action in ("index", "create"):
                    resp = self.index_doc(op.get("id"), op["source"],
                                          op_type=action)
                    status = 201 if resp["result"] == "created" else 200
                elif action == "delete":
                    resp = self.delete_doc(op["id"])
                    status = 200 if resp["result"] == "deleted" else 404
                else:
                    raise IllegalArgumentError(
                        f"unknown bulk action [{action}]")
                resp["status"] = status
                items.append({action: resp})
            except OpenSearchTpuError as e:
                errors = True
                items.append({action: {
                    "_index": self.index_name, "_id": op.get("id"),
                    "status": e.status, "error": e.to_xcontent()}})
        return {"took": int((time.monotonic() - start) * 1000),
                "errors": errors, "items": items}

    def search(self, body: Optional[dict] = None,
               phase_spec: Optional[dict] = None) -> dict:
        """`phase_spec`: the search pipeline's normalization spec, for a
        hybrid query (None: the defaults)."""
        from opensearch_tpu_torch.search.controller import execute_search
        return execute_search([s.executor for s in self.shards], body,
                              phase_spec, allow_envelope=True)

    def multi_search(self, bodies: List[dict]) -> dict:
        return self.shards[0].executor.multi_search(bodies)

    def refresh(self):
        for s in self.shards:
            s.refresh()
