"""IndexService: one index's mapping, its shards, and the document and
search operations on it (the subset of opensearch_tpu.index.service the
port needs). A document goes to the shard murmur3 routing picks
(cluster/routing.py: its id, or its `routing` value, with
`number_of_routing_shards` and `routing_partition_size`); a search runs
over every shard. The index setting `index.search.default_pipeline` names
the search pipeline of its searches."""

from __future__ import annotations

import secrets
import time
from typing import List, Optional

import torch

from opensearch_tpu_torch.analysis.registry import AnalysisRegistry
from opensearch_tpu_torch.cluster.routing import generate_shard_id
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
                 result_page: bool = False, blockmax: bool = False):
        settings = dict(settings or {})
        self.index_name = index_name
        self.settings = settings
        self.num_shards = int(settings.get("number_of_shards", 1))
        self.num_replicas = int(settings.get("number_of_replicas", 0))
        self.routing_partition_size = int(
            settings.get("routing_partition_size", 1))
        self.routing_num_shards = int(
            settings.get("number_of_routing_shards", self.num_shards))
        if self.num_shards < 1:
            raise IllegalArgumentError("number_of_shards must be >= 1")
        # routing_num_shards must be a positive multiple of number_of_shards
        # or routing goes out of range
        if (self.routing_num_shards < self.num_shards
                or self.routing_num_shards % self.num_shards != 0):
            raise IllegalArgumentError(
                f"number_of_routing_shards [{self.routing_num_shards}] must "
                f"be a multiple of number_of_shards [{self.num_shards}]")
        if self.routing_partition_size < 1 or (
                self.routing_partition_size > 1
                and self.routing_partition_size >= self.num_shards):
            raise IllegalArgumentError(
                f"routing_partition_size [{self.routing_partition_size}] "
                f"should be a positive number less than number_of_shards "
                f"[{self.num_shards}]")
        # index.analysis.* settings, flattened at creation, nest back into
        # the config the analysis registry reads (custom analyzers,
        # tokenizers, token filters and char filters)
        analysis_cfg: dict = {}
        for key, value in settings.items():
            if key.startswith("analysis."):
                parts = key.split(".")[1:]
                node = analysis_cfg
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = value
        self.mapper = MapperService(
            mapping, analysis_registry=AnalysisRegistry(analysis_cfg)
            if analysis_cfg else None)
        self.shards: List[IndexShard] = [
            IndexShard(i, self.mapper, device, index_name=index_name,
                       result_page=result_page, blockmax=blockmax)
            for i in range(self.num_shards)]
        window = int(settings.get("max_result_window", 10000))
        for shard in self.shards:
            shard.executor.max_result_window = window

    def shard_for(self, doc_id: str,
                  routing: Optional[str] = None) -> IndexShard:
        """The shard a document's write goes to."""
        return self.shards[generate_shard_id(
            doc_id, self.num_shards, routing=routing,
            routing_num_shards=self.routing_num_shards,
            routing_partition_size=self.routing_partition_size)]

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
                  op_type: str = "index",
                  routing: Optional[str] = None) -> dict:
        if doc_id is None:
            doc_id = _auto_id()
            op_type = "create"
        res = self.shard_for(doc_id, routing).index_doc(doc_id, source,
                                                        op_type=op_type)
        return self._write_response(res,
                                    "created" if res.created else "updated")

    def delete_doc(self, doc_id: str, routing: Optional[str] = None) -> dict:
        res = self.shard_for(doc_id, routing).delete_doc(doc_id)
        return self._write_response(res,
                                    "deleted" if res.found else "not_found")

    def bulk(self, operations: List[dict]) -> dict:
        """Execute parsed bulk items [{action, id, source, routing}] in
        order, each on its routed shard."""
        start = time.monotonic()
        items = []
        errors = False
        for op in operations:
            action = op["action"]
            try:
                if action in ("index", "create"):
                    resp = self.index_doc(op.get("id"), op["source"],
                                          op_type=action,
                                          routing=op.get("routing"))
                    status = 201 if resp["result"] == "created" else 200
                elif action == "delete":
                    resp = self.delete_doc(op["id"],
                                           routing=op.get("routing"))
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
        """_msearch on this index: one shard batches through its envelope;
        several run each body through search(), with the same per-item
        error objects."""
        if self.num_shards == 1:
            return self.shards[0].executor.multi_search(bodies)
        start = time.monotonic()
        responses = []
        for body in bodies:
            try:
                responses.append(self.search(body))
            except OpenSearchTpuError as e:
                responses.append({"error": e.to_xcontent(),
                                  "status": e.status})
        return {"took": int((time.monotonic() - start) * 1000),
                "responses": responses}

    def refresh(self):
        for s in self.shards:
            s.refresh()
