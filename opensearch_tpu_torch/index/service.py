"""IndexService: one index's mapping, its shards, and the document and
search operations on it (the subset of opensearch_tpu.index.service the
port needs). A document goes to the shard murmur3 routing picks
(cluster/routing.py: its id, or its `routing` value, with
`number_of_routing_shards` and `routing_partition_size`); a search runs
over every shard. The index setting `index.search.default_pipeline` names
the search pipeline of its searches. The document API: index, delete and
realtime get with optimistic concurrency (`if_seq_no` / `if_primary_term`,
external versions), partial updates (`doc`, `upsert`, `doc_as_upsert`,
`detect_noop`), `_mget`, `_bulk` with update items, `_count`, and refresh /
flush / force-merge over every shard."""

from __future__ import annotations

import difflib
import secrets
import time
from typing import Any, List, Optional

import torch

from opensearch_tpu_torch.analysis.registry import AnalysisRegistry
from opensearch_tpu_torch.cluster.routing import generate_shard_id
from opensearch_tpu_torch.common.errors import (DocumentMissingError,
                                                IllegalArgumentError,
                                                OpenSearchTpuError,
                                                VersionConflictError)
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard


def _auto_id() -> str:
    """Auto-generated doc id: 20 url-safe characters, as the reference's."""
    return secrets.token_urlsafe(15)


def deep_merge(base: dict, patch: dict) -> dict:
    """The recursive map merge of a partial-document update."""
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# the keys an update body may hold (UpdateRequest's fields)
_UPDATE_KEYS = {"doc", "doc_as_upsert", "script", "upsert",
                "scripted_upsert", "detect_noop", "_source", "lang",
                "if_seq_no", "if_primary_term", "fields"}


class IndexService:
    def __init__(self, index_name: str, device: torch.device,
                 mapping: Optional[dict] = None,
                 settings: Optional[dict] = None,
                 result_page: bool = False, blockmax: bool = False,
                 delta: bool = False):
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
                       result_page=result_page, blockmax=blockmax,
                       delta=delta)
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
                  op_type: str = "index", routing: Optional[str] = None,
                  **kw) -> dict:
        """`kw`: if_seq_no / if_primary_term / external_version."""
        if doc_id is None:
            doc_id = _auto_id()
            op_type = "create"
        res = self.shard_for(doc_id, routing).index_doc(
            doc_id, source, op_type=op_type, **kw)
        return self._write_response(res,
                                    "created" if res.created else "updated")

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True) -> dict:
        res = self.shard_for(doc_id, routing).get_doc(doc_id,
                                                      realtime=realtime)
        if res is None:
            return {"_index": self.index_name, "_id": doc_id, "found": False}
        return {"_index": self.index_name, "_id": doc_id, "found": True,
                "_version": res.version, "_seq_no": res.seq_no,
                "_primary_term": res.primary_term, "_source": res.source}

    def delete_doc(self, doc_id: str, routing: Optional[str] = None,
                   **kw) -> dict:
        res = self.shard_for(doc_id, routing).delete_doc(doc_id, **kw)
        return self._write_response(res,
                                    "deleted" if res.found else "not_found")

    def update_doc(self, doc_id: str, body: dict,
                   routing: Optional[str] = None,
                   if_seq_no: Optional[int] = None,
                   if_primary_term: Optional[int] = None,
                   external_version: Optional[int] = None) -> dict:
        """Partial update: realtime get, merge, index again with a CAS on
        the doc it read (detect_noop on by default, upsert,
        doc_as_upsert). A CAS of the caller's (URL or body) is checked
        against the current doc first. A `script` answers 400: scripted
        updates are not ported."""
        if external_version is not None:
            raise IllegalArgumentError(
                "internal versioning can not be used for optimistic "
                "concurrency control. Please use `if_seq_no` and "
                "`if_primary_term` instead")
        for key in body:
            if key not in _UPDATE_KEYS:
                guess = difflib.get_close_matches(key, sorted(_UPDATE_KEYS),
                                                  n=1)
                hint = f" did you mean [{guess[0]}]?" if guess else ""
                raise IllegalArgumentError(
                    f"[UpdateRequest] unknown field [{key}]{hint}")
        if if_seq_no is None and body.get("if_seq_no") is not None:
            if_seq_no = int(body["if_seq_no"])
        if if_primary_term is None and body.get("if_primary_term") is not None:
            if_primary_term = int(body["if_primary_term"])
        shard = self.shard_for(doc_id, routing)
        cur = shard.get_doc(doc_id)
        if if_seq_no is not None or if_primary_term is not None:
            if cur is None:
                raise DocumentMissingError(f"[{doc_id}]: document missing")
            if ((if_seq_no is not None and cur.seq_no != if_seq_no)
                    or (if_primary_term is not None
                        and cur.primary_term != if_primary_term)):
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], primary term [{if_primary_term}]. "
                    f"current document has seqNo [{cur.seq_no}] and primary "
                    f"term [{cur.primary_term}]")
        if "script" in body:
            raise IllegalArgumentError(
                "[script] is not supported by opensearch_tpu_torch yet")
        doc_patch = body.get("doc")
        if cur is None:
            if body.get("doc_as_upsert") and doc_patch is not None:
                new_source = doc_patch
            elif "upsert" in body:
                new_source = body["upsert"]
            else:
                raise DocumentMissingError(f"[{doc_id}]: document missing")
            res = shard.index_doc(doc_id, new_source, op_type="create")
            return self._write_response(res, "created")
        if doc_patch is None:
            raise IllegalArgumentError("update requires [doc] or [upsert]")
        merged = deep_merge(cur.source, doc_patch)
        if body.get("detect_noop", True) and merged == cur.source:
            return {"_index": self.index_name, "_id": doc_id,
                    "_version": cur.version, "result": "noop",
                    "_seq_no": cur.seq_no, "_primary_term": cur.primary_term,
                    "_shards": {"total": 0, "successful": 0, "failed": 0}}
        res = shard.index_doc(doc_id, merged, if_seq_no=cur.seq_no,
                              if_primary_term=cur.primary_term)
        return self._write_response(res, "updated")

    def mget(self, ids: List[Any]) -> dict:
        return {"docs": [
            self.get_doc(item["_id"], routing=item.get("routing"))
            if isinstance(item, dict) else self.get_doc(item)
            for item in ids]}

    def bulk(self, operations: List[dict]) -> dict:
        """Execute parsed bulk items [{action, id, source, routing,
        if_seq_no, if_primary_term}] in order, each on its routed
        shard."""
        start = time.monotonic()
        items = []
        errors = False
        for op in operations:
            action = op["action"]
            cas = {k: op[k] for k in ("if_seq_no", "if_primary_term")
                   if op.get(k) is not None}
            try:
                if action in ("index", "create"):
                    resp = self.index_doc(op.get("id"), op["source"],
                                          op_type=action,
                                          routing=op.get("routing"), **cas)
                    status = 201 if resp["result"] == "created" else 200
                elif action == "delete":
                    resp = self.delete_doc(op["id"],
                                           routing=op.get("routing"), **cas)
                    status = 200 if resp["result"] == "deleted" else 404
                elif action == "update":
                    resp = self.update_doc(op["id"], op["source"],
                                           routing=op.get("routing"), **cas)
                    status = 200
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

    def count(self, body: Optional[dict] = None) -> int:
        body = dict(body or {})
        body["size"] = 0
        body.pop("from", None)
        return self.search(body)["hits"]["total"]["value"]

    def refresh(self):
        for s in self.shards:
            s.refresh()

    def flush(self):
        for s in self.shards:
            s.flush()

    def force_merge(self):
        for s in self.shards:
            s.force_merge()
