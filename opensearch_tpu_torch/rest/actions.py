"""REST handlers of the BM25 slice (the subset of
opensearch_tpu.rest.actions the port serves): index create / delete,
document index / delete, `_bulk`, `_refresh`, `_search` and `_msearch`."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError)
from opensearch_tpu_torch.rest.controller import RestController, RestRequest


def _ndjson_lines(request: RestRequest) -> List[Any]:
    """NDJSON bodies arrive as text (or bytes) or, in-process, as a list
    of already-parsed lines."""
    if isinstance(request.body, list):
        return list(request.body)
    raw = request.raw_body
    if raw is None:
        raise IllegalArgumentError("request body is required")
    text = raw.decode("utf-8") if isinstance(raw, bytes) else raw
    return [json.loads(line) for line in text.split("\n") if line.strip()]


def _shards_header(node, names) -> dict:
    total = sum(node.indices.get(n).num_shards for n in names)
    return {"total": total, "successful": total, "failed": 0}


def register_actions(node, c: RestController) -> None:
    def do_create_index(req):
        name = req.param("index")
        node.indices.create_index(name, req.body)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def do_delete_index(req):
        node.indices.delete_index(req.param("index"))
        return {"acknowledged": True}

    def maybe_refresh(req, svc) -> None:
        if req.param("refresh") in ("true", "", "wait_for"):
            svc.refresh()

    def do_index(req):
        svc = node.indices.get(req.param("index"))
        source = req.body
        if not isinstance(source, dict):
            raise IllegalArgumentError("request body is required")
        res = svc.index_doc(req.param("id"), source)
        maybe_refresh(req, svc)
        return (201 if res["result"] == "created" else 200), res

    def do_delete(req):
        svc = node.indices.get(req.param("index"))
        res = svc.delete_doc(req.param("id"))
        maybe_refresh(req, svc)
        return (200 if res["result"] == "deleted" else 404), res

    def do_bulk(req):
        lines = _ndjson_lines(req)
        default_index = req.param("index")
        items: List[dict] = []
        i = 0
        while i < len(lines):
            action_line = lines[i]
            i += 1
            if not isinstance(action_line, dict) or len(action_line) != 1:
                raise IllegalArgumentError(
                    "Malformed action/metadata line, expected one action")
            op, meta = next(iter(action_line.items()))
            if op not in ("index", "create", "delete"):
                raise IllegalArgumentError(
                    f"Unknown action [{op}], expected one of "
                    f"[create, delete, index]")
            entry = {"action": op, "index": meta.get("_index", default_index),
                     "id": None if meta.get("_id") is None
                     else str(meta["_id"])}
            if entry["index"] is None:
                raise IllegalArgumentError("bulk item missing _index")
            if op != "delete":
                if i >= len(lines):
                    raise IllegalArgumentError(
                        f"bulk [{op}] action missing source line")
                entry["source"] = lines[i]
                i += 1
            items.append(entry)
        by_index: Dict[str, List[int]] = {}
        for pos, item in enumerate(items):
            by_index.setdefault(item["index"], []).append(pos)
        responses: List[Optional[dict]] = [None] * len(items)
        errors = False
        took = 0
        for name, positions in by_index.items():
            svc = node.indices.get(name)
            res = svc.bulk([items[p] for p in positions])
            took = max(took, res["took"])
            errors = errors or res["errors"]
            for p, item_res in zip(positions, res["items"]):
                responses[p] = item_res
        if req.param("refresh") in ("true", "", "wait_for"):
            for name in by_index:
                node.indices.get(name).refresh()
            for item_res in responses:
                body = next(iter(item_res.values()))
                if "error" not in body:
                    body["forced_refresh"] = True
        return {"took": took, "errors": errors, "items": responses}

    def do_refresh(req):
        name = req.param("index")
        node.indices.get(name).refresh()
        return {"_shards": _shards_header(node, [name])}

    def do_search(req):
        body = req.body if isinstance(req.body, dict) else {}
        for key in ("size", "from"):
            if req.param(key) is not None:
                body = {**body, key: req.param(key)}
        return node.indices.get(req.param("index")).search(body)

    def do_msearch(req):
        lines = _ndjson_lines(req)
        if len(lines) % 2 != 0:
            raise IllegalArgumentError(
                "msearch request must have an even number of lines "
                "(header, body pairs)")
        pairs = []
        for i in range(0, len(lines), 2):
            header, body = lines[i], lines[i + 1]
            pairs.append((header.get("index", req.param("index")), body))
        exprs = {e for e, _ in pairs}
        if len(exprs) == 1 and None not in exprs:
            # one index: the whole batch runs through its envelope
            res = node.indices.get(next(iter(exprs))).multi_search(
                [b for _, b in pairs])
            for r in res["responses"]:
                r.setdefault("status", 200)
            return res
        responses = []
        took = 0
        for index_expr, body in pairs:
            try:
                if index_expr is None:
                    raise IllegalArgumentError(
                        "msearch item names no index")
                res = node.indices.get(index_expr).search(body)
                res["status"] = 200
                took = max(took, res.get("took", 0))
                responses.append(res)
            except OpenSearchTpuError as e:
                responses.append({"error": e.to_xcontent(),
                                  "status": e.status})
        return {"took": took, "responses": responses}

    c.register("PUT", "/{index}", do_create_index)
    c.register("DELETE", "/{index}", do_delete_index)
    c.register("PUT", "/{index}/_doc/{id}", do_index)
    c.register("POST", "/{index}/_doc/{id}", do_index)
    c.register("POST", "/{index}/_doc", do_index)
    c.register("DELETE", "/{index}/_doc/{id}", do_delete)
    c.register("POST", "/_bulk", do_bulk)
    c.register("POST", "/{index}/_bulk", do_bulk)
    c.register("POST", "/{index}/_refresh", do_refresh)
    c.register("GET", "/{index}/_search", do_search)
    c.register("POST", "/{index}/_search", do_search)
    c.register("GET", "/_msearch", do_msearch)
    c.register("POST", "/_msearch", do_msearch)
    c.register("GET", "/{index}/_msearch", do_msearch)
    c.register("POST", "/{index}/_msearch", do_msearch)
