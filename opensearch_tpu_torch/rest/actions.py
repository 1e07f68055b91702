"""REST handlers (the subset of opensearch_tpu.rest.actions the port
serves): index create / delete, document index / delete, `_bulk`,
`_refresh`, `_search` and `_msearch` (with search-pipeline resolution),
and search-pipeline CRUD (`/_search/pipeline/{id}`)."""

from __future__ import annotations

import fnmatch
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


def _validate_doc_id(doc_id: Optional[str]) -> None:
    """IndexRequest.validate: ids are capped at 512 UTF-8 bytes."""
    if doc_id is not None and len(doc_id.encode("utf-8")) > 512:
        raise IllegalArgumentError(
            f"id [{doc_id[:64]}...] is too long, must be no longer than "
            f"512 bytes but was: {len(doc_id.encode('utf-8'))}")


def _search_index(node, expression) -> Optional[str]:
    """The one index a search expression (a name, `_all`, `*`, commas,
    wildcards, `-` exclusions, or None for every index) resolves to, None
    when it resolves to none. An expression over several indices answers
    400: the port serves one index per search until the cross-shard merge
    is ported."""
    names = node.indices.resolve(expression)
    if len(names) <= 1:
        return names[0] if names else None
    shown = expression if isinstance(expression, str) else (
        "_all" if expression is None else ",".join(expression))
    raise IllegalArgumentError(
        f"index expression [{shown}] resolves to {len(names)} indices "
        f"{names}: opensearch_tpu_torch serves one index per search so far")


def _shards_header(node, names) -> dict:
    total = sum(node.indices.get(n).num_shards for n in names)
    return {"total": total, "successful": total, "failed": 0}


def _run_search(node, index: Optional[str], body: Optional[dict],
                search_pipeline=None) -> dict:
    """One search with its pipeline: the request parameter, else an inline
    `search_pipeline` definition in the body, else the index's
    `index.search.default_pipeline`; the pipeline's
    normalization-processor spec rides along for a hybrid query. An
    expression that resolved to no index (`index` None) finds nothing."""
    if index is None:
        return {"took": 0, "timed_out": False,
                "_shards": {"total": 0, "successful": 0, "skipped": 0,
                            "failed": 0},
                "hits": {"total": {"value": 0, "relation": "eq"},
                         "max_score": None, "hits": []}}
    svc = node.indices.get(index)
    body = dict(body or {})
    inline = body.pop("search_pipeline", None)
    pipeline = node.search_pipelines.resolve(
        search_pipeline if search_pipeline is not None else inline, [svc])
    res = svc.search(body, pipeline.phase_spec()
                     if pipeline is not None else None)
    # the general path's page cursor is internal (an _msearch item of the
    # envelope route keeps it, as the reference's does)
    res.pop("_page_cursor", None)
    return res


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
        _validate_doc_id(req.param("id"))
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
        body = dict(req.body) if isinstance(req.body, dict) else {}
        for key in ("size", "from"):
            if req.param(key) is not None:
                body[key] = req.param(key)
        # URI sort / _source parameters fold into the body, as the
        # reference's REST layer folds them
        if req.param("sort") is not None:
            body["sort"] = [
                ({s.split(":")[0]: s.split(":")[1]} if ":" in s else s)
                for s in req.param("sort").split(",")]
        if req.param("_source") is not None:
            v = req.param("_source")
            body["_source"] = (v.split(",") if "," in v
                               else (v if v not in ("true", "false")
                                     else v == "true"))
        includes = req.param("_source_includes")
        excludes = req.param("_source_excludes")
        if includes or excludes:
            body["_source"] = {
                **({"includes": includes.split(",")} if includes else {}),
                **({"excludes": excludes.split(",")} if excludes else {})}
        return _run_search(node, _search_index(node, req.param("index")),
                           body, req.param("search_pipeline"))

    def do_msearch(req):
        lines = _ndjson_lines(req)
        if len(lines) % 2 != 0:
            raise IllegalArgumentError(
                "msearch request must have an even number of lines "
                "(header, body pairs)")
        exprs = [lines[i].get("index", req.param("index"))
                 for i in range(0, len(lines), 2)]
        pairs = []
        for expr, body in zip(exprs, lines[1::2]):
            try:
                pairs.append((_search_index(node, expr), body))
            except OpenSearchTpuError as e:
                pairs.append((e, body))
        # the batch route takes items that all name one concrete index;
        # an expression (a wildcard, `_all`, a header `{}`) runs item by
        # item, as the reference's does
        only = exprs[0] if exprs and all(e == exprs[0] for e in exprs) \
            else None
        if isinstance(only, str) and only in node.indices.indices \
                and not any(
                isinstance(b, dict) and b.get("search_pipeline")
                for _, b in pairs):
            svc = node.indices.get(only)
            if svc.settings.get("search.default_pipeline") in (None,
                                                               "_none"):
                # one index and no pipeline: the whole batch runs through
                # its envelope (hybrid bodies in the batched hybrid wave,
                # under the default normalization spec)
                res = svc.multi_search([b for _, b in pairs])
                for r in res["responses"]:
                    r.setdefault("status", 200)
                return res
        responses = []
        took = 0
        for index_expr, body in pairs:
            try:
                if isinstance(index_expr, OpenSearchTpuError):
                    raise index_expr
                res = _run_search(node, index_expr, body)
                res["status"] = 200
                took = max(took, res.get("took", 0))
                responses.append(res)
            except OpenSearchTpuError as e:
                responses.append({"error": e.to_xcontent(),
                                  "status": e.status})
        return {"took": took, "responses": responses}

    def do_put_pipeline(req):
        node.search_pipelines.put(req.param("id"), req.body or {})
        return {"acknowledged": True}

    def do_get_pipeline(req):
        pid = req.param("id")
        pipelines = node.search_pipelines.pipelines
        if pid is None or pid in ("*", "_all"):
            return {p: pipe.body for p, pipe in pipelines.items()}
        matched = {p: pipe.body for p, pipe in pipelines.items()
                   if fnmatch.fnmatchcase(p, pid)}
        if not matched:
            return 404, {}
        return matched

    def do_delete_pipeline(req):
        node.search_pipelines.delete(req.param("id"))     # 404 if missing
        return {"acknowledged": True}

    c.register("PUT", "/_search/pipeline/{id}", do_put_pipeline)
    c.register("GET", "/_search/pipeline", do_get_pipeline)
    c.register("GET", "/_search/pipeline/{id}", do_get_pipeline)
    c.register("DELETE", "/_search/pipeline/{id}", do_delete_pipeline)
    c.register("PUT", "/{index}", do_create_index)
    c.register("DELETE", "/{index}", do_delete_index)
    c.register("PUT", "/{index}/_doc/{id}", do_index)
    c.register("POST", "/{index}/_doc/{id}", do_index)
    c.register("POST", "/{index}/_doc", do_index)
    c.register("DELETE", "/{index}/_doc/{id}", do_delete)
    c.register("POST", "/_bulk", do_bulk)
    c.register("POST", "/{index}/_bulk", do_bulk)
    c.register("POST", "/{index}/_refresh", do_refresh)
    c.register("GET", "/_search", do_search)
    c.register("POST", "/_search", do_search)
    c.register("GET", "/{index}/_search", do_search)
    c.register("POST", "/{index}/_search", do_search)
    c.register("GET", "/_msearch", do_msearch)
    c.register("POST", "/_msearch", do_msearch)
    c.register("GET", "/{index}/_msearch", do_msearch)
    c.register("POST", "/{index}/_msearch", do_msearch)
