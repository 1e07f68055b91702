"""REST handlers (the subset of opensearch_tpu.rest.actions the port
serves): index create / delete; the document API (index with `op_type`,
`_create`, get / `_source` with `realtime`, delete, `_update`, `_mget` and
`_bulk`, with `routing`, `if_seq_no` / `if_primary_term` and external
versions; a write to a missing index creates it unless
`action.auto_create_index` is false); `_refresh`, `_flush` and
`_forcemerge` over index expressions; `_count`, `_search` and `_msearch`
over index expressions (every shard of every resolved index;
`search_type`; search-pipeline resolution), and search-pipeline CRUD
(`/_search/pipeline/{id}`). Ingest pipelines are not ported: a write that
would run one answers 400."""

from __future__ import annotations

import fnmatch
import json
from typing import Any, Dict, List, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                IndexNotFoundError,
                                                OpenSearchTpuError,
                                                ResourceAlreadyExistsError)
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


def _write_index(node, name: str) -> str:
    """The index a document write goes to, created when it is missing
    (action.auto_create_index, default true). Data streams and aliases are
    not ported."""
    if name in node.indices.indices:
        return name
    if str(node.settings.get("action.auto_create_index",
                             True)).lower() == "false":
        raise IndexNotFoundError(name)
    try:
        node.indices.create_index(name, {})
    except ResourceAlreadyExistsError:
        pass        # a concurrent writer created it first
    return name


def _check_no_pipeline(svc, pipeline_param) -> None:
    """A write that would run an ingest pipeline (the request's
    `pipeline`, the index's `default_pipeline` or `final_pipeline`)
    answers 400: ingest pipelines are not ported, and a pipeline skipped
    would index another document."""
    for name in (pipeline_param or svc.settings.get("default_pipeline"),
                 svc.settings.get("final_pipeline")):
        if name and name != "_none":
            raise IllegalArgumentError(
                "[pipeline] is not supported by opensearch_tpu_torch yet")


def _search_targets(node, expression):
    """The indices a search expression (a name, `_all`, `*`, commas,
    wildcards, `-` exclusions, or None for every index) resolves to, and
    every shard's executor of each, in resolve order (the order of the
    rows of the multi-shard program, hence of its ties). Alias filters are
    not ported: no per-index filter rides along (the reference's
    extra_filters are None for an index without one)."""
    services = [node.indices.get(n) for n in node.indices.resolve(expression)]
    executors = [shard.executor for svc in services for shard in svc.shards]
    return services, executors


def _shards_header(node, names) -> dict:
    total = sum(node.indices.get(n).num_shards for n in names)
    return {"total": total, "successful": total, "failed": 0}


def _run_search(node, expression, body: Optional[dict],
                search_pipeline=None) -> dict:
    """One search over every shard of the indices `expression` resolves
    to, with its pipeline: the request parameter, else an inline
    `search_pipeline` definition in the body, else the index's
    `index.search.default_pipeline` (a search of one index); the
    pipeline's normalization-processor spec rides along for a hybrid
    query. An expression that resolves to no index finds nothing."""
    from opensearch_tpu_torch.search.controller import execute_search
    services, executors = _search_targets(node, expression)
    if not services:
        return {"took": 0, "timed_out": False,
                "_shards": {"total": 0, "successful": 0, "skipped": 0,
                            "failed": 0},
                "hits": {"total": {"value": 0, "relation": "eq"},
                         "max_score": None, "hits": []}}
    body = dict(body or {})
    inline = body.pop("search_pipeline", None)
    pipeline = node.search_pipelines.resolve(
        search_pipeline if search_pipeline is not None else inline, services)
    res = execute_search(executors, body, pipeline.phase_spec()
                         if pipeline is not None else None,
                         allow_envelope=True)
    # the general path's page cursor is internal (an _msearch item of the
    # envelope route keeps it, as the reference's does)
    res.pop("_page_cursor", None)
    return res


def _total_as_int(resp):
    """rest_total_hits_as_int=true renders hits.total as the bare number
    (the pre-7.x shape)."""
    if isinstance(resp, dict):
        hits = resp.get("hits")
        if isinstance(hits, dict) and isinstance(hits.get("total"), dict):
            hits["total"] = hits["total"].get("value", 0)
        for sub in resp.get("responses", []):
            _total_as_int(sub)
    return resp


def register_actions(node, c: RestController) -> None:
    def do_create_index(req):
        name = req.param("index")
        node.indices.create_index(name, req.body)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def do_delete_index(req):
        # the reference also refuses an alias here; the port has none
        names = node.indices.resolve(
            req.param("index"),
            ignore_unavailable=req.param("ignore_unavailable") == "true")
        for n in dict.fromkeys(names):
            node.indices.delete_index(n)
        return {"acknowledged": True}

    def write_params(req) -> dict:
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.int_param("if_seq_no")
        if req.param("if_primary_term") is not None:
            kw["if_primary_term"] = req.int_param("if_primary_term")
        if req.param("version") is not None and \
                req.param("version_type") == "external":
            kw["external_version"] = req.int_param("version")
        return kw

    def maybe_refresh(req, svc) -> None:
        if req.param("refresh") in ("true", "", "wait_for"):
            svc.refresh()

    def do_index(req):
        # validation precedes the auto-create: a rejected request leaves
        # no empty index behind
        doc_id = req.param("id")
        _validate_doc_id(doc_id)
        svc = node.indices.get(_write_index(node, req.param("index")))
        _check_no_pipeline(svc, req.param("pipeline"))
        # a missing or unparsable body indexes `{}`; any other non-object
        # reaches the mapper, which refuses it after the engine has taken
        # its sequence number, as the reference's does
        res = svc.index_doc(doc_id, req.body or {},
                            routing=req.param("routing"),
                            op_type=req.param("op_type", "index"),
                            **write_params(req))
        maybe_refresh(req, svc)
        return (201 if res["result"] == "created" else 200), res

    def do_create(req):
        req.params["op_type"] = "create"
        return do_index(req)

    def do_get(req):
        svc = node.indices.get(req.param("index"))
        res = svc.get_doc(req.param("id"), routing=req.param("routing"),
                          realtime=req.bool_param("realtime", True))
        return (200 if res.get("found") else 404), res

    def do_get_source(req):
        svc = node.indices.get(req.param("index"))
        res = svc.get_doc(req.param("id"), routing=req.param("routing"))
        if not res.get("found"):
            return 404, {"error": f"document [{req.param('id')}] missing"}
        return 200, res.get("_source")

    def do_delete(req):
        svc = node.indices.get(req.param("index"))
        res = svc.delete_doc(req.param("id"), routing=req.param("routing"),
                             **write_params(req))
        maybe_refresh(req, svc)
        return (200 if res["result"] == "deleted" else 404), res

    def do_update(req):
        _validate_doc_id(req.param("id"))
        svc = node.indices.get(_write_index(node, req.param("index")))
        res = svc.update_doc(req.param("id"), req.body or {},
                             routing=req.param("routing"),
                             **write_params(req))
        maybe_refresh(req, svc)
        return res

    def do_mget(req):
        body = req.body or {}
        default_index = req.param("index")
        docs_spec = body.get("docs")
        if docs_spec is None and "ids" in body:
            docs_spec = [{"_id": i} for i in body["ids"]]
        if docs_spec is None:
            raise IllegalArgumentError(
                "unexpected content, expected [docs] or [ids]")
        docs = []
        for spec in docs_spec:
            idx = spec.get("_index", default_index)
            if idx is None:
                raise IllegalArgumentError("index is missing for doc")
            try:
                svc = node.indices.get(idx)
                docs.append(svc.get_doc(str(spec["_id"]),
                                        routing=spec.get("routing")))
            except IndexNotFoundError:
                docs.append({"_index": idx, "_id": spec.get("_id"),
                             "error": {"type": "index_not_found_exception",
                                       "reason": f"no such index [{idx}]"}})
        return {"docs": docs}

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
            if op not in ("index", "create", "update", "delete"):
                raise IllegalArgumentError(
                    f"Unknown action [{op}], expected one of "
                    f"[create, delete, index, update]")
            routing = meta.get("routing", meta.get("_routing"))
            entry = {"action": op, "index": meta.get("_index", default_index),
                     "id": None if meta.get("_id") is None
                     else str(meta["_id"]),
                     "routing": None if routing is None else str(routing)}
            for key in ("if_seq_no", "if_primary_term"):
                if meta.get(key) is not None:
                    entry[key] = meta[key]
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
            item["index"] = _write_index(node, item["index"])
            by_index.setdefault(item["index"], []).append(pos)
        responses: List[Optional[dict]] = [None] * len(items)
        errors = False
        took = 0
        for name, positions in by_index.items():
            svc = node.indices.get(name)
            if any(items[p]["action"] in ("index", "create")
                   for p in positions):
                _check_no_pipeline(svc, req.param("pipeline"))
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

    def over_indices(method):
        """A handler that runs `method` on every index the expression
        resolves to (all of them without one)."""
        def handler(req):
            names = node.indices.resolve(req.param("index"))
            for n in names:
                getattr(node.indices.get(n), method)()
            return {"_shards": _shards_header(node, names)}
        return handler

    def do_count(req):
        body = dict(req.body or {})
        if req.param("q") is not None:
            body["query"] = {"query_string": {"query": req.param("q")}}
        body["size"] = 0
        body.pop("from", None)
        body.pop("aggs", None)
        body.pop("aggregations", None)
        res = _run_search(node, req.param("index"), body,
                          search_pipeline="_none")
        return {"count": res["hits"]["total"]["value"],
                "_shards": res["_shards"]}

    def do_search(req):
        body = dict(req.body) if isinstance(req.body, dict) else {}
        # URI-search parameters override or add to the body, as the
        # reference's REST layer folds them (`timeout` and `scroll` then
        # answer the controller's 400 for an unported key)
        if req.param("q") is not None:
            body["query"] = {"query_string": {"query": req.param("q")}}
        if req.param("search_type"):
            body["search_type"] = req.param("search_type")
        if req.param("timeout") is not None:
            body["timeout"] = req.param("timeout")
        if req.param("allow_partial_search_results") is not None:
            body["allow_partial_search_results"] = req.bool_param(
                "allow_partial_search_results", True)
        if req.param("scroll"):
            body["scroll"] = req.param("scroll")
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
        out = _run_search(node, req.param("index"), body,
                          req.param("search_pipeline"))
        if req.param("rest_total_hits_as_int") == "true":
            _total_as_int(out)
        return out

    def do_msearch(req):
        lines = _ndjson_lines(req)
        if len(lines) % 2 != 0:
            raise IllegalArgumentError(
                "msearch request must have an even number of lines "
                "(header, body pairs)")
        exprs = [lines[i].get("index", req.param("index"))
                 for i in range(0, len(lines), 2)]
        pairs = list(zip(exprs, lines[1::2]))
        # the batch route takes items that all name one concrete index;
        # an expression (a wildcard, `_all`, a header `{}`) runs item by
        # item
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
    c.register("PUT", "/{index}/_create/{id}", do_create)
    c.register("POST", "/{index}/_create/{id}", do_create)
    c.register("GET", "/{index}/_doc/{id}", do_get)
    c.register("GET", "/{index}/_source/{id}", do_get_source)
    c.register("DELETE", "/{index}/_doc/{id}", do_delete)
    c.register("POST", "/{index}/_update/{id}", do_update)
    c.register("GET", "/_mget", do_mget)
    c.register("POST", "/_mget", do_mget)
    c.register("GET", "/{index}/_mget", do_mget)
    c.register("POST", "/{index}/_mget", do_mget)
    c.register("POST", "/_bulk", do_bulk)
    c.register("PUT", "/_bulk", do_bulk)
    c.register("POST", "/{index}/_bulk", do_bulk)
    c.register("PUT", "/{index}/_bulk", do_bulk)
    c.register("POST", "/_refresh", over_indices("refresh"))
    c.register("GET", "/_refresh", over_indices("refresh"))
    c.register("POST", "/{index}/_refresh", over_indices("refresh"))
    c.register("POST", "/_flush", over_indices("flush"))
    c.register("POST", "/{index}/_flush", over_indices("flush"))
    c.register("POST", "/_forcemerge", over_indices("force_merge"))
    c.register("POST", "/{index}/_forcemerge", over_indices("force_merge"))
    c.register("GET", "/_count", do_count)
    c.register("POST", "/_count", do_count)
    c.register("GET", "/{index}/_count", do_count)
    c.register("POST", "/{index}/_count", do_count)
    c.register("GET", "/_search", do_search)
    c.register("POST", "/_search", do_search)
    c.register("GET", "/{index}/_search", do_search)
    c.register("POST", "/{index}/_search", do_search)
    c.register("GET", "/_msearch", do_msearch)
    c.register("POST", "/_msearch", do_msearch)
    c.register("GET", "/{index}/_msearch", do_msearch)
    c.register("POST", "/{index}/_msearch", do_msearch)
