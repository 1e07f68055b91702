"""REST dispatch: method + path routing onto registered handlers, with the
reference's JSON error contract ({"error": {...}, "status": N}) (the subset
of opensearch_tpu.rest.controller the BM25 slice needs)."""

from __future__ import annotations

import json
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from opensearch_tpu_torch.common.errors import OpenSearchTpuError


@dataclass
class RestRequest:
    method: str
    path: str
    params: Dict[str, str] = field(default_factory=dict)
    body: Any = None          # parsed JSON (dict / list) or None
    raw_body: Optional[bytes] = None

    def param(self, name: str, default=None):
        return self.params.get(name, default)


@dataclass
class RestResponse:
    status: int = 200
    body: Any = None

    def json(self) -> str:
        return json.dumps(self.body, default=str)


class RestController:
    def __init__(self):
        self._routes: List[Tuple[str, List[str], Callable]] = []

    def register(self, method: str, path: str, handler: Callable):
        """handler(request) -> dict | (status, dict)."""
        self._routes.append((method.upper(),
                             [s for s in path.split("/") if s], handler))

    def _resolve(self, method: str, path: str):
        segments = [s for s in path.split("/") if s]
        best = None
        allowed = set()
        for m, pattern, handler in self._routes:
            if len(pattern) != len(segments):
                continue
            params = {}
            literal = 0
            for p, s in zip(pattern, segments):
                if p.startswith("{") and p.endswith("}"):
                    params[p[1:-1]] = s
                elif p == s:
                    literal += 1
                else:
                    break
            else:
                allowed.add(m)
                # literal segments beat {param} captures
                if m == method and (best is None or literal > best[0]):
                    best = (literal, handler, params)
        return best, allowed

    def dispatch(self, request: RestRequest) -> RestResponse:
        try:
            best, allowed = self._resolve(request.method.upper(),
                                          request.path)
            if best is None:
                if allowed:
                    return _error_response(
                        405, "method_not_allowed_exception",
                        f"Incorrect HTTP method for uri [{request.path}] and "
                        f"method [{request.method}], allowed: "
                        f"{sorted(allowed)}")
                return _error_response(
                    400, "illegal_argument_exception",
                    f"no handler found for uri [{request.path}] and method "
                    f"[{request.method}]")
            _literal, handler, params = best
            request.params = {**params, **request.params}
            result = handler(request)
            if isinstance(result, tuple):
                status, body = result
                return RestResponse(status=status, body=body)
            return RestResponse(status=200, body=result)
        except OpenSearchTpuError as e:
            return RestResponse(status=e.status, body={
                "error": {"root_cause": [e.to_xcontent()],
                          **e.to_xcontent()},
                "status": e.status})
        except Exception as e:  # unexpected: 500 with the exception chain
            return RestResponse(status=500, body={
                "error": {
                    "root_cause": [{"type": type(e).__name__,
                                    "reason": str(e)}],
                    "type": type(e).__name__,
                    "reason": str(e),
                    "stack_trace": traceback.format_exc(),
                },
                "status": 500,
            })


def _error_response(status: int, err_type: str, reason: str) -> RestResponse:
    return RestResponse(status=status, body={
        "error": {"root_cause": [{"type": err_type, "reason": reason}],
                  "type": err_type, "reason": reason},
        "status": status,
    })
