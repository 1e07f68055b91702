"""IndicesService: create, get and delete indices, and resolve index
expressions (the subset of opensearch_tpu.indices.service the port
needs)."""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional, Sequence, Union

import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                IndexNotFoundError,
                                                ResourceAlreadyExistsError)
from opensearch_tpu_torch.index.service import IndexService

_INVALID_CHARS = set('\\/*?"<>| ,')


def validate_index_name(name: str):
    if not name:
        raise IllegalArgumentError("index name must not be empty")
    if name != name.lower():
        raise IllegalArgumentError(f"index name [{name}] must be lowercase")
    if name.startswith(("-", "_", "+")):
        raise IllegalArgumentError(
            f"index name [{name}] must not start with '_', '-', or '+'")
    if _INVALID_CHARS & set(name) or "#" in name or ":" in name:
        raise IllegalArgumentError(
            f"index name [{name}] must not contain the following characters "
            f"{sorted(_INVALID_CHARS | set('#:'))}")
    if name in (".", ".."):
        raise IllegalArgumentError(f"index name [{name}] is invalid")
    if len(name.encode("utf-8")) > 255:
        raise IllegalArgumentError(f"index name [{name}] is too long")


def _normalize_settings(settings: Optional[dict]) -> dict:
    """Flatten {"index": {"number_of_shards": 1}} and "index.x" keys to
    bare setting names."""
    out: Dict[str, object] = {}

    def walk(prefix: str, obj):
        for k, v in obj.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(f"{key}.", v)
            else:
                out[key[len("index."):] if key.startswith("index.")
                    else key] = v
    walk("", settings or {})
    return out


class IndicesService:
    def __init__(self, device: torch.device, result_page: bool = False,
                 blockmax: bool = False, delta: bool = False):
        self.device = device
        # the node's search.result_page.enabled, search.blockmax.enabled
        # and indices.publish.delta, handed to every shard
        self.result_page = result_page
        self.blockmax = blockmax
        self.delta = delta
        self.indices: Dict[str, IndexService] = {}

    def create_index(self, name: str, body: Optional[dict] = None
                     ) -> IndexService:
        validate_index_name(name)
        if name in self.indices:
            raise ResourceAlreadyExistsError(
                f"index [{name}/] already exists")
        body = body or {}
        svc = IndexService(name, self.device,
                           mapping=body.get("mappings") or None,
                           settings=_normalize_settings(body.get("settings")),
                           result_page=self.result_page,
                           blockmax=self.blockmax, delta=self.delta)
        self.indices[name] = svc
        return svc

    def delete_index(self, name: str) -> List[str]:
        if name not in self.indices:
            raise IndexNotFoundError(name)
        del self.indices[name]
        return [name]

    def get(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundError(name)
        return svc

    def resolve(self, expression: Union[str, Sequence[str], None],
                ignore_unavailable: bool = False,
                allow_no_indices: bool = True) -> List[str]:
        """IndexNameExpressionResolver (the reference's, without aliases
        or closed indices, which the port does not have): wildcards,
        `_all`, commas and `-` exclusions. Returns concrete index names in
        creation order."""
        if expression is None or expression in ("_all", "*", ""):
            return list(self.indices)
        parts = (expression if isinstance(expression, list)
                 else expression.split(","))
        selected: List[str] = []
        for i, part in enumerate(parts):
            part = part.strip()
            exclude = part.startswith("-") and i > 0
            if exclude:
                part = part[1:]
            if part == "_all":
                names = list(self.indices)
            elif "*" in part or "?" in part:
                names = [n for n in self.indices
                         if fnmatch.fnmatchcase(n, part)]
            elif part in self.indices:
                names = [part]
            elif ignore_unavailable or exclude:
                names = []
            else:
                raise IndexNotFoundError(part)
            for n in names:
                if exclude:
                    if n in selected:
                        selected.remove(n)
                elif n not in selected:
                    selected.append(n)
        if not selected and not allow_no_indices:
            raise IndexNotFoundError(expression)
        return selected
