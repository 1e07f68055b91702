"""IndicesService: create, get and delete indices (the subset of
opensearch_tpu.indices.service the BM25 slice needs)."""

from __future__ import annotations

from typing import Dict, List, Optional

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
    def __init__(self, device: torch.device):
        self.device = device
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
                           settings=_normalize_settings(body.get("settings")))
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
