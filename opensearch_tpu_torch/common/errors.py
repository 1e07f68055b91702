"""The error types the BM25 search path raises, with their REST status and
JSON shape (the subset of opensearch_tpu.common.errors the port needs)."""

from __future__ import annotations


class OpenSearchTpuError(Exception):
    status = 500
    error_type = "exception"

    def __init__(self, reason: str = "", **metadata):
        super().__init__(reason)
        self.reason = reason
        self.metadata = metadata

    def to_xcontent(self) -> dict:
        body = {"type": self.error_type, "reason": self.reason}
        body.update(self.metadata)
        return body


class IndexNotFoundError(OpenSearchTpuError):
    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index,
                         **{"resource.type": "index_or_alias",
                            "resource.id": index})
        self.index = index


class ResourceAlreadyExistsError(OpenSearchTpuError):
    status = 400
    error_type = "resource_already_exists_exception"


class VersionConflictError(OpenSearchTpuError):
    status = 409
    error_type = "version_conflict_engine_exception"


class MapperParsingError(OpenSearchTpuError):
    status = 400
    error_type = "mapper_parsing_exception"


class IllegalArgumentError(OpenSearchTpuError):
    status = 400
    error_type = "illegal_argument_exception"


class ParsingError(OpenSearchTpuError):
    status = 400
    error_type = "parsing_exception"


class QueryShardError(OpenSearchTpuError):
    status = 400
    error_type = "query_shard_exception"
