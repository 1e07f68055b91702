"""IndexShard: one shard's write engine, device-resident reader and search
executor (the subset of opensearch_tpu.index.shard the BM25 slice needs)."""

from __future__ import annotations

import torch

from opensearch_tpu_torch.index.engine import EngineResult, InternalEngine
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.search.executor import SearchExecutor, ShardReader


class IndexShard:
    def __init__(self, shard_id: int, mapper: MapperService,
                 device: torch.device, index_name: str = "_index"):
        self.shard_id = shard_id
        self.index_name = index_name
        self.engine = InternalEngine(mapper)
        self.reader = ShardReader(mapper, device, index_name=index_name)
        self.executor = SearchExecutor(self.reader)

    def index_doc(self, doc_id: str, source: dict,
                  op_type: str = "index") -> EngineResult:
        return self.engine.index(doc_id, source, op_type=op_type)

    def delete_doc(self, doc_id: str) -> EngineResult:
        return self.engine.delete(doc_id)

    def refresh(self) -> None:
        """Seal the buffer, then publish: a new segment uploads once, a
        sealed segment whose deletes changed re-uploads its live mask."""
        new_seg, deleted_from = self.engine.refresh()
        for seg in deleted_from:
            self.reader.update_live(seg)
        if new_seg is not None:
            self.reader.add_segment(new_seg)
