"""IndexShard: one shard's write engine, device-resident reader and search
executor (the subset of opensearch_tpu.index.shard the port needs), with
its shard id within the index. A refresh, a flush or a merge reconciles the
reader with the engine's segments (`_sync_reader`)."""

from __future__ import annotations

from typing import Optional

import torch

from opensearch_tpu_torch.index.engine import (MERGE_MAX_SEGMENTS,
                                               EngineResult, GetResult,
                                               InternalEngine)
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import Segment
from opensearch_tpu_torch.search.executor import SearchExecutor, ShardReader


class IndexShard:
    def __init__(self, shard_id: int, mapper: MapperService,
                 device: torch.device, index_name: str = "_index",
                 result_page: bool = False, blockmax: bool = False,
                 delta: bool = False):
        """`delta`: the node's `indices.publish.delta` (compact-prefix
        segment publish)."""
        self.shard_id = shard_id
        self.index_name = index_name
        self.engine = InternalEngine(mapper, device=device)
        self.reader = ShardReader(mapper, device, index_name=index_name,
                                  delta=delta)
        self.executor = SearchExecutor(self.reader, result_page=result_page,
                                       blockmax=blockmax)

    def index_doc(self, doc_id: str, source: dict, **kw) -> EngineResult:
        return self.engine.index(doc_id, source, **kw)

    def delete_doc(self, doc_id: str, **kw) -> EngineResult:
        return self.engine.delete(doc_id, **kw)

    def get_doc(self, doc_id: str,
                realtime: bool = True) -> Optional[GetResult]:
        return self.engine.get(doc_id, realtime=realtime)

    def refresh(self) -> None:
        """Seal the buffer, then publish: a new segment uploads once, and
        a sealed one re-uploads its live mask if the mask changed."""
        self.engine.refresh()
        self._sync_reader()

    def flush(self) -> None:
        self.engine.flush()
        self._sync_reader()

    def force_merge(self) -> None:
        """Merge down to one segment."""
        while self.maybe_merge(1) is not None:
            pass
        self._sync_reader()

    def maybe_merge(self, max_segments: int = MERGE_MAX_SEGMENTS
                    ) -> Optional[Segment]:
        merged = self.engine.maybe_merge(max_segments)
        if merged is not None:
            self._sync_reader()
        return merged

    def _sync_reader(self) -> None:
        """Reconcile the reader with the engine's segments."""
        engine_ids = {s.seg_id for s in self.engine.segments}
        for seg in list(self.reader.segments):
            if seg.seg_id not in engine_ids:
                self.reader.remove_segment(seg.seg_id)
        reader_ids = {s.seg_id for s in self.reader.segments}
        for seg in self.engine.segments:
            if seg.seg_id not in reader_ids:
                self.reader.add_segment(seg)
            else:
                self.reader.update_segment(seg)
