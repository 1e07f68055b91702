"""Single-shard versioned write engine over columnar segments (the subset of
opensearch_tpu.index.engine the BM25 slice needs).

Writes land in an in-memory SegmentBuilder; `refresh()` seals it into a new
search-visible segment and applies buffered deletes to the sealed segments'
live bitmaps. There is no translog, replication or merge in this slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from opensearch_tpu_torch.common.errors import VersionConflictError
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import Segment, SegmentBuilder

NO_OPS_PERFORMED = -1


@dataclass
class VersionValue:
    version: int
    seq_no: int
    primary_term: int
    deleted: bool = False


@dataclass
class EngineResult:
    doc_id: str
    version: int
    seq_no: int
    primary_term: int
    created: bool = False
    found: bool = False


class InternalEngine:
    def __init__(self, mapper: MapperService, primary_term: int = 1,
                 device=None):
        """`device` is where a refresh builds what sealing computes (the
        IVF k-means of ANN vector fields): the card unless the caller names
        another."""
        self.mapper = mapper
        self.device = device
        self.primary_term = primary_term
        self._lock = threading.RLock()
        self._seg_counter = 0
        self._next_seq_no = 0
        self.segments: List[Segment] = []
        self.builder = SegmentBuilder(mapper, self._next_seg_id())
        self._builder_ords: Dict[str, int] = {}
        self.version_map: Dict[str, VersionValue] = {}
        # sealed-segment deletes buffered until refresh
        self._pending_seal_deletes: List[str] = []

    def _next_seg_id(self) -> str:
        sid = f"s{self._seg_counter:06d}"
        self._seg_counter += 1
        return sid

    def _current_version(self, doc_id: str) -> Optional[VersionValue]:
        vv = self.version_map.get(doc_id)
        if vv is not None:
            return vv
        for seg in reversed(self.segments):
            if seg.ord_of(doc_id) is not None:
                meta = seg.doc_meta.get(doc_id)
                if meta is not None:
                    return VersionValue(*meta)
                return VersionValue(1, NO_OPS_PERFORMED, self.primary_term)
        return None

    def _plan_versioning(self, doc_id: str, op_type: str) -> Tuple[int, bool]:
        cur = self._current_version(doc_id)
        exists = cur is not None and not cur.deleted
        if op_type == "create" and exists:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document already exists "
                f"(current version [{cur.version}])")
        return (cur.version + 1 if cur is not None else 1), not exists

    def index(self, doc_id: str, source: dict,
              op_type: str = "index") -> EngineResult:
        with self._lock:
            # the reference's order: plan the version, take the seq_no,
            # then parse, so a write that fails to parse still uses up
            # its sequence number
            new_version, created = self._plan_versioning(doc_id, op_type)
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            doc = self.mapper.parse_document(doc_id, source)
            self._builder_ords[doc_id] = self.builder.add(doc)
            self._pending_seal_deletes.append(doc_id)
            self.version_map[doc_id] = VersionValue(new_version, seq_no,
                                                    self.primary_term)
            return EngineResult(doc_id, new_version, seq_no,
                                self.primary_term, created=created)

    def delete(self, doc_id: str) -> EngineResult:
        with self._lock:
            cur = self._current_version(doc_id)
            found = cur is not None and not cur.deleted
            new_version, _ = self._plan_versioning(doc_id, "delete")
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            self._builder_ords.pop(doc_id, None)
            self._pending_seal_deletes.append(doc_id)
            self.version_map[doc_id] = VersionValue(
                new_version, seq_no, self.primary_term, deleted=True)
            return EngineResult(doc_id, new_version, seq_no,
                                self.primary_term, found=found)

    def refresh(self) -> Tuple[Optional[Segment], List[Segment]]:
        """Seal the buffer and apply buffered deletes. Returns the new
        segment (or None) and the sealed segments whose live bitmap
        changed."""
        with self._lock:
            deleted_from: List[Segment] = []
            if self._pending_seal_deletes:
                pending = set(self._pending_seal_deletes)
                for seg in self.segments:
                    if any([seg.delete(did) for did in pending]):
                        deleted_from.append(seg)
                self._pending_seal_deletes = []
            new_seg: Optional[Segment] = None
            if len(self.builder):
                new_seg = self.builder.seal(device=self.device)
                # within-buffer supersession: only the last ord per id
                # stays live, and none of an id deleted after it
                for ord_ in range(new_seg.num_docs):
                    did = new_seg.doc_ids[ord_]
                    vv = self.version_map.get(did)
                    if self._builder_ords.get(did) != ord_ \
                            or (vv is not None and vv.deleted):
                        new_seg.live[ord_] = False
                    elif vv is not None:
                        new_seg.doc_meta[did] = (vv.version, vv.seq_no,
                                                 vv.primary_term)
                self.segments.append(new_seg)
                self.builder = SegmentBuilder(self.mapper,
                                              self._next_seg_id())
                self._builder_ords = {}
            return new_seg, deleted_from
