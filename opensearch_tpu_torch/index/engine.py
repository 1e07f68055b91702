"""Single-shard versioned write engine over columnar segments (the subset of
opensearch_tpu.index.engine the port needs).

`index()` and `delete()` run a versioning plan against the live version map
(internal versions, `if_seq_no` / `if_primary_term` compare-and-set, an
external version, `op_type=create`), take a sequence number and buffer the
document in the in-memory SegmentBuilder. `refresh()` seals the buffer into
a new search-visible segment and applies buffered deletes to the sealed
segments' live bitmaps; `get()` reads the version map and the buffer first
(realtime), then the segments. `maybe_merge()` merges the smallest half of
the segments into one when there are more than `MERGE_MAX_SEGMENTS`.
There is no store or translog: `flush()` is a refresh.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from opensearch_tpu_torch.common.errors import VersionConflictError
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.segment import (Segment, SegmentBuilder,
                                                merge_segments)

NO_OPS_PERFORMED = -1
MERGE_MAX_SEGMENTS = 8


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


@dataclass
class GetResult:
    doc_id: str
    source: dict
    version: int
    seq_no: int
    primary_term: int


class InternalEngine:
    def __init__(self, mapper: MapperService, primary_term: int = 1,
                 device=None):
        """`device` is where a refresh or a merge builds what sealing
        computes (the IVF k-means of ANN vector fields): the card unless
        the caller names another."""
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

    def _plan_versioning(self, doc_id: str, op_type: str,
                         if_seq_no: Optional[int] = None,
                         if_primary_term: Optional[int] = None,
                         external_version: Optional[int] = None
                         ) -> Tuple[int, bool]:
        """(new version, created), or a VersionConflictError: a CAS on a
        missing doc or a stale seq_no / term, a create of a live doc, an
        external version not above the current one."""
        cur = self._current_version(doc_id)
        exists = cur is not None and not cur.deleted
        if if_seq_no is not None or if_primary_term is not None:
            if not exists:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, document does not exist")
            if ((if_seq_no is not None and cur.seq_no != if_seq_no) or
                    (if_primary_term is not None
                     and cur.primary_term != if_primary_term)):
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], primary term [{if_primary_term}], "
                    f"current document has seqNo [{cur.seq_no}] and primary "
                    f"term [{cur.primary_term}]")
        if op_type == "create" and exists:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document already exists "
                f"(current version [{cur.version}])")
        if external_version is not None:
            cur_v = cur.version if exists else 0
            if external_version <= cur_v:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, current version [{cur_v}] "
                    f"is higher or equal to the one provided "
                    f"[{external_version}]")
            return external_version, not exists
        # a delete's tombstone keeps the version chain: a re-create
        # continues it
        return (cur.version + 1 if cur is not None else 1), not exists

    def index(self, doc_id: str, source: dict, op_type: str = "index",
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              external_version: Optional[int] = None) -> EngineResult:
        """`external_version`: the caller's version, which must exceed the
        current one."""
        with self._lock:
            # the reference's order: plan the version, take the seq_no,
            # then parse, so a write that fails to parse still uses up
            # its sequence number
            new_version, created = self._plan_versioning(
                doc_id, op_type, if_seq_no, if_primary_term,
                external_version)
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            doc = self.mapper.parse_document(doc_id, source)
            self._builder_ords[doc_id] = self.builder.add(doc)
            self._pending_seal_deletes.append(doc_id)
            self.version_map[doc_id] = VersionValue(new_version, seq_no,
                                                    self.primary_term)
            return EngineResult(doc_id, new_version, seq_no,
                                self.primary_term, created=created)

    def delete(self, doc_id: str, if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None,
               external_version: Optional[int] = None) -> EngineResult:
        with self._lock:
            cur = self._current_version(doc_id)
            found = cur is not None and not cur.deleted
            new_version, _ = self._plan_versioning(
                doc_id, "delete", if_seq_no, if_primary_term,
                external_version)
            seq_no = self._next_seq_no
            self._next_seq_no += 1
            self._builder_ords.pop(doc_id, None)
            self._pending_seal_deletes.append(doc_id)
            self.version_map[doc_id] = VersionValue(
                new_version, seq_no, self.primary_term, deleted=True)
            return EngineResult(doc_id, new_version, seq_no,
                                self.primary_term, found=found)

    def get(self, doc_id: str, realtime: bool = True) -> Optional[GetResult]:
        """Realtime GET reads the version map and the buffer, so a write
        not yet refreshed is seen; otherwise only the sealed segments."""
        with self._lock:
            if realtime:
                vv = self.version_map.get(doc_id)
                if vv is not None:
                    if vv.deleted:
                        return None
                    ord_ = self._builder_ords.get(doc_id)
                    if ord_ is not None:
                        return GetResult(doc_id, self.builder.sources[ord_],
                                         vv.version, vv.seq_no,
                                         vv.primary_term)
                    for seg in reversed(self.segments):
                        o = seg.ord_of(doc_id)
                        if o is not None:
                            return GetResult(doc_id, seg.sources[o] or {},
                                             vv.version, vv.seq_no,
                                             vv.primary_term)
                    return None
            for seg in reversed(self.segments):
                o = seg.ord_of(doc_id)
                if o is not None:
                    version, seq_no, term = seg.doc_meta.get(
                        doc_id, (1, NO_OPS_PERFORMED, self.primary_term))
                    return GetResult(doc_id, seg.sources[o] or {}, version,
                                     seq_no, term)
            return None

    def refresh(self) -> Optional[Segment]:
        """Seal the buffer and apply buffered deletes to the sealed
        segments' live bitmaps. Returns the new segment (or None)."""
        with self._lock:
            if self._pending_seal_deletes:
                pending = set(self._pending_seal_deletes)
                for seg in self.segments:
                    for did in pending:
                        seg.delete(did)
                self._pending_seal_deletes = []
            new_seg: Optional[Segment] = None
            if len(self.builder):
                new_seg = self.builder.seal(device=self.device)
                # within-buffer supersession: only the last ord per id
                # stays live, and none of an id deleted after it; nested
                # rows (no id) take their root's verdict: a block lives or
                # dies whole
                for ord_ in range(new_seg.num_docs):
                    did = new_seg.doc_ids[ord_]
                    if did is None:
                        continue
                    vv = self.version_map.get(did)
                    if self._builder_ords.get(did) != ord_ \
                            or (vv is not None and vv.deleted):
                        new_seg.live[ord_] = False
                    elif vv is not None:
                        new_seg.doc_meta[did] = (vv.version, vv.seq_no,
                                                 vv.primary_term)
                if new_seg.nested_paths:
                    child = new_seg.parent_ptr >= 0
                    new_seg.live[child] = \
                        new_seg.live[new_seg.parent_ptr[child]]
                self.segments.append(new_seg)
                self.builder = SegmentBuilder(self.mapper,
                                              self._next_seg_id())
                self._builder_ords = {}
            return new_seg

    def flush(self) -> None:
        """A refresh: the port keeps no store or translog to commit."""
        self.refresh()

    def maybe_merge(self, max_segments: int = MERGE_MAX_SEGMENTS
                    ) -> Optional[Segment]:
        """With more than `max_segments` sealed segments, merge the
        smallest half (at least two) into one that replaces them."""
        with self._lock:
            if len(self.segments) <= max_segments:
                return None
            ranked = sorted(self.segments, key=lambda s: s.num_docs)
            victims = ranked[:max(2, len(ranked) // 2)]
            merged = merge_segments(self.mapper, victims,
                                    self._next_seg_id(), device=self.device)
            victim_ids = {s.seg_id for s in victims}
            self.segments = [s for s in self.segments
                             if s.seg_id not in victim_ids]
            self.segments.append(merged)
            return merged
