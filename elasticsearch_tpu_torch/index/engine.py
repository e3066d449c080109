"""Per-index write path for the `_search` slices (counterpart of
elasticsearch_tpu/index/engine.py): index, refresh and force-merge.

Indexed documents buffer in a SegmentWriter until ``refresh`` turns them
into an immutable Segment; ``force_merge(1)`` folds every segment into
one, which the v2m serving lane needs (the plan path serves several).
Re-indexing an id soft-deletes its older copy. Segments that a merge or
an install retires are marked ``retired`` and handed to ``on_retire``
(the node drops their fast-path registrations and device copies). This slice keeps the index in memory: the
translog and on-disk segments are later slices.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import (Segment, SegmentWriter,
                                                   merge_segments)


class Engine:
    def __init__(self, mapper: DocumentMapper, name: str = "",
                 on_retire: Optional[Callable[[Iterable[str]], None]] = None):
        self.mapper = mapper
        self._on_retire = on_retire
        # segment names carry the index name: the node's device cache
        # holds the segments of every index
        self.name = name
        self._lock = threading.Lock()
        self._segments: List[Segment] = []
        self._writer = SegmentWriter()
        self._buffered: Dict[str, int] = {}   # id -> index in the writer
        self._seg_counter = 0

    @property
    def segments(self) -> List[Segment]:
        with self._lock:
            return list(self._segments)

    def _next_name(self) -> str:
        self._seg_counter += 1
        return f"{self.name}_{self._seg_counter}"

    def _exists(self, doc_id: str) -> bool:
        if doc_id in self._buffered:
            return True
        return any(seg.docid_for(doc_id) >= 0 for seg in self._segments)

    def index(self, doc_id: Optional[str], source: Dict[str, Any],
              op_type: str = "index") -> Tuple[str, str]:
        """Index one document; returns (id, "created" | "updated").
        ``op_type="create"`` refuses an id that exists (ValueError)."""
        doc_id = doc_id if doc_id is not None else uuid.uuid4().hex[:20]
        parsed = self.mapper.parse(doc_id, source)
        with self._lock:
            existed = self._exists(doc_id)
            if existed and op_type == "create":
                raise ValueError(f"[{doc_id}]: version conflict, document "
                                 f"already exists")
            self._delete_locked(doc_id)
            self._buffered[doc_id] = self._writer.add(parsed)
        return doc_id, ("updated" if existed else "created")

    def delete(self, doc_id: str) -> bool:
        with self._lock:
            return self._delete_locked(doc_id)

    def _delete_locked(self, doc_id: str) -> bool:
        found = False
        pos = self._buffered.pop(doc_id, None)
        if pos is not None:
            self._writer.docs[pos] = None
            found = True
        for seg in self._segments:
            d = seg.docid_for(doc_id)
            if d >= 0:
                seg.delete(d)
                found = True
        return found

    def refresh(self) -> bool:
        """Turn the buffered documents into a new searchable segment;
        False when nothing was buffered."""
        with self._lock:
            docs = [d for d in self._writer.docs if d is not None]
            self._writer = SegmentWriter()
            self._buffered = {}
            if not docs:
                return False
            for d in docs:
                self._writer.add(d)
            seg = self._writer.build(self._next_name())
            self._writer = SegmentWriter()
            self._segments.append(seg)
            return True

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Merge every segment into one, dropping deleted documents."""
        if max_num_segments != 1:
            raise ValueError("this slice force-merges to one segment only "
                             "(max_num_segments=1)")
        with self._lock:
            if len(self._segments) > 1 or any(
                    not s.live.all() for s in self._segments):
                merged = merge_segments(self._next_name(), self._segments)
                self._replace([merged] if merged.n_docs else [])

    def install_segments(self, segments: List[Segment]) -> None:
        """Replace the searchable segments with prebuilt ones (bulk
        loading of a corpus built outside the write path)."""
        with self._lock:
            self._replace(list(segments))

    def _replace(self, segments: List[Segment]) -> None:
        kept = {id(s) for s in segments}
        retired = []
        for s in self._segments:
            if id(s) not in kept:
                s.retired = True
                retired.append(s.name)
        self._segments = segments
        if retired and self._on_retire is not None:
            self._on_retire(retired)
