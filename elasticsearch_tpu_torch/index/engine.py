"""The shard engine: versioned writes over immutable segments and a
write-ahead log (the port's copy of elasticsearch_tpu/index/engine.py,
Elasticsearch's InternalEngine).

- **Versioned writes.** Every index or delete takes the next sequence
  number (index/seqno.py) and the document's next ``_version``; the
  three are written into the document as the metadata numeric columns
  ``_seq_no``, ``_primary_term`` and ``_version``, so they survive a
  restart. The LiveVersionMap is two parts: ``version_map`` holds an
  entry for each id written (or replayed) since the engine opened, and
  a live document of a segment without one reads its entry from the
  segment's metadata columns (``_current``), which is what the
  reference's map rebuilt at recovery holds, without a host object a
  document. ``if_seq_no``/``if_primary_term`` compare and set;
  ``op_type="create"`` refuses a live id (VersionConflictEngineException,
  a 409). An op is applied, then appended to the translog
  (index/translog.py).
- **Near-real-time.** Indexed documents buffer until ``refresh`` builds
  them into an immutable Segment; a realtime GET reads the buffer. An
  update or delete of a refreshed document tombstones its old copy at
  the NEXT refresh (deferred tombstones): until then search sees the old
  copy and not the new one, as Elasticsearch's. The live masks on the
  device are keyed on ``Segment.live_version``, so they follow the
  refresh.
- **Merges.** After a refresh, more than ``merge_factor`` segments fold
  the smallest together; ``force_merge(n)`` refreshes and merges every
  segment into one when there are more than n.
- **Flush and recovery.** ``flush`` refreshes, saves the segments that
  changed since the last flush (index/segment.py ``Segment.save``),
  fsyncs the translog, rolls its generation, writes the commit point
  ``segments.json`` and trims the older generations. Opening an engine
  on a path loads the committed segments, builds the id maps the
  version map reads their metadata columns through, and replays the
  translog from the commit's generation.

**Mounted shards.** A shard whose directory holds a searchable
snapshot's manifest (``snapshot_store.json``, xpack/searchable_snapshots.py)
defers each committed segment whose files are missing: its files are
fetched from the repository, through the materializer the node
registers for its data path in ``LAZY_MATERIALIZERS``, at the first
``acquire_searcher``, and only then loaded. A flush keeps the
still-deferred names in the commit point.

Segment names are ``{name}_{n}``, ``name`` being ``{index}[{shard}]``
(index/service.py), unique across the node's indices and shards because
the node's device cache and the fast path key on them; a segment loaded
from a commit keeps the name it was saved under. Segments that a merge
or an install retires are marked ``retired`` and handed to
``on_retire`` (the node drops their fast-path registrations and device
copies). ``install_segments`` puts prebuilt segments in place of the
searchable ones (bulk loading of a corpus built outside the write
path); they are saved at the next flush, and their documents, which
carry no metadata columns, take version 1, seq_no -1 and the engine's
primary term, as the reference gives such documents.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import (
    EngineClosedException, VersionConflictEngineException)
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.segment import (Segment, SegmentWriter,
                                                   merge_segments)
from elasticsearch_tpu_torch.index.seqno import (NO_OPS_PERFORMED,
                                                 LocalCheckpointTracker)
from elasticsearch_tpu_torch.index.translog import Translog, TranslogOp

# the metadata columns every written document carries
META_COLUMNS = ("_seq_no", "_primary_term", "_version")
# the files of a saved segment (index/segment.py ``Segment.save``)
SEGMENT_FILES = ("meta.json", "arrays.npz", "stored.bin")
# the manifest of a mounted shard (xpack/searchable_snapshots.py)
LAZY_MANIFEST = "snapshot_store.json"

# data path -> fn(shard_path, segment name) -> bool: fetches a deferred
# segment's files into its directory (the node registers its own and
# drops it at close)
LAZY_MATERIALIZERS: Dict[str, Any] = {}


def _find_materializer(shard_path: str):
    for prefix, fn in list(LAZY_MATERIALIZERS.items()):
        # prefix + separator: "/data/node1" must not claim
        # "/data/node10/..." shards
        if shard_path.startswith(prefix.rstrip(os.sep) + os.sep):
            return fn
    return None


@dataclass(slots=True)
class VersionValue:
    """A LiveVersionMap entry."""

    version: int
    seq_no: int
    primary_term: int
    deleted: bool
    buffer_idx: int     # >= 0 while the doc lives in the indexing buffer


@dataclass
class IndexResult:
    doc_id: str
    version: int
    seq_no: int
    primary_term: int
    created: bool


@dataclass
class DeleteResult:
    doc_id: str
    version: int
    seq_no: int
    primary_term: int
    found: bool


@dataclass
class GetResult:
    found: bool
    doc_id: str
    source: Optional[Dict[str, Any]] = None
    version: int = -1
    seq_no: int = -1
    primary_term: int = -1


class SearcherSnapshot:
    """Point-in-time view over the published segments, with the epoch
    it was taken at."""

    def __init__(self, segments: List[Segment], epoch: int):
        self.segments = list(segments)
        self.epoch = epoch

    @property
    def doc_count(self) -> int:
        return sum(s.live_doc_count for s in self.segments)


class Engine:
    def __init__(self, shard_path: str, mapper: DocumentMapper,
                 merge_factor: int = 10, name: str = "",
                 on_retire: Optional[Callable[[Iterable[str]], None]] = None):
        self.path = shard_path
        self.mapper = mapper
        self.merge_factor = merge_factor
        self.name = name or f"seg_{uuid.uuid4().hex[:12]}"
        self._on_retire = on_retire
        os.makedirs(shard_path, exist_ok=True)
        self._lock = threading.RLock()
        self._closed = False
        self.primary_term = 1
        self.tracker = LocalCheckpointTracker()
        self.version_map: Dict[str, VersionValue] = {}
        self._buffer: List[Tuple[str, Any]] = []     # (id, ParsedDocument)
        self._buffer_dead: set = set()
        # (segment name, docid) -> (segment, docid): applied at refresh
        self._pending_tombstones: Dict[Tuple[str, int],
                                       Tuple[Segment, int]] = {}
        self._segments: List[Segment] = []
        # committed segments of a mounted shard whose files are still in
        # the repository (fetched at the first search)
        self._deferred_segments: List[str] = []
        self._dirty_segments: set = set()    # names needing a (re)save
        self._epoch = 0
        self._seg_counter = 0
        self.translog = Translog(os.path.join(shard_path, "translog"))
        self._recover()

    # ------------------------------------------------------------ recovery
    def _commit_path(self) -> str:
        return os.path.join(self.path, "segments.json")

    def _recover(self) -> None:
        """Load the commit point's segments, build the version map's id
        maps, replay the translog; ``recovery`` keeps each step's
        seconds and the ops replayed."""
        commit_gen = 1
        t0 = time.perf_counter()
        if os.path.exists(self._commit_path()):
            with open(self._commit_path()) as fh:
                commit = json.load(fh)
            lazy = os.path.exists(os.path.join(self.path, LAZY_MANIFEST))
            for name in commit["segments"]:
                seg_dir = os.path.join(self.path, name)
                complete = all(os.path.exists(os.path.join(seg_dir, f))
                               for f in SEGMENT_FILES)
                if lazy and not complete:
                    # a mounted shard: its files stream in at the first
                    # search; a partial directory (a fetch cut short)
                    # is fetched again
                    self._deferred_segments.append(name)
                else:
                    self._segments.append(Segment.load(seg_dir))
            commit_gen = commit["translog_generation"]
            self.primary_term = commit.get("primary_term", 1)
            self._seg_counter = commit.get("seg_counter",
                                           len(self._segments))
            max_seq = commit.get("max_seq_no", NO_OPS_PERFORMED)
            self.tracker = LocalCheckpointTracker(max_seq, max_seq)
        t1 = time.perf_counter()
        for seg in self._segments:
            seg.id_map     # the version map's index into the columns
        t2 = time.perf_counter()
        # replay the ops recorded after the commit point
        ops = self.translog.read_ops(commit_gen)
        for op in ops:
            if op.op_type == "index":
                self._index_internal(op.doc_id, op.source, seq_no=op.seq_no,
                                     primary_term=op.primary_term,
                                     from_translog=True)
            elif op.op_type == "delete":
                self._delete_internal(op.doc_id, seq_no=op.seq_no,
                                      primary_term=op.primary_term,
                                      from_translog=True)
            self.tracker.advance_max_seq_no(op.seq_no)
            self.tracker.mark_seq_no_as_processed(op.seq_no)
        self.recovery = {"segments": len(self._segments),
                         "segment_load_s": t1 - t0,
                         "version_map_s": t2 - t1,
                         "replay_ops": len(ops),
                         "replay_s": time.perf_counter() - t2}

    def _segment_version(self, seg: Segment, docid: int) -> VersionValue:
        """The version-map entry of a live doc of ``seg`` from its
        metadata columns; a doc without them takes version 1, seq_no -1
        and the engine's primary term, as the reference's map gives
        it."""
        vals = []
        for meta, default in zip(META_COLUMNS, (NO_OPS_PERFORMED,
                                                self.primary_term, 1)):
            nv = seg.numerics.get(meta)
            vals.append(default if nv is None or nv.missing[docid]
                        else int(nv.values[docid]))
        seq_no, primary_term, version = vals
        return VersionValue(version, seq_no, primary_term, False, -1)

    def _current(self, doc_id: str) -> Optional[VersionValue]:
        """The LiveVersionMap entry of ``doc_id``, None when it has
        none."""
        vv = self.version_map.get(doc_id)
        if vv is not None:
            return vv
        for seg in self._segments:
            docid = seg.docid_for(doc_id)
            if docid >= 0:
                return self._segment_version(seg, docid)
        return None

    # ------------------------------------------------------------- writes
    @staticmethod
    def new_id() -> str:
        """An id for a document indexed without one."""
        return uuid.uuid4().hex[:20]

    def _check_open(self):
        if self._closed:
            raise EngineClosedException("engine is closed")

    def index(self, doc_id: Optional[str], source: Dict[str, Any],
              seq_no: Optional[int] = None,
              primary_term: Optional[int] = None,
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              op_type: str = "index") -> IndexResult:
        """Plan (the version and compare-and-set checks), index into the
        buffer, append to the translog."""
        doc_id = doc_id if doc_id is not None else self.new_id()
        with self._lock:
            self._check_open()
            existing = self._current(doc_id)
            exists = existing is not None and not existing.deleted
            if if_seq_no is not None or if_primary_term is not None:
                if not exists:
                    raise VersionConflictEngineException(
                        doc_id, "document does not exist")
                if (existing.seq_no != if_seq_no or
                        existing.primary_term != if_primary_term):
                    raise VersionConflictEngineException(
                        doc_id,
                        f"required seqNo [{if_seq_no}], primary term "
                        f"[{if_primary_term}]. current document has seqNo "
                        f"[{existing.seq_no}] and primary term "
                        f"[{existing.primary_term}]")
            if op_type == "create" and exists:
                raise VersionConflictEngineException(
                    doc_id, "document already exists")
            result = self._index_internal(
                doc_id, source, seq_no=seq_no, primary_term=primary_term)
            self.translog.add(TranslogOp(
                "index", result.seq_no, result.primary_term,
                doc_id=doc_id, source=source, version=result.version))
            return result

    def _index_internal(self, doc_id, source, seq_no=None, primary_term=None,
                        from_translog=False) -> IndexResult:
        if seq_no is None:
            seq_no = self.tracker.generate_seq_no()
        else:
            self.tracker.advance_max_seq_no(seq_no)
        # a document the mapper refuses has taken its seq_no (as in the
        # reference) but leaves the current copy in place
        parsed = self.mapper.parse(doc_id, source)
        if primary_term is None:
            primary_term = self.primary_term
        existing = self._current(doc_id)
        exists = existing is not None and not existing.deleted
        version = existing.version + 1 if exists else 1
        self._remove_current_doc(doc_id, existing)
        parsed.numeric_values["_seq_no"] = [float(seq_no)]
        parsed.numeric_values["_primary_term"] = [float(primary_term)]
        parsed.numeric_values["_version"] = [float(version)]
        self._buffer.append((doc_id, parsed))
        self.version_map[doc_id] = VersionValue(
            version, seq_no, primary_term, False, len(self._buffer) - 1)
        if not from_translog:
            self.tracker.mark_seq_no_as_processed(seq_no)
        return IndexResult(doc_id, version, seq_no, primary_term,
                           not exists)

    def delete(self, doc_id: str, seq_no: Optional[int] = None,
               primary_term: Optional[int] = None,
               if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None) -> DeleteResult:
        with self._lock:
            self._check_open()
            existing = self._current(doc_id)
            exists = existing is not None and not existing.deleted
            if if_seq_no is not None and (
                    not exists or existing.seq_no != if_seq_no or
                    existing.primary_term != if_primary_term):
                raise VersionConflictEngineException(
                    doc_id, f"required seqNo [{if_seq_no}]")
            result = self._delete_internal(doc_id, seq_no=seq_no,
                                           primary_term=primary_term)
            self.translog.add(TranslogOp(
                "delete", result.seq_no, result.primary_term, doc_id=doc_id))
            return result

    def _delete_internal(self, doc_id, seq_no=None, primary_term=None,
                         from_translog=False) -> DeleteResult:
        if seq_no is None:
            seq_no = self.tracker.generate_seq_no()
        else:
            self.tracker.advance_max_seq_no(seq_no)
        if primary_term is None:
            primary_term = self.primary_term
        existing = self._current(doc_id)
        found = existing is not None and not existing.deleted
        version = existing.version + 1 if existing else 1
        self._remove_current_doc(doc_id, existing)
        self.version_map[doc_id] = VersionValue(
            version, seq_no, primary_term, True, -1)
        if not from_translog:
            self.tracker.mark_seq_no_as_processed(seq_no)
        return DeleteResult(doc_id, version, seq_no, primary_term, found)

    def _remove_current_doc(self, doc_id: str,
                            existing: Optional[VersionValue]) -> None:
        """Tombstone the current copy of a doc: a buffered one at once, a
        refreshed one at the next refresh."""
        if existing is not None and existing.buffer_idx >= 0:
            self._buffer_dead.add(existing.buffer_idx)
            return
        for seg in self._segments:
            docid = seg.docid_for(doc_id)
            if docid >= 0:
                self._pending_tombstones[(seg.name, docid)] = (seg, docid)
                return

    # -------------------------------------------------------------- reads
    def get(self, doc_id: str) -> GetResult:
        """Realtime GET: a buffered doc is visible before any refresh."""
        with self._lock:
            vv = self._current(doc_id)
            if vv is None or vv.deleted:
                return GetResult(False, doc_id)
            if vv.buffer_idx >= 0:
                parsed = self._buffer[vv.buffer_idx][1]
                return GetResult(True, doc_id, json.loads(parsed.source),
                                 vv.version, vv.seq_no, vv.primary_term)
            for seg in self._segments:
                docid = seg.docid_for(doc_id)
                if docid >= 0:
                    return GetResult(True, doc_id,
                                     json.loads(seg.stored.source(docid)),
                                     vv.version, vv.seq_no, vv.primary_term)
            return GetResult(False, doc_id)

    def acquire_searcher(self) -> SearcherSnapshot:
        if self._deferred_segments:
            self._materialize_deferred()
        with self._lock:
            return SearcherSnapshot(self._segments, self._epoch)

    def _materialize_deferred(self) -> None:
        """Fetch the deferred segments' files through the node's
        materializer and publish them (the lazy-load moment of a mounted
        shard); an IOError when no materializer covers the shard."""
        fn = _find_materializer(self.path)
        with self._lock:
            names = list(self._deferred_segments)
        if not names:
            return
        loaded = []
        for name in names:
            if fn is None or not fn(self.path, name):
                raise IOError(
                    f"segment [{name}] is snapshot-backed but no "
                    f"repository materializer is registered")
            loaded.append(Segment.load(os.path.join(self.path, name)))
        with self._lock:
            if self._deferred_segments:
                self._segments = self._segments + loaded
                self._deferred_segments = []
                self._epoch += 1


    @property
    def segments(self) -> List[Segment]:
        with self._lock:
            return list(self._segments)

    @property
    def epoch(self) -> int:
        return self._epoch

    # ------------------------------------------------------ refresh/flush
    def _next_name(self) -> str:
        self._seg_counter += 1
        return f"{self.name}_{self._seg_counter}"

    def refresh(self) -> bool:
        """Apply the pending tombstones and publish the buffered docs as a
        new segment; True when a segment was published."""
        with self._lock:
            self._check_open()
            changed = False
            if self._pending_tombstones:
                for seg, docid in self._pending_tombstones.values():
                    seg.delete(docid)
                    self._dirty_segments.add(seg.name)
                self._pending_tombstones = {}
                changed = True
            if not self._buffer:
                if changed:
                    self._epoch += 1
                    self._maybe_merge()
                return False
            writer = SegmentWriter()
            kept_ids = []
            for idx, (doc_id, parsed) in enumerate(self._buffer):
                if idx not in self._buffer_dead:
                    writer.add(parsed)
                    kept_ids.append(doc_id)
            published = False
            if len(writer):
                seg = writer.build(self._next_name())
                self._segments = self._segments + [seg]
                self._dirty_segments.add(seg.name)
                published = True
            for doc_id in kept_ids:
                vv = self.version_map.get(doc_id)
                if vv is not None:
                    vv.buffer_idx = -1
            self._buffer = []
            self._buffer_dead = set()
            self._epoch += 1
            self._maybe_merge()
            return published

    def _maybe_merge(self) -> None:
        """Fold the smallest segments when more than ``merge_factor``
        accumulated."""
        if len(self._segments) <= self.merge_factor:
            return
        by_size = sorted(self._segments, key=lambda s: s.live_doc_count)
        self.force_merge_segments(
            by_size[: len(self._segments) - self.merge_factor + 1])

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Refresh, then merge every segment into one when there are more
        than ``max_num_segments``."""
        with self._lock:
            self.refresh()
            if len(self._segments) > max_num_segments:
                self.force_merge_segments(list(self._segments))

    def force_merge_segments(self, to_merge: List[Segment]) -> None:
        with self._lock:
            merged = merge_segments(self._next_name(), to_merge)
            gone = {id(s) for s in to_merge}
            # a merge of deleted docs only leaves no segment
            self._replace([s for s in self._segments if id(s) not in gone]
                          + ([merged] if merged.n_docs else []))

    def install_segments(self, segments: List[Segment]) -> None:
        """Replace the searchable segments with prebuilt ones: only the
        buffered docs keep their version-map entries, the installed docs
        read theirs from their segments."""
        with self._lock:
            self._check_open()
            self._pending_tombstones = {}
            self.version_map = {i: vv for i, vv in self.version_map.items()
                                if vv.buffer_idx >= 0}
            self._replace(list(segments))

    def _replace(self, segments: List[Segment]) -> None:
        kept = {id(s) for s in segments}
        retired = []
        for s in self._segments:
            if id(s) not in kept:
                s.retired = True
                retired.append(s.name)
        self._dirty_segments -= set(retired)
        self._dirty_segments |= {s.name for s in segments
                                 if not any(s is o for o in self._segments)}
        self._segments = segments
        self._epoch += 1
        if retired and self._on_retire is not None:
            self._on_retire(retired)

    def flush(self) -> None:
        """Refresh, save the changed segments, then the commit point and
        the translog's sync, roll and trim."""
        with self._lock:
            self._check_open()
            self.refresh()
            for seg in self._segments:
                if seg.name in self._dirty_segments:
                    seg.save(os.path.join(self.path, seg.name))
            self._dirty_segments = set()
            self.translog.sync()
            new_gen = self.translog.roll_generation()
            commit = {
                # still-deferred segments MUST stay in the commit:
                # dropping them would lose the mounted data at the next
                # open
                "segments": ([s.name for s in self._segments]
                             + list(self._deferred_segments)),
                "translog_generation": new_gen,
                "max_seq_no": self.tracker.max_seq_no,
                "local_checkpoint": self.tracker.checkpoint,
                "primary_term": self.primary_term,
                "seg_counter": self._seg_counter,
            }
            tmp = self._commit_path() + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(commit, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._commit_path())
            self.translog.trim_generations(new_gen)

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "docs": {"count": sum(s.live_doc_count
                                      for s in self._segments)
                         + len(self._buffer) - len(self._buffer_dead)
                         - len(self._pending_tombstones),
                         "deleted": sum(s.n_docs - s.live_doc_count
                                        for s in self._segments)},
                "segments": {"count": len(self._segments)},
                "translog": self.translog.stats(),
                "seq_no": {"max_seq_no": self.tracker.max_seq_no,
                           "local_checkpoint": self.tracker.checkpoint},
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self.translog.close()
