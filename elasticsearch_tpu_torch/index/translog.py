"""Translog: the per-shard write-ahead log (the port's copy of
elasticsearch_tpu/index/translog.py, byte for byte the same files;
Elasticsearch's index/translog/Translog.java): an append-only sequential op log in generation files with an
fsync'd checkpoint file; ops are replayed on recovery up to the last commit.
Generations roll on flush; `trim` drops generations below the last committed
one (retention beyond that is the soft-delete history's job).

Format: one op per line — length-prefixed JSON with a CRC32 trailer, so a
torn tail write is detected and truncated rather than corrupting recovery
(Translog's checksummed ops and TranslogCorruptedException).

Durability: ``add`` writes each op through to the operating system (a
``_bulk`` request's ops at once, at its end: ``write_batch``), so an
acknowledged op outlives the process, and only ``sync`` (which the
engine's ``flush`` calls) fsyncs the log and advances the checkpoint,
as the reference does. Elasticsearch's default
``index.translog.durability: request`` fsyncs before it acknowledges a
write; neither package does.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

from elasticsearch_tpu_torch.common.errors import TranslogCorruptedException

_HEADER = struct.Struct("<I")   # payload length
_TRAILER = struct.Struct("<I")  # crc32

# ``json.dumps(d, separators=(",", ":"))`` without an encoder a call
_ENCODE = json.JSONEncoder(separators=(",", ":")).encode

# the translogs this thread's ``add`` calls reached inside ``write_batch``
_batch = threading.local()


@contextlib.contextmanager
def write_batch():
    """One request's ops (a ``_bulk``): inside it this thread's ``add``
    calls leave their ops in the files' buffers, and at its end every
    translog they reached hands them to the operating system at once,
    before the request is answered. Nested batches join the outer one."""
    if getattr(_batch, "logs", None) is not None:
        yield
        return
    _batch.logs = {}
    try:
        yield
    finally:
        logs, _batch.logs = _batch.logs, None
        for log in logs.values():
            log.write_through()


@dataclass
class TranslogOp:
    op_type: str            # "index" | "delete" | "noop"
    seq_no: int
    primary_term: int
    doc_id: Optional[str] = None
    source: Optional[Dict[str, Any]] = None
    version: int = 1

    def to_dict(self) -> Dict[str, Any]:
        d = {"op": self.op_type, "seq_no": self.seq_no,
             "primary_term": self.primary_term, "version": self.version}
        if self.doc_id is not None:
            d["id"] = self.doc_id
        if self.source is not None:
            d["source"] = self.source
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TranslogOp":
        return cls(op_type=d["op"], seq_no=d["seq_no"],
                   primary_term=d["primary_term"], doc_id=d.get("id"),
                   source=d.get("source"), version=d.get("version", 1))


@dataclass
class Checkpoint:
    """The fsync'd pointer that makes the log crash-consistent
    (index/translog/Checkpoint.java)."""

    generation: int
    num_ops: int
    min_seq_no: int
    max_seq_no: int

    def write(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.__dict__, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)  # atomic on POSIX

    @classmethod
    def read(cls, path: str) -> "Checkpoint":
        with open(path) as fh:
            return cls(**json.load(fh))


class Translog:
    """Write path: add() appends to the current generation; sync() fsyncs
    and advances the checkpoint. rollGeneration() on flush."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        ckp_path = os.path.join(directory, "translog.ckp")
        if os.path.exists(ckp_path):
            ckp = Checkpoint.read(ckp_path)
            self.generation = ckp.generation
        else:
            self.generation = 1
            Checkpoint(1, 0, -1, -1).write(ckp_path)
        self._num_ops = 0
        self._min_seq = -1
        self._max_seq = -1
        self._fh = open(self._gen_path(self.generation), "ab")
        # restore counters from existing ops in the current generation
        for op in self._read_gen(self.generation):
            self._account(op)

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.log")

    def _ckp_path(self) -> str:
        return os.path.join(self.dir, "translog.ckp")

    def _account(self, op: TranslogOp):
        self._num_ops += 1
        if self._min_seq < 0 or op.seq_no < self._min_seq:
            self._min_seq = op.seq_no
        self._max_seq = max(self._max_seq, op.seq_no)

    def add(self, op: TranslogOp) -> None:
        """Append ``op`` and hand it to the operating system (no fsync),
        at once or, inside ``write_batch``, when the batch ends: an
        acknowledged op survives the process's death, not a power
        loss."""
        payload = _ENCODE(op.to_dict()).encode()
        record = b"".join((_HEADER.pack(len(payload)), payload,
                           _TRAILER.pack(zlib.crc32(payload))))
        batch = getattr(_batch, "logs", None)
        with self._lock:
            self._fh.write(record)
            if batch is None:
                self._fh.flush()
            self._account(op)
        if batch is not None:
            batch[id(self)] = self

    def write_through(self) -> None:
        """Hand the buffered ops to the operating system (no fsync)."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()

    def sync(self) -> None:
        """fsync data then checkpoint."""
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            Checkpoint(self.generation, self._num_ops,
                       self._min_seq, self._max_seq).write(self._ckp_path())

    def roll_generation(self) -> int:
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self.generation += 1
            self._num_ops = 0
            self._min_seq = -1
            self._max_seq = -1
            self._fh = open(self._gen_path(self.generation), "ab")
            Checkpoint(self.generation, 0, -1, -1).write(self._ckp_path())
            return self.generation

    def trim_generations(self, keep_from: int) -> None:
        """Delete generations below keep_from (called after commit)."""
        with self._lock:
            for gen in range(1, keep_from):
                p = self._gen_path(gen)
                if os.path.exists(p):
                    os.remove(p)

    def _read_gen(self, gen: int) -> Iterator[TranslogOp]:
        path = self._gen_path(gen)
        if not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos < len(data):
            if pos + _HEADER.size > len(data):
                break  # torn header → truncate
            (length,) = _HEADER.unpack_from(data, pos)
            end = pos + _HEADER.size + length + _TRAILER.size
            if end > len(data):
                break  # torn payload → truncate
            payload = data[pos + _HEADER.size : pos + _HEADER.size + length]
            (crc,) = _TRAILER.unpack_from(data, pos + _HEADER.size + length)
            if zlib.crc32(payload) != crc:
                raise TranslogCorruptedException(
                    f"translog corruption in generation {gen} at offset {pos}")
            yield TranslogOp.from_dict(json.loads(payload))
            pos = end

    def read_ops(self, from_generation: int = 1) -> List[TranslogOp]:
        """All ops from from_generation to current (recovery replay,
        InternalEngine.recoverFromTranslog)."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()  # make buffered appends visible to readers
        ops: List[TranslogOp] = []
        for gen in range(from_generation, self.generation + 1):
            ops.extend(self._read_gen(gen))
        return ops

    def stats(self) -> Dict[str, Any]:
        return {"operations": self._num_ops, "generation": self.generation}

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()
