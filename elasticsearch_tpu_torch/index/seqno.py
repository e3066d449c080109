"""Sequence numbers and checkpoints (the port's copy of
elasticsearch_tpu/index/seqno.py, Elasticsearch's index/seqno/
LocalCheckpointTracker.java and ReplicationTracker.java):
every operation gets a monotonically increasing sequence number; the local
checkpoint is the highest seqno below which *all* ops are processed; the
global checkpoint (multi-copy, in the replication layer) is the minimum
local checkpoint over in-sync copies. Retention leases keep history for
peer recovery.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set

NO_OPS_PERFORMED = -1
UNASSIGNED_SEQ_NO = -2


class LocalCheckpointTracker:
    """Tracks processed seqnos and computes the contiguous watermark."""

    def __init__(self, max_seq_no: int = NO_OPS_PERFORMED,
                 local_checkpoint: int = NO_OPS_PERFORMED):
        self._lock = threading.Lock()
        self._next_seq_no = max_seq_no + 1
        self._checkpoint = local_checkpoint
        self._processed: Set[int] = set()

    def generate_seq_no(self) -> int:
        with self._lock:
            seq = self._next_seq_no
            self._next_seq_no += 1
            return seq

    def advance_max_seq_no(self, seq_no: int) -> None:
        """On replicas: ops arrive with pre-assigned seqnos."""
        with self._lock:
            if seq_no >= self._next_seq_no:
                self._next_seq_no = seq_no + 1

    def mark_seq_no_as_processed(self, seq_no: int) -> None:
        with self._lock:
            if seq_no <= self._checkpoint:
                return
            self._processed.add(seq_no)
            while self._checkpoint + 1 in self._processed:
                self._checkpoint += 1
                self._processed.remove(self._checkpoint)

    @property
    def checkpoint(self) -> int:
        return self._checkpoint

    @property
    def max_seq_no(self) -> int:
        return self._next_seq_no - 1

    def contains(self, seq_no: int) -> bool:
        with self._lock:
            return seq_no <= self._checkpoint or seq_no in self._processed


@dataclass
class RetentionLease:
    """ref: index/seqno/RetentionLease.java — a named guarantee that ops
    >= retaining_seq_no stay replayable (peer-recovery leases etc.)."""

    id: str
    retaining_seq_no: int
    timestamp: float
    source: str


@dataclass
class CheckpointState:
    """Per-copy state on the primary (ref: ReplicationTracker.CheckpointState)."""

    local_checkpoint: int = UNASSIGNED_SEQ_NO
    global_checkpoint: int = UNASSIGNED_SEQ_NO
    in_sync: bool = False
    tracked: bool = False


class ReplicationTracker:
    """Primary-side tracker of all shard copies: computes the global
    checkpoint = min(local checkpoint over in-sync copies) and manages
    retention leases (ref: index/seqno/ReplicationTracker.java:616-638
    computeGlobalCheckpoint)."""

    def __init__(self, shard_allocation_id: str,
                 local_checkpoint: int = NO_OPS_PERFORMED,
                 clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        # lease timestamps come from an injectable clock so the cluster
        # runtime can pin them to the scheduler's (virtual) time and
        # seeded chaos runs replay identically
        self._clock = clock or time.time
        self.allocation_id = shard_allocation_id
        self._checkpoints: Dict[str, CheckpointState] = {
            shard_allocation_id: CheckpointState(
                local_checkpoint=local_checkpoint, in_sync=True, tracked=True)
        }
        self._global_checkpoint = local_checkpoint
        self._leases: Dict[str, RetentionLease] = {}
        self.primary_mode = True

    # -- copy management
    def init_tracking(self, allocation_id: str) -> None:
        with self._lock:
            self._checkpoints.setdefault(allocation_id, CheckpointState(tracked=True))
            self._checkpoints[allocation_id].tracked = True

    def mark_in_sync(self, allocation_id: str, local_checkpoint: int) -> None:
        with self._lock:
            st = self._checkpoints.setdefault(allocation_id, CheckpointState())
            st.local_checkpoint = max(st.local_checkpoint, local_checkpoint)
            st.in_sync = True
            st.tracked = True
            self._recompute()

    def remove_copy(self, allocation_id: str) -> None:
        with self._lock:
            if allocation_id != self.allocation_id:
                self._checkpoints.pop(allocation_id, None)
                self._recompute()

    def update_local_checkpoint(self, allocation_id: str, checkpoint: int) -> None:
        with self._lock:
            st = self._checkpoints.get(allocation_id)
            if st is None:
                return
            if checkpoint > st.local_checkpoint:
                st.local_checkpoint = checkpoint
                self._recompute()

    def _recompute(self) -> None:
        in_sync = [s.local_checkpoint for s in self._checkpoints.values() if s.in_sync]
        if in_sync:
            gc = min(in_sync)
            if gc > self._global_checkpoint:
                self._global_checkpoint = gc

    @property
    def global_checkpoint(self) -> int:
        return self._global_checkpoint

    def in_sync_ids(self) -> Set[str]:
        with self._lock:
            return {a for a, s in self._checkpoints.items() if s.in_sync}

    def is_tracked(self, allocation_id: str) -> bool:
        with self._lock:
            st = self._checkpoints.get(allocation_id)
            return st is not None and st.tracked

    def tracked_ids(self) -> Set[str]:
        with self._lock:
            return {a for a, s in self._checkpoints.items() if s.tracked}

    def in_sync_checkpoints(self) -> Dict[str, int]:
        """Snapshot of {allocation_id: local_checkpoint} over the in-sync
        set — the state a primary-relocation handoff ships so the target
        can seed its own tracker (ref: ReplicationTracker
        getPrimaryContext / activateWithPrimaryContext)."""
        with self._lock:
            return {a: s.local_checkpoint
                    for a, s in self._checkpoints.items() if s.in_sync}

    # -- retention leases (ref: ReplicationTracker.java:511)
    def add_retention_lease(self, lease_id: str, retaining_seq_no: int,
                            source: str) -> RetentionLease:
        with self._lock:
            lease = RetentionLease(lease_id, retaining_seq_no,
                                   self._clock(), source)
            self._leases[lease_id] = lease
            return lease

    def renew_retention_lease(self, lease_id: str, retaining_seq_no: int) -> None:
        with self._lock:
            lease = self._leases[lease_id]
            lease.retaining_seq_no = max(lease.retaining_seq_no, retaining_seq_no)
            lease.timestamp = self._clock()

    def remove_retention_lease(self, lease_id: str) -> None:
        with self._lock:
            self._leases.pop(lease_id, None)

    def get_retention_leases(self) -> Dict[str, RetentionLease]:
        with self._lock:
            return dict(self._leases)

    def min_retained_seq_no(self) -> int:
        """History below this can be discarded."""
        with self._lock:
            if not self._leases:
                return self._global_checkpoint + 1
            return min(l.retaining_seq_no for l in self._leases.values())
