"""Indexing pressure: in-flight-byte admission control for the write path
(the port's copy of elasticsearch_tpu/index/pressure.py, Elasticsearch's
index/IndexingPressure.java).

Every bulk charges its payload bytes at each stage it passes through:
coordinating (the node that fans out), primary (the node executing the
shard bulk), replica (each in-sync copy applying pre-seqno'd ops), and
releases them when that stage completes. Past the configured limit the
operation is rejected with a retryable 429
(``EsRejectedExecutionException``) BEFORE any shard work happens. A node
of the port is one primary, so `_bulk` charges the coordinating stage
only, as the reference's single node does (rest/api.py ``_bulk``).

- coordinating + primary share one budget (``limit``); a replica gets
  1.5x headroom (``replica_limit``) so replication is shed last.
- rejection counters are per stage and cumulative; current bytes return
  to zero when every in-flight operation has released.
- the stats shape follows ``GET /_nodes/stats``'s ``indexing_pressure``
  section.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from elasticsearch_tpu_torch.common.errors import EsRejectedExecutionException
from elasticsearch_tpu_torch.common.settings import parse_byte_size

# default in-flight-bytes budget (Elasticsearch defaults to 10% of heap;
# a fixed, generous default keeps the unconfigured path unthrottled)
DEFAULT_LIMIT_BYTES = 64 * 1024 * 1024
LIMIT_SETTING = "indexing_pressure.memory.limit"

COORDINATING = "coordinating"
PRIMARY = "primary"
REPLICA = "replica"


class IndexingPressure:
    """Per-node in-flight indexing byte accounting (threadsafe)."""

    @classmethod
    def from_settings(cls, settings_get) -> "IndexingPressure":
        """Build from node settings (`indexing_pressure.memory.limit`);
        an explicit 0 is honored, not replaced by the default."""
        raw = settings_get(LIMIT_SETTING)
        limit = (parse_byte_size(raw, LIMIT_SETTING)
                 if raw is not None else DEFAULT_LIMIT_BYTES)
        return cls(limit)

    def __init__(self, limit_bytes: int = DEFAULT_LIMIT_BYTES):
        self.limit = int(limit_bytes)
        self._lock = threading.Lock()
        self._current = {COORDINATING: 0, PRIMARY: 0, REPLICA: 0}
        self._total = {COORDINATING: 0, PRIMARY: 0, REPLICA: 0}
        self._rejections = {COORDINATING: 0, PRIMARY: 0, REPLICA: 0}
        self._peak_all = 0

    @property
    def replica_limit(self) -> int:
        return int(self.limit * 1.5) if self.limit >= 0 else -1

    # ------------------------------------------------------------- marks

    def mark_coordinating_operation_started(
            self, n_bytes: int, label: str = "bulk"
    ) -> Callable[[], None]:
        return self._mark(COORDINATING, n_bytes, label)

    def mark_primary_operation_started(
            self, n_bytes: int, label: str = "bulk[s][p]"
    ) -> Callable[[], None]:
        return self._mark(PRIMARY, n_bytes, label)

    def mark_replica_operation_started(
            self, n_bytes: int, label: str = "bulk[s][r]"
    ) -> Callable[[], None]:
        return self._mark(REPLICA, n_bytes, label)

    def _mark(self, stage: str, n_bytes: int,
              label: str) -> Callable[[], None]:
        n_bytes = int(n_bytes)
        with self._lock:
            # coordinating + primary share the base budget; replica ops
            # get the 1.5x headroom. All stages' bytes count toward the
            # admission total.
            limit = self.replica_limit if stage == REPLICA else self.limit
            would = sum(self._current.values()) + n_bytes
            if 0 <= limit < would:
                self._rejections[stage] += 1
                raise EsRejectedExecutionException(
                    f"rejecting operation [{label}] at {stage} stage: "
                    f"in-flight indexing bytes [{would}] would exceed "
                    f"the limit of [{limit}] "
                    f"({LIMIT_SETTING}={self.limit})",
                    bytes_wanted=would, bytes_limit=limit)
            self._current[stage] += n_bytes
            self._total[stage] += n_bytes
            self._peak_all = max(self._peak_all,
                                 sum(self._current.values()))
        released = {"done": False}

        def release() -> None:
            if released["done"]:
                return
            released["done"] = True
            with self._lock:
                self._current[stage] -= n_bytes

        return release

    # ------------------------------------------------------------- stats

    def current_bytes(self, stage: Optional[str] = None) -> int:
        with self._lock:
            if stage is None:
                return sum(self._current.values())
            return self._current[stage]

    def rejections(self, stage: str) -> int:
        with self._lock:
            return self._rejections[stage]

    @property
    def peak_all_bytes(self) -> int:
        with self._lock:
            return self._peak_all

    def stats(self) -> Dict[str, Any]:
        """The ``indexing_pressure`` section of ``GET /_nodes/stats``."""
        with self._lock:
            cur = dict(self._current)
            tot = dict(self._total)
            rej = dict(self._rejections)
            peak = self._peak_all
        return {"memory": {
            "current": {
                "combined_coordinating_and_primary_in_bytes":
                    cur[COORDINATING] + cur[PRIMARY],
                "coordinating_in_bytes": cur[COORDINATING],
                "primary_in_bytes": cur[PRIMARY],
                "replica_in_bytes": cur[REPLICA],
                "all_in_bytes": sum(cur.values()),
            },
            "total": {
                "combined_coordinating_and_primary_in_bytes":
                    tot[COORDINATING] + tot[PRIMARY],
                "coordinating_in_bytes": tot[COORDINATING],
                "primary_in_bytes": tot[PRIMARY],
                "replica_in_bytes": tot[REPLICA],
                "all_in_bytes": sum(tot.values()),
                "peak_all_in_bytes": peak,
                "coordinating_rejections": rej[COORDINATING],
                "primary_rejections": rej[PRIMARY],
                "replica_rejections": rej[REPLICA],
            },
            "limit_in_bytes": self.limit,
        }}
