"""Node health and diagnostics (the port's copy of
elasticsearch_tpu/health/, Elasticsearch's ``org.elasticsearch.health``).

Three pieces:

- **indicator framework** (`indicator.py`, `indicators.py`): pluggable
  ``HealthIndicator``s rendering green/yellow/red with typed diagnosis
  and impacts, served at ``GET /_health_report``;
- **service + fan-out merge** (`service.py`): per-node local reports
  composed cluster-wide via ``cluster:monitor/health_report[n]``;
- **stalled-progress watchdog** (`watchdog.py`): detects recoveries,
  tasks, and followers that stopped making progress.

Everything runs on the injected clock (the node's metrics clock) and
renders sorted, uuid-free output. One node has no cluster state: its
``shards_availability`` is green by construction and
``node_shutdown`` green with no markers.
"""

from elasticsearch_tpu_torch.health.indicator import (  # noqa: F401
    Diagnosis,
    HealthContext,
    HealthIndicator,
    HealthIndicatorResult,
    HealthStatus,
    Impact,
)
from elasticsearch_tpu_torch.health.indicators import (  # noqa: F401
    DEFAULT_INDICATORS,
    NodeShutdownIndicator,
    RepositoryIntegrityIndicator,
    shard_availability_summary,
)
from elasticsearch_tpu_torch.health.service import (  # noqa: F401
    HealthService,
    UnknownIndicatorError,
    merge_node_reports,
)
from elasticsearch_tpu_torch.health.watchdog import (  # noqa: F401
    StalledProgressWatchdog,
)
