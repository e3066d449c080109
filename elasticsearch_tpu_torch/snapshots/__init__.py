from elasticsearch_tpu_torch.snapshots.slm import SnapshotLifecycleService

__all__ = ["SnapshotLifecycleService"]
