from elasticsearch_tpu_torch.repositories.blobstore import (
    BlobStoreRepository, ConcurrentSnapshotExecutionException,
    FsBlobContainer, FsBlobStore, RepositoriesService, RepositoryException,
    SnapshotException, SnapshotMissingException)

__all__ = ["BlobStoreRepository", "ConcurrentSnapshotExecutionException",
           "FsBlobContainer", "FsBlobStore", "RepositoriesService",
           "RepositoryException", "SnapshotException",
           "SnapshotMissingException"]
