"""Snapshot repositories: content-addressed blob store + snapshot/restore
(the port's copy of elasticsearch_tpu/repositories/blobstore.py: the
same layout and files, so either package restores the other's
snapshots).

Mirrors Elasticsearch's snapshot stack (ref: repositories/blobstore/
BlobStoreRepository.java:154,648,996 — content-addressed blob layout,
incremental shard snapshots, generation-CAS'd repository metadata;
snapshots/SnapshotsService.java — create/get/delete/restore orchestration).

Layout under the repository location:

    index-N                  repository data generation N (JSON)
    index.latest             current generation number
    snap-{name}.json         per-snapshot metadata (indices, shard files)
    indices/{index}/{shard}/__{sha256}   content-addressed file blobs

Incrementality falls out of content addressing: a segment file already
uploaded by an earlier snapshot is referenced, not re-written (the
reference dedupes per shard generation the same way). Deleting a snapshot
garbage-collects blobs no longer referenced by any remaining snapshot.

Snapshots copy the *host-side* segment files (the rectangular block
arrays). Restore rebuilds the on-disk index under fresh segment names
and a fresh translog; device state uploads lazily on first search,
exactly like any segment load — no device state is ever part of a
snapshot.

Repository types: ``fs`` (a directory) and ``url`` (a read-only
``file:`` location). ``s3``, ``gcs``, ``azure`` and ``hdfs`` come with
the distributed and cloud slice of the port: a typed 400 until then.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, ResourceAlreadyExistsException, ResourceNotFoundException,
    WriteException)


class RepositoryException(WriteException):
    status = 500
    error_type = "repository_exception"


class SnapshotException(WriteException):
    status = 500
    error_type = "snapshot_exception"


class SnapshotMissingException(WriteException):
    status = 404
    error_type = "snapshot_missing_exception"


class ConcurrentSnapshotExecutionException(WriteException):
    status = 503
    error_type = "concurrent_snapshot_execution_exception"


class RepositoryTypeUnsupported(WriteException):
    """A repository type of a later slice of the port (a typed 400)."""

    status = 400
    error_type = "unsupported_in_slice_exception"


# the repository types of the distributed and cloud slice
LATER_SLICE_TYPES = ("s3", "gcs", "azure", "hdfs")


# ---------------------------------------------------------------------------
# Blob store
# ---------------------------------------------------------------------------

class FsBlobContainer:
    """ref: common/blobstore/fs/FsBlobContainer — one directory of blobs."""

    def __init__(self, path: str):
        self.path = path

    def _ensure(self):
        os.makedirs(self.path, exist_ok=True)

    def write_blob(self, name: str, data: bytes,
                   fail_if_exists: bool = False) -> None:
        self._ensure()
        target = os.path.join(self.path, name)
        if fail_if_exists and os.path.exists(target):
            raise RepositoryException(f"blob [{name}] already exists")
        tmp = target + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)

    def read_blob(self, name: str) -> bytes:
        target = os.path.join(self.path, name)
        if not os.path.exists(target):
            raise ResourceNotFoundException(f"blob [{name}] not found")
        with open(target, "rb") as fh:
            return fh.read()

    def blob_exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, name))

    def list_blobs(self) -> List[str]:
        if not os.path.isdir(self.path):
            return []
        return sorted(n for n in os.listdir(self.path)
                      if not n.endswith(".tmp") and ".tmp-" not in n)

    def delete_blob(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.path, name))
        except FileNotFoundError:
            pass


class FsBlobStore:
    """ref: FsBlobStore — containers are nested directories."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def container(self, *parts: str) -> FsBlobContainer:
        return FsBlobContainer(os.path.join(self.root, *parts))


# ---------------------------------------------------------------------------
# Repository
# ---------------------------------------------------------------------------

SHARD_FILES = ("meta.json", "arrays.npz", "stored.bin")


class BlobStoreRepository:
    """One registered snapshot repository over a blob store (the
    filesystem's by default): everything above the container interface
    (snapshot format, CAS generations, restore) is backend-agnostic,
    Elasticsearch's BlobStoreRepository/BlobContainer split."""

    def __init__(self, name: str, location: str, readonly: bool = False,
                 blobstore=None):
        self.name = name
        self.location = location
        self.readonly = readonly
        self.blobstore = blobstore or FsBlobStore(location)
        self.root = self.blobstore.container()
        self._lock = threading.Lock()

    # ------------------------------------------------------ repository data
    def _latest_gen(self) -> int:
        if self.root.blob_exists("index.latest"):
            return int(self.root.read_blob("index.latest").decode())
        return -1

    def load_repository_data(self) -> Dict[str, Any]:
        gen = self._latest_gen()
        if gen < 0:
            return {"gen": -1, "snapshots": {}}
        data = json.loads(self.root.read_blob(f"index-{gen}").decode())
        data["gen"] = gen
        return data

    def _write_repository_data(self, data: Dict[str, Any],
                               expected_gen: int) -> None:
        """Generation CAS (ref: BlobStoreRepository.writeIndexGen:996):
        refuse if another writer bumped the generation underneath us."""
        current = self._latest_gen()
        if current != expected_gen:
            raise ConcurrentSnapshotExecutionException(
                f"repository [{self.name}] generation [{current}] != "
                f"expected [{expected_gen}]")
        new_gen = expected_gen + 1
        payload = {k: v for k, v in data.items() if k != "gen"}
        self.root.write_blob(f"index-{new_gen}",
                             json.dumps(payload).encode(),
                             fail_if_exists=True)
        self.root.write_blob("index.latest", str(new_gen).encode())
        if expected_gen >= 0:
            self.root.delete_blob(f"index-{expected_gen}")

    # ------------------------------------------------------------ snapshot
    def snapshot(self, snapshot_name: str, indices,
                 include_global_state: bool = True,
                 metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Snapshot the given IndexService list. Each shard is flushed
        first so its on-disk commit is the snapshot source."""
        if self.readonly:
            raise RepositoryException(
                f"repository [{self.name}] is readonly")
        with self._lock:
            repo_data = self.load_repository_data()
            if snapshot_name in repo_data["snapshots"]:
                raise ResourceAlreadyExistsException(
                    f"snapshot [{snapshot_name}] already exists")
            start_ms = int(time.time() * 1000)
            snap_uuid = uuid.uuid4().hex[:20]
            snap_indices: Dict[str, Any] = {}
            total_files = 0
            for idx in indices:
                idx.flush()
                shards = []
                for shard_id, engine in enumerate(idx.shards):
                    container = self.blobstore.container(
                        "indices", idx.name, str(shard_id))
                    shard_meta = {"segments": {}, "commit": None,
                                  "total_bytes": 0, "uploaded_bytes": 0,
                                  "skipped_bytes": 0}
                    commit_path = os.path.join(engine.path, "segments.json")
                    if os.path.exists(commit_path):
                        with open(commit_path) as fh:
                            shard_meta["commit"] = json.load(fh)
                    for seg_name in (shard_meta["commit"] or {}).get(
                            "segments", []):
                        seg_dir = os.path.join(engine.path, seg_name)
                        files = {}
                        for fname in SHARD_FILES:
                            fpath = os.path.join(seg_dir, fname)
                            if not os.path.exists(fpath):
                                continue
                            with open(fpath, "rb") as fh:
                                content = fh.read()
                            digest = hashlib.sha256(content).hexdigest()
                            blob = f"__{digest}"
                            shard_meta["total_bytes"] += len(content)
                            if not container.blob_exists(blob):
                                container.write_blob(blob, content)
                                total_files += 1
                                shard_meta["uploaded_bytes"] += len(content)
                            else:
                                shard_meta["skipped_bytes"] += len(content)
                            files[fname] = blob
                        shard_meta["segments"][seg_name] = files
                    shards.append(shard_meta)
                meta = idx.meta_dict()
                snap_indices[idx.name] = {
                    "settings": meta["settings"],
                    "mappings": meta["mappings"],
                    "shards": shards,
                }
            info = {
                "snapshot": snapshot_name,
                "uuid": snap_uuid,
                "state": "SUCCESS",
                "indices": sorted(snap_indices),
                "include_global_state": include_global_state,
                "start_time_in_millis": start_ms,
                "end_time_in_millis": int(time.time() * 1000),
                "metadata": metadata or {},
                "shards": {"total": sum(len(v["shards"])
                                        for v in snap_indices.values()),
                           "failed": 0,
                           "successful": sum(len(v["shards"])
                                             for v in snap_indices.values())},
            }
            self.root.write_blob(
                f"snap-{snapshot_name}.json",
                json.dumps({"info": info, "indices": snap_indices}).encode())
            repo_data["snapshots"][snapshot_name] = {
                "uuid": snap_uuid, "state": "SUCCESS",
                "indices": info["indices"],
                "start_time_in_millis": start_ms,
            }
            self._write_repository_data(repo_data, repo_data["gen"])
            return info

    # ---------------------------------------------- cluster snapshot plane
    #
    # The distributed snapshot path (snapshots/cluster.py) drives these
    # primitives instead of ``snapshot()``: each primary uploads its own
    # shard files (content-addressed, incremental), the master merges the
    # reported shard metadata and commits it in one CAS'd generation bump.
    # Until ``finalize_snapshot`` runs, nothing references the uploaded
    # blobs, so an aborted snapshot leaves the repository readable at its
    # prior generation and ``delete_shard_blobs`` reclaims the partials.

    def shard_container(self, index_name: str,
                        shard_id: int) -> FsBlobContainer:
        return self.blobstore.container("indices", index_name, str(shard_id))

    def upload_shard_blob(self, index_name: str, shard_id: int,
                          content: bytes) -> Dict[str, Any]:
        """Content-addressed single-blob upload. Returns the blob name
        plus whether bytes actually moved (False = incremental skip)."""
        if self.readonly:
            raise RepositoryException(
                f"repository [{self.name}] is readonly")
        container = self.shard_container(index_name, shard_id)
        blob = f"__{hashlib.sha256(content).hexdigest()}"
        if container.blob_exists(blob):
            return {"blob": blob, "uploaded": False, "size": len(content)}
        container.write_blob(blob, content)
        return {"blob": blob, "uploaded": True, "size": len(content)}

    def delete_shard_blobs(self, index_name: str, shard_id: int,
                           blob_names) -> int:
        """Abort cleanup: drop blobs a cancelled/failed shard snapshot
        uploaded. Only ever called pre-finalize, so the named blobs are
        unreferenced by construction."""
        container = self.shard_container(index_name, shard_id)
        dropped = 0
        for blob in sorted(set(blob_names)):
            if container.blob_exists(blob):
                container.delete_blob(blob)
                dropped += 1
        return dropped

    def finalize_snapshot(self, snapshot_name: str, snap_uuid: str,
                          snap_indices: Dict[str, Any], *,
                          include_global_state: bool = True,
                          metadata: Optional[Dict[str, Any]] = None,
                          start_ms: int = 0, end_ms: int = 0,
                          state: str = "SUCCESS",
                          shard_stats: Optional[Dict[str, int]] = None,
                          ) -> Dict[str, Any]:
        """Commit a cluster snapshot: write ``snap-{name}.json`` then CAS
        the repository generation. Timestamps come from the caller's
        scheduler clock — this layer never reads a wall clock for the
        cluster plane."""
        if self.readonly:
            raise RepositoryException(
                f"repository [{self.name}] is readonly")
        with self._lock:
            repo_data = self.load_repository_data()
            if snapshot_name in repo_data["snapshots"]:
                raise ResourceAlreadyExistsException(
                    f"snapshot [{snapshot_name}] already exists")
            n_shards = sum(len(v["shards"]) for v in snap_indices.values())
            stats = shard_stats or {}
            info = {
                "snapshot": snapshot_name,
                "uuid": snap_uuid,
                "state": state,
                "indices": sorted(snap_indices),
                "include_global_state": include_global_state,
                "start_time_in_millis": int(start_ms),
                "end_time_in_millis": int(end_ms),
                "metadata": metadata or {},
                "shards": {"total": n_shards,
                           "failed": int(stats.get("failed", 0)),
                           "successful": n_shards - int(
                               stats.get("failed", 0))},
            }
            self.root.write_blob(
                f"snap-{snapshot_name}.json",
                json.dumps({"info": info, "indices": snap_indices}).encode())
            repo_data["snapshots"][snapshot_name] = {
                "uuid": snap_uuid, "state": state,
                "indices": info["indices"],
                "start_time_in_millis": int(start_ms),
                "end_time_in_millis": int(end_ms),
            }
            self._write_repository_data(repo_data, repo_data["gen"])
            return info

    def snapshot_status(self, snapshot_name: str) -> Dict[str, Any]:
        """Per-shard byte/file accounting for a COMPLETED snapshot
        (``GET /_snapshot/{repo}/{snap}/_status``); in-flight status is
        served from the master's in-progress registry instead."""
        snap = self.get_snapshot(snapshot_name)
        indices: Dict[str, Any] = {}
        totals = {"total_bytes": 0, "uploaded_bytes": 0,
                  "skipped_bytes": 0, "file_count": 0}
        for index_name in sorted(snap["indices"]):
            idx_meta = snap["indices"][index_name]
            shards = {}
            for shard_id, shard_meta in enumerate(idx_meta["shards"]):
                row = {
                    "stage": "DONE",
                    "file_count": sum(len(files) for files in
                                      shard_meta["segments"].values()),
                    "total_bytes": int(shard_meta.get("total_bytes", 0)),
                    "uploaded_bytes": int(
                        shard_meta.get("uploaded_bytes", 0)),
                    "skipped_bytes": int(shard_meta.get("skipped_bytes", 0)),
                    "translog_ops": int(
                        (shard_meta.get("translog") or {}).get("ops", 0)),
                }
                shards[str(shard_id)] = row
                for k in totals:
                    totals[k] += row.get(k, 0)
            indices[index_name] = {"shards": shards}
        return {"snapshot": snapshot_name,
                "uuid": snap["info"].get("uuid"),
                "state": snap["info"].get("state", "SUCCESS"),
                "stats": totals,
                "indices": indices}

    def verify_integrity(self) -> List[Dict[str, str]]:
        """Repository self-check feeding the ``repository_integrity``
        health indicator. Returns sorted problem rows (empty = healthy):
        generation pointer/metadata mismatches and missing referenced
        blobs, each typed for the indicator's diagnosis."""
        problems: List[Dict[str, str]] = []
        gen = self._latest_gen()
        if gen < 0:
            return problems  # empty repo is healthy
        if not self.root.blob_exists(f"index-{gen}"):
            return [{"kind": "generation_mismatch",
                     "resource": f"index-{gen}",
                     "detail": "index.latest points at a missing "
                               "generation blob"}]
        try:
            repo_data = self.load_repository_data()
        except Exception as exc:  # noqa: BLE001 — diagnostic surface
            return [{"kind": "corrupted_metadata",
                     "resource": f"index-{gen}",
                     "detail": f"unreadable repository data: {exc}"}]
        for snap_name in sorted(repo_data["snapshots"]):
            try:
                snap = self.get_snapshot(snap_name)
            except Exception as exc:  # noqa: BLE001 — diagnostic surface
                problems.append({"kind": "corrupted_blob",
                                 "resource": f"snap-{snap_name}.json",
                                 "detail": str(exc)})
                continue
            for index_name in sorted(snap["indices"]):
                idx_meta = snap["indices"][index_name]
                for shard_id, shard_meta in enumerate(idx_meta["shards"]):
                    container = self.shard_container(index_name, shard_id)
                    refs = set()
                    for files in shard_meta["segments"].values():
                        refs.update(files.values())
                    tl = shard_meta.get("translog") or {}
                    if tl.get("blob"):
                        refs.add(tl["blob"])
                    for blob in sorted(refs):
                        if not container.blob_exists(blob):
                            problems.append({
                                "kind": "missing_blob",
                                "resource": (f"{snap_name}/{index_name}/"
                                             f"{shard_id}/{blob}"),
                                "detail": "referenced blob absent from "
                                          "shard container"})
        return sorted(problems,
                      key=lambda p: (p["kind"], p["resource"]))

    def get_snapshot(self, snapshot_name: str) -> Dict[str, Any]:
        if not self.root.blob_exists(f"snap-{snapshot_name}.json"):
            raise SnapshotMissingException(
                f"[{self.name}:{snapshot_name}] is missing")
        return json.loads(
            self.root.read_blob(f"snap-{snapshot_name}.json").decode())

    def list_snapshots(self) -> List[Dict[str, Any]]:
        data = self.load_repository_data()
        return [self.get_snapshot(n)["info"]
                for n in sorted(data["snapshots"])]

    # -------------------------------------------------------------- delete
    def delete_snapshot(self, snapshot_name: str) -> None:
        if self.readonly:
            raise RepositoryException(f"repository [{self.name}] is readonly")
        with self._lock:
            repo_data = self.load_repository_data()
            if snapshot_name not in repo_data["snapshots"]:
                raise SnapshotMissingException(
                    f"[{self.name}:{snapshot_name}] is missing")
            del repo_data["snapshots"][snapshot_name]
            self._write_repository_data(repo_data, repo_data["gen"])
            self.root.delete_blob(f"snap-{snapshot_name}.json")
            self._gc_blobs(repo_data)

    def _gc_blobs(self, repo_data: Dict[str, Any]) -> None:
        """Remove blobs unreferenced by any remaining snapshot (ref:
        BlobStoreRepository cleanup of stale shard blobs)."""
        referenced: Dict[str, set] = {}
        for snap_name in repo_data["snapshots"]:
            snap = self.get_snapshot(snap_name)
            for index_name, idx_meta in snap["indices"].items():
                for shard_id, shard_meta in enumerate(idx_meta["shards"]):
                    key = f"{index_name}/{shard_id}"
                    refs = referenced.setdefault(key, set())
                    for files in shard_meta["segments"].values():
                        refs.update(files.values())
                    # cluster snapshots pin a translog-ops blob per shard
                    tl = shard_meta.get("translog") or {}
                    if tl.get("blob"):
                        refs.add(tl["blob"])
        indices_dir = os.path.join(self.location, "indices")
        if not os.path.isdir(indices_dir):
            return
        for index_name in os.listdir(indices_dir):
            idx_dir = os.path.join(indices_dir, index_name)
            for shard_id in (os.listdir(idx_dir)
                             if os.path.isdir(idx_dir) else []):
                key = f"{index_name}/{shard_id}"
                container = self.blobstore.container(
                    "indices", index_name, shard_id)
                refs = referenced.get(key, set())
                for blob in container.list_blobs():
                    if blob.startswith("__") and blob not in refs:
                        container.delete_blob(blob)
            # drop empty dirs
            if not referenced.get(f"{index_name}/0"):
                if all(not referenced.get(f"{index_name}/{s}")
                       for s in os.listdir(idx_dir)):
                    shutil.rmtree(idx_dir, ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(self, snapshot_name: str, indices_service,
                indices: Optional[List[str]] = None,
                rename_pattern: Optional[str] = None,
                rename_replacement: Optional[str] = None) -> Dict[str, Any]:
        """ref: snapshots/RestoreService — rebuild index files from blobs,
        then open the index."""
        import re
        snap = self.get_snapshot(snapshot_name)
        restored = []
        targets = snap["indices"]
        if indices:
            wanted = set(indices)
            targets = {n: m for n, m in targets.items() if n in wanted}
            missing = wanted - set(targets)
            if missing:
                raise IllegalArgumentException(
                    f"indices {sorted(missing)} not found in snapshot "
                    f"[{snapshot_name}]")
        for index_name, idx_meta in targets.items():
            target_name = index_name
            if rename_pattern and rename_replacement is not None:
                target_name = re.sub(rename_pattern, rename_replacement,
                                     index_name)
            if target_name in indices_service:
                raise ResourceAlreadyExistsException(
                    f"cannot restore index [{target_name}]: already exists")
            # the port's index-name rule (index/service.py index_path): a
            # name outside it is a 400 invalid_index_name_exception
            index_path = indices_service.index_path(target_name)
            os.makedirs(index_path, exist_ok=True)
            with open(os.path.join(index_path, "_meta.json"), "w") as fh:
                json.dump({"settings": idx_meta["settings"],
                           "mappings": idx_meta["mappings"]}, fh)
            for shard_id, shard_meta in enumerate(idx_meta["shards"]):
                shard_path = os.path.join(index_path, str(shard_id))
                os.makedirs(shard_path, exist_ok=True)
                container = self.blobstore.container(
                    "indices", index_name, str(shard_id))
                # restored segments get FRESH names: segment names key the
                # node-wide device cache, so restoring beside a live copy
                # of the source index must not alias its device state
                restore_prefix = uuid.uuid4().hex[:12]
                name_map: Dict[str, str] = {}
                for i, (seg_name, files) in enumerate(
                        shard_meta["segments"].items()):
                    new_name = f"{restore_prefix}-r{i}"
                    name_map[seg_name] = new_name
                    seg_dir = os.path.join(shard_path, new_name)
                    os.makedirs(seg_dir, exist_ok=True)
                    for fname, blob in files.items():
                        content = container.read_blob(blob)
                        if fname == "meta.json":
                            meta = json.loads(content.decode())
                            meta["name"] = new_name
                            content = json.dumps(meta).encode()
                        with open(os.path.join(seg_dir, fname), "wb") as fh:
                            fh.write(content)
                if shard_meta["commit"] is not None:
                    commit = dict(shard_meta["commit"])
                    commit["segments"] = [name_map[s]
                                          for s in commit["segments"]]
                    # the restored shard starts a FRESH translog at gen 1;
                    # carrying the source's generation would make recovery
                    # skip post-restore writes (acked-write loss)
                    commit["translog_generation"] = 1
                    with open(os.path.join(shard_path, "segments.json"),
                              "w") as fh:
                        json.dump(commit, fh)
            indices_service.open_index(target_name)
            restored.append(target_name)
        return {"snapshot": {"snapshot": snapshot_name,
                             "indices": restored,
                             "shards": {"total": len(restored),
                                        "failed": 0,
                                        "successful": len(restored)}}}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class RepositoriesService:
    """ref: repositories/RepositoriesService — registry, persisted locally
    in ``_repositories.json`` under the data path (Elasticsearch keeps it
    in cluster state)."""

    def __init__(self, data_path: Optional[str] = None):
        self._repos: Dict[str, BlobStoreRepository] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._data_path = data_path
        self._path = (os.path.join(data_path, "_repositories.json")
                      if data_path else None)
        if data_path:
            os.makedirs(data_path, exist_ok=True)
        if self._path and os.path.exists(self._path):
            with open(self._path) as fh:
                for name, cfg in json.load(fh).items():
                    self._register(name, cfg)

    def _register(self, name: str, config: Dict[str, Any]):
        rtype = config.get("type")
        settings = config.get("settings", {})
        if rtype in LATER_SLICE_TYPES:
            raise RepositoryTypeUnsupported(
                f"repository type [{rtype}] comes with the distributed and "
                f"cloud slice of the port (this one serves [fs] and [url])")
        if rtype not in ("fs", "url"):
            raise RepositoryException(
                f"repository type [{rtype}] does not exist")
        location = settings.get("location") or settings.get("url")
        if not location:
            raise IllegalArgumentException(
                "[location] is not set for repository")
        if location.startswith("file:"):
            location = location[len("file:"):].lstrip("/")
            location = "/" + location
        if not os.path.isabs(location) and self._data_path:
            # relative locations resolve under the node's repo root, not
            # the process CWD (ref: path.repo resolution in Environment)
            location = os.path.join(self._data_path, "repos", location)
        self._repos[name] = BlobStoreRepository(
            name, location, readonly=(rtype == "url"
                                      or settings.get("readonly", False)))
        self._configs[name] = config

    def put_repository(self, name: str, config: Dict[str, Any]):
        self._register(name, config)
        self._persist()

    def get_repository(self, name: str) -> BlobStoreRepository:
        repo = self._repos.get(name)
        if repo is None:
            raise ResourceNotFoundException(
                f"[{name}] missing")
        return repo

    def get_configs(self, name: Optional[str] = None) -> Dict[str, Any]:
        if name is None or name in ("_all", "*"):
            return dict(self._configs)
        if name not in self._configs:
            raise ResourceNotFoundException(f"[{name}] missing")
        return {name: self._configs[name]}

    def delete_repository(self, name: str):
        if name not in self._repos:
            raise ResourceNotFoundException(f"[{name}] missing")
        del self._repos[name]
        del self._configs[name]
        self._persist()

    def _persist(self):
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._configs, fh)
            os.replace(tmp, self._path)
