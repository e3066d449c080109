"""Searchable snapshots: lazy blob-backed shard storage + local cache
(the port's copy of elasticsearch_tpu/xpack/searchable_snapshots.py).

The analogue of the reference's SearchableSnapshotDirectory (ref:
x-pack/plugin/searchable-snapshots/.../store/
SearchableSnapshotDirectory.java — a Lucene Directory whose file reads
fetch byte ranges from the repository on demand into a bounded local
cache, so a mounted index costs no local storage until queried).

Re-homed for this engine's storage model (whole-file npz segments, not
byte-range Lucene files):

- ``_mount`` writes the shard commit + a ``snapshot_store.json``
  manifest (repository, snapshot, per-segment blob names) but copies NO
  data files.
- Engine recovery defers any committed segment whose directory is
  missing when a manifest is present (index/engine.py); the first
  search pulls the segment's files through the :class:`BlobCache` and
  loads it — the lazy-materialization moment — and only then does the
  segment reach the card, as any segment does (search/context.py
  ``DeviceSegmentCache``). Mounted segments get fresh names, because
  names key the node's device cache.
- ``storage=shared_cache`` keeps the fetched files inside a BOUNDED
  node-level cache directory with LRU eviction (ref: the frozen tier's
  shared snapshot cache); ``storage=full_copy`` promotes fetched files
  to the shard directory permanently.
- `/_searchable_snapshots/stats` reports hits/misses/bytes fetched and
  evictions.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

MANIFEST = "snapshot_store.json"


class BlobCache:
    """Node-level bounded file cache (ref: the shared snapshot cache,
    xpack.searchable.snapshot.shared_cache.size)."""

    def __init__(self, cache_dir: str,
                 budget_bytes: int = 1024 * 1024 * 1024):
        self.dir = cache_dir
        self.budget = budget_bytes
        os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        # key -> (path, size); LRU order
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._size = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_fetched = 0
        # rebuild from a previous run's files
        for name in sorted(os.listdir(cache_dir)):
            p = os.path.join(cache_dir, name)
            if os.path.isfile(p):
                sz = os.path.getsize(p)
                self._entries[name] = (p, sz)
                self._size += sz

    @staticmethod
    def _key(repo: str, index: str, shard: str, blob: str) -> str:
        return f"{repo}~{index}~{shard}~{blob}".replace("/", "_")

    def get(self, repo: str, index: str, shard: str, blob: str,
            fetch) -> str:
        """Local path of the cached blob, fetching on miss."""
        key = self._key(repo, index, shard, blob)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[0]
        data = fetch()
        path = os.path.join(self.dir, key)
        tmp = f"{path}.tmp-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        with self._lock:
            self.misses += 1
            self.bytes_fetched += len(data)
            if key in self._entries:
                # lost a concurrent-miss race: the winner already
                # accounted the entry — don't double-count the size
                self._entries.move_to_end(key)
                return path
            self._entries[key] = (path, len(data))
            self._size += len(data)
            while self._size > self.budget and len(self._entries) > 1:
                old_key, (old_path, old_size) = \
                    self._entries.popitem(last=False)
                if old_key == key:
                    self._entries[key] = (path, len(data))
                    break
                self._size -= old_size
                self.evictions += 1
                try:
                    os.remove(old_path)
                except OSError:
                    pass
        return path

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"size_bytes": self._size,
                    "budget_bytes": self.budget,
                    "num_files": len(self._entries),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "bytes_fetched": self.bytes_fetched}


_caches: Dict[str, BlobCache] = {}
_caches_lock = threading.Lock()


def node_cache(data_path: str,
               budget_bytes: Optional[int] = None) -> BlobCache:
    with _caches_lock:
        cache = _caches.get(data_path)
        if cache is None:
            cache = _caches[data_path] = BlobCache(
                os.path.join(data_path, "_snapshot_cache"),
                budget_bytes or 1024 * 1024 * 1024)
        return cache


def write_manifest(shard_path: str, manifest: Dict[str, Any]) -> None:
    with open(os.path.join(shard_path, MANIFEST), "w") as f:
        json.dump(manifest, f)


def read_manifest(shard_path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(shard_path, MANIFEST)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def materialize_segment(shard_path: str, seg_name: str,
                        repositories_service, data_path: str) -> bool:
    """Fetch one deferred segment's files into its directory through the
    node cache. Returns False when no manifest covers it (a genuinely
    missing segment — caller decides how to fail)."""
    m = read_manifest(shard_path)
    if m is None:
        return False
    files = m["segments"].get(seg_name)
    if files is None:
        return False
    repo = repositories_service.get_repository(m["repository"])
    container = repo.blobstore.container(
        "indices", m["source_index"], str(m["shard"]))
    cache = node_cache(data_path)
    seg_dir = os.path.join(shard_path, seg_name)
    os.makedirs(seg_dir, exist_ok=True)
    for fname, blob in files.items():
        dest = os.path.join(seg_dir, fname)
        # a concurrent miss can LRU-evict the returned path before we
        # consume it — refetch once on a vanished file
        for attempt in (0, 1):
            local = cache.get(m["repository"], m["source_index"],
                              str(m["shard"]), blob,
                              lambda b=blob: container.read_blob(b))
            try:
                if fname == "meta.json":
                    # meta.json is REWRITTEN with the mount's segment
                    # name (device caches key on names node-wide) —
                    # always a private ATOMIC copy; a hard link would
                    # mutate the shared cache entry and
                    # cross-contaminate other mounts
                    with open(local) as fh:
                        meta = json.load(fh)
                    meta["name"] = seg_name
                    tmp = f"{dest}.tmp-{threading.get_ident()}"
                    with open(tmp, "w") as fh:
                        json.dump(meta, fh)
                    os.replace(tmp, dest)
                elif not os.path.exists(dest):
                    if m.get("storage") == "full_copy":
                        shutil.copyfile(local, dest)
                    else:
                        # shared_cache: hard-link the immutable data
                        # files so eviction of the cache entry leaves
                        # open readers intact while reclaiming space
                        # once the segment drops
                        try:
                            os.link(local, dest)
                        except OSError:
                            shutil.copyfile(local, dest)
                break
            except FileNotFoundError:
                if attempt:
                    raise
    return True


def mount(node, repo_name: str, snapshot: str, index: str,
          renamed: str, storage: str = "full_copy") -> Dict[str, Any]:
    """MountSearchableSnapshotAction (REST shape): create the index
    shell + manifests WITHOUT copying data files; segments stream in on
    first search."""
    return mount_services(node.repositories_service, node.indices,
                          repo_name, snapshot, index, renamed, storage)


def mount_services(repositories_service, indices_service, repo_name: str,
                   snapshot: str, index: str, renamed: str,
                   storage: str = "full_copy") -> Dict[str, Any]:
    import uuid as _uuid

    from elasticsearch_tpu_torch.common.errors import (
        IllegalArgumentException, ResourceAlreadyExistsException)

    repo = repositories_service.get_repository(repo_name)
    snap = repo.get_snapshot(snapshot)
    if index not in snap["indices"]:
        raise IllegalArgumentException(
            f"index [{index}] not found in snapshot [{snapshot}]")
    if renamed in indices_service:
        raise ResourceAlreadyExistsException(
            f"cannot mount as [{renamed}]: index already exists")
    idx_meta = snap["indices"][index]
    # the port's index-name rule (index/service.py index_path)
    index_path = indices_service.index_path(renamed)
    os.makedirs(index_path, exist_ok=True)
    with open(os.path.join(index_path, "_meta.json"), "w") as fh:
        json.dump({"settings": idx_meta["settings"],
                   "mappings": idx_meta["mappings"]}, fh)
    prefix = _uuid.uuid4().hex[:12]
    for shard_id, shard_meta in enumerate(idx_meta["shards"]):
        shard_path = os.path.join(index_path, str(shard_id))
        os.makedirs(shard_path, exist_ok=True)
        name_map = {s: f"{prefix}-m{i}"
                    for i, s in enumerate(shard_meta["segments"])}
        write_manifest(shard_path, {
            "repository": repo_name,
            "snapshot": snapshot,
            "source_index": index,
            "shard": shard_id,
            "storage": storage,
            "segments": {name_map[s]: files
                         for s, files in shard_meta["segments"].items()},
        })
        if shard_meta["commit"] is not None:
            commit = dict(shard_meta["commit"])
            commit["segments"] = [name_map[s] for s in commit["segments"]]
            commit["translog_generation"] = 1
            with open(os.path.join(shard_path, "segments.json"), "w") as fh:
                json.dump(commit, fh)
    indices_service.open_index(renamed)
    idx = indices_service.get(renamed)
    idx.update_settings({
        "index.blocks.write": True,
        "index.store.type": "snapshot",
        "index.store.snapshot.repository_name": repo_name,
        "index.store.snapshot.snapshot_name": snapshot,
        "index.store.snapshot.storage": storage,
    })
    return {"snapshot": {"snapshot": snapshot, "indices": [renamed],
                         "shards": {"total": idx.num_shards, "failed": 0,
                                    "successful": idx.num_shards}}}
