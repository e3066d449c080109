"""Index and indices services (counterpart of
elasticsearch_tpu/index/service.py): an index is N shard engines on a
path, and the node's indices live under one data path and resolve from
an index expression.

An index's directory holds ``_meta.json`` (its flat settings, with
``index.creation_date``, and its mappings; rewritten when a mapping
update or dynamic mapping grows them) and one directory a shard
(index/engine.py: the shard's segments, its commit point and its
translog). ``IndicesService(data_path)`` reopens every index found
under the path, the reference's data paths included.

A document routes to shard ``abs(murmur3(routing or id)) % N`` (the
reference's ``shard_for``, Elasticsearch's OperationRouting), where the
hash is the 32-bit murmur3 over the key's UTF-16LE bytes
(index/mapper.py ``murmur3_hash``). A join child without an explicit
routing routes by its parent's id, so it lands on its parent's shard and
``has_child``/``has_parent`` join within a shard. Every shard scores
with its own statistics (search/service.py ``_shard_searchers``: one
ShardSearcher a shard); ``dfs_query_then_fetch`` swaps in the
statistics of every shard of the request for that request.

A shard engine names its segments ``{index}[{shard}]_{n}``, so the
node's device cache, which keys on segment names, holds every shard's
segments apart.

An index's analyzers come from its settings (analysis/analyzers.py
``AnalysisRegistry``, built once when the index opens, as the
reference's MapperService builds it): a mapping update keeps them, and a
settings update reaches them when the index opens again.

Index state, as the reference keeps it in the index's settings:
``index.state: close`` closes an index (it keeps its files; a write is
a 403 ``cluster_block_exception``, a document read or a search that
names it a 400 ``index_closed_exception``, and a wildcard skips it),
and ``index.blocks.write`` or ``index.blocks.read_only`` refuse writes
with the 403. ``index.frozen`` (``POST /{index}/_freeze``, which also
sets the write block) keeps the index searchable with no device state
between searches: the search service evicts its segments after every
search (search/service.py), and searches that target only frozen
indices run one at a time on the ``search_throttled`` pool. ``index.blocks.read`` and ``index.blocks.metadata`` are
recorded and, as in the reference, refuse nothing.

The indexing slow log (the reference's IndexingSlowLog): a document
write that takes at least an ``index.indexing.slowlog.threshold.index.
{warn,info,debug,trace}`` lands in ``IndexService.
indexing_slowlog_recent`` (search/slowlog.py).

``IndicesService`` resolves an expression through the metadata's hooks
(index/metadata.py sets them): ``name_resolver`` maps an alias or a
data stream to its indices, ``abstraction_lister`` lists them for
wildcards, and every ``delete_listeners`` entry hears a deleted index.
"""

from __future__ import annotations

import fnmatch
import json
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from elasticsearch_tpu_torch.analysis.analyzers import AnalysisRegistry
from elasticsearch_tpu_torch.common.errors import (
    ClusterBlockException, IllegalArgumentException, IndexClosedException,
    IndexNotFoundException, InvalidIndexNameException,
    ResourceAlreadyExistsException)
from elasticsearch_tpu_torch.common.settings import (flat_settings,
                                                     parse_int_setting)
from elasticsearch_tpu_torch.index.engine import Engine, GetResult
from elasticsearch_tpu_torch.index.mapper import (DocumentMapper,
                                                  murmur3_hash)
from elasticsearch_tpu_torch.search.slowlog import (indexing_thresholds,
                                                    record_indexing_slowlog)

# the reference's index.number_of_shards bounds
MAX_SHARDS = 1024
# settings no update may change
FINAL_SETTINGS = ("index.number_of_shards",)


class IndexService:
    """One index on ``path``: its flat settings, its mapper, its
    similarity and its shard engines."""

    def __init__(self, name: str, path: str,
                 settings: Optional[Dict[str, Any]] = None,
                 mappings: Optional[Dict[str, Any]] = None,
                 on_retire: Optional[Callable[[Iterable[str]],
                                              None]] = None):
        self.name = name
        self.path = path
        flat = flat_settings(settings)
        flat.setdefault("index.creation_date", int(time.time() * 1000))
        self.settings = flat
        self.num_shards = parse_int_setting(flat, "index.number_of_shards",
                                            1, 1, MAX_SHARDS)
        self.k1 = float(flat.get("index.similarity.default.k1", 1.2))
        self.b = float(flat.get("index.similarity.default.b", 0.75))
        # the index's analyzers, from its ``analysis.*`` and
        # ``index.analysis.*`` settings; a mapping update keeps them
        self.mapper = DocumentMapper(mappings, AnalysisRegistry(flat))
        os.makedirs(path, exist_ok=True)
        self.shards: List[Engine] = [
            Engine(os.path.join(path, str(i)), self.mapper,
                   name=f"{name}[{i}]", on_retire=on_retire)
            for i in range(self.num_shards)]
        # the indexing slow log (search/slowlog.py): its thresholds parse
        # once a settings change
        self.indexing_slowlog_recent: List[Dict[str, Any]] = []
        self._index_slowlog = indexing_thresholds(self.settings)
        self._persist_meta()

    @property
    def engine(self) -> Engine:
        """The engine of a one-shard index (bulk loading and the fast
        path's registration take it); an index of several shards has
        none."""
        if self.num_shards != 1:
            raise ValueError(f"index [{self.name}] has {self.num_shards} "
                             f"shards: address one of them")
        return self.shards[0]

    # ---------------------------------------------------------- metadata
    def meta_dict(self) -> Dict[str, Any]:
        """``{"settings", "mappings"}`` as ``_meta.json`` holds them (a
        snapshot stores the same)."""
        mappings = self.mapper.to_mapping()
        if self.mapper.dynamic != "true":
            # GET _mapping leaves it out, as the reference's; a reopened
            # index keeps it
            mappings["dynamic"] = self.mapper.dynamic
        return {"settings": dict(self.settings), "mappings": mappings}

    def _persist_meta(self) -> None:
        meta = self.meta_dict()
        tmp = os.path.join(self.path, "_meta.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, os.path.join(self.path, "_meta.json"))

    def update_mappings(self, mappings: Dict[str, Any]) -> None:
        """Merge a mapping update; a field may not change its type."""
        incoming = DocumentMapper(mappings, self.mapper.analysis)
        for path, ft in incoming.fields.items():
            existing = self.mapper.fields.get(path)
            if existing is not None and existing.type_name != ft.type_name:
                raise IllegalArgumentException(
                    f"mapper [{path}] cannot be changed from type "
                    f"[{existing.type_name}] to [{ft.type_name}]")
        self.mapper.fields.update(incoming.fields)
        self.mapper.nested_paths |= incoming.nested_paths
        self._persist_meta()

    def update_settings(self, updates: Dict[str, Any]) -> None:
        """Merge setting updates; a final setting is refused."""
        flat = flat_settings(updates)
        for key in flat:
            if key in FINAL_SETTINGS:
                raise IllegalArgumentException(
                    f"final {self.name} setting [{key}], not updateable")
        self.settings = {**self.settings, **flat}
        self._index_slowlog = indexing_thresholds(self.settings)
        self._persist_meta()

    def nested_settings(self) -> Dict[str, Any]:
        """The ``index.*`` settings as a nested object (GET _settings)."""
        root: Dict[str, Any] = {}
        for key in sorted(self.settings):
            if not key.startswith("index."):
                continue
            parts = key[len("index."):].split(".")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = self.settings[key]
        return root

    # ------------------------------------------------------- state blocks
    @property
    def is_closed(self) -> bool:
        return str(self.settings.get("index.state", "open")) == "close"

    @property
    def is_frozen(self) -> bool:
        """Frozen: searchable, with no device-resident state between
        searches (x-pack frozen indices' per-search reader)."""
        return str(self.settings.get("index.frozen",
                                     "false")).lower() == "true"

    @property
    def write_blocked(self) -> bool:
        return self.is_closed or any(
            str(self.settings.get(key, "false")).lower() == "true"
            for key in ("index.blocks.write", "index.blocks.read_only"))

    @property
    def read_blocked(self) -> bool:
        return str(self.settings.get("index.blocks.read",
                                     "false")).lower() == "true"

    def check_write_block(self) -> None:
        if self.write_blocked:
            reason = "closed" if self.is_closed else "read-only"
            raise ClusterBlockException(
                f"index [{self.name}] blocked: {reason}")

    def segment_names(self) -> List[str]:
        return [seg.name for shard in self.shards for seg in shard.segments]

    # ------------------------------------------------------------ routing
    def shard_for(self, doc_id: str, routing: Optional[str] = None) -> int:
        if self.num_shards == 1:
            return 0
        key = routing if routing is not None else doc_id
        return abs(murmur3_hash(key)) % self.num_shards

    # ------------------------------------------------------------- writes
    def index_doc(self, doc_id: Optional[str], source: Dict[str, Any],
                  routing: Optional[str] = None, **kwargs):
        """Index one document on its shard (index/engine.py
        ``Engine.index``'s keywords pass through); an id-less document
        gets its id before it routes; a write block or a closed index
        refuses it (ClusterBlockException, a 403)."""
        self.check_write_block()
        if doc_id is None:
            doc_id = Engine.new_id()
        if routing is None:
            routing = self.mapper.join_parent_routing(source)
        n_fields = len(self.mapper.fields)
        t0 = time.monotonic()
        result = self.shards[self.shard_for(doc_id, routing)].index(
            doc_id, source, **kwargs)
        if self._index_slowlog:
            record_indexing_slowlog(self._index_slowlog, self.name, doc_id,
                                    time.monotonic() - t0,
                                    self.indexing_slowlog_recent)
        if len(self.mapper.fields) != n_fields:
            # dynamic mapping grew: keep _meta.json current
            self._persist_meta()
        return result

    def delete_doc(self, doc_id: str, routing: Optional[str] = None,
                   **kwargs):
        self.check_write_block()
        return self.shards[self.shard_for(doc_id, routing)].delete(
            doc_id, **kwargs)

    def get_doc(self, doc_id: str, routing: Optional[str] = None
                ) -> GetResult:
        """The realtime GET on the shard the id (or ``routing``) routes
        to; a closed index answers IndexClosedException."""
        if self.is_closed:
            raise IndexClosedException(self.name)
        return self.shards[self.shard_for(doc_id, routing)].get(doc_id)

    def refresh(self) -> None:
        for shard in self.shards:
            shard.refresh()

    def flush(self) -> None:
        for shard in self.shards:
            shard.flush()

    def force_merge(self, max_num_segments: int = 1) -> None:
        for shard in self.shards:
            shard.force_merge(max_num_segments)

    def stats(self) -> Dict[str, Any]:
        """Docs, deleted docs and segments summed over the shards, with
        each shard's translog, seq_no and recovery (index/engine.py
        ``Engine.recovery``: the seconds of its segment load, version
        map and translog replay when the engine opened) sections."""
        shard_stats = [shard.stats() for shard in self.shards]
        return {
            "docs": {"count": sum(s["docs"]["count"] for s in shard_stats),
                     "deleted": sum(s["docs"]["deleted"]
                                    for s in shard_stats)},
            "segments": {"count": sum(s["segments"]["count"]
                                      for s in shard_stats)},
            "shards": self.num_shards,
            "translog": [s["translog"] for s in shard_stats],
            "seq_no": [s["seq_no"] for s in shard_stats],
            "recovery": [shard.recovery for shard in self.shards],
        }

    def close(self) -> None:
        for shard in self.shards:
            shard.close()


def read_meta(path: str) -> Optional[Dict[str, Any]]:
    """The ``_meta.json`` of the index directory ``path``, or None."""
    meta_path = os.path.join(path, "_meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as fh:
        return json.load(fh)


# Elasticsearch's index-name rule as the port applies it to every name
# a client gives: lower case, a letter or digit first, then letters,
# digits, ``_``, ``.`` and ``-`` (so never ``.``, ``..`` or a separator);
# a data stream's backing index (``.ds-<stream>-<date>-<generation>``,
# index/metadata.py) is the one name that starts with a dot
INDEX_NAME = re.compile(r"^(\.ds-)?[a-z0-9][a-z0-9_.\-]*$")
# the node's own system indices, outside the client's rule: the results
# of background tasks (node.py)
SYSTEM_INDICES = (".tasks",)


class IndicesService(dict):
    """The node's indices by name, under ``data_path``: every index found
    there is reopened (``open_all``); the reference's index-expression
    resolution, over aliases and data streams through the metadata's
    hooks. ``on_retire`` hears the segments of a deleted index."""

    def __init__(self, data_path: str, on_retire=None):
        super().__init__()
        self.data_path = data_path
        self.on_retire = on_retire
        # alias and data-stream resolution (index/metadata.py sets them):
        # name -> its indices, or None when it is neither
        self.name_resolver: Optional[Callable[[str],
                                              Optional[List[str]]]] = None
        # () -> {alias or data stream: [indices]}, for wildcards
        self.abstraction_lister: Optional[Callable[[], Dict[str,
                                                        List[str]]]] = None
        # called with the name of each deleted index
        self.delete_listeners: List[Callable[[str], None]] = []
        os.makedirs(data_path, exist_ok=True)

    def open_all(self) -> None:
        """Reopen every index directory under the data path (recovery of
        each shard engine: commit, version map, translog replay)."""
        for name in sorted(os.listdir(self.data_path)):
            path = os.path.join(self.data_path, name)
            meta = read_meta(path)
            if meta is not None:
                self[name] = IndexService(name, path, meta["settings"],
                                          meta["mappings"],
                                          on_retire=self.on_retire)

    def create_index(self, name: str, settings=None,
                     mappings=None) -> IndexService:
        """A new index under the data path (the caller holds the node's
        index lock)."""
        if name in self:
            raise ResourceAlreadyExistsException(f"index [{name}]")
        svc = IndexService(name, self.index_path(name), settings, mappings,
                           on_retire=self.on_retire)
        self[name] = svc
        return svc

    def open_index(self, name: str) -> IndexService:
        """Open an index whose files were placed under the data path out
        of band (a snapshot's restore or mount)."""
        if name in self:
            raise ResourceAlreadyExistsException(f"index [{name}]")
        meta = read_meta(self.index_path(name))
        if meta is None:
            raise IndexNotFoundException(name)
        svc = self[name] = IndexService(name, self.index_path(name),
                                        meta["settings"], meta["mappings"],
                                        on_retire=self.on_retire)
        return svc

    def require(self, name: str) -> IndexService:
        """The index ``name``, or IndexNotFoundException (a 404)."""
        svc = self.get(name)
        if svc is None:
            raise IndexNotFoundException(name)
        return svc

    def index_path(self, name: str) -> str:
        """The index's directory: a child of the data path, or an
        InvalidIndexNameException (400) for a name outside the naming
        rule (``.``, ``..``, a path separator, upper case...) or one that
        resolves elsewhere (a symbolic link), so no client name reaches
        a path outside the data path."""
        if not INDEX_NAME.match(name) and name not in SYSTEM_INDICES:
            raise InvalidIndexNameException(name)
        root = os.path.realpath(self.data_path)
        if os.path.dirname(os.path.realpath(os.path.join(root, name))) \
                != root:
            raise InvalidIndexNameException(name)
        return os.path.join(self.data_path, name)

    def delete_index(self, name: str) -> IndexService:
        """Close the index, drop it and remove its files; its segments
        are retired (``on_retire``: no device copy or registration keeps
        them) and every delete listener hears it."""
        path = self.index_path(name)
        svc = self.pop(name, None)
        if svc is None:
            raise IndexNotFoundException(name)
        svc.close()
        shutil.rmtree(path, ignore_errors=True)
        segments = [s for shard in svc.shards for s in shard.segments]
        for seg in segments:
            seg.retired = True
        if self.on_retire is not None:
            self.on_retire([s.name for s in segments])
        for listener in self.delete_listeners:
            listener(name)
        return svc

    def close(self) -> None:
        for svc in self.values():
            svc.close()

    def resolve(self, expression: str,
                allow_closed: bool = False) -> List[str]:
        """The names an index expression selects, in order and each
        once: ``_all``, ``*`` and the empty expression select every open
        index (sorted); otherwise a comma list whose parts are an alias
        or a data stream (its indices), a wildcard (``*``, ``?``:
        expanded over the open indices and over the aliases' and data
        streams' members, sorted, possibly to none) or a concrete index
        name (IndexNotFoundException, a 404, when none; a closed one is
        an IndexClosedException, a 400). ``allow_closed`` (the admin
        routes) keeps closed indices."""
        if expression in ("_all", "*", ""):
            return sorted(n for n in self
                          if allow_closed or not self[n].is_closed)
        out: List[str] = []
        for part in expression.split(","):
            part = part.strip()
            if not part:
                continue
            if self.name_resolver is not None and "*" not in part:
                resolved = self.name_resolver(part)
                if resolved is not None:
                    out.extend(resolved)
                    continue
            if "*" in part or "?" in part:
                matched = {n for n in self if fnmatch.fnmatch(n, part)
                           and (allow_closed or not self[n].is_closed)}
                if self.abstraction_lister is not None:
                    for name, members in self.abstraction_lister().items():
                        if fnmatch.fnmatch(name, part):
                            matched.update(members)
                out.extend(sorted(matched))
            else:
                if part not in self:
                    raise IndexNotFoundException(part)
                if self[part].is_closed and not allow_closed:
                    raise IndexClosedException(part)
                out.append(part)
        return list(dict.fromkeys(out))
