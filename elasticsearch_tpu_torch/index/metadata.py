"""Index metadata: aliases, composable templates, data streams, rollover
and resize (the port's copy of elasticsearch_tpu/index/metadata.py,
Elasticsearch's cluster-metadata layer: IndexAbstraction resolution,
MetadataIndexTemplateService, MetadataCreateDataStreamService,
MetadataRolloverService, TransportResizeAction). It persists to the
node's data path as ``_metadata.json``, byte-compatible with the
reference's, so either package opens the other's.

A name resolves (``indices_for``, the IndicesService hook) as a data
stream (its backing indices), then an alias (its member indices,
sorted); a concrete index name is the caller's. Wildcards expand over
the aliases and data streams too (``_abstractions``). A deleted index
leaves every alias and data stream (``_on_index_deleted``).

- **Aliases.** ``update_aliases`` applies a batch of ``add``,
  ``remove`` and ``remove_index`` actions atomically; an alias may carry
  a ``filter`` (a query the search routes add as a bool filter,
  ``alias_filter``), a ``routing`` and ``is_write_index``; it may not
  take the name of an index or a data stream.
- **Templates.** Component templates and composable index templates
  (``index_patterns``, ``composed_of``, ``priority``, ``template``,
  ``data_stream``): an index created by name or by its first write takes
  the highest-priority match, its components merged in order, then the
  template, then the request's body on top
  (``create_index_from_template``).
- **Data streams.** ``create_data_stream`` needs a matching template
  with ``data_stream``; backing indices are named
  ``.ds-<stream>-<yyyy.mm.dd>-<generation:06d>`` with ``@timestamp``
  mapped as a date; a write goes to the newest (``write_target``).
- **Rollover.** Of an alias (its write index, named ``...-NNNNNN`` or
  given ``new_index``) or a data stream, under ``max_docs``, ``max_age``
  (the index directory's age) and ``max_size`` (the segments' bytes):
  any condition met, or none given, rolls over.
- **Resize.** ``resize_index`` (shrink, split, clone) refreshes the
  source and creates the target with the source's settings and mappings
  (blocks and state aside). The reference re-indexes each live document,
  segment by segment in docid order; the port copies columns instead
  (``_columnar_copy``): each target shard's documents are the source's
  live documents its routing sends there (a join child by its parent's
  id, as the re-index routes it), in that same order, merged into one
  segment whose ``_seq_no`` is 0, 1, ... and ``_version`` 1, which is
  what the reference's re-index leaves. Then the target is flushed and
  the blocks asked for apply.
"""

from __future__ import annotations

import copy
import fnmatch
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentException, IndexNotFoundException,
    ResourceAlreadyExistsException, ResourceNotFoundException)
from elasticsearch_tpu_torch.common.settings import parse_bytes, parse_ms
from elasticsearch_tpu_torch.index.engine import META_COLUMNS
from elasticsearch_tpu_torch.index.mapper import (JoinFieldType,
                                                  murmur3_hash_array)
from elasticsearch_tpu_torch.index.segment import (NumericDocValues,
                                                   merge_segments)
from elasticsearch_tpu_torch.index.seqno import LocalCheckpointTracker

ROLLOVER_SUFFIX_RE = re.compile(r"^(.*)-(\d{6})$")


class MetadataService:
    def __init__(self, indices, data_path: Optional[str] = None):
        self.indices = indices
        # alias -> {index: {"filter"?, "routing"?, "is_write_index"?}}
        self.aliases: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.index_templates: Dict[str, Dict[str, Any]] = {}
        self.component_templates: Dict[str, Dict[str, Any]] = {}
        # stream -> {"timestamp_field", "indices", "generation"}
        self.data_streams: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._path = (os.path.join(data_path, "_metadata.json")
                      if data_path else None)
        if self._path and os.path.exists(self._path):
            with open(self._path) as fh:
                state = json.load(fh)
            self.aliases = state.get("aliases", {})
            self.index_templates = state.get("index_templates", {})
            self.component_templates = state.get("component_templates", {})
            self.data_streams = state.get("data_streams", {})
        indices.name_resolver = self.indices_for
        indices.abstraction_lister = self._abstractions
        indices.delete_listeners.append(self._on_index_deleted)

    def _persist(self) -> None:
        if self._path:
            tmp = self._path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"aliases": self.aliases,
                           "index_templates": self.index_templates,
                           "component_templates": self.component_templates,
                           "data_streams": self.data_streams}, fh)
            os.replace(tmp, self._path)

    # ------------------------------------------------------------ aliases
    def update_aliases(self, actions: List[Dict[str, Any]]) -> None:
        """An atomic batch of ``add``, ``remove`` and ``remove_index``
        actions: every action applies to a staged copy, which replaces
        the aliases only when all succeeded."""
        with self._lock:
            staged = {a: dict(m) for a, m in self.aliases.items()}
            for action in actions:
                (kind, spec), = action.items()
                if kind == "add":
                    indices = self._action_indices(spec)
                    aliases = _names(spec, "alias", "aliases")
                    if not aliases:
                        raise IllegalArgumentException(
                            "[add] requires an [alias] to be set")
                    for a in aliases:
                        if a in self.indices or a in self.data_streams:
                            raise IllegalArgumentException(
                                f"alias [{a}] collides with an existing "
                                f"index or data stream")
                        entry = staged.setdefault(a, {})
                        for idx in indices:
                            props: Dict[str, Any] = {}
                            if "filter" in spec:
                                props["filter"] = spec["filter"]
                            if spec.get("is_write_index"):
                                props["is_write_index"] = True
                            entry[idx] = props
                elif kind == "remove":
                    indices = self._action_indices(spec)
                    aliases = _names(spec, "alias", "aliases")
                    if not aliases:
                        raise IllegalArgumentException(
                            "[remove] requires an [alias] to be set")
                    removed_any = False
                    for a in list(staged):
                        if not any(fnmatch.fnmatch(a, pat)
                                   for pat in aliases):
                            continue
                        for idx in indices:
                            if idx in staged[a]:
                                del staged[a][idx]
                                removed_any = True
                        if not staged[a]:
                            del staged[a]
                    if not removed_any and spec.get("must_exist"):
                        raise ResourceNotFoundException(
                            f"aliases {aliases} missing")
                elif kind == "remove_index":
                    for idx in self._action_indices(spec):
                        self.indices.delete_index(idx)
                        for a in list(staged):
                            staged[a].pop(idx, None)
                            if not staged[a]:
                                del staged[a]
                else:
                    raise IllegalArgumentException(
                        f"unknown alias action [{kind}]")
            self.aliases = staged
            self._persist()

    def _action_indices(self, spec: Dict[str, Any]) -> List[str]:
        indices = _names(spec, "index", "indices")
        if not indices:
            raise IllegalArgumentException(
                "alias action requires an [index] to be set")
        out = []
        for pat in indices:
            if "*" in pat:
                out.extend(n for n in sorted(self.indices)
                           if fnmatch.fnmatch(n, pat))
            else:
                if pat not in self.indices:
                    raise IndexNotFoundException(pat)
                out.append(pat)
        return out

    def get_aliases(self, index: Optional[str] = None,
                    alias: Optional[str] = None) -> Dict[str, Any]:
        """``GET _alias``'s shape: {index: {"aliases": {alias: props}}}."""
        out: Dict[str, Any] = {}
        for a, members in self.aliases.items():
            if alias and not fnmatch.fnmatch(a, alias):
                continue
            for idx, props in members.items():
                if index and not fnmatch.fnmatch(idx, index):
                    continue
                out.setdefault(idx, {"aliases": {}})["aliases"][a] = props
        if index and not out and index != "*" and "*" not in index:
            if index not in self.indices:
                raise IndexNotFoundException(index)
            out[index] = {"aliases": {}}
        return out

    def alias_filter(self, name: str) -> Optional[Dict[str, Any]]:
        """The filter of a filtered alias ``name`` (the members' filters
        OR-ed when several have one), else None."""
        members = self.aliases.get(name)
        if not members:
            return None
        filters = [p["filter"] for p in members.values() if "filter" in p]
        if not filters:
            return None
        if len(filters) == 1:
            return filters[0]
        return {"bool": {"should": filters, "minimum_should_match": 1}}

    def _abstractions(self) -> Dict[str, List[str]]:
        out = {a: sorted(m) for a, m in self.aliases.items()}
        out.update({ds: list(meta["indices"])
                    for ds, meta in self.data_streams.items()})
        return out

    def _on_index_deleted(self, name: str) -> None:
        """Strip a deleted index from every alias and backing list."""
        with self._lock:
            changed = False
            for a in list(self.aliases):
                if name in self.aliases[a]:
                    del self.aliases[a][name]
                    changed = True
                    if not self.aliases[a]:
                        del self.aliases[a]
            for ds in list(self.data_streams):
                meta = self.data_streams[ds]
                if name in meta["indices"]:
                    meta["indices"].remove(name)
                    changed = True
                    if not meta["indices"]:
                        del self.data_streams[ds]
            if changed:
                self._persist()

    # --------------------------------------------------------- resolution
    def indices_for(self, name: str) -> Optional[List[str]]:
        """A data stream's backing indices or an alias's members; None
        when ``name`` is neither."""
        if name in self.data_streams:
            return list(self.data_streams[name]["indices"])
        if name in self.aliases:
            return sorted(self.aliases[name])
        return None

    def write_target(self, name: str) -> str:
        """The index a write to ``name`` lands in: a data stream's newest
        backing index, an alias's write index (or its one member), else
        ``name`` itself."""
        if name in self.data_streams:
            return self.data_streams[name]["indices"][-1]
        members = self.aliases.get(name)
        if members:
            writes = [i for i, p in members.items()
                      if p.get("is_write_index")]
            if len(writes) == 1:
                return writes[0]
            if len(members) == 1:
                return next(iter(members))
            raise IllegalArgumentException(
                f"no write index is defined for alias [{name}]")
        return name

    # ---------------------------------------------------------- templates
    def put_component_template(self, name: str, body: Dict[str, Any]):
        if "template" not in body:
            raise IllegalArgumentException(
                "[template] is required for a component template")
        with self._lock:
            self.component_templates[name] = body
            self._persist()

    def put_index_template(self, name: str, body: Dict[str, Any]):
        if not body.get("index_patterns"):
            raise IllegalArgumentException(
                "[index_patterns] is required for an index template")
        for c in body.get("composed_of", []):
            if c not in self.component_templates:
                raise IllegalArgumentException(
                    f"component template [{c}] does not exist")
        with self._lock:
            self.index_templates[name] = body
            self._persist()

    def delete_index_template(self, name: str):
        if name not in self.index_templates:
            raise ResourceNotFoundException(
                f"index template [{name}] does not exist")
        with self._lock:
            del self.index_templates[name]
            self._persist()

    def delete_component_template(self, name: str):
        if name not in self.component_templates:
            raise ResourceNotFoundException(
                f"component template [{name}] does not exist")
        with self._lock:
            del self.component_templates[name]
            self._persist()

    def match_template(self, index_name: str) -> Optional[Dict[str, Any]]:
        """The highest-priority matching index template (the first on a
        tie), its components merged in order, then the template itself."""
        best, best_prio, best_name = None, -1, None
        for name, tmpl in self.index_templates.items():
            pats = tmpl["index_patterns"]
            if isinstance(pats, str):
                pats = [pats]
            if any(fnmatch.fnmatch(index_name, p) for p in pats):
                prio = int(tmpl.get("priority", 0))
                if prio > best_prio:
                    best, best_prio, best_name = tmpl, prio, name
        if best is None:
            return None
        merged: Dict[str, Any] = {"settings": {}, "mappings": {},
                                  "aliases": {}}
        for comp in best.get("composed_of", []):
            _merge_template(merged,
                            self.component_templates[comp]["template"])
        _merge_template(merged, best.get("template", {}))
        merged["_name"] = best_name
        merged["_data_stream"] = best.get("data_stream")
        return merged

    def create_index_from_template(self, name: str,
                                   body: Optional[Dict[str, Any]] = None):
        """Create ``name`` with the matching template applied, then the
        request's body on top (the body wins), and the aliases of both."""
        body = body or {}
        if name in self.aliases or name in self.data_streams:
            raise IllegalArgumentException(
                f"index name [{name}] collides with an existing alias or "
                f"data stream")
        tmpl = self.match_template(name) or {"settings": {}, "mappings": {},
                                             "aliases": {}}
        settings = dict(tmpl["settings"])
        settings.update(body.get("settings", {}))
        mappings: Dict[str, Any] = {}
        _deep_update(mappings, tmpl["mappings"])
        _deep_update(mappings, body.get("mappings", {}))
        idx = self.indices.create_index(name, settings or None,
                                        mappings or None)
        alias_actions = []
        for a, props in {**tmpl["aliases"],
                         **body.get("aliases", {})}.items():
            spec = {"index": name, "alias": a}
            spec.update(props or {})
            alias_actions.append({"add": spec})
        if alias_actions:
            self.update_aliases(alias_actions)
        return idx

    # -------------------------------------------------------- data streams
    def create_data_stream(self, name: str) -> None:
        with self._lock:
            if name in self.data_streams:
                raise ResourceAlreadyExistsException(
                    f"data_stream [{name}] already exists")
            if name in self.indices or name in self.aliases:
                raise IllegalArgumentException(
                    f"data stream name [{name}] collides with an existing "
                    f"index or alias")
            tmpl = self.match_template(name)
            if tmpl is None or tmpl.get("_data_stream") is None:
                raise IllegalArgumentException(
                    f"no matching index template with a data_stream "
                    f"definition for [{name}]")
            backing = _backing_name(name, 1)
            mappings = {"properties": {"@timestamp": {"type": "date"}}}
            _deep_update(mappings, tmpl["mappings"])
            self.indices.create_index(backing, tmpl["settings"] or None,
                                      mappings)
            self.data_streams[name] = {"timestamp_field": "@timestamp",
                                       "indices": [backing],
                                       "generation": 1}
            self._persist()

    def get_data_streams(self, name: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
        out = []
        for ds, meta in sorted(self.data_streams.items()):
            if name and name not in ("*", "_all") and \
                    not fnmatch.fnmatch(ds, name):
                continue
            out.append({
                "name": ds,
                "timestamp_field": {"name": meta["timestamp_field"]},
                "indices": [{"index_name": n} for n in meta["indices"]],
                "generation": meta["generation"],
                "status": "GREEN",
            })
        return out

    def delete_data_stream(self, name: str) -> None:
        with self._lock:
            if name not in self.data_streams:
                raise ResourceNotFoundException(
                    f"data_stream [{name}] does not exist")
            for backing in list(self.data_streams[name]["indices"]):
                if backing in self.indices:
                    self.indices.delete_index(backing)
            self.data_streams.pop(name, None)
            self._persist()

    # ------------------------------------------------------------ rollover
    def rollover(self, target: str, body: Optional[Dict[str, Any]] = None,
                 dry_run: bool = False) -> Dict[str, Any]:
        """Check ``conditions`` against the write index of ``target`` (an
        alias or a data stream); when one is met, or none is given,
        create the successor and point the alias or stream at it."""
        body = body or {}
        conditions = body.get("conditions", {})
        with self._lock:
            if target in self.data_streams:
                ds = self.data_streams[target]
                old_index = ds["indices"][-1]
                new_gen = ds["generation"] + 1
                new_index = _backing_name(target, new_gen)
                is_stream = True
            elif target in self.aliases:
                old_index = self.write_target(target)
                m = ROLLOVER_SUFFIX_RE.match(old_index)
                if body.get("new_index"):
                    new_index = body["new_index"]
                elif m:
                    new_index = f"{m.group(1)}-{int(m.group(2)) + 1:06d}"
                else:
                    raise IllegalArgumentException(
                        f"index name [{old_index}] does not match pattern "
                        f"'^.*-\\d+$' — specify [new_index]")
                is_stream = False
            else:
                raise IllegalArgumentException(
                    f"rollover target [{target}] is not an alias or data "
                    f"stream")
            met = self._check_conditions(old_index, conditions)
            should_roll = (not conditions) or any(met.values())
            result = {"old_index": old_index, "new_index": new_index,
                      "rolled_over": False, "dry_run": dry_run,
                      "acknowledged": True, "conditions": met}
            if dry_run or not should_roll:
                return result
            if is_stream:
                tmpl = self.match_template(target) or {
                    "settings": {}, "mappings": {}}
                mappings = {"properties": {"@timestamp": {"type": "date"}}}
                _deep_update(mappings, tmpl.get("mappings", {}))
                self.indices.create_index(new_index,
                                          tmpl.get("settings") or None,
                                          mappings)
                ds["indices"].append(new_index)
                ds["generation"] = new_gen
            else:
                self.create_index_from_template(
                    new_index, {k: v for k, v in body.items()
                                if k in ("settings", "mappings", "aliases")})
                members = self.aliases[target]
                old_props = members.get(old_index, {})
                if old_props.get("is_write_index"):
                    # an explicit write alias keeps the old index as a
                    # read member
                    members[old_index] = {
                        k: v for k, v in old_props.items()
                        if k != "is_write_index"}
                else:
                    members.pop(old_index, None)
                members[new_index] = {"is_write_index": True}
            self._persist()
            result["rolled_over"] = True
            return result

    def _check_conditions(self, index_name: str,
                          conditions: Dict[str, Any]) -> Dict[str, bool]:
        met: Dict[str, bool] = {}
        if not conditions:
            return met
        idx = self.indices.require(index_name)
        if "max_docs" in conditions:
            docs = idx.stats()["docs"]["count"]
            met[f"[max_docs: {conditions['max_docs']}]"] = (
                docs >= int(conditions["max_docs"]))
        if "max_age" in conditions:
            age_s = time.time() - os.path.getctime(idx.path)
            met[f"[max_age: {conditions['max_age']}]"] = (
                age_s * 1000 >= parse_ms(conditions["max_age"]))
        if "max_size" in conditions:
            size = sum(seg.ram_bytes() for sh in idx.shards
                       for seg in sh.segments)
            met[f"[max_size: {conditions['max_size']}]"] = (
                size >= parse_bytes(conditions["max_size"]))
        return met


def _names(spec: Dict[str, Any], one: str, many: str) -> List[str]:
    """An action's ``one`` (a name) or ``many`` (a name or a list)."""
    value = spec.get(one)
    names = spec.get(many, [value] if value else [])
    return [names] if isinstance(names, str) else list(names)


def _backing_name(stream: str, generation: int) -> str:
    stamp = time.strftime("%Y.%m.%d", time.gmtime())
    return f".ds-{stream}-{stamp}-{generation:06d}"


def _merge_template(acc: Dict[str, Any], tmpl: Dict[str, Any]) -> None:
    acc["settings"].update(tmpl.get("settings", {}))
    _deep_update(acc["mappings"], tmpl.get("mappings", {}))
    acc["aliases"].update(tmpl.get("aliases", {}))


def _deep_update(base: Dict[str, Any], update: Dict[str, Any]) -> None:
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


# ---------------------------------------------------------------------------
# shrink / split / clone
# ---------------------------------------------------------------------------

def resize_index(indices, source_name: str, target_name: str,
                 body: Optional[Dict[str, Any]] = None,
                 mode: str = "shrink"):
    """Shrink, split or clone ``source_name`` into a new index
    ``target_name`` of ``index.number_of_shards`` shards (1 for a
    shrink, the source's for a clone, twice the source's for a split
    unless the body says). The source's unrefreshed documents are
    refreshed first; each live document re-routes by the target's
    shard count, in segment order and docid order."""
    body = body or {}
    src = indices.require(source_name)
    src.refresh()
    settings = dict(body.get("settings", {}))
    n_target = int(settings.get(
        "index.number_of_shards",
        1 if mode == "shrink"
        else src.num_shards if mode == "clone"
        else src.num_shards * 2))
    if mode == "shrink" and n_target > src.num_shards:
        raise IllegalArgumentException(
            f"the number of target shards [{n_target}] must be less than or "
            f"equal to the number of source shards [{src.num_shards}]")
    if mode == "clone" and n_target != src.num_shards:
        raise IllegalArgumentException(
            f"the number of target shards [{n_target}] must be the "
            f"same as the number of source shards [{src.num_shards}]")
    if mode == "split" and n_target < src.num_shards:
        raise IllegalArgumentException(
            f"the number of target shards [{n_target}] must be greater than "
            f"the number of source shards [{src.num_shards}]")
    # the source's blocks and state stay behind; blocks asked for apply
    # after the documents land
    merged = {k: v for k, v in src.settings.items()
              if not k.startswith("index.blocks.") and k != "index.state"}
    merged.update({k: v for k, v in settings.items()
                   if not k.startswith("index.blocks.")})
    merged["index.number_of_shards"] = n_target
    target = indices.create_index(target_name, merged,
                                  src.mapper.to_mapping())
    _columnar_copy([seg for engine in src.shards
                    for seg in engine.segments], target)
    target.flush()
    requested = {k: v for k, v in settings.items()
                 if k.startswith("index.blocks.")}
    if requested:
        target.update_settings(requested)
    return target


def _routing_keys(segment, mapper) -> List[str]:
    """Each doc's routing key: its id, or for a join child its parent's
    id (``{join}#parent``; the first join field with one, as
    ``DocumentMapper.join_parent_routing`` takes it)."""
    keys = list(segment.stored.ids)
    joins = [p for p, ft in mapper.fields.items()
             if isinstance(ft, JoinFieldType)]
    for path in reversed(joins):
        kv = segment.keywords.get(f"{path}#parent")
        if kv is not None:
            for d in np.nonzero(kv.ords >= 0)[0].tolist():
                keys[d] = kv.terms[kv.ords[d]]
    return keys


def _columnar_copy(segments, target) -> None:
    """Each target shard's documents, the live documents of ``segments``
    (in order) whose ``abs(murmur3(routing key)) % shards`` is that
    shard, merged in segment and docid order into one segment of the
    shard with ``_seq_no`` 0 .. n-1, ``_primary_term`` the shard's and
    ``_version`` 1: the re-index's documents, numbers and order, without
    parsing them again."""
    n = target.num_shards
    routes = [np.abs(murmur3_hash_array(_routing_keys(
        seg, target.mapper)).astype(np.int64)) % n for seg in segments]
    for t, engine in enumerate(target.shards):
        views = []
        for seg, route in zip(segments, routes):
            view = copy.copy(seg)
            view.live = seg.live & (route == t)
            views.append(view)
        if not any(v.live.any() for v in views):
            continue
        seg = merge_segments(engine._next_name(), views)
        count = seg.n_docs
        for name, column in zip(META_COLUMNS, (
                np.arange(count, dtype=np.float64),
                np.full(count, float(engine.primary_term)),
                np.ones(count, np.float64))):
            seg.numerics[name] = NumericDocValues(
                name, column, np.zeros(count, bool),
                np.arange(count + 1, dtype=np.int64), column.copy())
        engine.install_segments([seg])
        engine.tracker = LocalCheckpointTracker(count - 1, count - 1)
