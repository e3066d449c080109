"""Index and indices services (counterpart of
elasticsearch_tpu/index/service.py, reduced to what one node in memory
needs): an index is N shard engines, and a node's indices resolve from
an index expression.

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
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, Iterable, List, Optional

from elasticsearch_tpu_torch.common.errors import IndexNotFoundException
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapper import (DocumentMapper,
                                                  murmur3_hash)

# the reference's index.number_of_shards bounds
MAX_SHARDS = 1024


class IndexService:
    """One index: its mapper, its similarity and its shard engines."""

    def __init__(self, name: str, mapper: DocumentMapper,
                 num_shards: int = 1, k1: float = 1.2, b: float = 0.75,
                 on_retire: Optional[Callable[[Iterable[str]],
                                              None]] = None):
        self.name = name
        self.mapper = mapper
        self.num_shards = num_shards
        self.k1 = k1
        self.b = b
        self.shards: List[Engine] = [
            Engine(mapper, f"{name}[{i}]", on_retire=on_retire)
            for i in range(num_shards)]

    @property
    def engine(self) -> Engine:
        """The engine of a one-shard index (bulk loading and the fast
        path's registration take it); an index of several shards has
        none."""
        if self.num_shards != 1:
            raise ValueError(f"index [{self.name}] has {self.num_shards} "
                             f"shards: address one of them")
        return self.shards[0]

    # ------------------------------------------------------------ routing
    def shard_for(self, doc_id: str, routing: Optional[str] = None) -> int:
        key = routing if routing is not None else doc_id
        return abs(murmur3_hash(key)) % self.num_shards

    # ------------------------------------------------------------- writes
    def index_doc(self, doc_id: Optional[str], source: Dict[str, Any],
                  routing: Optional[str] = None, op_type: str = "index"):
        """Index one document on its shard; returns (id, "created" |
        "updated"). An id-less document gets its id before it routes."""
        if doc_id is None:
            doc_id = Engine.new_id()
        if routing is None:
            routing = self.mapper.join_parent_routing(source)
        return self.shards[self.shard_for(doc_id, routing)].index(
            doc_id, source, op_type=op_type)

    def delete_doc(self, doc_id: str, routing: Optional[str] = None) -> bool:
        return self.shards[self.shard_for(doc_id, routing)].delete(doc_id)

    def get_doc(self, doc_id: str,
                routing: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """The live document's ``_source`` on the shard its id (or
        ``routing``) routes to, None when that shard has none."""
        return self.shards[self.shard_for(doc_id, routing)].get_source(
            doc_id)

    def refresh(self) -> None:
        for shard in self.shards:
            shard.refresh()

    def force_merge(self, max_num_segments: int = 1) -> None:
        for shard in self.shards:
            shard.force_merge(max_num_segments)


class IndicesService(dict):
    """The node's indices by name, with the reference's index-expression
    resolution (aliases and data streams aside: the port has neither)."""

    def resolve(self, expression: str) -> List[str]:
        """The names an index expression selects, in order and each
        once: ``_all``, ``*`` and the empty expression select every
        index (sorted); otherwise a comma list whose wildcard parts
        (``*``, ``?``) expand over the indices (sorted, possibly to
        none) and whose concrete parts must name an index
        (IndexNotFoundException, a 404)."""
        if expression in ("_all", "*", ""):
            return sorted(self)
        out: List[str] = []
        for part in expression.split(","):
            part = part.strip()
            if not part:
                continue
            if "*" in part or "?" in part:
                out.extend(sorted(n for n in self
                                  if fnmatch.fnmatch(n, part)))
            else:
                if part not in self:
                    raise IndexNotFoundException(part)
                out.append(part)
        return list(dict.fromkeys(out))
