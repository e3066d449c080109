"""The port's exceptions shared by several packages (counterpart of
elasticsearch_tpu/common/errors.py, reduced to what the port raises
from more than one module)."""

from __future__ import annotations


class IllegalArgumentException(ValueError):
    """A request whose arguments the engine refuses (a 400)."""

    error_type = "illegal_argument_exception"


class ScriptException(ValueError):
    """A script that does not compile, reads a parameter the request did
    not pass, or fails while it runs: a 400 with the reference's error
    type."""

    status = 400
    error_type = "script_exception"


class SettingsException(ValueError):
    """A setting whose value does not parse (a 400)."""

    status = 400
    error_type = "settings_exception"


class CircuitBreakingException(Exception):
    """An admission a breaker refuses: a 429 with the bytes it would
    have held (``bytes_wanted``) and the breaker's limit
    (``bytes_limit``), as the reference's (common/breaker/
    CircuitBreaker.java). It never moves the work elsewhere."""

    status = 429
    error_type = "circuit_breaking_exception"

    def __init__(self, message: str, bytes_wanted: int = 0,
                 bytes_limit: int = 0):
        super().__init__(message)
        self.bytes_wanted = bytes_wanted
        self.bytes_limit = bytes_limit


class ParsingException(ValueError):
    """A malformed request body, query or value (a 400, as in the
    reference)."""

    error_type = "parsing_exception"


class QueryShardException(ValueError):
    """A query the shard cannot run against its mapping (a nested path
    that is not mapped as nested, a join query without a join field): a
    400, as in the reference."""

    status = 400
    error_type = "query_shard_exception"


class IndexNotFoundException(Exception):
    """A concrete index name that names no index (a 404)."""

    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]")
        self.index = index


# the failure types that are the client's fault: a search whose failed
# shards all failed with one of them answers 400, not 503
_CLIENT_ERROR_TYPES = {
    "parsing_exception", "illegal_argument_exception",
    "query_shard_exception", "mapper_parsing_exception",
    "script_exception", "search_context_missing_exception",
}


class SearchPhaseExecutionException(Exception):
    """A search phase that could not complete within the partial-results
    contract: some shards failed and the request set
    ``allow_partial_search_results`` false. It carries the per-shard
    failures (``failed_shards``), as the reference's; its status is 503,
    or 400 when every failure is the client's fault."""

    error_type = "search_phase_execution_exception"

    def __init__(self, phase_name: str, message: str, shard_failures):
        super().__init__(message)
        self.phase_name = phase_name
        self.shard_failures = list(shard_failures)
        types = {(f.get("reason") or {}).get("type")
                 for f in self.shard_failures}
        self.status = (400 if self.shard_failures
                       and types <= _CLIENT_ERROR_TYPES else 503)


def snake_case(name: str) -> str:
    """CamelCase -> snake_case (idempotent on snake input)."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def error_type_of(exc: BaseException) -> str:
    """The wire ``type`` of an exception: its ``error_type`` when it has
    one, else its class name in snake case (the reference's
    ``error_type_of``)."""
    etype = getattr(exc, "error_type", None)
    return etype if isinstance(etype, str) else snake_case(
        type(exc).__name__)


# ------------------------------------ the write path, metadata and contexts
# (the reference's types, statuses, messages and ``to_xcontent`` bodies)


class WriteException(Exception):
    """A failure with the reference's wire form (the write path's, the
    metadata's and the search contexts'): ``status``,
    ``error_type`` and ``to_xcontent()`` (type, reason, then the
    exception's metadata)."""

    status = 500
    error_type = "exception"

    def __init__(self, message: str = "", **metadata):
        super().__init__(message)
        self.message = message
        self.metadata = metadata

    def to_xcontent(self) -> dict:
        return {"type": self.error_type, "reason": self.message,
                **self.metadata}


class VersionConflictEngineException(WriteException):
    """An optimistic-concurrency failure: ``op_type=create`` on a live
    id, or an ``if_seq_no``/``if_primary_term`` that does not match the
    document's (a 409)."""

    status = 409
    error_type = "version_conflict_engine_exception"

    def __init__(self, doc_id: str, message: str):
        super().__init__(f"[{doc_id}]: version conflict, {message}")


class DocumentMissingException(WriteException):
    """An update or ``_source`` read of a document that does not exist
    (a 404)."""

    status = 404
    error_type = "document_missing_exception"

    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{doc_id}]: document missing", index=index)


class EngineClosedException(WriteException):
    """A write to a shard engine that was closed."""

    error_type = "engine_closed_exception"


class TranslogCorruptedException(WriteException):
    """A translog operation whose CRC32 does not match its payload (a
    torn tail is truncated instead)."""

    error_type = "translog_corrupted_exception"


class EsRejectedExecutionException(WriteException):
    """An operation the node sheds under load: the retryable 429 of the
    indexing pressure (index/pressure.py), with the bytes it would have
    held and the limit."""

    status = 429
    error_type = "es_rejected_execution_exception"


class InvalidIndexNameException(WriteException):
    """An index name that breaks Elasticsearch's naming rule, or that
    would not name a directory of its own under the data path (a 400)."""

    status = 400
    error_type = "invalid_index_name_exception"

    def __init__(self, name: str):
        super().__init__(f"Invalid index name [{name}]", index=name)


class ResourceAlreadyExistsException(WriteException):
    status = 400
    error_type = "resource_already_exists_exception"

    def __init__(self, resource: str):
        super().__init__(f"resource [{resource}] already exists",
                         resource=resource)


class ResourceNotFoundException(WriteException):
    """A named resource that does not exist: a template, a data stream,
    a stored script, an alias a ``must_exist`` removal names (a 404)."""

    status = 404
    error_type = "resource_not_found_exception"


class ClusterBlockException(WriteException):
    """An index block refused the operation: a write to an index with
    ``index.blocks.write`` or ``index.blocks.read_only`` set, or to a
    closed index (a 403)."""

    status = 403
    error_type = "cluster_block_exception"


class IndexClosedException(WriteException):
    """A read of an explicitly named closed index (a 400)."""

    status = 400
    error_type = "index_closed_exception"

    def __init__(self, index: str):
        super().__init__(f"closed index [{index}]", index=index)


class SearchContextMissingException(WriteException):
    """A scroll or point-in-time id that names no open context: never
    opened, cleared, or expired (a 404)."""

    status = 404
    error_type = "search_context_missing_exception"

    def __init__(self, context_id):
        super().__init__(f"No search context found for id [{context_id}]")


class TaskCancelledException(WriteException):
    """Work whose task was cancelled (``POST /_tasks/{id}/_cancel``, a
    parent's ban, a deleted or expired async search): a 400, never a
    partial answer (transport/tasks.py)."""

    status = 400
    error_type = "task_cancelled_exception"
