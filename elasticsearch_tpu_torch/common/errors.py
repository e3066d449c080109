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
