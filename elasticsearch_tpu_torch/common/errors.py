"""The port's exceptions shared by several packages (counterpart of
elasticsearch_tpu/common/errors.py, reduced to what the port raises
from more than one module)."""

from __future__ import annotations


class ScriptException(ValueError):
    """A script that does not compile, reads a parameter the request did
    not pass, or fails while it runs: a 400 with the reference's error
    type."""

    status = 400
    error_type = "script_exception"
