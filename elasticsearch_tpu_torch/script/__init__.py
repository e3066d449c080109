"""Painless-class scripting (counterpart of elasticsearch_tpu/script/,
copied: the reference's package is jax-free).

`painless.py` — lexer + recursive-descent parser for the Java-like
Painless surface (statements, typed/def locals, if/else, while, do-while,
for / for-each, break/continue/return, try/catch, functions, lambdas,
method calls with per-type allowlists).
`interp.py` — the sandboxed tree-walking interpreter with execution
limits and per-context environments.

The score context VECTORIZES loop-free expression scripts to columnar
torch ops (search/script.py); a statement script runs this interpreter
per matched doc on the host. The reference's ``contexts.py`` (ingest,
update, watcher and scripted_metric contexts) is not copied: only
aggregations and reindex use it, later slices of the port.
"""

from elasticsearch_tpu_torch.script.painless import parse_program  # noqa: F401
from elasticsearch_tpu_torch.script.interp import (  # noqa: F401
    PainlessError,
    PainlessScript,
    compile_painless,
)
