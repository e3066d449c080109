"""Search templates: a mustache engine + render pipeline (the port's copy
of elasticsearch_tpu/search/template.py).

ref: modules/lang-mustache — `_search/template`, `_render/template`,
`_msearch/template`; the template source is a (JSON) string rendered with
mustache then parsed. Supported surface: ``{{var}}`` (JSON-string-escaped),
``{{{var}}}`` (raw), ``{{#toJson}}var{{/toJson}}``, sections
``{{#x}}…{{/x}}`` (truthy / list iteration), inverted ``{{^x}}…{{/x}}``
(the "default value" idiom), ``{{.}}`` inside list sections,
``{{#join}}var{{/join}}``, comments ``{{! …}}``, and dotted paths.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.common.errors import ParsingException

_TAG = re.compile(r"{{\s*([#^/!{&]?)\s*([^}]*?)\s*}?}}")


def _lookup(path: str, stack: List[Any]) -> Any:
    if path == ".":
        return stack[-1]
    for frame in reversed(stack):
        cur = frame
        found = True
        for part in path.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                found = False
                break
        if found:
            return cur
    return None


def _escape_json_string(value: Any) -> str:
    """Render a scalar for splicing inside a JSON template string."""
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return json.dumps(value)
    if isinstance(value, (dict, list)):
        return json.dumps(value)
    return json.dumps(str(value))[1:-1]  # escaped, without the quotes


def _parse(template: str) -> List[Tuple[str, Any]]:
    """Tokenize into [('text', s) | ('var', name, raw) | ('section',
    name, inverted, subtokens)]."""
    tokens: List[Tuple[str, Any]] = []
    stack = [tokens]
    pos = 0
    for m in _TAG.finditer(template):
        if m.start() > pos:
            stack[-1].append(("text", template[pos:m.start()]))
        sigil, name = m.group(1), m.group(2).strip()
        if sigil == "!":
            pass  # comment
        elif sigil in ("#",):
            sub: List[Tuple[str, Any]] = []
            stack[-1].append(("section", name, False, sub))
            stack.append(sub)
        elif sigil == "^":
            sub = []
            stack[-1].append(("section", name, True, sub))
            stack.append(sub)
        elif sigil == "/":
            if len(stack) == 1:
                raise ParsingException(
                    f"unbalanced section close [{name}] in template")
            stack.pop()
        elif sigil in ("{", "&"):
            stack[-1].append(("var", name, True))
        else:
            stack[-1].append(("var", name, False))
        pos = m.end()
    if pos < len(template):
        stack[-1].append(("text", template[pos:]))
    if len(stack) != 1:
        raise ParsingException("unclosed section in template")
    return tokens


def _render(tokens: List[Tuple[str, Any]], stack: List[Any]) -> str:
    out: List[str] = []
    for tok in tokens:
        kind = tok[0]
        if kind == "text":
            out.append(tok[1])
        elif kind == "var":
            _, name, raw = tok
            v = _lookup(name, stack)
            if v is None:
                continue
            if raw:
                out.append(json.dumps(v) if isinstance(v, (dict, list))
                           else str(v))
            else:
                out.append(_escape_json_string(v))
        else:  # section
            _, name, inverted, sub = tok
            if name == "toJson":
                # {{#toJson}}var{{/toJson}} — splice the param as JSON
                inner = _render(sub, stack).strip()
                out.append(json.dumps(_lookup(inner, stack)))
                continue
            if name == "join":
                inner = _render(sub, stack).strip()
                v = _lookup(inner, stack) or []
                out.append(",".join(str(x) for x in v))
                continue
            v = _lookup(name, stack)
            # mustache falsiness: null/missing, false, empty list — NOT 0
            # or empty string (ref: mustache spec; the ES default-value
            # idiom must work for size=0)
            truthy = not (v is None or v is False or v == [])
            if inverted:
                if not truthy:
                    out.append(_render(sub, stack))
            elif isinstance(v, list):
                for item in v:
                    out.append(_render(sub, stack + [item]))
            elif truthy:
                frame = v if isinstance(v, dict) else v
                out.append(_render(sub, stack + [frame]))
    return "".join(out)


def render_template(source: Any, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render a template (string or object) with params into the search
    body (ref: TransportSearchTemplateAction → MustacheScriptEngine)."""
    params = params or {}
    text = source if isinstance(source, str) else json.dumps(source)
    rendered = _render(_parse(text), [params])
    try:
        return json.loads(rendered)
    except json.JSONDecodeError as e:
        raise ParsingException(
            f"rendered template is not valid JSON: {e}: {rendered[:200]}")
