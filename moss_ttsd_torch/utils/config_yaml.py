"""A reader for the small YAML subset of the repository's configs
(``configs/training_config.yaml``, ``lora_config.yaml``,
``finetune_workflow.yaml``) and of the XY-Tokenizer's codec config (its
``generator_params`` nest keyword mappings two levels deep), so the port
needs no ``pyyaml``.

It reads what those files use and raises ``ValueError`` on anything else
rather than guess:
  * ``# comments``, whole-line or after a value;
  * ``key: value`` mappings, nested to any depth (``key:`` then lines
    indented under it, each mapping's keys at one indentation);
  * scalars as YAML 1.1 (``yaml.safe_load``) types them: ints (``0`` or no
    leading zero), floats with a dot (``1.0e-4``, ``0.1``; the exponent
    needs its sign), ``true`` / ``false``, ``null`` / ``~``, and strings,
    plain or in simple quotes;
  * inline lists of scalars, ``[a, b]``.
Plain scalars that YAML 1.1 reads some other way (``yes``, ``0x1f``,
``1e-4``, ``1:30``, dates, anchors, tags, block scalars) are refused.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
_NULLS = ("null", "Null", "NULL", "~")
# plain scalars YAML 1.1 would read as something else, or as structure
_REFUSED = re.compile(
    r"(yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|y|Y|n|N)"
    r"|[-+]?(0[0-9_]+|0[xob].*|[0-9][0-9_]*(:[0-5]?[0-9])+.*)"
    r"|[-+]?[0-9.]*[eE][-+]?[0-9]+"
    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"
    r"|[-+]?[0-9][0-9_]*_[0-9_]*(\.[0-9_]*)?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")


def _fail(lineno: int, line: str, why: str):
    raise ValueError(f"line {lineno}: {why}: {line.rstrip()!r} (this reader "
                     f"takes only the configs' YAML subset)")


def _strip_comment(text: str) -> str:
    """The text before an unquoted `` #`` (or a leading ``#``)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(tok: str, lineno: int, line: str) -> Any:
    tok = tok.strip()
    if not tok:
        _fail(lineno, line, "empty value")
    if tok[0] in "'\"":
        if len(tok) < 2 or tok[-1] != tok[0] or tok[0] in tok[1:-1] \
                or "\\" in tok:
            _fail(lineno, line, "unsupported quoted string")
        return tok[1:-1]
    if tok in _BOOLS:
        return _BOOLS[tok]
    if tok in _NULLS:
        return None
    if _INT.fullmatch(tok):
        return int(tok)
    if _FLOAT.fullmatch(tok):
        return float(tok)
    if _REFUSED.fullmatch(tok):
        _fail(lineno, line, f"ambiguous scalar {tok!r}")
    if tok[0] in "[]{}&*!|>%@`,?:-" or ": " in tok or tok.endswith(":") \
            or " #" in tok:
        _fail(lineno, line, f"unsupported syntax in {tok!r}")
    return tok


def _value(text: str, lineno: int, line: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:-1] or "]" in text[1:-1]:
            _fail(lineno, line, "only flat inline lists are supported")
        inner = text[1:-1].strip()
        if not inner:
            return []
        return [_scalar(t, lineno, line) for t in inner.split(",")]
    return _scalar(text, lineno, line)


def loads(text: str) -> Dict[str, Any]:
    """The YAML subset -> a dict (an empty document -> {})."""
    root: Dict[str, Any] = {}
    # the open mappings, outermost first: [indent of their keys, mapping];
    # a mapping just opened by "key:" has no indent until its first line
    stack: List[list] = [[0, root]]
    opened: Optional[tuple] = None       # (parent, key, parent's indent)
    for lineno, line in enumerate(text.splitlines(), 1):
        if "\t" in line[:len(line) - len(line.lstrip())]:
            _fail(lineno, line, "tab indentation")
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            _fail(lineno, line, "document markers")
        indent = len(body) - len(body.lstrip(" "))
        key, sep, rest = body.strip().partition(":")
        if not sep or not _KEY.fullmatch(key) or (rest and rest[0] != " "):
            _fail(lineno, line, "expected 'key: value'")
        if opened is not None:
            parent, pkey, pindent = opened
            opened = None
            if indent > pindent:
                stack[-1][0] = indent
            else:                       # "key:" with nothing under it
                stack.pop()
                parent[pkey] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            _fail(lineno, line, "inconsistent indentation")
        mapping = stack[-1][1]
        if key in mapping:
            _fail(lineno, line, f"duplicate key {key!r}")
        if rest.strip():
            mapping[key] = _value(rest, lineno, line)
        else:
            mapping[key] = {}
            stack.append([None, mapping[key]])
            opened = (mapping, key, indent)
    if opened is not None:
        opened[0][opened[1]] = None
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
