"""A reader for the subset of YAML the port's configs use (no YAML package).

The model configs (cfg/models/) and the dataset recipes (cfg/datasets/) are
the JAX package's files, copied byte for byte; the port reads them with
`load_yaml`, which gives what PyYAML's `safe_load` gives on each of them
(tests/test_torch_model.py, tests/test_torch_data.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict

_TOKEN = re.compile(r"\[|\]|,|\"[^\"]*\"|'[^']*'|[^\[\],]+")


def _scalar(tok: str):
    if tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if tok in ("null", "Null", "NULL", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def _flow(text: str):
    """A flow sequence (`[a, [b, c]]`) or a scalar."""
    tokens = [t.strip() for t in _TOKEN.findall(text) if t.strip()]
    pos = 0

    def value():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok != "[":
            return _scalar(tok)
        out = []
        if tokens[pos] == "]":
            pos += 1
            return out
        while True:
            out.append(value())
            tok = tokens[pos]
            pos += 1
            if tok == "]":
                return out
            if tok != ",":
                raise ValueError(f"bad flow sequence: {text!r}")

    result = value()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in {text!r}")
    return result


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def load_yaml(text: str) -> Dict[str, Any]:
    """Read a model config or a dataset recipe: top-level `key: value` (an
    empty value, as `test:`, is None), one nested mapping level (`scales:`,
    `names:` with integer keys) and block lists of flow sequences
    (`- [from, n, m, args]`)."""
    d: Dict[str, Any] = {}
    key = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        s = line.strip()
        if not line[0].isspace() and not s.startswith("-"):
            key, _, rest = s.partition(":")
            key = key.strip()
            d[key] = _flow(rest.strip()) if rest.strip() else None
        elif s.startswith("-"):
            if d.get(key) is None:
                d[key] = []
            d[key].append(_flow(s[1:].strip()))
        else:
            sub, _, rest = s.partition(":")
            if d.get(key) is None:
                d[key] = {}
            d[key][_scalar(sub.strip())] = _flow(rest.strip())
    return d


