"""``# raylint:`` comment annotations.

Two forms, both parsed with :mod:`tokenize` so ``#`` inside string
literals can never masquerade as an annotation:

  * ``# raylint: disable=rule-a,rule-b`` — suppress those rules on this
    line; placed on a ``def``/``class`` header (or its decorator line) it
    covers the whole body. ``disable=all`` suppresses every rule.
  * ``# raylint: hotpath`` — marks the function defined on this line (or
    the line below the comment) as a hot-path function: the ``hot-path``
    checker then forbids pickle/json, INFO logging, and eager f-string
    log calls inside it.

Suppressions are deliberate, reviewed exceptions and should carry a
trailing justification: ``# raylint: disable=async-blocking — snapshot
must serialize on the loop thread for a consistent view``.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, Set, Tuple

_ANNOT = re.compile(r"#\s*raylint:\s*(.*)")
_DISABLE = re.compile(r"disable=([\w\-,]+)")


def _comment_lines(source: str) -> Dict[int, str]:
    """line -> raylint annotation text, for every `# raylint:` comment."""
    out: Dict[int, str] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = _ANNOT.search(tok.string)
                if m:
                    out[tok.start[0]] = m.group(1).strip()
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def parse(source: str, tree: ast.Module
          ) -> Tuple[Dict[int, frozenset], frozenset]:
    """Return (disabled-rules-per-line, hotpath-def-lines).

    A ``disable=`` comment on a def/class header line (or any of its
    decorator lines) is expanded over the node's full line span. A
    ``hotpath`` comment attaches to the def on the same line, or the def
    starting on the next line.
    """
    annots = _comment_lines(source)
    src_lines = source.splitlines()
    disabled: Dict[int, Set[str]] = {}
    hotpath_comment_lines: Set[int] = set()

    for line, text in annots.items():
        m = _DISABLE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            disabled.setdefault(line, set()).update(rules)
            # A standalone comment line (no code before the `#`) covers
            # the line BELOW it — the natural place to write a disable
            # that would not fit at the end of the offending line.
            raw = src_lines[line - 1] if line - 1 < len(src_lines) else ""
            if raw.split("#", 1)[0].strip() == "":
                disabled.setdefault(line + 1, set()).update(rules)
        if re.search(r"\bhotpath\b", text):
            hotpath_comment_lines.add(line)

    hotpath_defs: Set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        header_lines = {node.lineno}
        header_lines.update(d.lineno for d in node.decorator_list)
        first = min(header_lines)
        span_rules: Set[str] = set()
        for hl in header_lines:
            span_rules.update(disabled.get(hl, ()))
        if span_rules:
            end = getattr(node, "end_lineno", node.lineno)
            for ln in range(first, end + 1):
                disabled.setdefault(ln, set()).update(span_rules)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # `# raylint: hotpath` on the def line or the line above it
            # (or above the first decorator).
            if (node.lineno in hotpath_comment_lines
                    or first in hotpath_comment_lines
                    or (first - 1) in hotpath_comment_lines):
                hotpath_defs.add(node.lineno)

    return ({ln: frozenset(rules) for ln, rules in disabled.items()},
            frozenset(hotpath_defs))
