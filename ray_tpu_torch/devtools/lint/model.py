"""Finding model + checker base for raylint.

A :class:`Finding` is one rule violation at a file:line, carrying the rule
id, a message, and a fix hint. Findings are identified across runs by a
*fingerprint* that deliberately excludes the line number — baselined
findings must survive unrelated edits above them — and instead keys on the
enclosing symbol (function/class qualname) plus the message text.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


@dataclass
class Finding:
    rule: str                 # rule id, e.g. "async-blocking"
    path: str                 # repo-relative, forward slashes
    line: int
    col: int
    message: str
    hint: str = ""            # how to fix (or legitimately suppress) it
    symbol: str = ""          # enclosing qualname, e.g. "GCSServer._snapshot_loop"

    def fingerprint(self) -> Tuple[str, str, str, str]:
        """Line-independent identity used for baseline matching."""
        return (self.rule, self.path, self.symbol, self.message)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        out = f"{loc}  [{self.rule}]  {self.message}"
        if self.symbol:
            out += f"  (in {self.symbol})"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Module:
    """One parsed source file, shared by every checker."""

    relpath: str              # forward-slash path relative to the project root
    source: str
    tree: ast.Module
    # line -> set of rule ids disabled on that line (from `# raylint:` comments,
    # with def/class-header disables expanded over the whole body span).
    disabled: Dict[int, frozenset] = field(default_factory=dict)
    # def-statement lines annotated `# raylint: hotpath`
    hotpath_lines: frozenset = frozenset()

    def is_disabled(self, line: int, rule: str) -> bool:
        rules = self.disabled.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


class Project:
    """The file set one lint run sees.

    Tests build synthetic projects out of tmp dirs with the same relative
    layout (``ray_tpu_torch/cluster/wire.py`` …), so every checker must address
    files only through :meth:`get` / :meth:`glob` — never the real repo.
    """

    def __init__(self, root: str, modules: Iterable[Module]):
        self.root = root
        self.modules: Dict[str, Module] = {m.relpath: m for m in modules}

    def get(self, relpath: str) -> Optional[Module]:
        return self.modules.get(relpath)

    def glob(self, prefix: str) -> List[Module]:
        """All modules whose relpath starts with ``prefix``, sorted."""
        return [self.modules[p] for p in sorted(self.modules)
                if p.startswith(prefix)]


class Checker:
    """Base class: one rule, run over a whole :class:`Project`.

    Subclasses set ``rule_id``/``description`` and implement :meth:`run`.
    The engine applies ``# raylint: disable=`` suppressions and the
    baseline after the checker yields raw findings, so checkers only
    report what they see.
    """

    rule_id: str = ""
    description: str = ""

    def run(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


def qualname_map(tree: ast.Module) -> Dict[ast.AST, str]:
    """Map every function/class def node to its dotted qualname."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}"
                out[child] = name
                walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def call_root(node: ast.expr) -> str:
    """Dotted name of a call target: ``a.b.c(x)`` -> ``a.b.c``; '' if not
    a plain name/attribute chain."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""
