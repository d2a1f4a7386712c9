"""hot-path: functions marked ``# raylint: hotpath`` stay lean.

The flight recorder's live 5k-batch profile names the top burners —
``controller.py:pump`` (43% of head self-time), ``protocol.py:_recv_exact``
(14% head / 60% worker) and the worker inner loop. Those functions run
per-frame or per-task at full rate; one "temporary" ``logger.info`` or a
convenience ``json.dumps`` inside them is a multi-percent throughput
regression that no test notices.

Marking a def with ``# raylint: hotpath`` (on the def line or the line
above) forbids, in that function's direct body:

  * any ``pickle`` / ``json`` / ``marshal`` call (serialization belongs
    on the slow path or behind the wire codec);
  * INFO-or-louder logging calls (``logger.info/warning/error`` —
    hot-path logging is DEBUG-gated or counter-based);
  * eager f-string arguments to ANY log call (``logger.debug(f"{x}")``
    formats even when the level is off — pass args lazily).

Nested defs are not covered (annotate them separately if they are hot).
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from ..model import Checker, Finding, Module, Project, call_root, qualname_map

FORBIDDEN_MODULES = ("pickle.", "json.", "marshal.", "cPickle.")
LOUD_LOG_LEVELS = {"info", "warning", "error", "critical", "exception"}
LOG_LEVELS = LOUD_LOG_LEVELS | {"debug", "log"}


def _is_logger_call(dotted: str) -> Tuple[bool, str]:
    """(is a log call, level) for `logger.info`, `logging.warning`,
    `self._log.debug`, ..."""
    if "." not in dotted:
        return False, ""
    head, leaf = dotted.rsplit(".", 1)
    if leaf not in LOG_LEVELS:
        return False, ""
    base = head.rsplit(".", 1)[-1].lower()
    return ("log" in base), leaf


class HotPathChecker(Checker):
    rule_id = "hot-path"
    description = ("`# raylint: hotpath` functions: no pickle/json, no "
                   "INFO logging, no eager f-string log args")
    paths = ("ray_tpu_torch/",)

    def run(self, project: Project) -> Iterator[Finding]:
        for prefix in self.paths:
            for mod in project.glob(prefix):
                if not mod.hotpath_lines:
                    continue
                yield from self._check_module(mod)

    def _check_module(self, mod: Module) -> Iterator[Finding]:
        for node, qual in qualname_map(mod.tree).items():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.lineno in mod.hotpath_lines:
                yield from self._check_fn(mod, node, qual)

    def _check_fn(self, mod: Module, fn: ast.AST, qual: str
                  ) -> Iterator[Finding]:
        findings = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, ast.Call):
                dotted = call_root(node.func)
                if dotted:
                    if any(dotted.startswith(p) for p in FORBIDDEN_MODULES):
                        findings.append(Finding(
                            rule=self.rule_id, path=mod.relpath,
                            line=node.lineno, col=node.col_offset,
                            message=f"`{dotted}` call in hot-path "
                                    f"function `{fn.name}`",
                            hint="serialize on the slow path (or via the "
                                 "struct-packed wire codec)",
                            symbol=qual))
                    else:
                        is_log, level = _is_logger_call(dotted)
                        if is_log and level in LOUD_LOG_LEVELS:
                            findings.append(Finding(
                                rule=self.rule_id, path=mod.relpath,
                                line=node.lineno, col=node.col_offset,
                                message=f"{level.upper()}-level log call "
                                        f"in hot-path function "
                                        f"`{fn.name}`",
                                hint="hot paths log at DEBUG behind a "
                                     "level check, or bump a counter",
                                symbol=qual))
                        elif is_log and any(
                                isinstance(a, ast.JoinedStr)
                                for a in node.args):
                            findings.append(Finding(
                                rule=self.rule_id, path=mod.relpath,
                                line=node.lineno, col=node.col_offset,
                                message=f"eager f-string log argument in "
                                        f"hot-path function `{fn.name}`",
                                hint="f-strings format even when the "
                                     "level is off; pass lazy %-args",
                                symbol=qual))
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)
        yield from findings
