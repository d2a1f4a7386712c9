"""raylint engine: file discovery, parsing, checker dispatch, suppression.

One :func:`run_lint` call loads the WHOLE project (cross-file rules like
wire-discipline need the full picture even when only one file changed),
runs the enabled checkers, drops ``# raylint: disable=`` suppressed
findings, and splits the rest against the committed baseline. The
``paths`` filter only restricts which findings are *reported* — never
what the checkers can see.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import annotations as _annotations
from . import baseline as _baseline
from .model import Checker, Finding, Module, Project
from .checkers.async_blocking import AsyncBlockingChecker
from .checkers.hot_path import HotPathChecker
from .checkers.kernel_purity import KernelPurityChecker
from .checkers.thread_shared import ThreadSharedStateChecker
from .checkers.wire_discipline import WireDisciplineChecker

ALL_CHECKERS: Tuple[type, ...] = (
    AsyncBlockingChecker,
    WireDisciplineChecker,
    KernelPurityChecker,
    ThreadSharedStateChecker,
    HotPathChecker,
)

RULE_IDS: Tuple[str, ...] = tuple(c.rule_id for c in ALL_CHECKERS)

# Source roots scanned into the project (tests are loaded for the
# cross-reference rules but are never lint *targets* themselves). The
# port's command-line tools live in its own package (``scripts/``).
SCAN_ROOTS = ("ray_tpu_torch", "tests")
SKIP_PARTS = ("__pycache__", ".git", "node_modules")


@dataclass
class LintResult:
    findings: List[Finding]          # reported, non-baselined
    baselined: List[Finding]
    suppressed: int                  # dropped by `# raylint: disable=`
    stale_baseline: List[Tuple[str, str, str, str]]
    files_scanned: int
    parse_errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


def discover_files(root: str) -> List[str]:
    out: List[str] = []
    for scan in SCAN_ROOTS:
        base = os.path.join(root, scan)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in SKIP_PARTS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


def load_project(root: str,
                 files: Optional[Iterable[str]] = None
                 ) -> Tuple[Project, List[str]]:
    """Parse every discovered file into a Project; unparseable files are
    reported, not fatal (the repo's own tests own syntax errors)."""
    errors: List[str] = []
    modules: List[Module] = []
    for path in (files if files is not None else discover_files(root)):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{rel}: {e}")
            continue
        disabled, hotpath = _annotations.parse(source, tree)
        modules.append(Module(relpath=rel, source=source, tree=tree,
                              disabled=disabled, hotpath_lines=hotpath))
    return Project(root, modules), errors


def run_lint(root: str,
             rules: Optional[Sequence[str]] = None,
             paths: Optional[Sequence[str]] = None,
             use_baseline: bool = True,
             project: Optional[Project] = None) -> LintResult:
    """Run the suite. ``rules`` filters checkers by id; ``paths`` filters
    REPORTED findings to those whose path matches one of the (repo
    relative, forward-slash) prefixes; ``project`` lets tests inject a
    synthetic file set."""
    parse_errors: List[str] = []
    if project is None:
        project, parse_errors = load_project(root)

    raw: List[Finding] = []
    for cls in ALL_CHECKERS:
        if rules is not None and cls.rule_id not in rules:
            continue
        raw.extend(cls().run(project))

    suppressed = 0
    kept: List[Finding] = []
    for f in raw:
        mod = project.get(f.path)
        if mod is not None and mod.is_disabled(f.line, f.rule):
            suppressed += 1
            continue
        if paths is not None and not any(
                f.path == p or f.path.startswith(p.rstrip("/") + "/")
                or f.path.startswith(p)
                for p in paths):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    if use_baseline:
        base = _baseline.load(root)
        new, old, stale = _baseline.split(kept, base)
    else:
        new, old, stale = kept, [], []
    return LintResult(findings=new, baselined=old, suppressed=suppressed,
                      stale_baseline=stale,
                      files_scanned=len(project.modules),
                      parse_errors=parse_errors)


def rewrite_baseline(root: str,
                     rules: Optional[Sequence[str]] = None) -> str:
    """Record the current finding set as the new baseline; returns the
    baseline path."""
    result = run_lint(root, rules=rules, use_baseline=False)
    return _baseline.save(root, result.findings)
