"""raylint: AST static analysis enforcing the control plane's invariants.

Five rules, each guarding a load-bearing convention nothing else checks:

  * ``async-blocking``      — no blocking calls reachable from the
                              cluster's event-loop coroutines;
  * ``wire-discipline``     — every wire frame has a paired encoder +
                              decoder, collision-free id, version gate
                              with pickle fallback, handler site, and a
                              codec test;
  * ``kernel-purity``       — every jit'd scheduler pass has a
                              bit-identical scalar reference, a property
                              test naming both, and a pure traced body;
  * ``thread-shared-state`` — cross-thread attribute mutation without a
                              lock;
  * ``hot-path``            — ``# raylint: hotpath`` functions stay free
                              of pickle/json/INFO-logging/eager f-string
                              logs.

Run it with ``python ray_tpu_torch/scripts/lint.py`` (``--changed`` for
pre-commit, ``--baseline-rewrite`` to re-record known debt). The committed
baseline lives in ``.raylint_torch_baseline.json``;
``tests/test_torch_lint.py`` is the tier-1 gate keeping the port clean.
See docs/devtools.md for the rule catalog and annotation syntax.
"""

from .engine import (ALL_CHECKERS, RULE_IDS, LintResult, load_project,
                     rewrite_baseline, run_lint)
from .model import Checker, Finding, Module, Project

__all__ = [
    "ALL_CHECKERS", "RULE_IDS", "LintResult", "Checker", "Finding",
    "Module", "Project", "load_project", "rewrite_baseline", "run_lint",
]
