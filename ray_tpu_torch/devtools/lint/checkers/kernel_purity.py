"""kernel-purity: every scheduler pass stays pure and verifiable.

The data-parallel placement passes are the repo's differentiator vs the
reference's sequential loop (Ray, arXiv:1712.05889) — and the entire
safety argument rests on each pass having a bit-identical scalar reference
that property tests pin (placement, gang admission, and pending-reason
classification all ship that way today; Tesserae, arXiv:2508.04953, makes
the same argument for evolving policies against a pinned spec). The port's
passes are plain torch functions with no decorator to find them by:
``scheduler/kernel.py`` names them in its module-level ``PASSES`` tuple.
This checker makes the convention structural:

  1. every name in ``PASSES`` must be a function of ``kernel.py`` with a
     ``<name>_reference`` in ``scheduler/reference.py`` — or be a shared
     spec helper the reference itself imports (directly or via its
     ``<name>_host`` wrapper);
  2. some ``tests/test_torch_*.py`` module must exercise the pair by
     naming BOTH the pass and its reference (the property-test handle);
  3. pass bodies must be pure: no ``time``/``random``/``np.random`` draws,
     no host side effects (``print``/``open``/``os.*``), and no draw from
     torch's own generators — the threefry helpers (``task_bits``) are
     the sanctioned draws, and ``torch.*`` calls the sanctioned ops.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..model import Checker, Finding, Module, Project, call_root

KERNEL_PATH = "ray_tpu_torch/scheduler/kernel.py"
REFERENCE_PATH = "ray_tpu_torch/scheduler/reference.py"
TESTS_PREFIX = "tests/test_torch_"
PASSES_NAME = "PASSES"

IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                   "os.", "datetime.", "torch.random.", "torch.cuda.random.")
IMPURE_CALLS = {"print", "open", "input", "eval", "exec"}
# torch's own generators: a draw from one depends on every earlier draw
# in the process, so a pass that made one would not be its reference's.
TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
               "torch.randperm", "torch.normal", "torch.bernoulli",
               "torch.multinomial", "torch.poisson", "torch.rand_like",
               "torch.randn_like", "torch.randint_like", "torch.manual_seed",
               "torch.seed"}


def _declared_passes(kernel: Module) -> Tuple[int, Optional[List[str]]]:
    """(line, names) of the module-level ``PASSES = (...)`` tuple; names
    is None when there is none or it holds anything but string literals."""
    for node in kernel.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == PASSES_NAME
                for t in node.targets):
            elts = getattr(node.value, "elts", None)
            if isinstance(node.value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in elts):
                return node.lineno, [e.value for e in elts]
            return node.lineno, None
    return 1, None


class KernelPurityChecker(Checker):
    rule_id = "kernel-purity"
    description = ("scheduler passes: scalar reference mirror, property "
                   "test naming both, no host effects or torch draws")

    def run(self, project: Project) -> Iterator[Finding]:
        kernel = project.get(KERNEL_PATH)
        if kernel is None:
            return
        reference = project.get(REFERENCE_PATH)

        decl_line, names = _declared_passes(kernel)
        if names is None:
            yield Finding(
                rule=self.rule_id, path=kernel.relpath, line=decl_line,
                col=0,
                message=(f"{KERNEL_PATH} declares no `{PASSES_NAME}` tuple "
                         f"of pass names (string literals)"),
                hint="list every placement pass by name in a module-level "
                     "PASSES tuple",
                symbol=PASSES_NAME)
            return

        fns: Dict[str, ast.AST] = {
            node.name: node for node in kernel.tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}

        ref_defs: Set[str] = set()
        ref_imports: Set[str] = set()
        if reference is not None:
            for node in ast.walk(reference.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ref_defs.add(node.name)
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.module.endswith("kernel"):
                    ref_imports.update(a.name for a in node.names)

        test_sources = [m.source for m in project.glob(TESTS_PREFIX)]

        for name in sorted(set(names)):
            node = fns.get(name)
            if node is None:
                yield Finding(
                    rule=self.rule_id, path=kernel.relpath,
                    line=decl_line, col=0,
                    message=(f"`{PASSES_NAME}` names `{name}`, which is no "
                             f"function of {KERNEL_PATH}"),
                    hint="define the pass or take its name off PASSES",
                    symbol=name)
                continue
            ref_name = f"{name}_reference"
            # Shared-spec helpers (e.g. the threefry draw both sides use)
            # are exempt: the reference imports them (or their _host
            # wrapper), so they ARE the spec rather than mirroring one.
            shared = name in ref_imports or f"{name}_host" in ref_imports
            if not shared and reference is not None \
                    and ref_name not in ref_defs:
                yield Finding(
                    rule=self.rule_id, path=kernel.relpath,
                    line=node.lineno, col=0,
                    message=(f"pass `{name}` has no `{ref_name}` in "
                             f"{REFERENCE_PATH}"),
                    hint="add the bit-identical scalar mirror (or import "
                         "the helper into reference.py if it IS the spec)",
                    symbol=name)
            elif not shared and reference is not None and test_sources:
                if not any(name in src and ref_name in src
                           for src in test_sources):
                    yield Finding(
                        rule=self.rule_id, path=kernel.relpath,
                        line=node.lineno, col=0,
                        message=(f"no test module names both `{name}` and "
                                 f"`{ref_name}` (bit-identity property "
                                 f"test missing)"),
                        hint="add a property test asserting pass == "
                             "reference on random + adversarial inputs",
                        symbol=name)
            yield from self._check_purity(kernel, name, node)

    def _check_purity(self, kernel: Module, name: str,
                      fn: ast.AST) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = call_root(node.func)
            if not dotted:
                continue
            impure = dotted in IMPURE_CALLS or dotted in TORCH_DRAWS \
                or any(dotted.startswith(p) for p in IMPURE_PREFIXES)
            if impure:
                yield Finding(
                    rule=self.rule_id, path=kernel.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=(f"host call `{dotted}` inside pass `{name}` "
                             f"(its reference cannot make the same one)"),
                    hint="hoist host work out of the pass; draw with the "
                         "threefry helpers (task_bits)",
                    symbol=name)
