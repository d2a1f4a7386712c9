"""thread-shared-state: cross-thread attribute mutation wants a lock.

Every process in the control plane runs helper threads beside its main
thread or event loop — the flight-recorder sampler, the driver's
``_stats_flush_loop``, reader threads, log pumps, GCS warm/persist
helpers. A ``self.x`` that both a thread-target method and a main-thread
method mutate without a lock is a data race the GIL merely makes rare
(TSAN catches the native twin of this; nothing caught the Python one).

Per class that starts a thread on one of its own methods
(``threading.Thread(target=self.foo)``), this checker:

  1. closes the set of methods reachable from thread entrypoints via
     ``self.method()`` calls;
  2. collects ``self.attr`` mutations (assign / augassign / del /
     ``self.attr[...] =``) per method, noting whether each occurs inside
     a ``with self.<...lock...>:`` block;
  3. flags attributes mutated on BOTH sides of the thread boundary where
     at least one mutation is unlocked. ``__init__`` doesn't count (the
     thread doesn't exist yet).

Benign cases (GIL-atomic flag stores, monotonic counters tolerating a
lost update) are annotated ``# raylint: disable=thread-shared-state``
with a justification — the annotation is the reviewed contract.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Set, Tuple

from ..model import Checker, Finding, Module, Project, call_root


@dataclass
class _Mutation:
    attr: str
    line: int
    col: int
    locked: bool


@dataclass
class _Method:
    node: ast.AST
    mutations: List[_Mutation] = field(default_factory=list)
    self_calls: Set[str] = field(default_factory=set)
    thread_targets: Set[str] = field(default_factory=set)


def _self_attr(node: ast.expr) -> str:
    """'attr' for a `self.attr` expression (possibly under Subscript)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


def _is_lock_ctx(expr: ast.expr) -> bool:
    """`with self._lock:` / `with self._counts_lock:` — any self attribute
    whose name smells like a lock."""
    attr = _self_attr(expr)
    low = attr.lower()
    return bool(attr) and ("lock" in low or "mutex" in low or "cond" in low)


def _scan_method(fn: ast.AST) -> _Method:
    info = _Method(fn)

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # nested defs are their own (closure) world
        if isinstance(node, ast.With):
            inner = locked or any(_is_lock_ctx(item.context_expr)
                                  for item in node.items)
            for item in node.items:
                visit(item.context_expr, locked)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Assign):
            flat = []
            for tgt in node.targets:
                if isinstance(tgt, (ast.Tuple, ast.List)):
                    flat.extend(tgt.elts)   # a, self.b = ... unpacking
                else:
                    flat.append(tgt)
            for tgt in flat:
                attr = _self_attr(tgt)
                if attr:
                    info.mutations.append(_Mutation(
                        attr, tgt.lineno, tgt.col_offset, locked))
        elif isinstance(node, ast.AugAssign):
            attr = _self_attr(node.target)
            if attr:
                info.mutations.append(_Mutation(
                    attr, node.target.lineno, node.target.col_offset, locked))
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr:
                    info.mutations.append(_Mutation(
                        attr, tgt.lineno, tgt.col_offset, locked))
        elif isinstance(node, ast.Call):
            dotted = call_root(node.func)
            if dotted.endswith("Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        tgt_attr = _self_attr(kw.value)
                        if tgt_attr:
                            info.thread_targets.add(tgt_attr)
            if dotted.startswith("self.") and dotted.count(".") == 1:
                info.self_calls.add(dotted.split(".", 1)[1])
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in getattr(fn, "body", []):
        visit(stmt, False)
    return info


class ThreadSharedStateChecker(Checker):
    rule_id = "thread-shared-state"
    description = ("unlocked self.attr mutations shared between a thread "
                   "entrypoint and main-thread methods")
    paths = ("ray_tpu_torch/cluster/",
             "ray_tpu_torch/_private/flight_recorder.py",
             "ray_tpu_torch/_private/timeseries.py",
             "ray_tpu_torch/monitor.py")

    def run(self, project: Project) -> Iterator[Finding]:
        for prefix in self.paths:
            for mod in project.glob(prefix):
                yield from self._check_module(mod)

    def _check_module(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node)

    def _check_class(self, mod: Module, cls: ast.ClassDef
                     ) -> Iterator[Finding]:
        methods: Dict[str, _Method] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[item.name] = _scan_method(item)

        entries: Set[str] = set()
        for m in methods.values():
            entries.update(t for t in m.thread_targets if t in methods)
        if not entries:
            return

        # Closure of thread-side methods over self.method() calls.
        thread_side: Set[str] = set()
        frontier = list(entries)
        while frontier:
            name = frontier.pop()
            if name in thread_side:
                continue
            thread_side.add(name)
            frontier.extend(c for c in methods[name].self_calls
                            if c in methods and c not in thread_side)

        # Async methods all run on one loop; they are "main side" here.
        per_attr: Dict[str, Dict[str, List[Tuple[str, _Mutation]]]] = {}
        for name, m in methods.items():
            if name == "__init__":
                continue
            side = "thread" if name in thread_side else "main"
            for mut in m.mutations:
                per_attr.setdefault(mut.attr, {}).setdefault(
                    side, []).append((name, mut))

        for attr, sides in sorted(per_attr.items()):
            if "thread" not in sides or "main" not in sides:
                continue
            unlocked = [(name, mut)
                        for muts in sides.values()
                        for name, mut in muts if not mut.locked]
            if not unlocked:
                continue
            name, mut = min(unlocked, key=lambda nm: nm[1].line)
            t_names = sorted({n for n, _ in sides["thread"]})
            m_names = sorted({n for n, _ in sides["main"]})
            yield Finding(
                rule=self.rule_id, path=mod.relpath,
                line=mut.line, col=mut.col,
                message=(f"`self.{attr}` mutated by thread-side "
                         f"{t_names} and main-side {m_names} with an "
                         f"unlocked write in `{name}`"),
                hint="guard every mutation with the owning lock, or "
                     "annotate the benign case with a justification",
                symbol=f"{cls.name}.{name}")
