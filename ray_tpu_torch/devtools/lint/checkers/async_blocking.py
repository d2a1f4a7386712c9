"""async-blocking: no blocking calls reachable from event-loop coroutines.

The control plane's throughput ceiling *is* the head's event loop (the
measured ~300 µs/task of ROADMAP item 3 lives in it), so a single stray
``time.sleep`` / sync file read / subprocess wait inside any of the
cluster's ``async def`` handlers stalls every connection at once.

The checker walks every ``async def`` in the cluster sources and flags
blocking primitives in its body — and, because handlers delegate to sync
helper methods, it also follows plain same-module calls (``self.foo()``,
``foo()``) a few hops deep and attributes the blocking site back to the
coroutines that can reach it. Function *references* passed to
``asyncio.to_thread`` / ``run_in_executor`` are not calls and are never
descended into, so the standard off-loop escape hatches come out clean.

``pickle.dumps``/``loads`` are flagged only when written directly in a
coroutine body: a pickle of an unbounded live structure stalls the loop
for as long as the structure is large, which is invisible in code review
precisely because it looks cheap. Bounded/deliberate cases carry a
``# raylint: disable=async-blocking`` with a justification.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..model import Checker, Finding, Module, Project, call_root, qualname_map

# Dotted-name call targets that block the calling thread.
BLOCKING_CALLS: Dict[str, str] = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "move to a thread: `await asyncio.to_thread(...)`",
    "subprocess.call": "move to a thread: `await asyncio.to_thread(...)`",
    "subprocess.check_call": "move to a thread: `await asyncio.to_thread(...)`",
    "subprocess.check_output": "move to a thread: `await asyncio.to_thread(...)`",
    "subprocess.Popen": "spawn off-loop: `await asyncio.to_thread(...)` "
                        "(fork+exec blocks for milliseconds)",
    "os.system": "use asyncio.create_subprocess_exec or a thread",
    "socket.create_connection": "connect in a thread or use asyncio streams",
    "open": "file I/O blocks the loop: `await asyncio.to_thread(...)`",
    "os.listdir": "disk metadata I/O: `await asyncio.to_thread(...)`",
    "os.scandir": "disk metadata I/O: `await asyncio.to_thread(...)`",
    "os.stat": "disk metadata I/O: `await asyncio.to_thread(...)`",
    "os.remove": "disk I/O: `await asyncio.to_thread(...)`",
    "os.unlink": "disk I/O: `await asyncio.to_thread(...)`",
    "os.rename": "disk I/O: `await asyncio.to_thread(...)`",
    "os.replace": "disk I/O: `await asyncio.to_thread(...)`",
    "os.makedirs": "disk I/O: `await asyncio.to_thread(...)`",
    "os.fsync": "disk I/O: `await asyncio.to_thread(...)`",
    "shutil.rmtree": "disk I/O: `await asyncio.to_thread(...)`",
}

# Direct-only: flagged when written in the coroutine body itself (see
# module docstring for why transitive pickle would be all noise).
DIRECT_ONLY_CALLS: Dict[str, str] = {
    "pickle.dumps": "loop-thread pickle of an unbounded structure; "
                    "serialize off-loop or bound and annotate",
    "pickle.loads": "loop-thread unpickle of an unbounded blob; "
                    "deserialize off-loop or bound and annotate",
}

# Method names that block when called un-awaited on a non-asyncio object.
BLOCKING_METHODS: Dict[str, str] = {
    "recv": "sync socket read on the event loop",
    "recv_into": "sync socket read on the event loop",
    "recvfrom": "sync socket read on the event loop",
    "sendall": "sync socket write on the event loop",
    "sendmsg": "sync socket write on the event loop",
    "accept": "sync socket accept on the event loop",
    "connect": "sync socket connect on the event loop",
    "join": "thread/process join blocks the loop",
}

# `.join` is shared with str.join: only flag it when the receiver name
# says thread/process (``sep.join(parts)`` must never fire the rule).
_JOIN_RECEIVER_HINTS = ("thread", "proc", "worker", "sampler", "pump")

MAX_DEPTH = 3  # call-graph hops followed out of an async def


def _local_name(node: ast.expr) -> Optional[str]:
    """Resolve a call target to a same-module function key: 'foo' for
    plain calls, 'self.foo' collapsed to 'foo' for method calls."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _FnInfo:
    __slots__ = ("node", "qual", "is_async", "calls", "blocking")

    def __init__(self, node, qual: str, is_async: bool):
        self.node = node
        self.qual = qual
        self.is_async = is_async
        self.calls: List[Tuple[str, int]] = []     # (callee key, line)
        # (line, col, dotted target, hint)
        self.blocking: List[Tuple[int, int, str, str]] = []


def _collect_functions(mod: Module) -> Dict[str, List[_FnInfo]]:
    """Index every def by bare name (methods collapse to their own name so
    ``self.foo()`` resolves across classes in the same module — a tolerable
    over-approximation for lint purposes)."""
    quals = qualname_map(mod.tree)
    by_name: Dict[str, List[_FnInfo]] = {}

    for node, qual in quals.items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        info = _FnInfo(node, qual, isinstance(node, ast.AsyncFunctionDef))
        _scan_body(node, info)
        by_name.setdefault(node.name, []).append(info)
    return by_name


def _scan_body(fn: ast.AST, info: _FnInfo) -> None:
    """Record blocking primitives and same-module calls in ``fn``'s own
    body (nested defs are separate functions; entering them here would
    misattribute thread-target closures to the enclosing coroutine)."""
    awaited_calls: Set[ast.Call] = set()

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            awaited_calls.add(node.value)
        if isinstance(node, ast.Call):
            dotted = call_root(node.func)
            if node not in awaited_calls and dotted:
                leaf = dotted.rsplit(".", 1)[-1]
                if dotted in BLOCKING_CALLS:
                    info.blocking.append((node.lineno, node.col_offset,
                                          dotted, BLOCKING_CALLS[dotted]))
                elif dotted in DIRECT_ONLY_CALLS:
                    info.blocking.append((node.lineno, node.col_offset,
                                          dotted,
                                          DIRECT_ONLY_CALLS[dotted]))
                elif "." in dotted and leaf in BLOCKING_METHODS \
                        and not dotted.startswith(("asyncio.",)):
                    receiver = dotted.rsplit(".", 1)[0].lower()
                    if leaf != "join" or any(
                            h in receiver for h in _JOIN_RECEIVER_HINTS):
                        info.blocking.append((node.lineno, node.col_offset,
                                              dotted,
                                              BLOCKING_METHODS[leaf]))
            key = _local_name(node.func)
            if key is not None:
                info.calls.append((key, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn, "body", []):
        visit(stmt)


class AsyncBlockingChecker(Checker):
    rule_id = "async-blocking"
    description = ("blocking calls (sleep/file/socket/subprocess/unbounded "
                   "pickle) reachable from cluster async handlers")
    # serve/ is included because the Router is an asyncio actor: one
    # blocking call in its event loop stalls EVERY endpoint's routing.
    # loopmon wraps *every* loop callback, so a blocking call there is a
    # blocking call in all monitored loops at once.
    paths = ("ray_tpu_torch/cluster/", "ray_tpu_torch/serve/",
             "ray_tpu_torch/_private/loopmon.py")

    def run(self, project: Project) -> Iterator[Finding]:
        for prefix in self.paths:
            for mod in project.glob(prefix):
                yield from self._check_module(mod)

    def _check_module(self, mod: Module) -> Iterator[Finding]:
        by_name = _collect_functions(mod)
        all_fns = [f for fns in by_name.values() for f in fns]

        # For each sync function: the set of async-def quals that reach it
        # within MAX_DEPTH same-module hops.
        reached_by: Dict[int, Set[str]] = {}
        # Direct-only findings live where they are written.
        emitted: Set[Tuple[int, int, str]] = set()

        for fn in all_fns:
            if not fn.is_async:
                continue
            seen: Set[int] = {id(fn)}
            frontier = [fn]
            depth = 0
            while frontier and depth <= MAX_DEPTH:
                nxt: List[_FnInfo] = []
                for cur in frontier:
                    reached_by.setdefault(id(cur), set()).add(fn.qual)
                    for callee_key, _line in cur.calls:
                        for cand in by_name.get(callee_key, ()):
                            # Never cross into another coroutine: calling
                            # an async def returns a coroutine object, it
                            # does not run its body here.
                            if cand.is_async or id(cand) in seen:
                                continue
                            seen.add(id(cand))
                            nxt.append(cand)
                frontier = nxt
                depth += 1

        for fn in all_fns:
            sources = reached_by.get(id(fn), set())
            if not sources:
                continue
            direct = fn.is_async
            for line, col, dotted, hint in fn.blocking:
                if dotted in DIRECT_ONLY_CALLS and not direct:
                    continue
                key = (line, col, dotted)
                if key in emitted:
                    continue
                emitted.add(key)
                if direct:
                    origin = "in coroutine body"
                else:
                    names = sorted(sources)
                    origin = f"reachable from async `{names[0]}`"
                    if len(names) > 1:
                        origin += f" (+{len(names) - 1} more)"
                yield Finding(
                    rule=self.rule_id, path=mod.relpath, line=line, col=col,
                    message=f"blocking call `{dotted}` {origin}",
                    hint=hint, symbol=fn.qual)
