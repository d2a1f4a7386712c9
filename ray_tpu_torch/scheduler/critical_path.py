"""Job-level critical-path analysis over recorded DAG timelines.

The GCS task table already holds everything a job profile needs: dep
edges (object ids embed their producing task), lifecycle stamps
(``ts_submit/ts_dispatch/ts_finish``), and — since wire v7 — exact
worker-side execution windows (``ts_exec_start/ts_exec_end``) on every
completion. This module turns those rows into the two artifacts
the critical-path scheduling policies consume:

* the duration-weighted **longest path to sink** per task ("It's the
  Critical Path!", arXiv:1711.01912) — the priority signal, and
* a per-job **profile**: makespan, the critical path itself with each
  hop's gap decomposed into deps-wait / scheduler-queue /
  dispatch-to-exec buckets (queue time labeled by the
  pending-reason ledger), per-node skew, and the scheduler-efficiency
  ratio = critical-path exec lower bound / actual makespan.

Same discipline as the gang-admission kernel: ``longest_path_ref`` is
the scalar spec, ``longest_path_vec`` the vectorized pass, and the two
are pinned bit-identical under property tests. All path arithmetic is
int64 *microseconds* so equality is exact — no float accumulation
order to argue about.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "parents_from_array",
    "topo_order",
    "longest_path_ref",
    "longest_path_vec",
    "extract_path",
    "profile_rows",
    "chrome_trace",
]

# Bucket names for per-hop gap attribution. The first reuses the
# pending-reason taxonomy verbatim; queue time is labeled dynamically
# by the dominant ledger reason ("queue:<reason>").
BUCKET_DEPS = "waiting-for-deps"
BUCKET_DISPATCH = "dispatch-to-exec"
BUCKET_REGISTER = "result-register"
BUCKET_UNCLASSIFIED = "unclassified"


# ---------------------------------------------------------------------------
# Graph plumbing
# ---------------------------------------------------------------------------

def parents_from_array(parents: np.ndarray) -> List[List[int]]:
    """Adapt a ``dag.py``-shaped ``[T, K]`` int parents array (-1 pad)
    into the dedup'd adjacency lists the path passes consume."""
    out: List[List[int]] = []
    arr = np.asarray(parents)
    for i in range(arr.shape[0]):
        seen: List[int] = []
        for p in arr[i]:
            p = int(p)
            if p >= 0 and p != i and p not in seen:
                seen.append(p)
        out.append(sorted(seen))
    return out


def _children(parents: Sequence[Sequence[int]]) -> List[List[int]]:
    out: List[List[int]] = [[] for _ in parents]
    for c, ps in enumerate(parents):
        for p in ps:
            out[p].append(c)
    return out


def topo_order(parents: Sequence[Sequence[int]]) -> List[int]:
    """Kahn topological order (parents before children). Edges that
    would form a cycle — impossible from real lineage, but hand-built
    test inputs may try — are dropped by simply stopping early; the
    unreached remainder is appended in index order so every node gets
    a slot and downstream passes stay total."""
    n = len(parents)
    indeg = [len(ps) for ps in parents]
    children = _children(parents)
    stack = sorted((i for i in range(n) if indeg[i] == 0), reverse=True)
    order: List[int] = []
    while stack:
        u = stack.pop()
        order.append(u)
        for c in children[u]:
            indeg[c] -= 1
            if indeg[c] == 0:
                stack.append(c)
        stack.sort(reverse=True)
    if len(order) < n:
        seen = set(order)
        order.extend(i for i in range(n) if i not in seen)
    return order


# ---------------------------------------------------------------------------
# Longest path to sink — scalar spec and vectorized pass
# ---------------------------------------------------------------------------

def longest_path_ref(
    exec_us: Sequence[int], parents: Sequence[Sequence[int]]
) -> List[int]:
    """Scalar spec: ``down[i] = exec[i] + max(down[children(i)])`` by a
    reverse-topological sweep. Pure-python ints, so no overflow and no
    rounding — this is the value the vectorized pass must match
    bit-for-bit."""
    n = len(parents)
    children = _children(parents)
    down = [0] * n
    for u in reversed(topo_order(parents)):
        best = 0
        for c in children[u]:
            if down[c] > best:
                best = down[c]
        down[u] = int(exec_us[u]) + best
    return down


def longest_path_vec(
    exec_us: Sequence[int], parents: Sequence[Sequence[int]]
) -> np.ndarray:
    """Vectorized pass: edges are grouped by the *child's* depth and
    relaxed deepest-first with ``np.maximum.at``. A node appears as a
    child only at its own depth, and its children sit strictly deeper,
    so by the time an edge reads ``down[child]`` every contribution to
    that child has already landed — one scatter-max per DAG level
    instead of a python loop per node."""
    n = len(parents)
    exec_arr = np.asarray(exec_us, dtype=np.int64)
    down = exec_arr.copy()
    if n == 0:
        return down
    p_idx: List[int] = []
    c_idx: List[int] = []
    for c, ps in enumerate(parents):
        for p in ps:
            p_idx.append(p)
            c_idx.append(c)
    if not p_idx:
        return down
    pa = np.asarray(p_idx, dtype=np.int64)
    ca = np.asarray(c_idx, dtype=np.int64)
    depth = np.zeros(n, dtype=np.int64)
    for u in topo_order(parents):
        ps = parents[u]
        if ps:
            depth[u] = max(int(depth[p]) for p in ps) + 1
    child_depth = depth[ca]
    for d in np.unique(child_depth)[::-1]:
        sel = child_depth == d
        np.maximum.at(down, pa[sel], exec_arr[pa[sel]] + down[ca[sel]])
    return down


def extract_path(
    down: Sequence[int],
    exec_us: Sequence[int],
    parents: Sequence[Sequence[int]],
) -> List[int]:
    """Walk one longest path deterministically: start at the global
    argmax of ``down`` (smallest index on ties), then repeatedly step
    to the smallest-index child whose ``down`` accounts for the
    remainder. Both passes feed the same walk, so tie-breaks can never
    diverge between them."""
    n = len(parents)
    if n == 0:
        return []
    children = _children(parents)
    start = 0
    for i in range(1, n):
        if down[i] > down[start]:
            start = i
    path = [start]
    cur = start
    while True:
        want = int(down[cur]) - int(exec_us[cur])
        if want <= 0:
            # Sink (or all downstream work is zero-width — stop rather
            # than chain through empty nodes).
            break
        nxt = -1
        for c in children[cur]:
            if int(down[c]) == want:
                nxt = c
                break
        if nxt < 0:
            break
        path.append(nxt)
        cur = nxt
    return path


# ---------------------------------------------------------------------------
# Profile assembly
# ---------------------------------------------------------------------------

def _exec_window(row: Dict[str, Any]) -> Tuple[float, float]:
    t0 = float(row.get("ts_exec_start") or 0.0)
    t1 = float(row.get("ts_exec_end") or 0.0)
    if t1 > 0.0 and t1 >= t0 > 0.0:
        return t0, t1
    # Stamp-less rows (pre-v7 peers, failed tasks): synthesize a window
    # from coarse lifecycle stamps so the task still has exec weight.
    exec_s = float(row.get("exec_s") or 0.0)
    fin = float(row.get("ts_finish") or 0.0)
    if exec_s > 0.0 and fin > 0.0:
        return fin - exec_s, fin
    return 0.0, 0.0


def _exec_us(row: Dict[str, Any]) -> int:
    t0, t1 = _exec_window(row)
    return max(0, int(round((t1 - t0) * 1e6)))


def _dominant_reason(row: Dict[str, Any]) -> str:
    ledger = row.get("reason_s") or {}
    best, best_s = BUCKET_UNCLASSIFIED, 0.0
    for name, secs in ledger.items():
        if float(secs) > best_s:
            best, best_s = str(name), float(secs)
    return best


def _hop_buckets(
    row: Dict[str, Any],
    gap_s: float,
    ready_at: float,
    prev_end: float,
) -> Dict[str, float]:
    """Decompose one hop gap (path-parent exec end → this task's exec
    start) into deps-wait, scheduler-queue (labeled by the dominant
    pending-reason ledger entry), and dispatch-to-exec. Each bucket is
    clamped into the remaining gap, so by construction the buckets sum
    exactly to the (non-negative) gap — which is what makes the
    job-level identity `sum(blocked) == makespan - critical exec` hold.
    """
    out: Dict[str, float] = {}
    remain = max(0.0, gap_s)
    deps = 0.0
    if ready_at > 0.0 and prev_end > 0.0:
        deps = min(remain, max(0.0, ready_at - prev_end))
    if deps > 0.0:
        out[BUCKET_DEPS] = deps
        remain -= deps
    t0, _ = _exec_window(row)
    disp = 0.0
    dispatch = float(row.get("ts_dispatch") or 0.0)
    if dispatch > 0.0 and t0 > 0.0:
        disp = min(remain, max(0.0, t0 - dispatch))
    queue = remain - disp
    if queue > 1e-9:
        out["queue:" + _dominant_reason(row)] = queue
    if disp > 0.0:
        out[BUCKET_DISPATCH] = disp
    return out


def profile_rows(
    rows: List[Dict[str, Any]],
    job_id: str = "",
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Assemble the full job profile from state-API-shaped task rows.

    Rows need ``task_id`` (hex), ``deps`` (parent *task* hex ids),
    the lifecycle stamps, and optionally ``reason_s`` / ``node_id`` /
    ``name``. Returns a plain-JSON dict (the ``job_profile`` RPC body).
    """
    rows = sorted(
        rows,
        key=lambda r: (float(r.get("ts_submit") or 0.0),
                       str(r.get("task_id") or "")),
    )
    n = len(rows)
    index = {str(r.get("task_id") or ""): i for i, r in enumerate(rows)}
    parents: List[List[int]] = []
    for i, r in enumerate(rows):
        ps: List[int] = []
        for dep in r.get("deps") or ():
            j = index.get(str(dep))
            if j is not None and j != i and j not in ps:
                ps.append(j)
        parents.append(sorted(ps))
    exec_us = [_exec_us(r) for r in rows]

    down = longest_path_vec(exec_us, parents)
    path = extract_path(down, exec_us, parents)

    # --- makespan bounds ---
    submits = [float(r.get("ts_submit") or 0.0) for r in rows]
    t0 = min((t for t in submits if t > 0.0), default=0.0)
    t1 = 0.0
    for r in rows:
        t1 = max(t1, float(r.get("ts_finish") or 0.0),
                 _exec_window(r)[1])
    if t1 <= 0.0 and now is not None:
        t1 = float(now)
    makespan = max(0.0, t1 - t0) if t0 > 0.0 else 0.0

    # --- walk the critical path, decomposing every inter-hop gap ---
    hops: List[Dict[str, Any]] = []
    blocked: Dict[str, float] = {}
    critical_exec = 0.0
    prev_end = t0
    for step, i in enumerate(path):
        r = rows[i]
        w0, w1 = _exec_window(r)
        gap = max(0.0, (w0 - prev_end)) if w0 > 0.0 else 0.0
        ready_at = 0.0
        for p in parents[i]:
            ready_at = max(ready_at, float(rows[p].get("ts_finish") or 0.0),
                           _exec_window(rows[p])[1])
        buckets = _hop_buckets(r, gap, ready_at, prev_end)
        for k, v in buckets.items():
            blocked[k] = blocked.get(k, 0.0) + v
        exec_s = exec_us[i] / 1e6
        critical_exec += exec_s
        hops.append({
            "task_id": str(r.get("task_id") or ""),
            "name": r.get("name") or "",
            "kind": r.get("kind") or "",
            "node_id": r.get("node_id") or "",
            "state": r.get("state") or "",
            "exec_s": exec_s,
            "gap_s": gap,
            "buckets": buckets,
        })
        if w1 > 0.0:
            prev_end = w1
    # Tail: last exec end → job end is result registration / release.
    if path and t1 > prev_end:
        tail = t1 - prev_end
        blocked[BUCKET_REGISTER] = blocked.get(BUCKET_REGISTER, 0.0) + tail

    # --- job-wide rollups ---
    states: Dict[str, int] = {}
    reason_s: Dict[str, float] = {}
    nodes: Dict[str, Dict[str, float]] = {}
    for i, r in enumerate(rows):
        st = str(r.get("state") or "")
        states[st] = states.get(st, 0) + 1
        for name, secs in (r.get("reason_s") or {}).items():
            reason_s[str(name)] = reason_s.get(str(name), 0.0) + float(secs)
        node = str(r.get("node_id") or "")
        if node:
            agg = nodes.setdefault(node, {"tasks": 0, "exec_s": 0.0})
            agg["tasks"] += 1
            agg["exec_s"] += exec_us[i] / 1e6
    skew = 0.0
    if nodes:
        loads = [a["exec_s"] for a in nodes.values()]
        mean = sum(loads) / len(loads)
        skew = (max(loads) / mean) if mean > 0 else 0.0

    blocked_total = sum(blocked.values())
    efficiency = (critical_exec / makespan) if makespan > 0 else 0.0
    return {
        "job_id": job_id,
        "num_tasks": n,
        "states": states,
        "t_start": t0,
        "t_end": t1,
        "makespan_s": makespan,
        "critical_path": hops,
        "critical_len": len(path),
        "critical_exec_s": critical_exec,
        "efficiency": min(1.0, efficiency),
        "blocked_s": blocked,
        "blocked_total_s": blocked_total,
        "reason_s": reason_s,
        "nodes": nodes,
        "node_skew": skew,
    }


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def chrome_trace(rows: List[Dict[str, Any]], job_id: str = "") -> Dict[str, Any]:
    """Render the job timeline as Chrome trace-event JSON (loads in
    Perfetto / chrome://tracing). One lane (tid) per node, a complete
    "X" slice per task's exec window, and an "s"/"f" flow arrow per
    recorded dep edge so parent→child structure is visible on the
    timeline. Timestamps are microseconds relative to the earliest
    submit, which keeps the numbers small enough for the JSON viewer."""
    rows = sorted(
        rows,
        key=lambda r: (float(r.get("ts_submit") or 0.0),
                       str(r.get("task_id") or "")),
    )
    t0 = min((float(r.get("ts_submit") or 0.0) for r in rows
              if float(r.get("ts_submit") or 0.0) > 0.0), default=0.0)

    def us(t: float) -> int:
        return max(0, int(round((t - t0) * 1e6)))

    lanes: Dict[str, int] = {}
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": f"job {job_id}" if job_id else "job"},
    }]
    index = {str(r.get("task_id") or ""): r for r in rows}
    for r in rows:
        node = str(r.get("node_id") or "") or "(unplaced)"
        if node not in lanes:
            lanes[node] = len(lanes) + 1
            events.append({
                "ph": "M", "pid": 1, "tid": lanes[node],
                "name": "thread_name",
                "args": {"name": f"node {node[:12]}"},
            })
    flow = 0
    for r in rows:
        w0, w1 = _exec_window(r)
        if w1 <= 0.0:
            continue
        node = str(r.get("node_id") or "") or "(unplaced)"
        tid = lanes[node]
        name = r.get("name") or (str(r.get("task_id") or "")[:12])
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": name,
            "cat": r.get("kind") or "task",
            "ts": us(w0), "dur": max(1, us(w1) - us(w0)),
            "args": {
                "task_id": str(r.get("task_id") or ""),
                "state": r.get("state") or "",
                "reason_s": r.get("reason_s") or {},
            },
        })
        for dep in r.get("deps") or ():
            pr = index.get(str(dep))
            if pr is None:
                continue
            p0, p1 = _exec_window(pr)
            if p1 <= 0.0:
                continue
            pnode = str(pr.get("node_id") or "") or "(unplaced)"
            flow += 1
            events.append({
                "ph": "s", "pid": 1, "tid": lanes[pnode], "name": "dep",
                "cat": "dep", "id": flow, "ts": us(p1),
            })
            events.append({
                "ph": "f", "pid": 1, "tid": tid, "name": "dep",
                "cat": "dep", "id": flow, "ts": us(w0), "bp": "e",
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
