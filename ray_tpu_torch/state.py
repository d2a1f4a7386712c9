"""Global state API (reference: python/ray/state.py GlobalState).

Snapshot queries over the running system: nodes, actors, objects, resources,
the memory summary that backs the ``ray memory`` CLI view, and — state API
v2 — the bounded/filterable/paginated task table (``tasks()`` /
``summarize_tasks()``) with per-task pending-reason attribution.

The port's copy of ``ray_tpu/state.py`` for the local runtime: every query
reads the in-process runtime. The reference's cluster branches (the GCS
task table, object directory and node-stats table) come with the cluster
runtime (A6 of ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ._private.worker import global_worker


def _core():
    worker = global_worker()
    worker.check_connected()
    return worker.core


def tasks(state: Optional[str] = None, kind: Optional[str] = None,
          node_id: Optional[str] = None, reason: Optional[str] = None,
          name_contains: Optional[str] = None,
          limit: int = 1000, offset: int = 0) -> List[Dict[str, Any]]:
    """Query the cluster task table (reference: Ray's state API
    ``list_tasks``). Each row carries the lifecycle (state + wall-clock
    stamps ``ts_submit``/``ts_dispatch``/``ts_finish``) and, for PENDING
    tasks, the scheduler's pending-reason attribution (waiting-for-deps /
    waiting-for-capacity / infeasible / waiting-for-pg / quota-throttled).

    Filterable by ``state``/``kind``/``node_id``/``reason``/
    ``name_contains``; paginated by ``limit``/``offset`` (server-capped at
    10k rows per page). Local mode serves the same row shape from the
    in-process runtime's task records (same lifecycle + exec stamps, so
    durations don't read 0 in local runs)."""
    rows = [r for r in _local_task_rows(_core())
            if (not state or r["state"] == state)
            and (not kind or r["kind"] == kind)
            and (not node_id or r["node_id"] == node_id)
            and (not reason or r.get("pending_reason") == reason)
            and (not name_contains or name_contains in r["name"])]
    return rows[offset:offset + limit]


def _local_task_rows(core) -> List[Dict[str, Any]]:
    rows = getattr(core, "task_rows", None)
    return rows() if callable(rows) else []


def summarize_tasks() -> Dict[str, Any]:
    """Per-state counts over the cluster task table, with the PENDING set
    broken down by pending reason:
    ``{total, states, kinds, pending_reasons, ...}``. The summary is
    kept by the cluster's task table (A6); the local runtime gives the
    empty summary, as the reference's local mode does."""
    _core()
    return {"total": 0, "states": {}, "kinds": {}, "pending_reasons": {}}


def nodes() -> List[Dict[str, Any]]:
    return _core().nodes()


def actors() -> Dict[str, Dict[str, Any]]:
    """actor_id hex -> {ActorID, State, Name} (reference state.py actors)."""
    return _core().actors()


def objects() -> Dict[str, Dict[str, Any]]:
    """object_id hex -> {size, has_error} for every stored object.

    Reads the in-process store (reference: GlobalState.objects over the
    GCS object table)."""
    store = _core().store
    out = {}
    with store._lock:
        for oid, obj in store._objects.items():
            out[oid.hex()] = {
                "size_bytes": obj.nbytes,
                "has_error": obj.error is not None,
            }
    return out


_local_sampler = None


def node_stats() -> Dict[str, Dict[str, Any]]:
    """node_id -> physical stats from each node's reporter (reference:
    dashboard reporter datapath). Local mode samples this process's host."""
    _core()
    global _local_sampler
    from ._private.node_stats import NodeStatsSampler

    if _local_sampler is None:
        _local_sampler = NodeStatsSampler()
    import os as _os

    return {"local": _local_sampler.sample([_os.getpid()])}


def cluster_resources() -> Dict[str, float]:
    return _core().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _core().available_resources()


def object_store_stats() -> Dict[str, int]:
    return _core().store.stats()


def memory_summary() -> str:
    """Human-readable object-store summary (reference: `ray memory`,
    scripts.py:1084 + memory.py)."""
    objs = objects()
    stats = object_store_stats()
    lines = [
        "=== Object store summary ===",
        f"objects: {len(objs)}",
        f"used_bytes: {stats.get('used_bytes', 0)}",
        f"max_bytes: {stats.get('max_bytes', 0) or 'unlimited'}",
        "",
        f"{'OBJECT_ID':<44} {'SIZE':>12}  ERROR",
    ]
    for oid, info in sorted(objs.items(),
                            key=lambda kv: -kv[1]["size_bytes"])[:50]:
        lines.append(
            f"{oid:<44} {info['size_bytes']:>12}  {info['has_error']}")
    return "\n".join(lines)


def jobs() -> List[Dict[str, Any]]:
    """Per-job rollup rows (`cli jobs`): task/state counts, submit /
    finish bounds, and — once the GCS profiler tick has analyzed a
    completed job — its efficiency figures. Local mode rolls up the
    in-process task records; with no records yet it degrades to the
    single driver-job row."""
    core = _core()
    by_job: Dict[str, Dict[str, Any]] = {}
    for r in _local_task_rows(core):
        job = r["task_id"][24:32]  # tail 4 bytes of the 16-byte TaskID
        row = by_job.setdefault(job, {
            "job_id": job, "tasks": 0, "states": {},
            "ts_first_submit": 0.0, "ts_last_finish": 0.0})
        row["tasks"] += 1
        row["states"][r["state"]] = row["states"].get(r["state"], 0) + 1
        ts = r.get("ts_submit") or 0.0
        if ts and (not row["ts_first_submit"] or ts < row["ts_first_submit"]):
            row["ts_first_submit"] = ts
        row["ts_last_finish"] = max(row["ts_last_finish"],
                                    r.get("ts_finish") or 0.0)
    if not by_job:
        return [{"job_id": core.job_id.hex(), "is_dead": False}]
    for row in by_job.values():
        row["active"] = any(st not in ("FINISHED", "FAILED")
                            for st in row["states"])
        row["is_dead"] = not row["active"]
    return sorted(by_job.values(), key=lambda j: j["ts_first_submit"])


def job_profile(job_id: Optional[str] = None) -> Dict[str, Any]:
    """Critical-path profile of one job (hex prefix accepted; omitted =
    the only job): makespan, the duration-weighted longest path with
    per-hop blocked-time buckets, per-node skew, and the
    scheduler-efficiency ratio (critical-path exec lower bound / actual
    makespan). Profiles the in-process records directly."""
    rows, job = _local_job_rows(_core(), job_id)
    from .scheduler import critical_path as _cp
    import time as _time

    return _cp.profile_rows(rows, job_id=job, now=_time.time())


def job_timeline(job_id: Optional[str] = None,
                 path: Optional[str] = None):
    """Chrome-trace / Perfetto export of a job's DAG timeline: one lane
    per node, one slice per task exec window, flow arrows per dep edge.
    With ``path``, writes the JSON file and returns the path; without,
    returns the trace dict (``json.dump``-able)."""
    rows, job = _local_job_rows(_core(), job_id)
    from .scheduler import critical_path as _cp

    trace = _cp.chrome_trace(rows, job_id=job)
    if path:
        import json

        with open(path, "w") as f:
            json.dump(trace, f)
        return path
    return trace


def _local_job_rows(core, job_id: Optional[str]):
    """(rows, job_hex) for one job out of the local records, with the
    same prefix-match/ambiguity contract as the GCS handler."""
    rows = _local_task_rows(core)
    all_jobs = sorted({r["task_id"][24:32] for r in rows})
    want = (job_id or "").lower()
    matches = [j for j in all_jobs if j.startswith(want)] \
        if want else all_jobs
    if not matches:
        raise ValueError(f"no job matching {want!r}")
    if len(matches) > 1:
        raise ValueError(f"{len(matches)} jobs match {want!r}: {matches}")
    job = matches[0]
    return [r for r in rows if r["task_id"][24:32] == job], job
