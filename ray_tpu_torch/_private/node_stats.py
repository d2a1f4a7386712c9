"""Per-node physical stats sampler (reference: python/ray/dashboard/
reporter.py, which shells out to psutil; psutil isn't in this image, so the
sampler reads /proc directly — Linux is the only deploy target).

Stateful: CPU percentages are deltas between consecutive ``sample()`` calls
(first call returns 0% like psutil's interval=None convention).

The port's copy of ``ray_tpu/_private/node_stats.py``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, Iterable, Optional

_CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _read_cpu_total() -> Optional[tuple]:
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [int(v) for v in parts[1:]]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        return sum(vals), idle
    except (OSError, ValueError, IndexError):
        return None


def _read_meminfo() -> Dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                out[key] = int(rest.split()[0]) * 1024  # kB -> bytes
    except (OSError, ValueError, IndexError):
        pass
    return out


def _read_proc_cpu(pid: int) -> Optional[float]:
    """Cumulative CPU seconds of one process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        # utime, stime are fields 14,15 (1-indexed); after the comm split
        # they land at offsets 11,12.
        return (int(fields[11]) + int(fields[12])) / _CLK
    except (OSError, ValueError, IndexError):
        return None


def _read_proc_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class NodeStatsSampler:
    def __init__(self):
        self._last_total: Optional[tuple] = None
        self._last_proc: Dict[int, tuple] = {}  # pid -> (wall, cpu_seconds)

    def sample(self, worker_pids: Iterable[int] = ()) -> Dict:
        now = time.monotonic()
        stats: Dict = {"ts": time.time(), "num_cpus": os.cpu_count() or 1}

        cur = _read_cpu_total()
        if cur is not None and self._last_total is not None:
            d_total = cur[0] - self._last_total[0]
            d_idle = cur[1] - self._last_total[1]
            stats["cpu_percent"] = round(
                100.0 * (d_total - d_idle) / max(d_total, 1), 1)
        else:
            stats["cpu_percent"] = 0.0
        if cur is not None:
            self._last_total = cur

        mem = _read_meminfo()
        if mem:
            total = mem.get("MemTotal", 0)
            avail = mem.get("MemAvailable", 0)
            stats["mem_total_bytes"] = total
            stats["mem_available_bytes"] = avail
            stats["mem_percent"] = round(
                100.0 * (total - avail) / max(total, 1), 1)
        try:
            stats["load_avg"] = list(os.getloadavg())
        except OSError:
            stats["load_avg"] = [0.0, 0.0, 0.0]
        try:
            du = shutil.disk_usage(tempfile.gettempdir())
            stats["disk_percent"] = round(100.0 * du.used / max(du.total, 1), 1)
        except OSError:
            pass

        workers = []
        seen = set()
        for pid in list(worker_pids):
            seen.add(pid)
            cpu_s = _read_proc_cpu(pid)
            if cpu_s is None:
                continue
            pct = 0.0
            last = self._last_proc.get(pid)
            if last is not None and now > last[0]:
                pct = round(100.0 * (cpu_s - last[1]) / (now - last[0]), 1)
            self._last_proc[pid] = (now, cpu_s)
            workers.append({"pid": pid, "cpu_percent": max(pct, 0.0),
                            "rss_bytes": _read_proc_rss(pid)})
        for pid in list(self._last_proc):
            if pid not in seen:
                del self._last_proc[pid]
        stats["workers"] = workers
        return stats
