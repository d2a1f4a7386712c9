"""Chaos soak for the self-healing serving fleet
(counterpart: ``scripts/serve_soak.py``; reference:
ci/long_running_tests/workloads/serve_failure.py — random
backend/replica deletion under sustained serve traffic, asserting the
client never sees a failure).

Drives a sustained request mix — whole-response calls and token streams —
at a fixed request rate while a chaos thread SIGKILLs one replica every
``--kill-every`` seconds
(``ray_tpu_torch._private.chaos.arm_replica_killer``).
The run FAILS unless all of:

* zero failed whole-response requests: every call issued during a kill is
  retried onto a sibling replica by the router's failover budget;
* streams pinned to a killed replica fail FAST with the typed
  ``ReplicaUnavailableError`` (never a hang past ``--stream-fail-budget``)
  and are the only stream failures seen;
* the fleet heals: after every kill the router is back to the full
  routable replica count within one health-check period + spawn budget;
* per-route p50/p99 stay within ``--p50-budget``/``--p99-budget``.

The backends are host-only (no tensor and no card): the soak drives the
serve control plane, its router's failover and the master's healing.

Unlike the reference's, this script has no ``--record``: that flag appends
the result to the repo's serving record, a file of the JAX package's runs
that the port leaves as it is. The result is printed as JSON.

Run:  python -m ray_tpu_torch.scripts.serve_soak --duration 30 --kill-every 5
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private.chaos import arm_replica_killer
from ray_tpu_torch.exceptions import ReplicaUnavailableError


class EchoModel:
    """Whole-response backend: a little math so calls take real time."""

    def __call__(self, x: int) -> int:
        acc = x
        for _ in range(200):
            acc = (acc * 1103515245 + 12345) % (1 << 31)
        return acc


class TickStream:
    """Streaming backend speaking the stream_start/poll/cancel protocol
    (the LMBackend wire contract) without the LM engine: each poll yields
    the next few integers until ``total`` are out."""

    def __init__(self):
        self._streams = {}
        self._n = 0
        self._lock = threading.Lock()

    def stream_start(self, total: int = 20) -> str:
        with self._lock:
            self._n += 1
            token = f"s{self._n}"
            self._streams[token] = [0, int(total)]
        return token

    def stream_poll(self, token: str, wait_s: float = 2.0) -> dict:
        with self._lock:
            st = self._streams.get(token)
            if st is None:
                return {"tokens": [], "done": True}
            lo = st[0]
            st[0] = min(st[1], lo + 4)
            done = st[0] >= st[1]
            out = list(range(lo + 1, st[0] + 1))
            if done:
                del self._streams[token]
        time.sleep(0.01)  # a poll costs something, like a decode step
        return {"tokens": out, "done": done}

    def stream_cancel(self, token: str) -> bool:
        with self._lock:
            return self._streams.pop(token, None) is not None


def _percentile(xs, q):
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(q * (len(xs) - 1))))
    return xs[i]


def run_soak(duration_s: float, kill_every_s: float, replicas: int,
             call_threads: int, stream_threads: int,
             p50_budget_ms: float, p99_budget_ms: float,
             stream_fail_budget_s: float, heal_budget_s: float) -> dict:
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    serve.init()
    probe_s = 0.5
    serve.create_backend(
        "soak:echo", EchoModel,
        config=serve.BackendConfig(
            num_replicas=replicas, health_check_period_s=probe_s,
            health_check_timeout_s=2.0, health_check_failures=1))
    serve.create_endpoint("soak_echo", backend="soak:echo")
    serve.create_backend(
        "soak:stream", TickStream,
        config=serve.BackendConfig(
            num_replicas=replicas, replica_concurrency=8,
            health_check_period_s=probe_s,
            health_check_timeout_s=2.0, health_check_failures=1))
    serve.create_endpoint("soak_stream", backend="soak:stream")

    echo = serve.get_handle("soak_echo")
    streamh = serve.get_handle("soak_stream")
    master = ray_tpu_torch.get_actor(serve.master.MASTER_NAME)

    stop = threading.Event()
    lock = threading.Lock()
    lat_ms = []
    failures = []            # (kind, repr) — ANY entry fails the run
    fast_fails = [0]         # streams failed with the typed error (allowed)
    slow_fail = [0.0]        # worst stream failure latency
    counts = {"calls": 0, "streams": 0, "tokens": 0}
    model = EchoModel()

    def call_worker(seed: int):
        i = seed
        while not stop.is_set():
            i += 1
            t0 = time.monotonic()
            try:
                out = ray_tpu_torch.get(echo.remote(i), timeout=60.0)
            except Exception as e:  # noqa: BLE001 - every failure is a finding
                with lock:
                    failures.append(("call", repr(e)))
                continue
            dt = (time.monotonic() - t0) * 1e3
            with lock:
                lat_ms.append(dt)
                counts["calls"] += 1
                if out != model(i):
                    failures.append(("call", f"wrong result for {i}"))

    def stream_worker():
        while not stop.is_set():
            t_last = time.monotonic()
            try:
                n = 0
                for _tok in streamh.stream(total=20):
                    n += 1
                    t_last = time.monotonic()
                with lock:
                    counts["streams"] += 1
                    counts["tokens"] += n
            except ReplicaUnavailableError:
                # The allowed failure mode: pinned replica died mid-stream.
                # It must be FAST — measured from the last healthy chunk.
                dt = time.monotonic() - t_last
                with lock:
                    fast_fails[0] += 1
                    slow_fail[0] = max(slow_fail[0], dt)
                    if dt > stream_fail_budget_s:
                        failures.append(
                            ("stream", f"fail-fast took {dt:.1f}s "
                                       f"(> {stream_fail_budget_s}s budget)"))
            except Exception as e:  # noqa: BLE001 - every failure is a finding
                with lock:
                    failures.append(("stream", repr(e)))

    threads = [threading.Thread(target=call_worker, args=(k * 10_000,),
                                daemon=True)
               for k in range(call_threads)]
    threads += [threading.Thread(target=stream_worker, daemon=True)
                for _ in range(stream_threads)]
    for t in threads:
        t.start()

    kills = [0]
    heal_violations = []

    def on_kill(_victim):
        kills[0] += 1
        # The fleet must be back to full routable strength within the
        # probe period + spawn budget; router "up" is the heal signal.
        deadline = time.monotonic() + probe_s + heal_budget_s
        while time.monotonic() < deadline:
            s = ray_tpu_torch.get(master.stat.remote())
            ups = [s["backends"].get(f"soak:{k}", {}).get("up", 0)
                   for k in ("echo", "stream")]
            if all(u >= replicas for u in ups):
                return
            time.sleep(0.1)
        heal_violations.append(
            f"kill #{kills[0]}: fleet not healed within "
            f"{probe_s + heal_budget_s:.1f}s")

    chaos_stop = arm_replica_killer(master, "soak:echo",
                                    every_s=kill_every_s, on_kill=on_kill)
    stream_chaos = arm_replica_killer(master, "soak:stream",
                                      every_s=kill_every_s * 1.7)

    t_start = time.time()
    time.sleep(duration_s)
    chaos_stop.set()
    stream_chaos.set()
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    wall = time.time() - t_start

    stat = ray_tpu_torch.get(master.stat.remote())
    p50 = _percentile(lat_ms, 0.50)
    p99 = _percentile(lat_ms, 0.99)
    result = {
        "unix": int(t_start),
        "duration_s": round(wall, 1),
        "replicas": replicas,
        "requests": counts["calls"],
        "req_per_s": round(counts["calls"] / max(wall, 1e-9), 1),
        "streams": counts["streams"],
        "stream_tokens": counts["tokens"],
        "p50_ms": round(p50, 2),
        "p99_ms": round(p99, 2),
        "failed": len(failures),
        "kills": kills[0],
        "stream_failfast": fast_fails[0],
        "worst_stream_fail_s": round(slow_fail[0], 2),
        "replaced": stat["fleet_counters"]["replicas_replaced"],
        "failovers": stat["counters"]["failovers"],
        "retries": stat["counters"]["retries"],
    }
    serve.shutdown()

    problems = [f"{kind}: {msg}" for kind, msg in failures[:10]]
    problems += heal_violations
    if kills[0] == 0 and kill_every_s < duration_s:
        problems.append("chaos never fired (0 kills)")
    if result["replaced"] < kills[0]:
        problems.append(
            f"only {result['replaced']} replacements for {kills[0]} kills")
    if p50 > p50_budget_ms:
        problems.append(f"p50 {p50:.1f}ms > {p50_budget_ms}ms budget")
    if p99 > p99_budget_ms:
        problems.append(f"p99 {p99:.1f}ms > {p99_budget_ms}ms budget")
    result["ok"] = not problems
    result["problems"] = problems
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--kill-every", type=float, default=5.0)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--call-threads", type=int, default=4)
    ap.add_argument("--stream-threads", type=int, default=2)
    ap.add_argument("--p50-budget-ms", type=float, default=500.0)
    ap.add_argument("--p99-budget-ms", type=float, default=5000.0)
    ap.add_argument("--stream-fail-budget", type=float, default=10.0,
                    help="max seconds from last chunk to the typed stream "
                         "failure (the no-300s-hang assertion)")
    ap.add_argument("--heal-budget", type=float, default=8.0,
                    help="seconds ON TOP of the health-check period for a "
                         "replacement to serve traffic")
    args = ap.parse_args(argv)

    result = run_soak(args.duration, args.kill_every, args.replicas,
                      args.call_threads, args.stream_threads,
                      args.p50_budget_ms, args.p99_budget_ms,
                      args.stream_fail_budget, args.heal_budget)
    print(json.dumps(result, indent=2))
    if not result["ok"]:
        print("SOAK FAILED:", *result["problems"], sep="\n  ")
        return 1
    print(f"SOAK OK: {result['requests']} calls + {result['streams']} "
          f"streams, {result['kills']} kills survived, 0 failed")
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        ray_tpu_torch.shutdown()
    sys.exit(rc)
