"""ServeMaster control-plane actor (reference: python/ray/serve/master.py).

Owns all serving state: endpoint registry, backend registry, traffic
policies, and replica lifecycle. The router and replicas are child actors it
creates and reconciles; every mutation is pushed to the router so the data
plane never consults the master on the request path.

Self-healing: a reconcile thread probes every replica with the typed
``handle_request("__health__")`` RPC on each backend's
``health_check_period_s`` cadence. A probe that dies (ActorDiedError — the
death event), times out, errors, or reports unhealthy (e.g. a poisoned
LMBackend) strikes the replica; ``health_check_failures`` consecutive
strikes (death: immediately) mark it DOWN. Down replicas are dropped from
the router's set at once (so traffic stops hitting them), killed, and
replaced; the replacement serves traffic as soon as its constructor
finishes. The same loop runs queue-depth autoscaling between
``min_replicas``/``max_replicas`` off the router's load snapshot, with
scale-down going through a graceful drain: the router stops routing new
work to the retiring replica and the master waits for its inflight calls
and pinned streams to finish (up to ``drain_timeout_s``) before killing it.

The port's copy of ``ray_tpu/serve/master.py``; its knobs read
``RAY_TPU_TORCH_SERVE_RECONCILE`` (0/false/off: no reconcile thread) and
``RAY_TPU_TORCH_SERVE_RECONCILE_PERIOD_S``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

from .backend_worker import HEALTH_CHECK_METHOD, ReplicaActor
from .config import BackendConfig
from .router import Router

logger = logging.getLogger(__name__)

MASTER_NAME = "__serve_master__"
ROUTER_NAME = "__serve_router__"
PROXY_NAME = "__serve_http_proxy__"


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ServeMaster(ray_tpu_torch.Checkpointable):
    """Control plane. Checkpointable + restartable: the master is created
    with max_restarts=-1; after a crash-restart it reattaches to the (still
    live) router/proxy/replica actors and restores its registry from the
    newest checkpoint (reference: master.py writes the same state to a
    GCS-backed kv_store for exactly this recovery)."""

    # Bumped per constructed instance (restarts included): a superseded
    # instance's reconcile thread sees the newer generation and retires, so
    # two reconcilers never fight over the same fleet.
    _generation = 0

    def __init__(self, http_host: Optional[str] = None,
                 http_port: Optional[int] = None):
        # Idempotent child creation: on restart the named actors exist.
        try:
            self.router = ray_tpu_torch.get_actor(ROUTER_NAME)
        except Exception:
            self.router = ray_tpu_torch.remote(num_cpus=0)(Router).options(
                name=ROUTER_NAME).remote()
        # endpoint -> {"route": str|None, "methods": [..]}
        self.endpoints: Dict[str, Dict[str, Any]] = {}
        # backend -> {"config": dict, "func_or_class": obj, "init_args": tuple}
        self.backends: Dict[str, Dict[str, Any]] = {}
        self.replicas: Dict[str, List[Any]] = {}
        self.traffic: Dict[str, Dict[str, float]] = {}
        self.http_proxy = None
        if http_port is not None:
            from .http_proxy import HTTPProxyActor

            try:
                self.http_proxy = ray_tpu_torch.get_actor(PROXY_NAME)
            except Exception:
                self.http_proxy = ray_tpu_torch.remote(num_cpus=0)(
                    HTTPProxyActor).options(name=PROXY_NAME).remote(
                        http_host or "127.0.0.1", http_port)
            ray_tpu_torch.get(self.http_proxy.ready.remote())
        # ---- fleet state (registry mutations happen on the actor's
        # dispatch thread AND the reconcile thread; _lock serializes) ----
        self._lock = threading.RLock()
        self._probe_strikes: Dict[str, Dict[Any, int]] = {}
        self._autoscale_target: Dict[str, int] = {}
        self._downscale_since: Dict[str, float] = {}
        self._last_probe: Dict[str, float] = {}
        self.fleet_counters: Dict[str, int] = {
            "replicas_replaced": 0, "scale_ups": 0, "scale_downs": 0,
            "probes": 0,
        }
        self._last_router_counters: Dict[str, int] = {}
        self._reconcile_stop = threading.Event()
        ServeMaster._generation += 1
        self._my_generation = ServeMaster._generation
        self._reconcile_tick_s = _env_f(
            "RAY_TPU_TORCH_SERVE_RECONCILE_PERIOD_S", 0.5)
        if os.environ.get("RAY_TPU_TORCH_SERVE_RECONCILE",
                          "1").lower() not in ("0", "false", "off"):
            threading.Thread(
                target=self._reconcile_loop, name="serve-reconcile",
                daemon=True).start()

    # ---- crash recovery (Checkpointable contract) ----

    def save_checkpoint(self):
        with self._lock:
            return {
                "endpoints": {k: dict(v) for k, v in self.endpoints.items()},
                "backends": {
                    tag: {"config": e["config"].to_dict(),
                          "func_or_class": e["func_or_class"],
                          "init_args": e["init_args"],
                          "init_kwargs": e.get("init_kwargs", {})}
                    for tag, e in self.backends.items()
                },
                "replicas": {k: list(v) for k, v in self.replicas.items()},
                "traffic": {k: dict(v) for k, v in self.traffic.items()},
                "autoscale_target": dict(self._autoscale_target),
            }

    def load_checkpoint(self, checkpoint) -> None:
        with self._lock:
            self.endpoints = checkpoint["endpoints"]
            self.backends = {
                tag: {"config": BackendConfig.from_dict(e["config"]),
                      "func_or_class": e["func_or_class"],
                      "init_args": e["init_args"],
                      "init_kwargs": e.get("init_kwargs", {})}
                for tag, e in checkpoint["backends"].items()
            }
            self.replicas = checkpoint["replicas"]
            self.traffic = checkpoint["traffic"]
            self._autoscale_target = dict(
                checkpoint.get("autoscale_target", {}))
            # Reconcile the data plane with restored intent.
            for tag in self.backends:
                self._sync_router(tag)
            for ep, traffic in self.traffic.items():
                ray_tpu_torch.get(self.router.set_traffic.remote(ep, traffic))

    def get_router(self):
        return [self.router]

    def get_http_proxy(self):
        return [self.http_proxy]

    # ---- backends ----

    def create_backend(self, backend_tag: str, func_or_class: Any,
                       init_args: tuple, config_dict: dict,
                       init_kwargs: Optional[dict] = None) -> None:
        with self._lock:
            if backend_tag in self.backends:
                raise ValueError(f"backend {backend_tag!r} already exists")
            config = BackendConfig.from_dict(config_dict)
            self.backends[backend_tag] = {
                "config": config, "func_or_class": func_or_class,
                "init_args": init_args,
                "init_kwargs": dict(init_kwargs or {}),
            }
            self.replicas[backend_tag] = []
            self._scale(backend_tag, self._desired_replicas(backend_tag))

    def delete_backend(self, backend_tag: str) -> None:
        with self._lock:
            for policy in self.traffic.values():
                if backend_tag in policy:
                    raise ValueError(
                        f"backend {backend_tag!r} still receives traffic")
            self.backends.pop(backend_tag, None)
            self._probe_strikes.pop(backend_tag, None)
            self._autoscale_target.pop(backend_tag, None)
            self._downscale_since.pop(backend_tag, None)
            for h in self.replicas.pop(backend_tag, []):
                ray_tpu_torch.kill(h)
            ray_tpu_torch.get(self.router.remove_backend.remote(backend_tag))

    def update_backend_config(self, backend_tag: str, config_dict: dict) -> None:
        with self._lock:
            entry = self._backend(backend_tag)
            merged = entry["config"].to_dict()
            merged.update(config_dict)
            config = BackendConfig.from_dict(merged)
            entry["config"] = config
            if "num_replicas" in config_dict:
                # An explicit replica count resets any autoscaler decision.
                self._autoscale_target.pop(backend_tag, None)
            self._scale(backend_tag, self._desired_replicas(backend_tag))
            if "user_config" in config_dict:
                ray_tpu_torch.get([h.reconfigure.remote(config.user_config)
                                   for h in self.replicas[backend_tag]])

    def list_backends(self) -> Dict[str, dict]:
        with self._lock:
            return {t: e["config"].to_dict()
                    for t, e in self.backends.items()}

    def get_replicas(self, backend_tag: str) -> List[Any]:
        """Live replica handles (chaos drills kill these directly)."""
        with self._lock:
            return list(self.replicas.get(backend_tag, []))

    def _backend(self, backend_tag: str) -> Dict[str, Any]:
        if backend_tag not in self.backends:
            raise ValueError(f"no backend {backend_tag!r}")
        return self.backends[backend_tag]

    def _desired_replicas(self, backend_tag: str) -> int:
        """Current desired replica count: the autoscaler's target when one
        is active, else the configured num_replicas (clamped into the
        autoscale band when autoscaling is on)."""
        entry = self._backend(backend_tag)
        config: BackendConfig = entry["config"]
        if not config.autoscaling:
            return config.num_replicas
        target = self._autoscale_target.get(backend_tag,
                                            config.num_replicas)
        return max(config.min_replicas, min(config.max_replicas, target))

    def _scale(self, backend_tag: str, target: int) -> None:
        entry = self._backend(backend_tag)
        current = self.replicas[backend_tag]
        config: BackendConfig = entry["config"]
        while len(current) < target:
            h = ray_tpu_torch.remote(num_cpus=0)(ReplicaActor).options(
                max_concurrency=config.replica_concurrency).remote(
                backend_tag, entry["func_or_class"], entry["init_args"],
                dict(config.user_config),
                entry.get("init_kwargs") or {})
            current.append(h)
        retired = []
        while len(current) > target:
            retired.append(current.pop())
        # Block until new replicas constructed so traffic never hits a
        # half-initialized model, and sync the router BEFORE killing retired
        # replicas so no in-flight route targets a dead actor.
        ray_tpu_torch.get([h.ready.remote() for h in current])
        if retired:
            # Graceful drain: the router stops routing new work to the
            # retiring replicas, and we wait for their inflight calls and
            # pinned streams to finish before the kill — scale-down must
            # not drop in-flight requests or live streams.
            self._drain_and_wait(backend_tag, retired,
                                 config.drain_timeout_s)
        self._sync_router(backend_tag)
        for h in retired:
            ray_tpu_torch.kill(h)

    def _drain_and_wait(self, backend_tag: str, retired: List[Any],
                        timeout_s: float) -> None:
        for h in retired:
            ray_tpu_torch.get(self.router.drain_replica.remote(backend_tag, h))
        deadline = time.monotonic() + max(0.0, timeout_s)
        pending = list(retired)
        while pending and time.monotonic() < deadline:
            still = []
            for h in pending:
                load = ray_tpu_torch.get(
                    self.router.replica_load.remote(backend_tag, h))
                if load["found"] and (load["inflight"] or load["streams"]):
                    still.append(h)
            pending = still
            if pending:
                time.sleep(0.05)
        if pending:
            logger.warning(
                "serve backend %r: %d replica(s) still busy after %.1fs "
                "drain timeout; retiring anyway", backend_tag,
                len(pending), timeout_s)

    def _sync_router(self, backend_tag: str) -> None:
        entry = self._backend(backend_tag)
        ray_tpu_torch.get(self.router.set_backend.remote(
            backend_tag, list(self.replicas[backend_tag]),
            entry["config"].to_dict()))

    # ---- reconcile loop (replica health + autoscaling) ----

    def _reconcile_loop(self) -> None:
        infra_failures = 0
        while not self._reconcile_stop.wait(self._reconcile_tick_s):
            if ServeMaster._generation != self._my_generation:
                return  # superseded by a restarted master instance
            try:
                self._reconcile_once()
                infra_failures = 0
            except Exception:  # noqa: BLE001 - the loop must survive ticks
                # Repeated infrastructure failures mean the runtime (or
                # this serve instance) is gone; stop spinning.
                infra_failures += 1
                if infra_failures >= 20:
                    return
                if not ray_tpu_torch.is_initialized():
                    return

    def _reconcile_once(self) -> None:
        with self._lock:
            tags = list(self.backends.keys())
        now = time.monotonic()
        for tag in tags:
            with self._lock:
                entry = self.backends.get(tag)
                if entry is None:
                    continue
                config: BackendConfig = entry["config"]
                handles = list(self.replicas.get(tag, []))
            if now - self._last_probe.get(tag, 0.0) \
                    < config.health_check_period_s:
                continue
            self._last_probe[tag] = now
            down = self._probe_backend(tag, config, handles)
            if down:
                self._replace_down_replicas(tag, down)
        self._autoscale_once()
        self._export_fleet_metrics()

    def _probe_backend(self, tag: str, config: BackendConfig,
                       handles: List[Any]) -> List[Any]:
        """Probe every replica; return the handles now considered DOWN."""
        strikes = self._probe_strikes.setdefault(tag, {})
        refs = [(h, h.handle_request.remote(HEALTH_CHECK_METHOD, (), {}))
                for h in handles]
        down: List[Any] = []
        for h, ref in refs:
            self.fleet_counters["probes"] += 1
            reason = ""
            try:
                out = ray_tpu_torch.get(
                    ref, timeout=config.health_check_timeout_s)
                healthy = bool(out.get("healthy", True)) \
                    if isinstance(out, dict) else bool(out)
                if not healthy:
                    reason = (out or {}).get("reason", "reported unhealthy") \
                        if isinstance(out, dict) else "reported unhealthy"
            except ActorDiedError:
                # Death event: no strike accounting, the replica is gone.
                down.append(h)
                strikes.pop(h, None)
                continue
            except GetTimeoutError:
                healthy, reason = False, "health probe timed out"
            except Exception as e:  # noqa: BLE001 - probe errors are data
                healthy, reason = False, f"{type(e).__name__}: {e}"
            if healthy:
                strikes.pop(h, None)
                continue
            strikes[h] = strikes.get(h, 0) + 1
            if strikes[h] >= config.health_check_failures:
                logger.warning(
                    "serve backend %r: replica %s DOWN after %d failed "
                    "probes (%s)", tag, h, strikes[h], reason)
                down.append(h)
                strikes.pop(h, None)
        # Strikes for handles no longer in the fleet must not accumulate.
        for h in list(strikes):
            if h not in handles:
                strikes.pop(h, None)
        return down

    def _replace_down_replicas(self, tag: str, down: List[Any]) -> None:
        with self._lock:
            entry = self.backends.get(tag)
            current = self.replicas.get(tag)
            if entry is None or current is None:
                return
            removed = [h for h in down if h in current]
            if not removed:
                return
            for h in removed:
                current.remove(h)
            # Push the healthy-only set FIRST so no new request routes to
            # the dead/unhealthy replica while its replacement constructs.
            self._sync_router(tag)
            for h in removed:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass
            self.fleet_counters["replicas_replaced"] += len(removed)
            # Spawn replacements back to the desired count (blocks on
            # construction, then syncs the full set to the router).
            self._scale(tag, self._desired_replicas(tag))

    def _autoscale_once(self) -> None:
        with self._lock:
            auto_tags = [t for t, e in self.backends.items()
                         if e["config"].autoscaling]
        if not auto_tags:
            return
        snap = ray_tpu_torch.get(self.router.load_snapshot.remote())
        now = time.monotonic()
        for tag in auto_tags:
            with self._lock:
                entry = self.backends.get(tag)
                if entry is None:
                    continue
                config: BackendConfig = entry["config"]
                load = snap.get(tag) or {}
                demand = (load.get("queued", 0) + load.get("inflight", 0)
                          + load.get("streams", 0))
                desired = math.ceil(
                    demand / config.autoscale_target_inflight) or \
                    config.min_replicas
                desired = max(config.min_replicas,
                              min(config.max_replicas, desired))
                cur = self._desired_replicas(tag)
                if desired > cur:
                    self._downscale_since.pop(tag, None)
                    self._autoscale_target[tag] = desired
                    self.fleet_counters["scale_ups"] += 1
                    logger.info("serve backend %r: scale up %d -> %d "
                                "(demand=%d)", tag, cur, desired, demand)
                    self._scale(tag, desired)
                elif desired < cur:
                    since = self._downscale_since.setdefault(tag, now)
                    if now - since >= config.autoscale_downscale_delay_s:
                        self._downscale_since.pop(tag, None)
                        self._autoscale_target[tag] = desired
                        self.fleet_counters["scale_downs"] += 1
                        logger.info(
                            "serve backend %r: scale down %d -> %d "
                            "(demand=%d)", tag, cur, desired, demand)
                        self._scale(tag, desired)
                else:
                    self._downscale_since.pop(tag, None)

    def _export_fleet_metrics(self) -> None:
        """Mirror the router's per-route latency/error metrics and the
        fleet state into the process metrics registry (Prometheus at the
        dashboard's /metrics; the untagged worst-case gauges feed the
        monitor's serve SLO rules)."""
        try:
            from ..metrics import serve_fleet_metrics

            m = serve_fleet_metrics()
            snap = ray_tpu_torch.get(self.router.metric_snapshot.remote())
            stats = ray_tpu_torch.get(self.router.stats.remote())
        except Exception:  # noqa: BLE001 - metrics must never kill the loop
            return
        worst_p99 = 0.0
        worst_err = 0.0
        for ep, s in snap.get("endpoints", {}).items():
            tags = {"endpoint": ep}
            m["p50"].record(s.get("latency_ms_p50", 0.0), tags=tags)
            m["p99"].record(s.get("latency_ms_p99", 0.0), tags=tags)
            err_rate = s.get("errors", 0) / max(1, s.get("count", 0))
            m["error_rate"].record(err_rate, tags=tags)
            worst_p99 = max(worst_p99, s.get("latency_ms_p99", 0.0))
            worst_err = max(worst_err, err_rate)
        m["worst_p99"].record(worst_p99)
        m["worst_error_rate"].record(worst_err)
        for tag, b in stats.get("backends", {}).items():
            for state in ("up", "down", "draining"):
                m["replicas"].record(
                    b.get(state, 0), tags={"backend": tag, "state": state})
        counters = stats.get("counters", {})
        for kind, value in counters.items():
            delta = value - self._last_router_counters.get(kind, 0)
            if delta > 0:
                m["events"].record(delta, tags={"kind": kind})
            self._last_router_counters[kind] = value
        for kind in ("replicas_replaced", "scale_ups", "scale_downs"):
            value = self.fleet_counters[kind]
            delta = value - self._last_router_counters.get(
                f"fleet:{kind}", 0)
            if delta > 0:
                m["events"].record(delta, tags={"kind": kind})
            self._last_router_counters[f"fleet:{kind}"] = value

    # ---- endpoints ----

    def create_endpoint(self, endpoint: str, backend_tag: str,
                        route: Optional[str], methods: List[str]) -> None:
        with self._lock:
            if endpoint in self.endpoints:
                raise ValueError(f"endpoint {endpoint!r} already exists")
            self._backend(backend_tag)
            self.endpoints[endpoint] = {"route": route,
                                        "methods": list(methods)}
            self.set_traffic(endpoint, {backend_tag: 1.0})
            if self.http_proxy is not None and route is not None:
                ray_tpu_torch.get(self.http_proxy.set_route.remote(
                    route, endpoint, list(methods)))

    def delete_endpoint(self, endpoint: str) -> None:
        with self._lock:
            info = self.endpoints.pop(endpoint, None)
            self.traffic.pop(endpoint, None)
            ray_tpu_torch.get(self.router.remove_endpoint.remote(endpoint))
            if self.http_proxy is not None and info and info.get("route"):
                ray_tpu_torch.get(self.http_proxy.remove_route.remote(
                    info["route"]))

    def list_endpoints(self) -> Dict[str, dict]:
        with self._lock:
            return {
                ep: {**info, "traffic": self.traffic.get(ep, {})}
                for ep, info in self.endpoints.items()
            }

    def set_traffic(self, endpoint: str, traffic: Dict[str, float]) -> None:
        with self._lock:
            if endpoint not in self.endpoints:
                raise ValueError(f"no endpoint {endpoint!r}")
            for tag, w in traffic.items():
                self._backend(tag)
                if w < 0:
                    raise ValueError("traffic weights must be >= 0")
            total = sum(traffic.values())
            if total <= 0:
                raise ValueError("traffic weights must sum to > 0")
            normalized = {t: w / total for t, w in traffic.items()}
            self.traffic[endpoint] = normalized
            ray_tpu_torch.get(
                self.router.set_traffic.remote(endpoint, normalized))

    # ---- observability / lifecycle ----

    def stat(self) -> dict:
        out = ray_tpu_torch.get(self.router.stats.remote())
        with self._lock:
            out["fleet"] = {
                tag: {
                    "target": self._desired_replicas(tag),
                    "replicas": len(self.replicas.get(tag, [])),
                    "autoscaling": entry["config"].autoscaling,
                    "min_replicas": entry["config"].min_replicas,
                    "max_replicas": entry["config"].max_replicas,
                }
                for tag, entry in self.backends.items()
            }
            out["fleet_counters"] = dict(self.fleet_counters)
        return out

    def shutdown_children(self) -> None:
        """Kill every replica actor (the master itself is killed by the API)."""
        self._reconcile_stop.set()
        with self._lock:
            for handles in self.replicas.values():
                for h in handles:
                    ray_tpu_torch.kill(h)
            self.replicas.clear()
            self.backends.clear()
            self.endpoints.clear()
            self.traffic.clear()
