"""Typed runtime configuration registry.

Equivalent role to the reference's ``RAY_CONFIG(type, name, default)`` macro
registry (reference: ``src/ray/common/ray_config_def.h``): a single process-wide
table of typed knobs, overridable at ``init()`` time via a ``_system_config``
dict or via ``RAY_TPU_TORCH_<NAME>`` environment variables.

The port's copy of ``ray_tpu/_private/config.py``. Its knobs are read from
their own prefix, ``RAY_TPU_TORCH_``, so neither package reads the other's
environment, and the placement backend is named ``"torch"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional


ENV_PREFIX = "RAY_TPU_TORCH_"


def _env(name: str, default, cast):
    raw = os.environ.get(f"{ENV_PREFIX}{name.upper()}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes")
    return cast(raw)


@dataclass
class Config:
    # --- heartbeats / failure detection (reference: ray_config_def.h:38,46) ---
    heartbeat_interval_ms: int = 100
    num_heartbeats_timeout: int = 30
    # --- scheduling ---
    scheduler_backend: str = "torch"  # "torch" | "scalar"
    scheduler_tick_ms: int = 2
    scheduler_spread_threshold: float = 0.5
    max_tasks_per_tick: int = 65536
    # --- objects ---
    max_direct_call_object_size: int = 100 * 1024  # inline threshold, ref ray_config_def.h:117
    object_store_memory: int = 2 * 1024**3
    object_transfer_chunk_bytes: int = 1024 * 1024  # ref ray_config_def.h:242
    free_objects_batch_size: int = 100
    # Spill-to-disk under memory pressure (reference: plasma
    # external_store.h + quota_aware_policy.cc). Arena use above the high
    # watermark spills cold unpinned sealed objects down to the low one;
    # producers over the high watermark back off (bounded) before putting.
    object_spill_enabled: bool = True
    object_spill_dir: str = ""  # "" => <tmpdir>/ray_tpu_torch_spill/<store name>
    object_spill_high_watermark: float = 0.85
    object_spill_low_watermark: float = 0.60
    # Per-owner arena byte quota, LRU-within-owner enforced (0 = off).
    object_store_owner_quota: int = 0
    # Owner-side put backpressure: bounded wait (exponential backoff) while
    # the node is over its spill high watermark. 0 disables the wait.
    put_backpressure_max_wait_s: float = 2.0
    # Owner-side refcount GC (reference: core_worker/reference_count.h:33)
    ref_counting_enabled: bool = True
    # --- tasks / actors ---
    max_retries_default: int = 4  # ref doc/source/fault-tolerance.rst:12
    actor_max_restarts_default: int = 0
    max_pending_lease_requests: int = 10
    worker_lease_timeout_ms: int = 500
    # Owner worker leases + direct push (reference: direct task transport,
    # direct_task_transport.h:49): dependency-free tasks skip the GCS queue
    # and go straight to a leased worker while few results are outstanding.
    direct_call_enabled: bool = True
    direct_call_max_outstanding: int = 32
    direct_lease_idle_s: float = 5.0
    # --- workers ---
    num_workers_soft_limit: int = 0  # 0 => num_cpus
    worker_register_timeout_s: int = 30
    maximum_startup_concurrency: int = 8
    # --- lineage / reconstruction ---
    max_lineage_size: int = 100  # ref ray_config_def.h:157
    task_lease_timeout_ms: int = 1000
    # --- logging / debug ---
    debug_dump_period_ms: int = 10000
    event_log_enabled: bool = True
    # Cluster event-log ring size (GCS cluster_events deque; overflow is
    # counted in events_dropped and surfaced by `cli events`).
    event_log_size: int = 20_000
    # --- observability: flight recorder + time-series rollups ---
    # Continuous stack sampler (env kill switch RAY_TPU_TORCH_FLIGHT_RECORDER=0;
    # rate via RAY_TPU_TORCH_FLIGHT_RECORDER_HZ, default 20).
    flight_recorder: bool = True
    # GCS time-series store: fixed bucket width and per-series retention
    # ring (360 x 10 s = one hour of rollups), rolled every tick.
    timeseries_bucket_s: int = 10
    timeseries_retention_buckets: int = 360
    timeseries_tick_s: float = 2.0
    # Consistency auditor: seconds between periodic GCS reconciliation
    # passes (directory vs controller arenas/spill dirs/rings/task table).
    # <= 0 disables the loop; `cli doctor` still audits on demand.
    audit_interval_s: float = 30.0
    # --- head HA: GCS reconnect / leadership / replication ---
    # ResilientClient re-dial budget per call (was a hardcoded 30 s) and
    # the jittered-exponential-backoff shape of the re-dials
    # (sleep = min(cap, base * 2^attempt) * uniform[0.5, 1.5)).
    gcs_retry_window_s: float = 30.0
    gcs_retry_backoff_base_s: float = 0.05
    gcs_retry_backoff_cap_s: float = 2.0
    # Extra GCS addresses clients rotate through on reconnect
    # ("host:port,host:port" — typically the warm standby).
    gcs_addrs: str = ""
    # Leadership lease: the leader renews every ttl/3; a standby may steal
    # only after expiry (epoch bump). Must comfortably exceed one renewal
    # round-trip to the persistent store.
    gcs_lease_ttl_s: float = 3.0
    # Replication log: buffered on-loop, flushed to the snapshot backend
    # off-loop at this cadence (the acked-but-unflushed window a hard head
    # kill can lose; the warm standby's wire tail usually covers it).
    gcs_repl_flush_interval_s: float = 0.05
    # Warm standby: leader-tail poll cadence and the in-memory ring of
    # recent records the leader serves tails from (a standby farther
    # behind than the ring gets a full-snapshot resync).
    gcs_standby_poll_interval_s: float = 0.1
    gcs_repl_ring_size: int = 65536
    # --- raw overrides applied last ---
    _overrides: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for f in fields(self):
            if f.name.startswith("_"):
                continue
            cast = type(getattr(self, f.name))
            setattr(self, f.name, _env(f.name, getattr(self, f.name), cast))

    def update(self, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        for key, value in (overrides or {}).items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown config key: {key}")
            setattr(self, key, value)
            self._overrides[key] = value
        return self


_global_config: Optional[Config] = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def reset_config(overrides: Optional[Dict[str, Any]] = None) -> Config:
    global _global_config
    _global_config = Config().update(overrides)
    return _global_config
