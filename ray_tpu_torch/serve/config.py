"""Backend configuration (counterpart: ``ray_tpu/serve/config.py``; the
reference is python/ray/serve/config.py). A copy: the module holds no JAX."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class BackendConfig:
    """Tunables for one backend.

    Mirrors the reference's BackendConfig keys (num_replicas, max_batch_size,
    batch_wait_timeout, max_concurrent_queries): batching is the lever that
    keeps the accelerator busy, so ``max_batch_size`` is first-class.
    """

    num_replicas: int = 1
    max_batch_size: int = 0  # 0 = no batching
    batch_wait_timeout_s: float = 0.01
    max_concurrent_queries: int = 8
    # Actor-level max_concurrency for each replica: how many RPCs (batch
    # calls, streaming long-polls) may PARK in the replica concurrently.
    # Default 1 = serial execution, safe for any user backend; streaming
    # backends (serve.lm.LMBackend) are internally locked and should run
    # with replica_concurrency >= expected concurrent streams so a
    # long-poll never blocks batch-mates.
    replica_concurrency: int = 1
    # ---- fleet self-healing (master reconcile loop) ----
    # Replicas are probed every health_check_period_s; a probe that times
    # out / errors / reports unhealthy counts one strike,
    # health_check_failures consecutive strikes mark the replica DOWN and
    # the master spawns a replacement.
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 5.0
    health_check_failures: int = 3
    # ---- queue-depth autoscaling ----
    # Active iff 1 <= min_replicas <= max_replicas and max_replicas > 0
    # (both default 0 = fixed num_replicas). Target replica count is
    # ceil((router queue depth + inflight) / autoscale_target_inflight),
    # clamped to [min_replicas, max_replicas]; scale-up applies
    # immediately, scale-down only after the demand stayed below the
    # lower target for autoscale_downscale_delay_s, and the retired
    # replica drains (inflight + pinned streams finish) before it exits.
    min_replicas: int = 0
    max_replicas: int = 0
    autoscale_target_inflight: int = 4
    autoscale_downscale_delay_s: float = 10.0
    drain_timeout_s: float = 30.0
    user_config: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_batch_size < 0:
            raise ValueError("max_batch_size must be >= 0")
        if self.max_concurrent_queries < 1:
            raise ValueError("max_concurrent_queries must be >= 1")
        if self.replica_concurrency < 1:
            raise ValueError("replica_concurrency must be >= 1")
        if self.health_check_period_s <= 0:
            raise ValueError("health_check_period_s must be > 0")
        if self.health_check_timeout_s <= 0:
            raise ValueError("health_check_timeout_s must be > 0")
        if self.health_check_failures < 1:
            raise ValueError("health_check_failures must be >= 1")
        if self.min_replicas < 0 or self.max_replicas < 0:
            raise ValueError("min/max_replicas must be >= 0")
        if self.max_replicas and self.min_replicas > self.max_replicas:
            raise ValueError("min_replicas must be <= max_replicas")
        if self.max_replicas and self.min_replicas < 1:
            raise ValueError(
                "autoscaling needs min_replicas >= 1 (a backend scaled to "
                "zero could never serve the probe that would scale it up)")
        if self.autoscale_target_inflight < 1:
            raise ValueError("autoscale_target_inflight must be >= 1")

    @property
    def autoscaling(self) -> bool:
        return self.max_replicas > 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "num_replicas": self.num_replicas,
            "max_batch_size": self.max_batch_size,
            "batch_wait_timeout_s": self.batch_wait_timeout_s,
            "max_concurrent_queries": self.max_concurrent_queries,
            "replica_concurrency": self.replica_concurrency,
            "health_check_period_s": self.health_check_period_s,
            "health_check_timeout_s": self.health_check_timeout_s,
            "health_check_failures": self.health_check_failures,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "autoscale_target_inflight": self.autoscale_target_inflight,
            "autoscale_downscale_delay_s": self.autoscale_downscale_delay_s,
            "drain_timeout_s": self.drain_timeout_s,
            "user_config": dict(self.user_config),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BackendConfig":
        cfg = cls(**d)
        cfg.validate()
        return cfg


@dataclass
class ServeRequest:
    """One query as seen by a backend callable.

    Batched backends (``@serve.accept_batch``) receive ``List[ServeRequest]``;
    unbatched backends are called as ``fn(*request.args, **request.kwargs)``.
    """

    args: tuple
    kwargs: dict

    @property
    def data(self):
        """Convenience accessor for single-payload requests."""
        if self.args:
            return self.args[0]
        return self.kwargs
