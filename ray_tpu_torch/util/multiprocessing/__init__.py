"""multiprocessing.Pool API on actors (reference: python/ray/util/multiprocessing)."""

from .pool import Pool, PoolTaskError, TimeoutError  # noqa: F401

__all__ = ["Pool", "PoolTaskError", "TimeoutError"]
