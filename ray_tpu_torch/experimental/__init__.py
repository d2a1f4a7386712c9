"""Experimental APIs (reference: python/ray/experimental/)."""

from .internal_kv import (  # noqa: F401
    _internal_kv_del,
    _internal_kv_exists,
    _internal_kv_get,
    _internal_kv_put,
)
from .dynamic_resources import set_resource  # noqa: F401
from .async_api import as_future  # noqa: F401
