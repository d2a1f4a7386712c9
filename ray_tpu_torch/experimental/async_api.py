"""Asyncio integration (reference: python/ray/experimental/async_api.py).

ObjectRefs are natively awaitable in this framework (object_ref.py
``__await__``), so the reference's plasma-eventloop machinery reduces to a
thin helper.
"""

from __future__ import annotations

import asyncio
from typing import Any


def as_future(ref: Any) -> "asyncio.Future":
    """Wrap an ObjectRef into an asyncio future on the running loop."""
    return asyncio.wrap_future(ref.future())
