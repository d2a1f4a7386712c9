"""Native runtime components, built lazily with the system toolchain.

The C++ sources live in ``src/``; the first import compiles them with g++
into this directory (cached by source mtime). Anything that fails to build
falls back to a pure-Python implementation with the same interface, so the
framework always works — the native path is the fast path, not a hard dep.
"""

from .build import load_native_library  # noqa: F401
from .shm_store import (  # noqa: F401
    PyObjectStore,
    ShmObjectStore,
    StoreFullError,
    create_store,
    open_store,
)


def __getattr__(name):
    # Spill policy types re-exported lazily (they live in _private to keep
    # this package import-light; importing them eagerly would pull metrics
    # into every worker that only wants the raw arena).
    if name in ("SpillingStore", "SpillManager"):
        from .._private import spill

        return getattr(spill, name)
    raise AttributeError(name)
