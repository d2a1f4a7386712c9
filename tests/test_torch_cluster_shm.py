"""The port's shared-memory arena against the JAX package's, on the CPU: twins
of every test of tests/test_shm_store.py. Each test runs the same operations
on an arena of each package (the port builds its own copy of
``shm_store.cc`` into its own cache) and holds their answers equal: the
create/seal protocol, immutability, eviction under pressure, pinning, the
pure-Python fallback and a second process attaching to the segment."""

import os
import random
import subprocess
import sys
import uuid

import pytest

from ray_tpu import _native as jnative
from ray_tpu._native.build import load_native_library as jload
from ray_tpu_torch import _native as tnative
from ray_tpu_torch._native.build import load_native_library as tload

NATIVES = (jnative, tnative)

pytestmark = pytest.mark.skipif(
    jload("shm_store") is None or tload("shm_store") is None,
    reason="native shm_store failed to build")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _name(native):
    tag = "tps" if native is jnative else "tts"
    return f"{tag}test-{uuid.uuid4().hex[:12]}"


def oid(i: int) -> bytes:
    return i.to_bytes(4, "big") * 6  # 24 bytes == ObjectID.SIZE


def _blob(n, seed):
    return random.Random(seed).randbytes(n)


def same(program):
    """``program(native, store)`` on a fresh 8 MiB arena of each package;
    hold the results equal and return the port's."""
    outs = []
    for native in NATIVES:
        store = native.ShmObjectStore(_name(native), capacity=8 * 1024 * 1024,
                                      create=True)
        try:
            outs.append(program(native, store))
        finally:
            store.close()
    assert outs[0] == outs[1]
    return outs[1]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__
    return None


def test_put_get_roundtrip():
    data = _blob(100_000, 1)
    assert same(lambda n, s: (s.put(oid(1), data), s.contains(oid(1)),
                              s.get_bytes(oid(1)) == data)) == (True,) * 3


def test_double_put_is_noop():
    assert same(lambda n, s: (s.put(oid(1), b"first"),
                              s.put(oid(1), b"second"),
                              s.get_bytes(oid(1)))) == (True, False, b"first")


def test_missing_object():
    assert same(lambda n, s: (s.get(oid(99)), s.contains(oid(99)))) \
        == (None, False)


def test_create_seal_two_phase():
    def prog(n, s):
        view = s.create(oid(2), 1000)
        out = [view is not None, s.get(oid(2)), s.contains(oid(2))]
        view[:] = b"x" * 1000
        view.release()
        s.seal(oid(2))
        return out + [s.get_bytes(oid(2)) == b"x" * 1000]

    assert same(prog) == [True, None, False, True]


def test_abort_frees_space():
    def prog(n, s):
        view = s.create(oid(3), 4 * 1024 * 1024)
        view.release()
        s.abort(oid(3))
        return s.put(oid(4), b"y" * (4 * 1024 * 1024))

    assert same(prog) is True


def test_zero_copy_get_is_view():
    def prog(n, s):
        s.put(oid(5), b"z" * 4096)
        with s.get(oid(5)) as view:
            return isinstance(view, memoryview), bytes(view[:4])

    assert same(prog) == (True, b"zzzz")


def test_reseal_keeps_reader_pin():
    def prog(n, s):
        s.put(oid(8), b"pinme")
        buf = s.get(oid(8))
        s.seal(oid(8))
        s.delete(oid(8))  # deferred: a reader holds a pin
        seen = bytes(buf.view)
        buf.release()
        return seen, s.contains(oid(8))

    assert same(prog) == (b"pinme", False)


def test_oversized_put_does_not_wipe_store():
    def prog(n, s):
        s.put(oid(9), b"survivor")
        err = _raised(lambda: s.put(oid(10), b"x" * (64 * 1024 * 1024)))
        return err, s.contains(oid(9)), s.stats()["num_evictions"]

    assert same(prog) == ("StoreFullError", True, 0)


def test_delete():
    def prog(n, s):
        s.put(oid(6), b"gone")
        s.delete(oid(6))
        out = s.contains(oid(6))
        s.delete(oid(6))  # deleting again is fine
        return out

    assert same(prog) is False


def test_delete_deferred_while_pinned():
    def prog(n, s):
        s.put(oid(7), b"pinned")
        buf = s.get(oid(7))
        s.delete(oid(7))
        seen = bytes(buf.view)
        buf.release()
        return seen, s.contains(oid(7))

    assert same(prog) == (b"pinned", False)


def test_lru_eviction_under_pressure():
    blob = _blob(1024 * 1024, 2)

    def prog(n, s):
        for i in range(20):  # 20 MiB into an 8 MiB arena
            s.put(oid(100 + i), blob)
        return (s.stats()["num_evictions"],
                [s.contains(oid(100 + i)) for i in range(20)])

    evictions, present = same(prog)
    assert evictions > 0 and present[-1] and not present[0]


def test_pinned_objects_survive_eviction():
    blob = _blob(1024 * 1024, 3)

    def prog(n, s):
        s.put(oid(200), b"keep" * 1000)
        pin = s.get(oid(200))
        for i in range(20):
            s.put(oid(300 + i), blob)
        out = s.contains(oid(200))
        pin.release()
        return out

    assert same(prog) is True


def test_store_full_when_everything_pinned():
    def prog(n, s):
        s.put(oid(400), _blob(6 * 1024 * 1024, 4))
        pin = s.get(oid(400))
        err = _raised(lambda: s.put(oid(401), _blob(6 * 1024 * 1024, 5)))
        pin.release()
        return err

    assert same(prog) == "StoreFullError"


def test_many_small_objects_and_list():
    def prog(n, s):
        for i in range(500):
            s.put(oid(1000 + i), i.to_bytes(8, "big"))
        return (sorted(s.list_ids()),
                [s.get_bytes(oid(1000 + i)) for i in (0, 250, 499)])

    ids, vals = same(prog)
    assert len(ids) == 500
    assert vals == [i.to_bytes(8, "big") for i in (0, 250, 499)]


def test_stats():
    def prog(n, s):
        s.put(oid(500), b"a" * 1000)
        st = s.stats()
        return st, sorted(st)

    st, _ = same(prog)
    assert st["num_objects"] == 1 and st["used_bytes"] >= 1000
    assert st["arena_bytes"] > 0


def test_cross_process_attach():
    """A second process attaches to the segment and sees the object with no
    socket traffic; the parent sees the child's write."""
    out = []
    for native in NATIVES:
        name = _name(native)
        store = native.ShmObjectStore(name, capacity=4 * 1024 * 1024,
                                      create=True)
        try:
            store.put(oid(1), b"shared-bytes")
            child = subprocess.run(
                [sys.executable, "-c", (
                    f"from {native.__name__} import ShmObjectStore\n"
                    f"s = ShmObjectStore({name!r}, create=False)\n"
                    f"data = s.get_bytes({oid(1)!r})\n"
                    "assert data == b'shared-bytes', data\n"
                    f"s.put({oid(2)!r}, b'from-child')\n"
                    "s.close()\n")],
                capture_output=True, text=True, timeout=60,
                env=dict(os.environ, PYTHONPATH=_REPO))
            assert child.returncode == 0, child.stderr
            out.append(store.get_bytes(oid(2)))
        finally:
            store.close()
    assert out == [b"from-child"] * 2


def test_fallback_store_same_interface():
    out = []
    for native in NATIVES:
        s = native.PyObjectStore("fallback", capacity=1024 * 1024)
        got = (s.put(oid(1), b"abc"), s.get_bytes(oid(1)))
        buf = s.get(oid(1))
        s.delete(oid(1))
        buf.release()
        s.close()
        out.append(got)
    assert out == [(True, b"abc")] * 2


def test_create_store_factory():
    out = []
    for native in NATIVES:
        s = native.create_store(_name(native), 1024 * 1024)
        try:
            s.put(oid(1), b"via-factory")
            out.append((type(s).__name__, s.get_bytes(oid(1))))
        finally:
            s.close()
    assert out == [("ShmObjectStore", b"via-factory")] * 2
