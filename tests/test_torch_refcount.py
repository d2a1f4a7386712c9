"""The port's reference counting against the JAX package's, on the CPU:
twins of the local cases of tests/test_reference_counting.py (puts and task
returns freed when their last ref dies, in-flight task arguments pinned,
intermediates of a chain kept alive, a return dropped before its task ends
collected, the debug view, GC off through ``_system_config``), each program
run through ``ray_tpu`` and then ``ray_tpu_torch`` in one process on numpy-
seeded data (numpy arrays for JAX, CPU tensors for the port), with the
stored objects and the reference-count tables held equal, hexes included."""

import gc
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PKGS = (ray_tpu, ray_tpu_torch)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in PKGS:
        rt.shutdown()


def _tensor(rt, arr):
    return arr if rt is ray_tpu else torch.from_numpy(arr)


def _counts(rt):
    return rt._private.worker.global_worker().core.reference_counts()


def _objects(rt):
    return {h: info["size_bytes"] for h, info in rt.state.objects().items()}


def _wait_gone(rt, oid_hex, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gc.collect()
        if oid_hex not in rt.state.objects():
            return True
        time.sleep(0.01)
    return False


def same(program, **init_kw):
    outs = []
    for rt in PKGS:
        init_kw.setdefault("num_cpus", 8)
        init_kw.setdefault("object_store_memory", 256 * 1024 * 1024)
        rt.init(**init_kw)
        try:
            outs.append(program(rt))
        finally:
            rt.shutdown()
    assert outs[0] == outs[1]
    return outs[1]


RNG = np.random.default_rng(0)
DATA = RNG.standard_normal(1000)          # float64, 8000 bytes
ONES = np.ones(500, np.float32)


def test_put_freed_when_ref_dies():
    def prog(rt):
        before = _objects(rt)
        ref = rt.put(_tensor(rt, DATA.copy()))
        held = _objects(rt)
        table = _counts(rt)
        hex_id = ref.hex()
        del ref
        gc.collect()
        return hex_id, held, table, _objects(rt) == before

    hex_id, held, table, freed = same(prog)
    assert held[hex_id] == DATA.nbytes and table[hex_id] == {"local_refs": 1}
    assert freed


def test_task_return_freed_when_ref_dies():
    def prog(rt):
        @rt.remote
        def make():
            return _tensor(rt, np.ones(1000))

        before = _objects(rt)
        ref = make.remote()
        total = float(rt.get(ref).sum())
        held = _objects(rt)
        del ref
        gc.collect()
        return total, held, _objects(rt) == before

    total, held, freed = same(prog)
    assert total == 1000.0 and 8000 in held.values() and freed


def test_pending_task_arg_pinned():
    def prog(rt):
        release = threading.Event()

        @rt.remote
        def slow_consume(x):
            release.wait(10)
            return float(x.sum())

        data_ref = rt.put(_tensor(rt, ONES.copy()))
        out = slow_consume.remote(data_ref)
        oid_hex = data_ref.hex()
        del data_ref  # only the in-flight task holds it now
        gc.collect()
        pinned = oid_hex in rt.state.objects()
        table = _counts(rt)[oid_hex]
        release.set()
        total = rt.get(out)
        del out
        return oid_hex, pinned, table, total, _wait_gone(rt, oid_hex)

    _, pinned, table, total, gone = same(prog)
    assert pinned and table == {"task_arg_pins": 1}
    assert total == 500.0 and gone


def test_chained_tasks_keep_intermediates_alive():
    def prog(rt):
        @rt.remote
        def a():
            return _tensor(rt, np.arange(100))

        @rt.remote
        def b(x):
            return x * 2

        out = b.remote(a.remote())  # intermediate ref dropped immediately
        return out.hex(), int(rt.get(out).sum())

    assert same(prog)[1] == 2 * int(np.arange(100).sum())


def test_return_dropped_before_completion_is_collected():
    def prog(rt):
        release = threading.Event()

        @rt.remote
        def slow():
            release.wait(10)
            return _tensor(rt, np.zeros(10000))

        before = _objects(rt)
        ref = slow.remote()
        oid_hex = ref.hex()
        del ref
        gc.collect()
        release.set()
        return oid_hex, _wait_gone(rt, oid_hex), _objects(rt) == before

    assert same(prog)[1:] == (True, True)


def test_refcount_debug_view():
    def prog(rt):
        refs = [rt.put(i) for i in range(3)]
        extra = pickle.loads(pickle.dumps(refs[0]))  # a second handle
        table = _counts(rt)
        del extra
        return table, _counts(rt)

    first, second = same(prog)
    counts = sorted(v["local_refs"] for v in first.values())
    assert counts == [1, 1, 2]
    assert sorted(v["local_refs"] for v in second.values()) == [1, 1, 1]


def test_gc_disabled_via_system_config():
    def prog(rt):
        ref = rt.put(_tensor(rt, np.zeros(10)))
        hex_id = ref.hex()
        del ref
        gc.collect()
        return hex_id, hex_id in rt.state.objects()

    assert same(prog, num_cpus=2,
                _system_config={"ref_counting_enabled": False})[1]


def test_free_drops_an_object_its_refs_still_name():
    def prog(rt):
        ref = rt.put(_tensor(rt, DATA.copy()))
        rt.free([ref])
        gone = ref.hex() not in rt.state.objects()
        with pytest.raises(rt.GetTimeoutError):
            rt.get(ref, timeout=0.05)
        return gone, _counts(rt)

    gone, table = same(prog)
    assert gone and list(table.values()) == [{"local_refs": 1}]


def test_memory_summary_lists_the_stored_objects():
    def prog(rt):
        refs = [rt.put(_tensor(rt, np.zeros(n))) for n in (10, 100)]
        summary = rt.state.memory_summary()
        stats = rt.state.object_store_stats()
        return summary, stats, [r.hex() for r in refs]

    summary, stats, hexes = same(prog)
    assert all(h in summary for h in hexes)
    assert stats["num_objects"] == 2 and stats["used_bytes"] == 880
