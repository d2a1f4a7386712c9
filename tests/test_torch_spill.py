"""The port's spill to disk against the JAX package's, on the CPU: twins of
tests/test_spill.py's SpillManager, memory-store, metrics and
put_backpressure cases, each run through ``ray_tpu`` and ``ray_tpu_torch``
on the same seeded bytes, with the files on disk, the store's counts and
the metrics held equal; then the runtime over a small
``object_store_memory`` (numpy arrays through JAX's, CPU tensors through the
port's: the same spill counts, every value back equal), CPU tensors of
several dtypes spilled and restored with their bits, and the port's spill
directory apart from JAX's."""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import metrics as jmetrics
from ray_tpu._private import config as jconfig
from ray_tpu._private import ids as jids
from ray_tpu._private import memory_store as jstore
from ray_tpu._private import spill as jspill
from ray_tpu_torch import metrics as tmetrics
from ray_tpu_torch._private import config as tconfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import memory_store as tstore
from ray_tpu_torch._private import spill as tspill

PKGS = (ray_tpu, ray_tpu_torch)
# (ids, memory_store, spill, exceptions) of each package
MODS = ((jids, jstore, jspill, ray_tpu.exceptions),
        (tids, tstore, tspill, ray_tpu_torch.exceptions))
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in PKGS:
        rt.shutdown()


def oid(i: int) -> bytes:
    return i.to_bytes(4, "big") * 6  # 24 bytes == ObjectID.SIZE


def blob(n: int) -> bytes:
    return RNG.integers(0, 256, n, dtype=np.uint8).tobytes()


# --------------------------------------------------------------- SpillManager


def test_spill_roundtrip_and_checksum(tmp_path):
    data = blob(100_000)
    files = []
    for i, (_, _, spill, _) in enumerate(MODS):
        mgr = spill.SpillManager(str(tmp_path / f"s{i}"))
        assert mgr.write(oid(1), data) == len(data)
        assert mgr.contains(oid(1)) and mgr.read(oid(1)) == data
        assert mgr.spilled_bytes == len(data) and mgr.num_objects == 1
        path = mgr._path(oid(1))
        raw = open(path, "rb").read()
        files.append((os.path.basename(path), raw))
        # A corrupted file must be dropped, never served.
        with open(path, "wb") as f:
            f.write(raw[:-4] + b"XXXX")
        assert mgr.read(oid(1)) is None
        assert not os.path.exists(path)
    assert files[0] == files[1]  # the same file, byte for byte


def test_spill_write_idempotent(tmp_path):
    for i, (_, _, spill, _) in enumerate(MODS):
        mgr = spill.SpillManager(str(tmp_path / f"s{i}"))
        mgr.write(oid(1), b"first")
        mgr.write(oid(1), b"second")  # immutable: first copy wins
        assert mgr.read(oid(1)) == b"first"


def test_crash_restart_scan_reads_either_package_files(tmp_path):
    """The port's restart scan indexes a directory the JAX package wrote
    (the format is the same), and drops the same torn entries."""
    d = str(tmp_path / "s")
    blobs = {oid(i): blob(10_000) for i in range(3)}
    mgr = jspill.SpillManager(d)
    for k, v in blobs.items():
        mgr.write(k, v)
    with open(os.path.join(d, "deadbeef.tmp"), "wb") as f:
        f.write(b"torn")
    trunc = mgr._path(oid(2))
    raw = open(trunc, "rb").read()
    with open(trunc, "wb") as f:
        f.write(raw[: len(raw) // 2])
    mgr2 = tspill.SpillManager(d)
    assert mgr2.read(oid(0)) == blobs[oid(0)]
    assert mgr2.read(oid(1)) == blobs[oid(1)]
    assert not mgr2.contains(oid(2))
    assert not os.path.exists(os.path.join(d, "deadbeef.tmp"))
    assert sorted(mgr2.ids()) == sorted(jspill.SpillManager(d).ids())
    mgr2.close()
    assert not os.path.exists(d)


# --------------------------------------------------------- MemoryStore spill


def _spilling_store(mods, path, max_bytes):
    ids, store, spill, _ = mods
    return ids, store, store.MemoryStore(
        max_bytes=max_bytes, spiller=spill.SpillManager(str(path)))


def test_memory_store_spills_over_budget(tmp_path):
    raw = [os.urandom(24) for _ in range(8)]
    payloads = [blob(100_000) for _ in range(8)]
    stats = []
    for i, mods in enumerate(MODS):
        ids, store_mod, store = _spilling_store(mods, tmp_path / f"m{i}",
                                                300_000)
        oids = [ids.ObjectID(r) for r in raw]
        for o, p in zip(oids, payloads):
            store.put(o, store_mod.StoredObject(value=p, nbytes=len(p)))
        st = store.stats()
        assert st["spilled_objects"] > 0 and st["used_bytes"] <= 300_000
        for o, p in zip(oids, payloads):  # resident or spilled, all read
            assert store.contains(o)
            assert store.get([o], timeout=1.0)[0].value == p
        stats.append((st, store.stats()))
    assert stats[0] == stats[1]


def test_memory_store_without_spiller_still_raises():
    names = []
    for ids, store_mod, _, exc in MODS:
        store = store_mod.MemoryStore(max_bytes=1000, spiller=None)
        with pytest.raises(exc.ObjectStoreFullError) as info:
            store.put(ids.ObjectID(os.urandom(24)),
                      store_mod.StoredObject(value=b"x" * 2000, nbytes=2000))
        names.append((type(info.value).__name__, str(info.value)))
    assert names[0] == names[1]


def test_error_objects_stay_resident_and_delete_covers_spilled(tmp_path):
    for i, mods in enumerate(MODS):
        ids, store_mod, store = _spilling_store(mods, tmp_path / f"e{i}",
                                                1000)
        err, big = ids.ObjectID(oid(1)), ids.ObjectID(oid(2))
        store.put(err, store_mod.StoredObject(error=ValueError("x"),
                                              nbytes=800))
        store.put(big, store_mod.StoredObject(value=blob(900), nbytes=900))
        store.put(ids.ObjectID(oid(3)),
                  store_mod.StoredObject(value=blob(900), nbytes=900))
        assert store.stats()["spilled_objects"] == 1
        assert isinstance(store.get([err], timeout=1.0)[0].error, ValueError)
        store.delete([big, ids.ObjectID(oid(3))])
        assert not store.contains(big)
        assert store.stats()["spilled_objects"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8])
def test_cpu_tensor_spills_and_restores_with_its_bits(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    values = [(torch.randn(64, 33, generator=gen) * 100).to(dtype)
              for _ in range(4)]
    values.append(values[0].t())  # a strided view
    ids, store_mod, store = _spilling_store(MODS[1], tmp_path / "t",
                                            values[0].nbytes * 2)
    oids = [ids.ObjectID(oid(i)) for i in range(len(values))]
    for o, v in zip(oids, values):
        store.put(o, store_mod.StoredObject(value=v, nbytes=v.nbytes))
    assert store.stats()["spilled_objects"] >= 2
    for o, v in zip(oids, values):
        got = store.get([o], timeout=1.0)[0].value
        assert got.dtype == v.dtype and got.device == v.device
        assert got.shape == v.shape and got.stride() == v.stride()
        assert torch.equal(got.contiguous().view(torch.uint8),
                           v.contiguous().view(torch.uint8))


def test_spill_metrics_registered(tmp_path):
    for i, (mods, metrics) in enumerate(zip(MODS, (jmetrics, tmetrics))):
        _, _, spill, _ = mods
        mgr = spill.SpillManager(str(tmp_path / f"x{i}"))
        mgr.write(oid(0), blob(512 * 1024))
        assert mgr.read(oid(0)) is not None
        snap = metrics.collect_all()
        for name in ("object_store_spilled_bytes",
                     "object_store_restored_bytes",
                     "object_store_spill_latency_ms",
                     "object_store_quota_evictions"):
            assert name in snap
        assert sum(snap["object_store_spilled_bytes"]["values"]
                   .values()) >= 512 * 1024
    # Each package keeps its own registry.
    assert tmetrics.get_or_create is not jmetrics.get_or_create


# --------------------------------------------------------------- backpressure


def test_put_backpressure_bounded_wait():
    for _, _, spill, _ in MODS:
        t0 = time.monotonic()
        waited = spill.put_backpressure(
            lambda: {"used_bytes": 100, "capacity": 100}, 10,
            high_watermark=0.85, max_wait_s=0.2)
        assert 0.15 <= waited <= 0.3 and time.monotonic() - t0 < 2.0
        assert spill.put_backpressure(
            lambda: {"used_bytes": 0, "capacity": 100}, 10,
            max_wait_s=5.0) == 0.0
        state, calls = {"used": 100}, []

        def stats():
            calls.append(1)
            if len(calls) > 3:
                state["used"] = 0
            return {"used_bytes": state["used"], "capacity": 100}

        assert spill.put_backpressure(stats, 10, max_wait_s=10.0) < 1.0
        assert spill.put_backpressure(lambda: 1 / 0, 10) == 0.0


# ------------------------------------------------------ the runtime's spill


def test_spill_dirs_are_the_ports_own(monkeypatch, tmp_path):
    t = tspill.resolve_spill_dir(tconfig.Config(), "local-x")
    j = jspill.resolve_spill_dir(jconfig.Config(), "local-x")
    assert os.path.basename(os.path.dirname(t)) == "ray_tpu_torch_spill"
    assert os.path.basename(os.path.dirname(j)) == "ray_tpu_spill"
    monkeypatch.setenv("RAY_TPU_OBJECT_SPILL_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("RAY_TPU_TORCH_OBJECT_SPILL_DIR", str(tmp_path / "pt"))
    assert tspill.resolve_spill_dir(tconfig.Config(), "a") == \
        str(tmp_path / "pt" / "a")
    assert jspill.resolve_spill_dir(jconfig.Config(), "a") == \
        str(tmp_path / "jax" / "a")
    assert tspill.resolve_spill_dir(
        tconfig.Config(object_spill_enabled=False), "a") is None


def test_runtime_spills_over_object_store_memory(tmp_path):
    """Twelve 64 KiB values through a 256 KiB store: the same spill counts
    in both packages, every value back equal, the ids equal, and the spill
    directory gone after shutdown."""
    base = [RNG.standard_normal(8192) for _ in range(12)]  # 64 KiB each
    outs = []
    for rt in PKGS:
        rt.init(num_cpus=2, object_store_memory=256 * 1024,
                _system_config={"object_spill_dir": str(tmp_path / rt.__name__)})
        try:
            vals = [v if rt is ray_tpu else torch.from_numpy(v.copy())
                    for v in base]
            refs = [rt.put(v) for v in vals]
            stats = rt.state.object_store_stats()
            spill_dir = rt._private.worker.global_worker().core._spiller.dir
            on_disk = len(os.listdir(spill_dir))

            @rt.remote
            def total(x):
                return float(x.sum())

            sums = rt.get([total.remote(r) for r in refs])
            # One at a time: a batched get of more than the budget never
            # completes in either package (each restore spills another).
            got = [rt.get(r) for r in refs]
            for g, v in zip(got, base):
                np.testing.assert_array_equal(np.asarray(g), v)
            np.testing.assert_allclose(sums, [v.sum() for v in base],
                                       rtol=1e-12)
            outs.append(([r.hex() for r in refs], stats, on_disk))
        finally:
            rt.shutdown()
        assert not os.path.exists(spill_dir)
    assert outs[0] == outs[1]
    assert outs[1][1]["spilled_objects"] == outs[1][2] >= 8


def test_batched_get_over_the_budget_times_out_in_both(tmp_path):
    """ROADMAP.md C5, kept for parity: a get of more values than the store
    can hold at once never sees them all resident (each restore spills
    another), so it times out in both packages; one ref at a time works."""
    outs = []
    for rt in PKGS:
        rt.init(num_cpus=1, object_store_memory=256 * 1024,
                _system_config={"object_spill_dir": str(tmp_path / rt.__name__)})
        try:
            vals = [np.full(8192, i, np.float64) for i in range(6)]
            refs = [rt.put(v if rt is ray_tpu else torch.from_numpy(v))
                    for v in vals]
            with pytest.raises(rt.GetTimeoutError) as info:
                rt.get(refs)
            ones = [float(np.asarray(rt.get(r))[0]) for r in refs]
            outs.append((str(info.value).split(" (")[0], ones))
        finally:
            rt.shutdown()
    assert outs[0] == outs[1]
    assert outs[1][1] == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
