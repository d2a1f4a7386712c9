"""The port's native layer against the JAX package's, on the CPU: twins of
every test of tests/test_native_channel.py, tests/test_native_transfer.py,
tests/test_shm_stress.py and tests/test_native_san.py.

Most twins run the reference test's own program against the JAX package
and then against the port (``RefTwin``: module paths and ``RAY_TPU_``
knobs renamed to the port's; the stress harnesses and the sanitizer sweep
are the port's own copies, ``ray_tpu_torch/_native/stress/*.cc`` and
``python -m ray_tpu_torch.scripts.native_san``; the JAX run's channel and
arena names are its own, so that it never meets the reference file's run
beside it). Each run passes the reference's own assertions.

Three twins are written out here. Two channel tests drive each package's
streaming ``JobWorker`` (its drain thread and EOF join) and
``_OutChannel`` (its backpressure loop) over that package's ring, on
segments named for the process, and both halves must give the same
records and outcomes. The cluster
test starts one cluster of each package (the port's with its GCS on the
CPU and 4 workers a head) and holds sizes and values equal. A last test
moves objects between the two packages' transfer servers and clients,
whose protocol is the same."""

import os
import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_wire_codec import RefTwin

_CHANNEL = RefTwin("test_native_channel", record={},
                   jax_renames=[("rtch-ut", "rtch-tj-ut")],
                   renames=[("rtch-ut", "rttch-ut")])
_STREAMING = ("test_jobworker_native_handshake_end_to_end",
              "test_outchannel_unblocked_by_reader_death_flag")
_TRANSFER = RefTwin("test_native_transfer", record={"available": None},
                    jax_renames=[("tts-ut-", "tts-tj-ut-")],
                    renames=[("tts-ut-", "rtts-tt-ut-")])
_STRESS = RefTwin("test_shm_stress", record={},
                  jax_renames=[("tpsspill-", "tpsspill-tj-")],
                  renames=[("tpsspill-", "rttsspill-"),
                           ('os.path.join(REPO, "tests", "native", src_name)',
                            'os.path.join(REPO, "ray_tpu_torch", "_native",'
                            ' "stress", src_name)')])
_SAN = RefTwin("test_native_san", record={},
               renames=[('[sys.executable, os.path.join(REPO, "scripts", '
                         '"native_san.py"),',
                         '[sys.executable, "-m", '
                         '"ray_tpu_torch.scripts.native_san",')])

TWINNED = {
    "test_native_channel": _CHANNEL.twin_classes(
        globals(), skip=_STREAMING, module_class="TestNativeChannel"),
    "test_native_transfer": _TRANSFER.twin_classes(
        globals(), skip=("test_cluster_large_objects_use_native_plane",),
        module_class="TestNativeTransfer"),
    "test_shm_stress": _STRESS.twin_classes(
        globals(), module_class="TestShmStress"),
    "test_native_san": _SAN.twin_classes(
        globals(), module_class="TestNativeSan"),
}
_WRITTEN_OUT = {
    "test_native_channel": set(_STREAMING),
    "test_native_transfer": {"test_cluster_large_objects_use_native_plane"}}


def test_every_reference_test_is_twinned():
    import importlib

    for ref, twinned in TWINNED.items():
        mod = importlib.import_module(ref)
        names = {n for n in vars(mod) if n.startswith("test_")}
        assert set(twinned) | _WRITTEN_OUT.get(ref, set()) == names, ref
        assert not set(twinned) & _WRITTEN_OUT.get(ref, set())


# ------------------------------------------- the streaming channel programs


def _channels(pkg):
    if pkg is ray_tpu:
        from ray_tpu._native import channel
    else:
        from ray_tpu_torch._native import channel
    return channel


def _worker_module(pkg):
    if pkg is ray_tpu:
        from ray_tpu.streaming import worker
    else:
        from ray_tpu_torch.streaming import worker
    return worker


def _handshake_prog(pkg):
    """20 pickled batches through a channel into a sink ``JobWorker`` that
    drains it on its thread and joins it at EOF; (sorted records, record
    count)."""
    ch, wmod = _channels(pkg), _worker_module(pkg)
    name = ("rtch-tj-hs" if pkg is ray_tpu else "rttch-hs") + str(os.getpid())
    w = ch.ChannelWriter(name, capacity=1 << 20)
    sink = wmod.JobWorker("sink", None, 0, 1)
    channel_id = "ut-edge:0->0"
    sink.expect_input(channel_id)
    assert sink.open_native_channel(channel_id, name)
    for chunk in range(20):
        w.write(pickle.dumps(list(range(chunk * 10, chunk * 10 + 10))))
    w.close()
    assert sink.push_eof(channel_id)  # joins the drain thread
    return sorted(sink.sink_results()), sink.stats()["records_in"]


def test_jobworker_native_handshake_end_to_end():
    j, t = _handshake_prog(ray_tpu), _handshake_prog(ray_tpu_torch)
    assert j == t == (list(range(200)), 200)


def _death_flag_prog(pkg, monkeypatch):
    """A writer blocked on a full ring stays blocked while the consumer is
    stalled but alive, and is released when the consumer marks itself dead;
    a draining consumer lets every batch through. (outcome, blocked, then
    released, batches drained)."""
    ch, wmod = _channels(pkg), _worker_module(pkg)
    tag = "rtch-tj-" if pkg is ray_tpu else "rttch-"
    names = (f"{tag}d7-{os.getpid()}", f"{tag}d8-{os.getpid()}")
    monkeypatch.setattr(wmod, "BACKPRESSURE_WINDOW_S", 0.2)

    def sender(name):
        out = wmod._OutChannel.__new__(wmod._OutChannel)  # transport only
        out._writer = ch.ChannelWriter(name, capacity=4096)
        out.channel_id, out.seq = name, 0
        return out._writer, out.send

    _, send = sender(names[0])
    r = ch.ChannelReader(names[0])
    outcome = []

    def fill():
        try:
            for _ in range(100):
                send([b"x" * 400])
        except ch.ChannelClosed:
            outcome.append("released")

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    t.join(1.5)
    blocked = t.is_alive()
    r.mark_dead()
    t.join(5)
    released = not t.is_alive()
    r.close()
    w2, send2 = sender(names[1])
    r2 = ch.ChannelReader(names[1])
    drained = []

    def drain():
        while True:
            try:
                drained.append(r2.read(timeout=15))
            except ch.ChannelClosed:
                return

    t2 = threading.Thread(target=drain)
    t2.start()
    for _ in range(20):
        send2([b"y" * 400])
    w2.close()
    t2.join(10)
    r2.close()
    return outcome, blocked, released, len(drained) >= 20


def test_outchannel_unblocked_by_reader_death_flag(monkeypatch):
    j = _death_flag_prog(ray_tpu, monkeypatch)
    t = _death_flag_prog(ray_tpu_torch, monkeypatch)
    assert j == t == (["released"], True, True, True)


# --------------------------------------------------------- the cluster test


def _cluster_large_objects(rt):
    """The reference's program on a cluster of ``rt``: (some alive node
    has a transfer port, the consumers' sizes, the first blob's size and
    its bytes' digest)."""
    import hashlib

    if rt is ray_tpu_torch:
        from ray_tpu_torch.cluster.testing import Cluster
        cluster = Cluster(head_resources={"CPU": 2}, num_workers=4,
                          device="cpu")
    else:
        from ray_tpu.cluster.testing import Cluster
        cluster = Cluster(head_resources={"CPU": 2}, num_workers=4)
    try:
        rt.init(address=cluster.address)
        nodes = rt.nodes()
        has_port = any(n.get("TransferPort") for n in nodes if n["Alive"])

        @rt.remote
        def produce(seed):
            rng = np.random.RandomState(seed)
            return rng.bytes(4 * 1024 * 1024)

        @rt.remote
        def consume(blob):
            return len(blob)

        refs = [produce.remote(i) for i in range(4)]
        sizes = rt.get([consume.remote(r) for r in refs], timeout=120)
        blob0 = rt.get(refs[0], timeout=120)
        return has_port, sizes, len(blob0), hashlib.sha256(blob0).hexdigest()
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.mark.cluster
def test_cluster_large_objects_use_native_plane():
    j = _cluster_large_objects(ray_tpu)
    t = _cluster_large_objects(ray_tpu_torch)
    assert j == t
    assert t[:3] == (True, [4 * 1024 * 1024] * 4, 4 * 1024 * 1024)


# ------------------------------------------------- across the two packages


def _stores(tag):
    from ray_tpu._native.shm_store import ShmObjectStore as JStore
    from ray_tpu_torch._native.shm_store import ShmObjectStore as TStore

    names = (f"tts-tj-x{tag}-{os.getpid()}", f"rtts-tt-x{tag}-{os.getpid()}")
    return [cls(n, 16 * 1024 * 1024, create=True)
            for cls, n in zip((JStore, TStore), names)], names


@pytest.mark.skipif(not _TRANSFER.mods["jax"].available()
                    or not _TRANSFER.mods["port"].available(),
                    reason="native transfer lib unavailable")
@pytest.mark.parametrize("direction", ["port_pulls_from_jax",
                                       "jax_pulls_from_port"])
def test_transfer_between_the_packages(direction):
    """The port's client pulls from the JAX package's server, and the
    reverse, whole and in resumed chunks: the same bytes land."""
    from ray_tpu._native import transfer as jt
    from ray_tpu_torch._native import transfer as tt

    (jstore, tstore), names = _stores(direction[:4])
    try:
        src, dst = (jstore, tstore) if direction.startswith("port") \
            else (tstore, jstore)
        smod, cmod = (jt, tt) if direction.startswith("port") else (tt, jt)
        sname, dname = (names if direction.startswith("port")
                        else names[::-1])
        payload = os.urandom(700_001)
        assert src.put(b"x" * 24, payload)
        srv, cli = smod.TransferServer(sname), cmod.TransferClient(dname)
        try:
            assert cli.probe_size("127.0.0.1", srv.port, b"x" * 24) \
                == len(payload)
            assert cli.fetch_into_store("127.0.0.1", srv.port, b"x" * 24)
            assert dst.get_bytes(b"x" * 24) == payload
            view = dst.create(b"y" * 24, len(payload))
            view[:1234] = payload[:1234]
            got = cli.fetch_chunks("127.0.0.1", srv.port, b"x" * 24, view,
                                   1234, 1 << 14)
            assert got == -(-(len(payload) - 1234) // (1 << 14))
            del view
            dst.seal(b"y" * 24)
            assert dst.get_bytes(b"y" * 24) == payload
        finally:
            cli.close()
            srv.stop()
    finally:
        for s, n in zip((jstore, tstore), names):
            s.close()
            try:
                os.unlink(f"/dev/shm/{n}")
            except OSError:
                pass


def test_channel_between_the_packages():
    """A port writer and a JAX reader on one segment, and the reverse: the
    two channel libraries share the ring's layout."""
    from ray_tpu._native import channel as jc
    from ray_tpu_torch._native import channel as tc

    for wmod, rmod in ((tc, jc), (jc, tc)):
        name = f"rttch-x-{os.getpid()}-{time.monotonic_ns()}"
        w = wmod.ChannelWriter(name, capacity=4096)
        r = rmod.ChannelReader(name)
        msgs = [os.urandom(50 + (i * 61) % 700) for i in range(40)]
        got = []

        def drain():
            while True:
                try:
                    got.append(r.read(timeout=15))
                except rmod.ChannelClosed:
                    return

        t = threading.Thread(target=drain)
        t.start()
        for m in msgs:
            w.write(m, timeout=15)
        w.close()
        t.join(20)
        r.close()
        assert got == msgs
