"""The port's cluster runtime against the JAX package's, on the CPU: twins of
every test of tests/test_cluster.py. One cluster of each package per module
(a real GCS head with a colocated node controller and worker processes; the
port's GCS places on ``device="cpu"``); each program runs through a
``ray_tpu`` driver and then a ``ray_tpu_torch`` driver in this process, and
their values, error types and fields, wait splits, resources (``TPU`` read
as ``GPU``) and node tables are held equal. One test holds the port's one
deviation, C10: an actor keeps its resources for its life."""

import importlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster.testing import Cluster as JCluster
from ray_tpu_torch.cluster.testing import Cluster as TCluster

pytestmark = pytest.mark.cluster

PKGS = (ray_tpu, ray_tpu_torch)


def _start(rt, head_resources, **kw):
    """A cluster of ``rt``'s package; ``ACCEL`` in ``head_resources`` names
    the package's accelerator (``TPU`` or ``GPU``)."""
    res = {(_ACCEL[rt] if k == "ACCEL" else k): v
           for k, v in head_resources.items()}
    if rt is ray_tpu_torch:
        return TCluster(head_resources=res, device="cpu", **kw)
    return JCluster(head_resources=res, **kw)


_ACCEL = {ray_tpu: "TPU", ray_tpu_torch: "GPU"}


def start_both(**kw):
    """One cluster of each package, started side by side."""
    out = {}

    def go(rt):
        out[rt] = _start(rt, **kw)

    threads = [threading.Thread(target=go, args=(rt,)) for rt in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(out) != 2:
        for c in out.values():
            c.shutdown()
        raise RuntimeError("a cluster failed to start")
    return out


@pytest.fixture(scope="module")
def clusters():
    # Four workers on the head where the reference's file starts two: with
    # two, a nested task's children can be pipelined behind their parent,
    # blocked in get(), on its own worker, and wait for ever (a fault of
    # the reference's controller, which the port keeps: ROADMAP C11).
    cs = start_both(head_resources={"CPU": 4, "ACCEL": 1}, num_workers=4)
    yield cs
    for c in cs.values():
        c.shutdown()


@pytest.fixture()
def drivers(clusters):
    for rt in PKGS:
        rt.init(address=clusters[rt].address, ignore_reinit_error=True)
    yield clusters
    for rt in PKGS:
        rt.shutdown()


def same(program, *args):
    """Run ``program(rt, *args)`` through each package's driver; hold the
    results equal and return the port's."""
    j, t = (program(rt, *args) for rt in PKGS)
    assert j == t
    return t


def same_side_by_side(program):
    """``same`` for programs that touch no driver (each starts its own
    cluster in a subprocess): both packages' runs go side by side."""
    out = {}
    threads = [threading.Thread(target=lambda rt=rt: out.__setitem__(
        rt, program(rt))) for rt in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 2 and out[ray_tpu] == out[ray_tpu_torch]
    return out[ray_tpu_torch]


def _gpu_key(d):
    names = {"TPU": "GPU", "tpu_memory": "gpu_memory"}
    return {names.get(k, k): v for k, v in d.items()}


def _err(e):
    out = [type(e).__name__]
    if hasattr(e, "function_name"):
        out += [e.function_name.rsplit(".", 1)[-1], type(e.cause).__name__,
                str(e.cause)]
    return out


def _raises(rt, fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the result
        return e
    pytest.fail(f"{rt.__name__}: nothing raised")


def _worker(rt):
    return importlib.import_module(rt.__name__ + "._private.worker")


# ------------------------------------------------------------------ basics


class TestClusterBasics:
    def test_task_roundtrip(self, drivers):
        def prog(rt):
            @rt.remote
            def mul(a, b):
                return a * b

            return rt.get(mul.remote(6, 7), timeout=30)

        assert same(prog) == 42

    def test_fanout(self, drivers):
        def prog(rt):
            @rt.remote
            def sq(x):
                return x * x

            return rt.get([sq.remote(i) for i in range(30)], timeout=60)

        assert same(prog) == [i * i for i in range(30)]

    def test_dependency_chain(self, drivers):
        def prog(rt):
            @rt.remote
            def inc(x):
                return x + 1

            ref = rt.put(0)
            for _ in range(10):
                ref = inc.remote(ref)
            return rt.get(ref, timeout=60)

        assert same(prog) == 10

    def test_error_propagation(self, drivers):
        def prog(rt):
            @rt.remote
            def boom():
                raise ValueError("cluster kaboom")

            e = _raises(rt, lambda: rt.get(boom.remote(), timeout=30))
            assert isinstance(e, rt.TaskError)
            assert "cluster kaboom" in str(e)
            return _err(e)

        assert same(prog) == ["TaskError", "boom", "ValueError",
                              "cluster kaboom"]

    def test_put_get(self, drivers):
        def prog(rt):
            data = {"x": list(range(100))}
            return rt.get(rt.put(data), timeout=30)

        assert same(prog) == {"x": list(range(100))}

    def test_wait(self, drivers):
        def prog(rt):
            @rt.remote
            def fast():
                return 1

            @rt.remote
            def slow():
                time.sleep(3)
                return 2

            f, s = fast.remote(), slow.remote()
            ready, rest = rt.wait([f, s], num_returns=1, timeout=2.5)
            return ready == [f], rest == [s]

        assert same(prog) == (True, True)

    def test_nested_tasks(self, drivers):
        def prog(rt):
            @rt.remote
            def leaf(x):
                return x * 2

            @rt.remote
            def parent(n):
                return sum(rt.get([leaf.remote(i) for i in range(n)]))

            return rt.get(parent.remote(4), timeout=60)

        assert same(prog) == 12

    def test_cluster_state(self, drivers):
        def prog(rt):
            res = _gpu_key(rt.cluster_resources())
            nodes = rt.nodes()
            return res, sum(1 for n in nodes if n["Alive"]), sorted(nodes[0])

        res, alive, keys = same(prog)
        assert res["CPU"] >= 4 and res["GPU"] == 1
        assert alive >= 1 and "Alive" in keys


# ------------------------------------------------------------------ actors


class TestClusterActors:
    def test_actor_lifecycle(self, drivers):
        def prog(rt):
            @rt.remote
            class Counter:
                def __init__(self, start):
                    self.n = start

                def inc(self):
                    self.n += 1
                    return self.n

            c = Counter.remote(100)
            return rt.get([c.inc.remote() for _ in range(5)], timeout=30)

        assert same(prog) == [101, 102, 103, 104, 105]

    def test_named_actor(self, drivers):
        def prog(rt):
            @rt.remote
            class Store:
                def __init__(self):
                    self.d = {}

                def put(self, k, v):
                    self.d[k] = v
                    return True

                def get(self, k):
                    return self.d.get(k)

            Store.options(name="kvstore").remote()
            h = rt.get_actor("kvstore")
            rt.get(h.put.remote("a", 1), timeout=30)
            return rt.get(h.get.remote("a"), timeout=30)

        assert same(prog) == 1

    def test_kill_actor(self, drivers):
        def prog(rt):
            @rt.remote
            class A:
                def ping(self):
                    return "pong"

            a = A.remote()
            assert rt.get(a.ping.remote(), timeout=30) == "pong"
            rt.kill(a)
            time.sleep(0.5)
            e = _raises(rt, lambda: rt.get(a.ping.remote(), timeout=15))
            assert isinstance(e, (rt.ActorError, rt.RayTpuError))
            return type(e).__name__

        same(prog)

    def test_max_concurrency(self, drivers):
        def prog(rt):
            @rt.remote(max_concurrency=4)
            class Slow:
                def work(self):
                    time.sleep(0.5)
                    return 1

            s = Slow.remote()
            rt.get(s.work.remote(), timeout=30)  # creation + warm path
            t0 = time.monotonic()
            out = rt.get([s.work.remote() for _ in range(4)], timeout=30)
            return out, time.monotonic() - t0 < 1.6  # concurrent, not 2 s

        assert same(prog) == ([1] * 4, True)

    def test_asyncio_actor_concurrent_awaits(self, drivers):
        def prog(rt):
            @rt.remote
            class AsyncWorker:
                async def work(self, i):
                    import asyncio
                    await asyncio.sleep(0.5)
                    return i

            w = AsyncWorker.remote()
            rt.get(w.work.remote(-1), timeout=30)  # creation + warm path
            t0 = time.monotonic()
            out = rt.get([w.work.remote(i) for i in range(5)], timeout=30)
            return sorted(out), time.monotonic() - t0 < 2.0

        assert same(prog) == (list(range(5)), True)

    def test_asyncio_actor_state_consistency(self, drivers):
        def prog(rt):
            @rt.remote
            class Accum:
                def __init__(self):
                    self.total = 0

                async def add(self, x):
                    import asyncio
                    await asyncio.sleep(0.01)
                    self.total += x
                    return self.total

                async def value(self):
                    return self.total

            a = Accum.remote()
            rt.get([a.add.remote(i) for i in range(10)], timeout=30)
            return rt.get(a.value.remote(), timeout=30)

        assert same(prog) == sum(range(10))


def test_accelerator_actor_holds_its_accelerator_for_its_life(drivers):
    """C10, the port's one deviation here: an actor keeps the resources of
    its creation until its worker exits, as the local runtime's actors do
    in both packages. The reference's controller gives them back when the
    constructor returns, so a ``num_tpus=1`` task runs beside a live
    ``num_tpus=1`` actor; the port's ``num_gpus=1`` task waits for
    ``kill()``."""
    def prog(rt):
        accel = "num_tpus" if rt is ray_tpu else "num_gpus"

        @rt.remote
        class Holder:
            def ping(self):
                return 1

        @rt.remote
        def use():
            return "ran"

        a = Holder.options(**{accel: 1}).remote()
        rt.get(a.ping.remote(), timeout=60)
        held = _gpu_key(rt.available_resources()).get("GPU", 0.0)
        ref = use.options(**{accel: 1}).remote()
        ran_beside = bool(rt.wait([ref], timeout=30 if rt is ray_tpu
                                  else 3)[0])
        rt.kill(a)
        out = rt.get(ref, timeout=60)
        deadline = time.monotonic() + 10
        while _gpu_key(rt.available_resources()).get("GPU") != 1.0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        back = _gpu_key(rt.available_resources()).get("GPU")
        return held, ran_beside, out, back

    assert prog(ray_tpu) == (1.0, True, "ran", 1.0)
    assert prog(ray_tpu_torch) == (0.0, False, "ran", 1.0)


# -------------------------------------------------------------- multi-node


class TestMultiNode:
    def test_add_node_and_spread(self, drivers):
        def prog(rt, clusters):
            cluster = clusters[rt]
            node = cluster.add_node(resources={"CPU": 4}, num_workers=2)
            cluster.wait_for_nodes(2)
            try:
                total = _gpu_key(rt.cluster_resources())

                @rt.remote
                def where(i):
                    import importlib as _il

                    time.sleep(0.5)  # hold the slot so tasks spread
                    worker = _il.import_module(rt.__name__ + "._private.worker")
                    return worker.global_worker().core._home_addr

                refs = [where.remote(i) for i in range(8)]
                homes = set(rt.get(refs, timeout=90))
                return total["CPU"] >= 8, len(homes)
            finally:
                cluster.remove_node(node)

        assert same(prog, drivers) == (True, 2)

    def test_object_transfer(self, drivers):
        def prog(rt, clusters):
            cluster = clusters[rt]
            node = cluster.add_node(resources={"CPU": 4, "tag": 1},
                                    num_workers=2)
            cluster.wait_for_nodes(2)
            try:
                @rt.remote(resources={"tag": 1})
                def produce():
                    return b"x" * (1 << 20)  # 1 MB born on the tagged node

                @rt.remote(num_cpus=1)
                def consume(data):
                    return len(data)

                return rt.get(consume.remote(produce.remote()), timeout=60)
            finally:
                cluster.remove_node(node)

        assert same(prog, drivers) == 1 << 20


# ---------------------------------------------------------- fault tolerance


class TestFaultTolerance:
    def test_worker_crash_surfaces(self, drivers):
        def prog(rt):
            @rt.remote
            def die():
                os._exit(1)

            e = _raises(rt, lambda: rt.get(die.remote(), timeout=60))
            assert isinstance(e, rt.RayTpuError)
            return type(e).__name__

        same(prog)

    def test_cluster_survives_worker_crash(self, drivers):
        def prog(rt):
            @rt.remote
            def die():
                os._exit(1)

            @rt.remote
            def ok():
                return 1

            try:
                rt.get(die.remote(), timeout=60)
            except rt.RayTpuError:
                pass
            return rt.get(ok.remote(), timeout=60)

        assert same(prog) == 1

    def test_node_death_detected(self, drivers):
        def prog(rt, clusters):
            cluster = clusters[rt]
            node = cluster.add_node(resources={"CPU": 2}, num_workers=1)
            cluster.wait_for_nodes(2)
            alive = sum(1 for n in rt.nodes() if n["Alive"])
            cluster.remove_node(node)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if sum(1 for n in rt.nodes() if n["Alive"]) == alive - 1:
                    return alive
                time.sleep(0.2)
            return None

        assert same(prog, drivers) == 2


# ---------------------------------------------------------------- the rest


def test_small_ref_args_are_inlined(drivers):
    """A small, locally available ref arg ships inline in the task spec (the
    task succeeds after the object is freed before dispatch); a large one
    and a container holding a nested ref depend on the store copy."""
    def prog(rt):
        @rt.remote
        def total(x):
            return float(np.sum(x))

        small = rt.put(np.ones(100))
        out = total.remote(small)
        rt.free([small])
        r1 = rt.get(out, timeout=30.0)
        big = rt.put(np.ones(1_000_000))
        r2 = rt.get(total.remote(big), timeout=30.0)
        inner = rt.put(np.arange(1000.0))
        outer = rt.put({"r": inner})

        @rt.remote
        def read_box(box):
            return float(np.sum(rt.get(box["r"])))

        out3 = read_box.remote(outer)
        del inner
        return r1, r2, rt.get(out3, timeout=30.0)

    assert same(prog) == (100.0, 1_000_000.0, float(np.arange(1000.0).sum()))


def test_gcs_debug_stats(drivers):
    def prog(rt):
        @rt.remote
        def one():
            return 1

        assert rt.get([one.remote() for _ in range(20)], timeout=60) == [1] * 20
        stats = _worker(rt).global_worker().core.gcs.call(
            {"type": "debug_stats"})
        handlers = stats["handlers"]
        totals = [v["total_s"] for v in handlers.values()]
        return (handlers["submit_batch"]["count"] >= 1,
                handlers["submit_batch"]["total_s"] >= 0,
                totals == sorted(totals, reverse=True),
                sorted(stats))

    out = same(prog)
    assert out[:3] == (True, True, True)
    assert {"handlers", "ok", "place_perf", "recv_stats"} <= set(out[3])


def _script_env(rt):
    return importlib.import_module(
        rt.__name__ + ".cluster.testing")._subprocess_env()


def _cluster_line(rt):
    return (f"from {rt.__name__}.cluster.testing import Cluster\n"
            "c = Cluster(head_resources={'CPU': 1}, num_workers=1"
            + (", device='cpu'" if rt is ray_tpu_torch else "") + ")\n")


def _refused(addr):
    host, port = addr.split(":")
    try:
        socket.create_connection((host, int(port)), timeout=2).close()
    except OSError:
        return True
    return False


def test_cluster_atexit_cleanup():
    """A driver that exits without shutdown() orphans no cluster process."""
    def prog(rt):
        script = _cluster_line(rt) + "print(c.address, flush=True)\n"
        proc = subprocess.run([sys.executable, "-c", script],
                              env=_script_env(rt), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-1000:]
        return _refused(proc.stdout.strip())

    assert same_side_by_side(prog) is True


def test_cluster_cleanup_on_dropped_reference_and_sigterm():
    """Cleanup holds when the driver drops its Cluster and is SIGTERM'd."""
    def prog(rt):
        script = ("import sys, time\n"
                  "def run():\n    "
                  + _cluster_line(rt).replace("\n", "\n    ")
                  + "print(c.address, flush=True)\n"
                  "run()\n"
                  "time.sleep(60)\n")
        proc = subprocess.Popen([sys.executable, "-c", script],
                                env=_script_env(rt), stdout=subprocess.PIPE,
                                text=True)
        addr = proc.stdout.readline().strip()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        time.sleep(1)
        return _refused(addr)

    assert same_side_by_side(prog) is True
