"""The port's cluster fault tolerance against the JAX package's, on the CPU:
twins of every test of tests/test_cluster_ft.py (task retry, direct-push
retry, object reconstruction, actor restart, checkpoints, cancellation, a
torn completion record). Tests that kill only workers share one cluster of
each package per module; the three that kill a node get clusters of their
own, and run both packages' programs side by side. Values and error types
are held equal."""

import importlib
import os
import tempfile
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


def _start(rt):
    kw = dict(head_resources={"CPU": 2}, num_workers=1)
    return TCluster(device="cpu", **kw) if rt is ray_tpu_torch else JCluster(**kw)


def _run_side_by_side(fn):
    """``fn(rt)`` for both packages on two threads: ({rt: result},
    {rt: exception})."""
    out, errs = {}, {}

    def go(rt):
        try:
            out[rt] = fn(rt)
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            errs[rt] = e

    threads = [threading.Thread(target=go, args=(rt,)) for rt in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, errs


def _start_both():
    cs, errs = _run_side_by_side(_start)
    if errs:
        for c in cs.values():
            c.shutdown()
        raise next(iter(errs.values()))
    return cs


@pytest.fixture(scope="module")
def shared():
    cs = _start_both()
    yield cs
    for c in cs.values():
        c.shutdown()


@pytest.fixture()
def drivers(shared):
    for rt in PKGS:
        rt.init(address=shared[rt].address, ignore_reinit_error=True)
    yield shared
    for rt in PKGS:
        rt.shutdown()


@pytest.fixture()
def own():
    """Fresh clusters for a test that kills a node."""
    cs = _start_both()
    for rt in PKGS:
        rt.init(address=cs[rt].address)
    yield cs
    for rt in PKGS:
        rt.shutdown()
    for c in cs.values():
        c.shutdown()


def same(program, *args):
    j, t = (program(rt, *args) for rt in PKGS)
    assert j == t
    return t


def same_side_by_side(program, clusters):
    out, errs = _run_side_by_side(lambda rt: program(rt, clusters[rt]))
    for e in errs.values():
        raise e
    assert out[ray_tpu] == out[ray_tpu_torch]
    return out[ray_tpu_torch]


def _raised(rt, fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__
    return None


def _warm_direct_lease(rt, timeout=20.0):
    """Run quick no-dep tasks until the driver's direct-push lease is live,
    so the next no-dep submission takes the leased direct path."""
    worker = importlib.import_module(
        rt.__name__ + "._private.worker").global_worker()

    @rt.remote
    def ping():
        return 1

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rt.get(ping.remote(), timeout=30)
        leases = worker.core._direct_leases
        if leases and not any(v.get("acquiring") for v in leases.values()):
            return
        time.sleep(0.1)
    raise TimeoutError("direct lease never became ready")


def _flaky_prog(rt, warm):
    marker = tempfile.mktemp(prefix="ray_tpu_torch_retry_")
    if warm:
        _warm_direct_lease(rt)

    @rt.remote(max_retries=2)
    def flaky(marker_path):
        # First attempt kills its worker; the retry succeeds.
        if not os.path.exists(marker_path):
            with open(marker_path, "w") as f:
                f.write("attempt 1")
            os._exit(1)
        return "survived"

    try:
        return rt.get(flaky.remote(marker), timeout=90)
    finally:
        if os.path.exists(marker):
            os.unlink(marker)


def test_task_retry_on_worker_death(drivers):
    assert same(_flaky_prog, False) == "survived"


def test_direct_push_retry_on_leased_worker_death(drivers):
    assert same(_flaky_prog, True) == "survived"


def test_direct_push_crash_without_retries(drivers):
    def prog(rt):
        _warm_direct_lease(rt)

        @rt.remote(max_retries=0)
        def die():
            os._exit(1)

        return _raised(rt, lambda: rt.get(die.remote(), timeout=60))

    assert same(prog) == "WorkerCrashedError"


def test_no_retry_raises_worker_crashed(drivers):
    def prog(rt):
        @rt.remote(max_retries=0)
        def die():
            os._exit(1)

        return _raised(rt, lambda: rt.get(die.remote(), timeout=60))

    assert same(prog) == "WorkerCrashedError"


def test_retries_exhausted(drivers):
    def prog(rt):
        @rt.remote(max_retries=1)
        def always_dies():
            os._exit(1)

        return _raised(rt, lambda: rt.get(always_dies.remote(), timeout=90))

    assert same(prog) == "WorkerCrashedError"


def test_object_reconstruction_on_node_death(own):
    """The only copy of a task output dies with its node; a dependent task's
    fetch re-executes its lineage on a fresh node."""
    def prog(rt, cluster):
        n2 = cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)
        cluster.wait_for_nodes(2)

        @rt.remote(resources={"pin": 1})
        def produce():
            return np.arange(1000, dtype=np.int64)

        ref = produce.remote()
        ready, _ = rt.wait([ref], num_returns=1, timeout=60)
        assert ready
        cluster.remove_node(n2)  # SIGKILL: arena and object are gone
        cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)

        @rt.remote
        def consume(x):
            return int(x.sum())

        return rt.get(consume.remote(ref), timeout=120)

    assert same_side_by_side(prog, own) == 499500


def test_chained_reconstruction(own):
    """y = g(f()) with both outputs only on the dead node."""
    def prog(rt, cluster):
        n2 = cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)
        cluster.wait_for_nodes(2)

        @rt.remote(resources={"pin": 1})
        def f():
            return np.full(10, 7, dtype=np.int64)

        @rt.remote(resources={"pin": 1})
        def g(x):
            return int(x.sum()) + 1

        x = f.remote()
        y = g.remote(x)
        ready, _ = rt.wait([y], num_returns=1, timeout=60)
        assert ready
        cluster.remove_node(n2)
        cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)
        return rt.get(y, timeout=120)

    assert same_side_by_side(prog, own) == 71


def test_actor_restart_on_worker_death(drivers):
    def prog(rt):
        @rt.remote(max_restarts=1)
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

            def crash(self):
                os._exit(1)

        c = Counter.remote()
        out = [rt.get(c.incr.remote(), timeout=60)]
        out.append(_raised(rt, lambda: rt.get(c.crash.remote(), timeout=60)))
        out.append(rt.get(c.incr.remote(), timeout=90))  # fresh state
        out.append(_raised(rt, lambda: rt.get(c.crash.remote(), timeout=60)))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            err = _raised(rt, lambda: rt.get(c.incr.remote(), timeout=30))
            if err in ("ActorDiedError", "TaskError"):
                out.append("dead")
                break
            time.sleep(0.5)
        return out

    out = same(prog)
    assert out[0] == 1 and out[2] == 1 and out[4] == "dead"
    assert out[1] in ("ActorDiedError", "TaskError", "WorkerCrashedError")


def test_checkpointable_actor_restores_state(drivers):
    def prog(rt):
        @rt.remote(max_restarts=2)
        class CkptCounter(rt.Checkpointable):
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

            def crash(self):
                os._exit(1)

            def should_checkpoint(self, ctx):
                return True

            def save_checkpoint(self):
                return self.n

            def load_checkpoint(self, checkpoint):
                self.n = checkpoint

        c = CkptCounter.remote()
        out = [rt.get(c.incr.remote(), timeout=60) for _ in range(3)]
        out.append(_raised(rt, lambda: rt.get(c.crash.remote(), timeout=60)))
        out.append(rt.get(c.incr.remote(), timeout=90))  # n=3 restored
        return out

    out = same(prog)
    assert out[:3] == [1, 2, 3] and out[4] == 4


def test_actor_restart_on_node_death(own):
    def prog(rt, cluster):
        n2 = cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)
        cluster.wait_for_nodes(2)

        @rt.remote(max_restarts=1, resources={"pin": 1})
        class Pinned:
            def where(self):
                return os.getpid()

        a = Pinned.remote()
        pid1 = rt.get(a.where.remote(), timeout=60)
        cluster.remove_node(n2)
        cluster.add_node(resources={"CPU": 2, "pin": 1}, num_workers=1)
        pid2 = rt.get(a.where.remote(), timeout=120)
        return pid2 != pid1

    assert same_side_by_side(prog, own) is True


def test_cancel_queued_task(drivers):
    def prog(rt):
        @rt.remote(resources={"nonexistent": 1})
        def never_runs():
            return 1

        ref = never_runs.remote()
        time.sleep(0.3)
        rt.cancel(ref)
        return _raised(rt, lambda: rt.get(ref, timeout=60))

    assert same(prog) == "TaskCancelledError"


def test_cancel_running_task(drivers):
    def prog(rt):
        started = tempfile.mktemp(prefix="ray_tpu_torch_cancel_")

        @rt.remote(max_retries=3)
        def slow(path):
            with open(path, "w") as f:
                f.write("started")
            time.sleep(120)
            return "done"

        ref = slow.remote(started)
        deadline = time.monotonic() + 30
        while not os.path.exists(started) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert os.path.exists(started), "task never started"
        os.unlink(started)
        rt.cancel(ref, force=True)
        return _raised(rt, lambda: rt.get(ref, timeout=60))

    assert same(prog) == "TaskCancelledError"


def test_cancel_finished_task_is_noop(drivers):
    def prog(rt):
        @rt.remote
        def quick():
            return 42

        ref = quick.remote()
        first = rt.get(ref, timeout=60)
        rt.cancel(ref)
        return first, rt.get(ref, timeout=60)

    assert same(prog) == (42, 42)


def test_torn_completion_record_falls_back_to_rpc_path(drivers):
    """A torn completion record degrades the owner's ring; every result
    still arrives exactly once through the RPC/directory path."""
    def prog(rt):
        core = importlib.import_module(
            rt.__name__ + "._private.worker").global_worker().core

        @rt.remote
        def sq(x):
            return x * x

        out = [rt.get([sq.remote(i) for i in range(10)], timeout=60)]
        ring = core._ring
        out.append(bool(ring) and not ring.degraded)
        ring._debug_publish_torn()
        refs = [sq.remote(i) for i in range(30)]
        out.append(rt.get(refs, timeout=90))
        out.append((ring.degraded, ring.torn_records >= 1,
                    core._ring_active()))
        out.append(rt.get([sq.remote(i) for i in range(40)], timeout=90))
        out.append(rt.get(refs, timeout=60))
        return out

    out = same(prog)
    assert out[1] is True and out[3] == (True, True, False)
    assert out[2] == out[5] == [i * i for i in range(30)]
    assert out[4] == [i * i for i in range(40)]
