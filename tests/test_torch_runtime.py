"""The port's local runtime against the JAX package's, on the CPU: twins of
tests/test_basic.py (tasks, dependencies, errors, put/get/wait, nested tasks,
actors, named actors, cluster state), each program run through
``ray_tpu`` and then through ``ray_tpu_torch`` in one process on the same
numpy-seeded inputs (numpy arrays for JAX, CPU tensors for the port), with
their values, error types and fields, ObjectRef hexes, wait splits,
resources and timeline event kinds held equal. Then the port's own surface:
``num_gpus`` and the ``GPU`` resource, actor restarts, cluster mode failing
without a head as JAX's does,
``ObjectRef.future()`` before and after ``init()``, and ``shutdown()``
leaving no runtime thread."""

import asyncio
import itertools
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import ids as jids
from ray_tpu._private import memory_store as jstore
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import memory_store as tstore

PKGS = (ray_tpu, ray_tpu_torch)
_RUNTIME_THREADS = ("task-", "actor-", "pg-", "flight-recorder")


@pytest.fixture(autouse=True)
def _both_shut_down():
    """Neither runtime outlives a test (nor, under --dist loadfile, this
    file)."""
    yield
    for rt in PKGS:
        rt.shutdown()


def _init(rt, gpus=0, **kw):
    accel = "num_tpus" if rt is ray_tpu else "num_gpus"
    rt.init(num_cpus=8, **{accel: gpus}, **kw)


def _tensor(rt, arr):
    """The same input for both packages: the numpy array for JAX, a CPU
    tensor over the same bytes for the port."""
    return arr if rt is ray_tpu else torch.from_numpy(arr)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gpu_key(d):
    """A resource dict with the JAX package's accelerator names mapped to
    the port's."""
    names = {"TPU": "GPU", "tpu_memory": "gpu_memory"}
    return {names.get(k, k): v for k, v in d.items()}


def _err(e):
    """What the reference's tests read of an error, by package-free names."""
    out = [type(e).__name__]
    if hasattr(e, "function_name"):
        out += [e.function_name.rsplit(".", 1)[-1], type(e.cause).__name__,
                str(e.cause)]
    if getattr(e, "actor_id", None) is not None:
        out.append(e.actor_id.hex())
    if getattr(e, "task_id", None) is not None:
        out.append(e.task_id.hex())
    return out


def both(program, gpus=0, **init_kw):
    """Run ``program(rt)`` on a fresh runtime of each package in turn;
    return (JAX's result, the port's)."""
    outs = []
    for rt in PKGS:
        _init(rt, gpus, **init_kw)
        try:
            outs.append(program(rt))
        finally:
            rt.shutdown()
    return outs


def same(program, gpus=0, **init_kw):
    j, t = both(program, gpus, **init_kw)
    assert j == t
    return t


# ------------------------------------------------------------------ tasks


def test_simple_task_and_hexes():
    def prog(rt):
        @rt.remote
        def f(x):
            return x + 1

        ref = f.remote(1)
        return ref.hex(), rt.get(ref)

    assert same(prog)[1] == 2


def test_fanout():
    def prog(rt):
        @rt.remote
        def sq(x):
            return x * x

        refs = [sq.remote(i) for i in range(100)]
        return [r.hex() for r in refs], rt.get(refs)

    assert same(prog)[1] == [i * i for i in range(100)]


def test_dependency_chain():
    def prog(rt):
        @rt.remote
        def inc(x):
            return x + 1

        ref = rt.put(0)
        hexes = [ref.hex()]
        for _ in range(50):
            ref = inc.remote(ref)
            hexes.append(ref.hex())
        return hexes, rt.get(ref)

    assert same(prog)[1] == 50


def test_multiple_returns():
    def prog(rt):
        @rt.remote(num_returns=3)
        def three():
            return 1, 2, 3

        refs = three.remote()
        return [r.hex() for r in refs], rt.get(refs)

    assert same(prog)[1] == [1, 2, 3]


def test_kwargs_and_ref_kwarg():
    def prog(rt):
        @rt.remote
        def f(a, b=10):
            return a + b

        r = rt.put(5)
        return rt.get([f.remote(1), f.remote(1, b=2), f.remote(1, b=r)])

    assert same(prog) == [11, 3, 6]


def test_task_error_propagates():
    def prog(rt):
        @rt.remote
        def boom():
            raise ValueError("kaboom")

        with pytest.raises(rt.TaskError, match="kaboom") as info:
            rt.get(boom.remote())
        return _err(info.value)

    assert same(prog) == ["TaskError", "boom", "ValueError", "kaboom"]


def test_error_propagates_through_chain():
    def prog(rt):
        @rt.remote
        def boom():
            raise ValueError("root cause")

        @rt.remote
        def passthrough(x):
            return x

        with pytest.raises(rt.TaskError, match="root cause") as info:
            rt.get(passthrough.remote(passthrough.remote(boom.remote())))
        assert "ValueError" in info.value.remote_traceback
        return _err(info.value)

    assert same(prog)[1] == "boom"


def test_nested_and_deeply_nested_tasks():
    """More nesting levels than CPU slots: blocked tasks release theirs."""
    def prog(rt):
        @rt.remote
        def leaf(x):
            return x * 2

        @rt.remote
        def parent(x):
            return sum(rt.get([leaf.remote(i) for i in range(x)]))

        @rt.remote
        def rec(n):
            if n == 0:
                return 0
            return rt.get(rec.remote(n - 1)) + 1

        return rt.get(parent.remote(5)), rt.get(rec.remote(20))

    assert same(prog) == (20, 20)


def test_options_override_and_direct_call():
    def prog(rt):
        @rt.remote
        def f():
            return 1

        with pytest.raises(TypeError):
            f()
        return rt.get(f.options(num_cpus=2).remote())

    assert same(prog) == 1


def test_array_roundtrip_is_the_same_object():
    """A numpy array through JAX's runtime, a CPU tensor through the port's:
    equal values, and the task gets the stored object itself."""
    base = np.random.default_rng(0).standard_normal(1000).astype(np.float32)

    def prog(rt):
        arr = _tensor(rt, base)

        @rt.remote
        def double(a):
            return a * 2

        @rt.remote
        def ident(a):
            return a

        ref = rt.put(arr)
        same_obj = rt.get(ident.remote(ref)) is arr and rt.get(ref) is arr
        return ref.hex(), _np(rt.get(double.remote(arr))).tolist(), same_obj

    out = same(prog)
    np.testing.assert_array_equal(np.asarray(out[1], np.float32), base * 2)
    assert out[2]


# ---------------------------------------------------------- put/get/wait


def test_put_get_and_put_objectref_rejected():
    def prog(rt):
        ref = rt.put({"a": [1, 2, 3]})
        with pytest.raises(TypeError):
            rt.put(ref)
        return ref.hex(), rt.get(ref)

    assert same(prog)[1] == {"a": [1, 2, 3]}


def test_get_timeout():
    def prog(rt):
        gate = threading.Event()

        @rt.remote
        def slow():
            gate.wait(10)

        ref = slow.remote()
        with pytest.raises(rt.GetTimeoutError) as info:
            rt.get(ref, timeout=0.1)
        gate.set()
        assert rt.get(ref, timeout=10) is None
        return type(info.value).__name__, str(info.value)

    assert same(prog)[0] == "GetTimeoutError"


def test_wait_splits_ready_from_not_ready():
    def prog(rt):
        gate = threading.Event()

        @rt.remote
        def fast():
            return 1

        @rt.remote
        def slow():
            gate.wait(10)
            return 2

        f, s = fast.remote(), slow.remote()
        ready, not_ready = rt.wait([f, s], num_returns=1, timeout=5.0)
        assert ready == [f] and not_ready == [s]
        slows = [slow.remote() for _ in range(3)]
        none, rest = rt.wait(slows, num_returns=3, timeout=0.1)
        gate.set()
        split = ([r.hex() for r in ready], [r.hex() for r in not_ready],
                 [r.hex() for r in none], [r.hex() for r in rest])
        assert rt.get(slows, timeout=10) == [2, 2, 2]
        return split

    out = same(prog)
    assert out[2] == [] and len(out[3]) == 3


def test_wait_argument_errors():
    def prog(rt):
        r = rt.put(1)
        errs = []
        for kw in ({"refs": [r, r]}, {"refs": [r], "num_returns": 2},
                   {"refs": [r], "num_returns": 0}):
            refs = kw.pop("refs")
            with pytest.raises(ValueError) as info:
                rt.wait(refs, **kw)
            errs.append(str(info.value))
        with pytest.raises(TypeError):
            rt.wait(r)
        return errs

    same(prog)


def test_await_objectref():
    def prog(rt):
        @rt.remote
        def f():
            return 41

        async def main():
            return await f.remote() + 1

        return asyncio.run(main())

    assert same(prog) == 42


def test_future_before_and_after_init():
    """Before init() future() fails as JAX's does (no runtime to ask);
    after it the future resolves."""
    kinds = []
    for rt, ids in ((ray_tpu, jids), (ray_tpu_torch, tids)):
        ref = rt.ObjectRef(ids.ObjectID.for_put(
            ids.TaskID.for_driver_task(ids.JobID.from_int(1)), 1))
        with pytest.raises(Exception) as info:
            ref.future()
        kinds.append(type(info.value))
    assert kinds[0] is kinds[1]

    def prog(rt):
        ref = rt.put(7)
        return ref.hex(), ref.future().result(timeout=5)

    assert same(prog)[1] == 7


class _CountingDict(dict):
    """A store's object table that counts membership checks."""

    checks = 0

    def __contains__(self, key):
        self.checks += 1
        return super().__contains__(key)


def test_batched_get_is_linear_in_the_batch():
    """A get of n objects that arrive one put at a time returns what the
    reference's store returns, and checks O(n) entries of the port's
    store: it waits at the first missing object, where the reference
    rescans the whole batch on every put (O(n^2) under the store's lock;
    ROADMAP.md C6)."""
    n = 1000
    outs = []
    for ids, store_mod in ((jids, jstore), (tids, tstore)):
        store = store_mod.MemoryStore()
        store._objects = table = _CountingDict()
        driver = ids.TaskID.for_driver_task(ids.JobID.from_int(1))
        oids = [ids.ObjectID.for_put(driver, i + 1) for i in range(n)]
        got = []
        getter = threading.Thread(
            target=lambda: got.append(store.get(oids, timeout=60)))
        getter.start()
        for i, oid in enumerate(oids):
            store.put(oid, store_mod.StoredObject(value=i, nbytes=8))
            time.sleep(0)  # let the getter wake between puts
        getter.join(60)
        assert not getter.is_alive()
        outs.append(([obj.value for obj in got[0]], table.checks))
    assert outs[0][0] == outs[1][0] == list(range(n))
    assert outs[1][1] <= 4 * n, outs[1][1]


# ------------------------------------------------------------------ actors


def test_actor_counter_is_ordered():
    def prog(rt):
        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.remote()
        refs = [c.inc.remote() for _ in range(10)]
        return [r.hex() for r in refs], rt.get(refs)

    assert same(prog)[1] == list(range(1, 11))


def test_actor_constructor_args_and_ref_args():
    def prog(rt):
        @rt.remote
        class Adder:
            def __init__(self, base):
                self.base = base

            def add(self, x):
                return self.base + x

        a = Adder.remote(100)
        h = Adder.remote(rt.put(7))
        return rt.get([a.add.remote(1), h.add.remote(0)])

    assert same(prog) == [101, 7]


def test_actor_errors():
    def prog(rt):
        @rt.remote
        class A:
            def boom(self):
                raise RuntimeError("actor oops")

        @rt.remote
        class Broken:
            def __init__(self):
                raise ValueError("cannot build")

            def m(self):
                return 1

        with pytest.raises(rt.TaskError, match="actor oops") as info:
            rt.get(A.remote().boom.remote())
        b = Broken.remote()
        with pytest.raises(rt.RayTpuError) as died:
            rt.get(b.m.remote(), timeout=5)
        return _err(info.value), _err(died.value), died.value.message

    out = same(prog)
    assert out[1][0] == "ActorDiedError" and "cannot build" in out[2]


def test_kill_and_named_actor():
    def prog(rt):
        @rt.remote
        class Registry:
            def __init__(self):
                self.data = {}

            def set(self, k, v):
                self.data[k] = v

            def get(self, k):
                return self.data.get(k)

        Registry.options(name="registry").remote()
        h = rt.get_actor("registry")
        rt.get(h.set.remote("x", 1))
        got = rt.get(h.get.remote("x"))
        rt.kill(h)
        with pytest.raises(rt.ActorError) as info:
            rt.get(h.get.remote("x"), timeout=5)
        with pytest.raises(ValueError):
            rt.get_actor("registry")  # a killed actor gives up its name
        with pytest.raises(TypeError):
            rt.kill("not a handle")
        return got, _err(info.value), sorted(
            v["State"] for v in rt.state.actors().values())

    assert same(prog)[0] == 1


def test_actor_restarts_as_in_the_reference():
    """max_restarts=1: the first kill(no_restart=False) restarts the actor
    (fresh instance, same handle and name), the second kills it."""
    def prog(rt):
        @rt.remote(max_restarts=1)
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.options(name="c").remote()
        first = rt.get([c.inc.remote() for _ in range(3)])
        rt.kill(c, no_restart=False)
        again = rt.get(c.inc.remote(), timeout=10)
        alive = rt.get_actor("c") == c
        rt.kill(c, no_restart=False)
        with pytest.raises(rt.ActorDiedError):
            rt.get(c.inc.remote(), timeout=5)
        return first, again, alive

    assert same(prog) == ([1, 2, 3], 1, True)


def test_checkpointable_actor_resumes_after_restart():
    def prog(rt):
        @rt.remote(max_restarts=1)
        class Acc(rt.Checkpointable):
            def __init__(self):
                self.total = 0

            def add(self, x):
                self.total += x
                return self.total

            def save_checkpoint(self):
                return self.total

            def load_checkpoint(self, checkpoint):
                self.total = checkpoint

        a = Acc.remote()
        rt.get([a.add.remote(i) for i in range(5)])
        rt.kill(a, no_restart=False)
        return rt.get(a.add.remote(100), timeout=10)

    assert same(prog) == 110


def test_exit_actor():
    def prog(rt):
        @rt.remote
        class A:
            def bye(self):
                rt.exit_actor()

            def ping(self):
                return 1

        a = A.remote()
        out = rt.get(a.bye.remote(), timeout=5)
        with pytest.raises(rt.ActorDiedError):
            rt.get(a.ping.remote(), timeout=5)
        return out

    assert same(prog) is None


def test_actor_handle_passing():
    def prog(rt):
        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        @rt.remote
        def bump(counter):
            return rt.get(counter.inc.remote())

        c = Counter.remote()
        rt.get([bump.remote(c) for _ in range(5)])
        return rt.get(c.inc.remote())

    assert same(prog) == 6


def test_max_concurrency_and_asyncio_actors_overlap():
    """Four calls that each wait for all four to have started: they can only
    finish if they run at once (no wall-clock bound needed)."""
    def prog(rt):
        @rt.remote(max_concurrency=4)
        class Threaded:
            def __init__(self):
                self.barrier = threading.Barrier(4)

            def work(self):
                self.barrier.wait(10)
                return 1

        @rt.remote
        class AsyncWorker:
            def __init__(self):
                self.started = 0

            async def work(self, i):
                self.started += 1
                for _ in range(1000):
                    if self.started == 5:
                        return i
                    await asyncio.sleep(0.01)
                return -1

        t, w = Threaded.remote(), AsyncWorker.remote()
        return (rt.get([t.work.remote() for _ in range(4)], timeout=20),
                sorted(rt.get([w.work.remote(i) for i in range(5)],
                              timeout=20)))

    assert same(prog) == ([1] * 4, list(range(5)))


# ------------------------------------------------------------ cluster state


def test_resources_and_nodes():
    def prog(rt):
        total = rt.cluster_resources()
        avail = rt.available_resources()
        ns = rt.nodes()
        assert len(ns) == 1 and ns[0]["Alive"]
        return _gpu_key(total), _gpu_key(avail), _gpu_key(ns[0]["Resources"])

    out = same(prog, gpus=1)
    assert out[0]["CPU"] == 8.0 and out[0]["GPU"] == 1.0


def test_timeline_event_kinds():
    def prog(rt):
        @rt.remote
        def f():
            return 1

        @rt.remote
        class A:
            def m(self):
                return 2

        a = A.remote()
        rt.get([f.remote() for _ in range(3)] + [a.m.remote()])
        with rt.profile("user span", {"k": 1}):
            pass
        events = rt.timeline()
        kinds = sorted({e["cat"] for e in events})
        names = sorted(e["name"].rsplit(".", 1)[-1] for e in events
                       if e["cat"] in ("task", "actor_task", "user"))
        return kinds, names, sorted({e["ph"] for e in events})

    kinds, names, _ = same(prog)
    assert {"task", "actor_creation", "user"} <= set(kinds)
    assert names.count("f") == 3 and "m" in names


def test_resource_limit_respected():
    """8 CPUs, tasks take 2 each: at most 4 at once."""
    def prog(rt):
        peak, live = [0], [0]
        lock = threading.Lock()

        @rt.remote(num_cpus=2)
        def busy():
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.05)
            with lock:
                live[0] -= 1
            return 1

        rt.get([busy.remote() for _ in range(8)])
        return peak[0] <= 4

    assert same(prog)


def test_cancel_pending_task():
    def prog(rt):
        gate = threading.Event()

        @rt.remote(num_cpus=8)
        def hog():
            gate.wait(10)
            return 1

        @rt.remote(num_cpus=8)
        def victim():
            return 2

        h = hog.remote()
        v = victim.remote()  # queued behind hog
        rt.cancel(v)
        with pytest.raises(rt.TaskCancelledError) as info:
            rt.get(v, timeout=5)
        gate.set()
        rows = {r["name"].rsplit(".", 1)[-1]: r["state"]
                for r in rt.state.tasks()}
        return _err(info.value), rt.get(h), rows["victim"]

    assert same(prog)[1:] == (1, "FAILED")


def test_free_deletes_the_object():
    def prog(rt):
        ref = rt.put(np.arange(10))
        before = ref.hex() in rt.state.objects()
        rt.free(ref)
        return before, ref.hex() in rt.state.objects()

    assert same(prog) == (True, False)


def test_state_task_rows_and_jobs():
    def prog(rt):
        @rt.remote
        def f(x):
            return x

        rt.get([f.remote(i) for i in range(4)])
        rows = rt.state.tasks(kind="task")
        jobs = rt.state.jobs()
        return (sorted(r["task_id"] for r in rows),
                sorted({r["state"] for r in rows}),
                [(j["job_id"], j["tasks"], j["states"]) for j in jobs],
                rt.state.summarize_tasks())

    same(prog)


# ------------------------------------------------------- GPU accounting


def test_gpu_task_waits_for_the_gpu_actor():
    """With one GPU declared, an actor holding it keeps a num_gpus=1 task
    pending (wait says not ready; its row gives the capacity reason); kill
    admits it. JAX's TPU runs the same program."""
    base = np.random.default_rng(1).standard_normal(64).astype(np.float32)

    def prog(rt):
        accel = {"num_tpus" if rt is ray_tpu else "num_gpus": 1}

        @rt.remote(**accel)
        class Holder:
            def ping(self):
                return "pong"

        @rt.remote(**accel)
        def scale(x):
            return x * 3

        h = Holder.remote()
        assert rt.get(h.ping.remote()) == "pong"
        ref = scale.remote(rt.put(_tensor(rt, base)))
        ready, rest = rt.wait([ref], timeout=0.3)
        row = rt.state.tasks(name_contains="scale")[0]
        held = _gpu_key(rt.available_resources()).get("GPU", 0.0)
        rt.kill(h)
        out = _np(rt.get(ref, timeout=10))
        # The task releases its GPU just after its result lands.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            freed = _gpu_key(rt.available_resources()).get("GPU")
            if freed:
                break
            time.sleep(0.01)
        return (len(ready), [r.hex() for r in rest], row["state"],
                row["pending_reason"], held, out.tolist(), freed)

    out = same(prog, gpus=1)
    assert out[0] == 0 and out[2] == "PENDING"
    assert out[3] == "waiting-for-capacity" and out[4] == 0.0
    np.testing.assert_array_equal(np.asarray(out[5], np.float32), base * 3)
    assert out[6] == 1.0


def test_init_counts_the_cards_torch_sees(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    ray_tpu_torch.init(num_cpus=2)
    assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0
    ray_tpu_torch.shutdown()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    ray_tpu_torch.init(num_cpus=2)
    assert "GPU" not in ray_tpu_torch.cluster_resources()


def test_cluster_mode_raises_naming_a6(monkeypatch):
    """Cluster mode is ported (A6): ``init(address=...)`` with no head
    there fails as the JAX package's does, and only the port's own
    ``RAY_TPU_TORCH_ADDRESS`` names an address."""
    errs = []
    for rt in PKGS:
        with pytest.raises(ConnectionError) as e:
            rt.init(address="tcp://127.0.0.1:1")
        errs.append((type(e.value).__name__, e.value.errno))
        assert not rt.is_initialized()
    assert errs[0] == errs[1]
    monkeypatch.setenv("RAY_TPU_TORCH_ADDRESS", "tcp://127.0.0.1:1")
    with pytest.raises(ConnectionError):
        ray_tpu_torch.init()
    assert not ray_tpu_torch.is_initialized()
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS")
    monkeypatch.setenv("RAY_TPU_ADDRESS", "tcp://127.0.0.1:1")
    ray_tpu_torch.init(num_cpus=1)  # the JAX package's variable is not read
    assert ray_tpu_torch.is_initialized()


def test_api_needs_init_and_refuses_a_second_one():
    for rt in PKGS:
        with pytest.raises(RuntimeError, match="init"):
            rt.put(1)
    _init(ray_tpu_torch)
    with pytest.raises(RuntimeError, match="twice"):
        _init(ray_tpu_torch)
    assert ray_tpu_torch.init(ignore_reinit_error=True) is not None


def test_shutdown_leaves_no_runtime_thread():
    def prog(rt):
        @rt.remote
        def f():
            return 1

        @rt.remote
        class A:
            def m(self):
                return 1

        a = A.remote()
        rt.get([f.remote() for _ in range(8)] + [a.m.remote()])
        pg = rt.placement_group([{"CPU": 1}])
        assert pg.wait(10)
        return 1

    for rt in PKGS:
        before = set(threading.enumerate())
        _init(rt)
        prog(rt)
        rt.shutdown()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            left = [t.name for t in threading.enumerate()
                    if t not in before
                    and t.name.startswith(_RUNTIME_THREADS)]
            if not left:
                break
            time.sleep(0.02)
        assert not left, (rt.__name__, left)


# ------------------------------------------- actor teardown (port only)


def test_kill_runs_the_instance_shutdown_hook():
    """The port calls ``__ray_shutdown__`` once when an actor dies or
    restarts, and at ``shutdown()``; the reference keeps the dead instance
    and never calls it."""
    calls = {rt: [] for rt in PKGS}

    def prog(rt):
        @rt.remote(max_restarts=1)
        class Holder:
            def __init__(self):
                self.tag = len(calls[rt])

            def ping(self):
                return self.tag

            def __ray_shutdown__(self):
                calls[rt].append(self.tag)

        h = Holder.remote()
        assert rt.get(h.ping.remote()) == 0
        rt.kill(h, no_restart=False)
        after_restart = list(calls[rt])
        rt.get(h.ping.remote(), timeout=10)
        rt.kill(h)
        rt.kill(h)
        after_kill = list(calls[rt])
        live = Holder.remote()
        rt.get(live.ping.remote())
        return after_restart, after_kill

    j, t = both(prog)
    assert j == ([], []) and calls[ray_tpu] == []
    assert t == ([0], [0, 1]) and calls[ray_tpu_torch] == [0, 1, 2]


def _tiny_lm():
    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2,
                            n_kv_heads=1, d_ff=32, max_seq_len=32,
                            dtype=torch.float32)
    return init_params(torch.Generator().manual_seed(0), cfg,
                       device="cpu"), cfg


def test_gpu_actor_frees_its_lm_backend_on_kill():
    """An actor hosting LMBackend serves as the backend does alone; kill()
    closes it: its pump thread ends and its engine is freed before the GPU
    goes back to the pool."""
    import gc
    import weakref

    from ray_tpu_torch.serve import LMBackend, ServeRequest

    params, cfg = _tiny_lm()
    reqs = [ServeRequest(([1, 2, 3],), {"max_new_tokens": 5}),
            ServeRequest(([4, 5],), {"max_new_tokens": 3})]
    direct = LMBackend(params, cfg, max_slots=2, device="cpu")
    want = direct(reqs)
    direct.close()
    with pytest.raises(ray_tpu_torch.exceptions.ReplicaUnavailableError):
        direct(reqs)

    before = set(threading.enumerate())
    _init(ray_tpu_torch, gpus=1)

    @ray_tpu_torch.remote(num_gpus=1)
    class Server:
        def __init__(self, p):
            self.backend = LMBackend(p, cfg, max_slots=2, device="cpu")

        def serve(self, batch):
            return self.backend(batch), weakref.ref(self.backend.engine)

        def __ray_shutdown__(self):
            self.backend.close()

    s = Server.remote(ray_tpu_torch.put(params))
    got, engine_ref = ray_tpu_torch.get(s.serve.remote(reqs))
    assert got == want
    assert any(t.name == "lm-engine-pump" for t in threading.enumerate())
    ray_tpu_torch.kill(s)
    gc.collect()
    assert engine_ref() is None
    assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    left = [t.name for t in threading.enumerate()
            if t not in before and t.name == "lm-engine-pump"]
    assert not left


# ------------------------------ tracing, flight recorder, loopmon, stats

from ray_tpu import metrics as jmetrics  # noqa: E402
from ray_tpu._private import flight_recorder as jfr  # noqa: E402
from ray_tpu._private import loopmon as jloop  # noqa: E402
from ray_tpu._private import tracing as jtrace  # noqa: E402
from ray_tpu_torch import metrics as tmetrics  # noqa: E402
from ray_tpu_torch._private import flight_recorder as tfr  # noqa: E402
from ray_tpu_torch._private import loopmon as tloop  # noqa: E402
from ray_tpu_torch._private import tracing as ttrace  # noqa: E402

_OBS = {ray_tpu: (jtrace, jfr, jloop, jmetrics),
        ray_tpu_torch: (ttrace, tfr, tloop, tmetrics)}
_PREFIX = {ray_tpu: "RAY_TPU_", ray_tpu_torch: "RAY_TPU_TORCH_"}


def _counted(metrics, name, tags=()):
    m = metrics.collect_all().get(name)
    return m["values"].get(str(dict(tags)), 0.0) if m else 0.0


@pytest.mark.parametrize("rate", ["0", "1", "64", "junk"])
def test_trace_sampling_gives_phase_lanes(monkeypatch, rate):
    """Every rate-th task (0: none; unparsable: 1 in 64) carries a trace:
    a worker_exec lane in timeline() and one trace_tasks_sampled count."""
    for rt in PKGS:
        monkeypatch.setenv(_PREFIX[rt] + "TRACE_SAMPLE", rate)
        monkeypatch.setattr(_OBS[rt][0], "_counter", itertools.count())

    def prog(rt):
        tracing, metrics = _OBS[rt][0], _OBS[rt][3]
        before = _counted(metrics, "trace_tasks_sampled")

        @rt.remote
        def f(i):
            return i

        assert rt.get([f.remote(i) for i in range(130)]) == list(range(130))
        lanes = [e for e in rt.timeline() if e["cat"] == "phase"]
        assert all(e["pid"] == "trace:" + e["args"]["trace"][:12]
                   for e in lanes)
        return (tracing.sample_rate(), len(lanes),
                sorted({e["name"] for e in lanes}),
                len({e["args"]["task_id"] for e in lanes}),
                _counted(metrics, "trace_tasks_sampled") - before)

    n = {"0": 0, "1": 130, "64": 3, "junk": 3}[rate]
    assert same(prog)[1:] == (n, ["worker_exec"] if n else [], n, float(n))


def test_each_package_reads_its_own_variables(monkeypatch):
    for var in ("TRACE_SAMPLE", "FLIGHT_RECORDER", "LOOPMON"):
        monkeypatch.setenv("RAY_TPU_" + var, "0")
        monkeypatch.delenv("RAY_TPU_TORCH_" + var, raising=False)
    assert (jtrace.sample_rate(), jfr.enabled(), jloop.enabled()) == \
        (0, False, False)
    assert (ttrace.sample_rate(), tfr.enabled(), tloop.enabled()) == \
        (64, True, True)
    # The loopmon kill switch also turns the recorder's CPU tagging off.
    monkeypatch.setenv("RAY_TPU_TORCH_LOOPMON", "0")
    assert [m.FlightRecorder("x")._tag_cpu for m in (jfr, tfr)] == \
        [False, False]


def test_thread_cpu_ns_reads_this_thread():
    tid = threading.get_native_id()
    j = jloop.thread_cpu_ns(tid)
    t = tloop.thread_cpu_ns(tid)
    assert isinstance(t, int) and 0 < j <= t
    assert jloop.thread_cpu_ns(-1) is tloop.thread_cpu_ns(-1) is None


def test_flight_recorder_rides_init_and_shutdown(monkeypatch):
    """init() starts one 'driver' sampler that folds running frames;
    drain() swaps its counts out; shutdown() stops it; the kill switch
    keeps it off."""
    for rt in PKGS:
        monkeypatch.setenv(_PREFIX[rt] + "FLIGHT_RECORDER_HZ", "200")

    def prog(rt):
        fr, metrics = _OBS[rt][1], _OBS[rt][3]
        rec = fr.get()
        stop = threading.Event()

        def busy_named_frame():
            while not stop.is_set():
                sum(range(500))

        t = threading.Thread(target=busy_named_frame)
        t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not any(
                "busy_named_frame" in s for s in rec.snapshot()):
            time.sleep(0.02)
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive()
        stack = next(s for s in rec.drain() if "busy_named_frame" in s)
        return (rec.component, rec.running, rec.hz,
                [x.name for x in threading.enumerate()].count(
                    "flight-recorder"),
                stack.rsplit(";", 1)[-1].split(":")[-1],
                any("busy_named_frame" in s for s in rec.snapshot()),
                _counted(metrics, "flight_recorder_starts",
                         (("component", "driver"),)) > 0)

    assert same(prog) == ("driver", True, 200.0, 1, "busy_named_frame",
                          False, True)
    for rt in PKGS:
        fr = _OBS[rt][1]
        assert fr.get() is None
        assert "flight-recorder" not in [x.name
                                         for x in threading.enumerate()]
        monkeypatch.setenv(_PREFIX[rt] + "FLIGHT_RECORDER", "0")
        _init(rt)
        assert fr.get() is None
        rt.shutdown()


def test_flight_recorder_holds_no_frame_through_its_clock_reads(
        monkeypatch):
    """The port's sampler drops its frame snapshot before the per-thread
    clock reads, which give up the GIL: an object that a sampled function
    held is freed once the function returns, while the sample still runs.
    (A held frame kept a returned stream job's CUDA sums alive past its
    shutdown.) The stack it folds is the same."""
    import weakref

    class Held:
        pass

    entered, leave, left, done = (threading.Event() for _ in range(4))
    refs = []

    def holding_frame():
        held = Held()
        refs.append(weakref.ref(held))
        entered.set()
        leave.wait(10)

    def body():
        holding_frame()
        left.set()
        done.wait(10)

    freed_during_reads = []

    def clock_read(tid):
        if not leave.is_set():
            leave.set()
            assert left.wait(10)
            freed_during_reads.append(refs[0]() is None)
        return None

    monkeypatch.setattr(tfr, "_thread_cpu_ns", clock_read)
    rec = tfr.FlightRecorder("driver", hz=1.0)
    rec._tag_cpu = True
    t = threading.Thread(target=body, name="held-frame")
    t.start()
    try:
        assert entered.wait(10)
        rec._sample_once(threading.get_ident())
    finally:
        leave.set()
        done.set()
        t.join(timeout=10)
    assert freed_during_reads == [True]
    assert any(":holding_frame;" in s for s in rec.drain())


def test_node_stats_and_metric_exposition():
    """state.node_stats() gives the same keys and kinds as the reference's,
    and the two metric registries render the same Prometheus text and
    histogram cells for the same records."""
    import os

    def prog(rt):
        rt.state.node_stats()
        sums = [sum(range(2000)) for _ in range(200)]
        st = rt.state.node_stats()["local"]
        assert 0 < st["mem_available_bytes"] <= st["mem_total_bytes"]
        assert 0 <= st["cpu_percent"] <= 100 and sums
        w, = st["workers"]
        assert w["pid"] == os.getpid() and w["rss_bytes"] > 0
        m = _OBS[rt][3]
        c = m.get_or_create(m.Count, "twin_count", tag_keys=("k",))
        g = m.get_or_create(m.Gauge, "twin_gauge")
        h = m.get_or_create(m.Histogram, "twin_hist", tag_keys=("p",),
                            boundaries=[1, 10])
        c.record(2.0, tags={"k": "a"})
        g.record(0.5)
        for v in (0.5, 5.0, 50.0):
            h.record(v, tags={"p": "x"})
        text = [ln for ln in m.render_prometheus().splitlines()
                if "twin_" in ln]
        return (sorted(rt.state.node_stats()), sorted(st),
                {k: type(v).__name__ for k, v in st.items()}, sorted(w),
                text, m.histogram_cells("twin_hist"))

    same(prog)
