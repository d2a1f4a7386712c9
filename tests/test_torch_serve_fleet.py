"""The port's self-healing serve fleet against the JAX package's, on the CPU:
twins of tests/test_serve_fleet.py's nine fast tests (failover with retry
budgets, stream fast-fail and purge, replacement of an unhealthy replica,
drain on scale-down, a replica killed mid-traffic, the fleet's metrics),
each program run through ``ray_tpu.serve`` then ``ray_tpu_torch.serve`` in
one process, with what the reference's tests read held equal. The
reference's chaos soak (``scripts/serve_soak.py``, slow) is not twinned.

Then the port's one deviation, C8: ``ReplicaActor.__ray_shutdown__``
forwards the runtime's teardown hook to the user callable, so each killed
replica (scale-down, ``delete_backend``, replacement, ``serve.shutdown()``)
calls its backend's hook exactly once, and a retired ``LMBackend`` replica
leaves no pump thread; the reference calls no hook."""

import gc
import threading
import time
import weakref

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import metrics as jmetrics
from ray_tpu import serve as jserve
from ray_tpu.serve import master as jmaster
from ray_tpu.serve import router as jrouter
from ray_tpu_torch import metrics as tmetrics
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import master as tmaster
from ray_tpu_torch.serve import router as trouter

PKGS = (ray_tpu, ray_tpu_torch)
SERVE = {ray_tpu: jserve, ray_tpu_torch: tserve}
MASTER = {ray_tpu: jmaster, ray_tpu_torch: tmaster}
METRICS = {ray_tpu: jmetrics, ray_tpu_torch: tmetrics}
PREFIX = {ray_tpu: "RAY_TPU_", ray_tpu_torch: "RAY_TPU_TORCH_"}


@pytest.fixture(scope="module", autouse=True)
def _light():
    """One intra-op thread for torch, and a short reconcile period for
    both masters."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for prefix in PREFIX.values():
            mp.setenv(prefix + "SERVE_RECONCILE_PERIOD_S", "0.05")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in PKGS:
        SERVE[rt].shutdown()
        rt.shutdown()


def both(program):
    outs = []
    for rt in PKGS:
        rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
        sv = SERVE[rt]
        try:
            sv.init()
            outs.append(program(rt, sv, rt.get_actor(
                MASTER[rt].MASTER_NAME)))
        finally:
            sv.shutdown()
            rt.shutdown()
    return outs


def same(program):
    j, t = both(program)
    assert j == t
    return t


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _first_probes_done(rt, master, n):
    """Wait for the reconcile pass that probes a new backend's ``n``
    replicas at once; with ``health_check_period_s=60`` the next is a
    minute away, so a replica killed after it stays down."""
    assert _wait_for(lambda: rt.get(master.stat.remote())[
        "fleet_counters"]["probes"] >= n)


def _up(rt, master, tag):
    return rt.get(master.stat.remote())["backends"][tag]["up"]


class TickStream:
    """A streaming backend (the stream_start/poll/cancel contract of
    LMBackend) whose stream gives 1, 2, ... one token a poll."""

    def __init__(self):
        self._streams = {}

    def stream_start(self, total=1000):
        token = f"t{len(self._streams) + 1}"
        self._streams[token] = [0, int(total)]
        return token

    def stream_poll(self, token, wait_s=2.0):
        st = self._streams.get(token)
        if st is None:
            return {"tokens": [], "done": True}
        st[0] += 1
        done = st[0] >= st[1]
        if done:
            del self._streams[token]
        return {"tokens": [st[0]], "done": done}

    def stream_cancel(self, token):
        return self._streams.pop(token, None) is not None


# ------------------------------------------ twins of test_serve_fleet.py


def test_pick_backend_zero_weights():
    for mod, sv in ((jrouter, jserve), (trouter, tserve)):
        r = mod.Router.__new__(mod.Router)
        with pytest.raises(sv.ReplicaUnavailableError, match="traffic weight"):
            r._pick_backend({"a": 0.0, "b": 0.0})
        assert r._pick_backend({"a": 0.0, "b": 1.0}) == "b"


def test_failover_marks_down_and_retries():
    def prog(rt, sv, master):
        sv.create_backend("fo:v1", lambda x: x, config=sv.BackendConfig(
            num_replicas=2, health_check_period_s=60.0))
        sv.create_endpoint("fo", backend="fo:v1")
        h = sv.get_handle("fo")
        first = rt.get(h.remote(0))
        _first_probes_done(rt, master, 2)
        victim = rt.get(master.get_replicas.remote("fo:v1"))[0]
        rt.kill(victim)
        outs = rt.get([h.remote(i) for i in range(40)])
        stats = rt.get(master.stat.remote())
        return (first, outs, stats["counters"]["replicas_down"],
                stats["counters"]["failovers"] >= 1,
                stats["backends"]["fo:v1"])

    first, outs, down, failed_over, backend = same(prog)
    assert first == 0 and outs == list(range(40)) and down == 1
    assert failed_over and backend["up"] == 1 and backend["down"] == 1


def test_retry_budget_exhaustion(monkeypatch):
    """Each package reads its own retry knob: each run sets only its
    package's ``<prefix>SERVE_RETRY_MAX_ATTEMPTS``."""
    def prog(rt, sv, master):
        sv.create_backend("rb:v1", lambda x: x, config=sv.BackendConfig(
            num_replicas=2, health_check_period_s=60.0))
        sv.create_endpoint("rb", backend="rb:v1")
        h = sv.get_handle("rb")
        first = rt.get(h.remote(1))
        _first_probes_done(rt, master, 2)
        for rep in rt.get(master.get_replicas.remote("rb:v1")):
            rt.kill(rep)
        errs = []
        t0 = time.monotonic()
        for x in (2, 3):
            try:
                rt.get(h.remote(x))
            except sv.ReplicaUnavailableError as e:
                errs.append(str(e))
        return first, errs, time.monotonic() - t0 < 10.0

    outs = []
    for rt in PKGS:
        with monkeypatch.context() as mp:
            for prefix in PREFIX.values():
                mp.delenv(prefix + "SERVE_RETRY_MAX_ATTEMPTS", raising=False)
            mp.setenv(PREFIX[rt] + "SERVE_RETRY_MAX_ATTEMPTS", "2")
            rt.init(num_cpus=8)
            sv = SERVE[rt]
            try:
                sv.init()
                outs.append(prog(rt, sv, rt.get_actor(
                    MASTER[rt].MASTER_NAME)))
            finally:
                sv.shutdown()
                rt.shutdown()
    assert outs[0] == outs[1]
    first, errs, fast = outs[1]
    assert first == 1 and fast and len(errs) == 2
    assert "failed on 2 replica(s)" in errs[0] and "max_attempts=2" in errs[0]
    assert "no live replica" in errs[1]


def test_stream_fast_fail_on_replica_death():
    def prog(rt, sv, master):
        sv.create_backend("sf:v1", TickStream, config=sv.BackendConfig(
            num_replicas=1, replica_concurrency=4,
            health_check_period_s=60.0))
        sv.create_endpoint("sf", backend="sf:v1")
        h = sv.get_handle("sf")
        _first_probes_done(rt, master, 1)
        got, t_kill, raised = [], None, None
        try:
            for tok in h.stream(total=1000):
                got.append(tok)
                if len(got) == 3:
                    rt.kill(rt.get(master.get_replicas.remote("sf:v1"))[0])
                    t_kill = time.monotonic()
        except sv.ReplicaUnavailableError as e:
            raised = type(e).__name__
        stats = rt.get(master.stat.remote())
        return (got, raised, time.monotonic() - t_kill < 10.0,
                stats["counters"]["stream_failfast"], stats["streams"])

    got, raised, fast, failfast, live = same(prog)
    assert got == [1, 2, 3] and raised == "ReplicaUnavailableError"
    assert fast and failfast == 1 and live == 0


def test_stream_purged_on_backend_delete():
    def prog(rt, sv, master):
        sv.create_backend("sp:v1", TickStream, config=sv.BackendConfig(
            num_replicas=1, replica_concurrency=4,
            health_check_period_s=60.0))
        sv.create_endpoint("sp", backend="sp:v1")
        gen = sv.get_handle("sp").stream(total=1000)
        first = next(gen)
        sv.delete_endpoint("sp")
        sv.delete_backend("sp:v1")
        try:
            for _ in gen:
                pass
        except sv.ReplicaUnavailableError as e:
            return first, str(e)

    first, err = same(prog)
    assert first == 1 and "deleted" in err


def test_unhealthy_backend_replaced():
    def prog(rt, sv, master):
        class Flaky:
            def __init__(self):
                self.healthy = True

            def __call__(self, x):
                return x

            def poison(self):
                self.healthy = False
                return "poisoned"

            def check_health(self):
                return {"healthy": self.healthy, "reason": "poisoned"}

        sv.create_backend("uh:v1", Flaky, config=sv.BackendConfig(
            num_replicas=1, health_check_period_s=0.05,
            health_check_timeout_s=2.0, health_check_failures=2))
        sv.create_endpoint("uh", backend="uh:v1")
        h = sv.get_handle("uh")
        first = rt.get(h.remote(1))
        old = rt.get(master.get_replicas.remote("uh:v1"))[0]
        poisoned = rt.get(h.options(method="poison").remote())

        def replaced():
            reps = rt.get(master.get_replicas.remote("uh:v1"))
            return bool(reps) and reps[0] != old
        swapped = _wait_for(replaced, timeout=15.0)
        healed = _wait_for(lambda: _up(rt, master, "uh:v1") == 1, 15.0)
        stats = rt.get(master.stat.remote())
        return (first, poisoned, swapped, healed,
                stats["fleet_counters"]["replicas_replaced"],
                rt.get(h.remote(2)))

    assert same(prog) == (1, "poisoned", True, True, 1, 2)


def test_scale_down_drains_inflight():
    """In-flight calls on the retiring replicas finish before they exit:
    the calls block on an event that the test sets only once the master
    has marked two replicas draining (each replica keeps one slot free
    for the master's own calls)."""
    def prog(rt, sv, master):
        release = threading.Event()

        class Slow:
            def __call__(self, x):
                release.wait(30)
                return x

        sv.create_backend("dr:v1", Slow, config=sv.BackendConfig(
            num_replicas=3, max_concurrent_queries=3,
            replica_concurrency=4, health_check_period_s=60.0,
            drain_timeout_s=30.0))
        sv.create_endpoint("dr", backend="dr:v1")
        h = sv.get_handle("dr")
        refs = [h.remote(i) for i in range(9)]
        busy = _wait_for(lambda: rt.get(master.stat.remote())[
            "backends"]["dr:v1"]["inflight"] == 9)
        # The master answers nothing while it drains: ask it first.
        router = rt.get(master.get_router.remote())[0]
        scaler = threading.Thread(
            target=sv.update_backend_config, args=("dr:v1",
                                                   {"num_replicas": 1}))
        scaler.start()
        draining = _wait_for(lambda: rt.get(router.stats.remote())[
            "backends"]["dr:v1"]["draining"] == 2)
        release.set()
        scaler.join(30)
        return (busy, draining, scaler.is_alive(), sorted(rt.get(refs)),
                len(rt.get(master.get_replicas.remote("dr:v1"))))

    assert same(prog) == (True, True, False, list(range(9)), 1)


def test_kill_replica_mid_traffic_e2e():
    def prog(rt, sv, master):
        probe_s = 0.3
        sv.create_backend("e2e:v1", lambda x: x, config=sv.BackendConfig(
            num_replicas=3, health_check_period_s=probe_s,
            health_check_timeout_s=2.0, health_check_failures=1))
        sv.create_endpoint("e2e", backend="e2e:v1")
        h = sv.get_handle("e2e")
        failures, sent, t_killed = [], 0, None
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            try:
                assert rt.get(h.remote(sent), timeout=30.0) == sent
                sent += 1
            except Exception as e:  # noqa: BLE001 - failures are the subject
                failures.append(e)
            if t_killed is None and sent >= 20:
                rt.kill(rt.get(master.get_replicas.remote("e2e:v1"))[0])
                t_killed = time.monotonic()
            if t_killed is not None:
                s = rt.get(master.stat.remote())
                if (s["fleet_counters"]["replicas_replaced"] >= 1
                        and s["backends"]["e2e:v1"]["up"] == 3):
                    break
        heal_s = time.monotonic() - t_killed
        stats = rt.get(master.stat.remote())
        return (failures, sent > 20,
                stats["fleet_counters"]["replicas_replaced"] >= 1,
                stats["backends"]["e2e:v1"]["up"], heal_s < probe_s + 8.0)

    assert same(prog) == ([], True, True, 3, True)


def test_fleet_metrics_and_cli_surface():
    def prog(rt, sv, master):
        sv.create_backend("fm:v1", lambda x: x, config=sv.BackendConfig(
            num_replicas=1, health_check_period_s=0.2))
        sv.create_endpoint("fm", backend="fm:v1")
        h = sv.get_handle("fm")
        rt.get([h.remote(i) for i in range(10)])
        metrics = METRICS[rt]

        def exported():
            values = metrics.collect_all().get(
                "serve_replicas", {}).get("values", {})
            return any("fm:v1" in tags and "'up'" in tags and v == 1
                       for tags, v in values.items())

        seen = _wait_for(exported)
        text = metrics.render_prometheus()
        series = sorted({ln.split()[2] for ln in text.splitlines()
                         if ln.startswith("# TYPE serve_")})
        p99 = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
               if ln.startswith('serve_route_latency_p99_ms{endpoint="fm"}')]
        return seen, series, p99

    seen, series, p99 = same(prog)
    assert seen and p99 == ['serve_route_latency_p99_ms{endpoint="fm"}']
    assert {"serve_route_latency_p99_ms", "serve_replicas"} <= set(series)


# ------------------------------------------- C8: a killed replica's hook


class Counted:
    """A class backend that records each call of its teardown hook under
    its package, by the order in which replicas were built."""

    built = {}
    closed = {}

    def __init__(self, pkg):
        self.pkg = pkg
        self.n = len(Counted.built.setdefault(pkg, []))
        Counted.built[pkg].append(self.n)
        self.healthy = True

    def __call__(self, x):
        return x

    def poison(self):
        self.healthy = False
        return self.n

    def check_health(self):
        return {"healthy": self.healthy, "reason": "poisoned"}

    def __ray_shutdown__(self):
        Counted.closed.setdefault(self.pkg, []).append(self.n)


def test_each_killed_replica_runs_its_backends_hook_once():
    """Scale-down, delete_backend, replacement after an unhealthy probe and
    serve.shutdown() each kill replicas; the port runs each killed
    replica's backend hook exactly once, the reference never."""
    Counted.built.clear()
    Counted.closed.clear()

    def prog(rt, sv, master):
        pkg = rt.__name__
        closed = lambda: list(Counted.closed.get(pkg, []))  # noqa: E731
        cfg = dict(health_check_period_s=60.0)
        sv.create_backend("sd", Counted, pkg, config=sv.BackendConfig(
            num_replicas=2, **cfg))                         # replicas 0, 1
        sv.update_backend_config("sd", {"num_replicas": 1})
        after_scale = closed()
        sv.create_backend("del", Counted, pkg, config=sv.BackendConfig(
            **cfg))                                         # replica 2
        sv.delete_backend("del")
        after_delete = closed()
        sv.create_backend("uh", Counted, pkg, config=sv.BackendConfig(
            health_check_period_s=0.05, health_check_failures=1))  # 3
        sv.create_endpoint("uh", backend="uh")
        h = sv.get_handle("uh")
        poisoned = rt.get(h.options(method="poison").remote())
        assert _wait_for(lambda: rt.get(master.stat.remote())[
            "fleet_counters"]["replicas_replaced"] == 1)   # replica 4
        after_replace = closed()
        sv.shutdown()
        after_shutdown = closed()
        rt.shutdown()
        return (poisoned, after_scale, after_delete, after_replace,
                after_shutdown, closed(), list(Counted.built[pkg]))

    j, t = both(prog)
    assert j == (3, [], [], [], [], [], [0, 1, 2, 3, 4])
    assert t == (3, [1], [1, 2], [1, 2, 3], [1, 2, 3, 0, 4],
                 [1, 2, 3, 0, 4], [0, 1, 2, 3, 4])


def test_a_call_under_way_at_kill_is_answered_then_the_hook_runs():
    """A kill does not stop a call already running on the replica, in
    either package, and the call gets its answer; the port runs the
    backend's hook as that call ends, the reference never."""
    def prog(rt, sv, master):
        started, release = threading.Event(), threading.Event()
        closed = []

        class Busy:
            def __call__(self, x):
                started.set()
                release.wait(10)
                return x

            def __ray_shutdown__(self):
                closed.append(len(closed))

        sv.create_backend("busy", Busy, config=sv.BackendConfig(
            health_check_period_s=60.0, replica_concurrency=2))
        sv.create_endpoint("busy", backend="busy")
        ref = sv.get_handle("busy").remote(7)
        assert started.wait(10)
        rt.kill(rt.get(master.get_replicas.remote("busy"))[0])
        at_kill = list(closed)
        release.set()
        return at_kill, rt.get(ref, timeout=10), list(closed)

    j, t = both(prog)
    assert j == ([], 7, []) and t == ([], 7, [0])


def _tiny_lm():
    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2,
                            n_kv_heads=1, d_ff=32, max_seq_len=32,
                            dtype=torch.float32)
    return init_params(torch.Generator().manual_seed(0), cfg,
                       device="cpu"), cfg


def test_retired_lm_replica_leaves_no_pump_thread():
    """The port alone: an LMBackend replica retired by scale-down closes
    its backend, so its engine is freed and its pump thread ends; its
    sibling keeps serving the same tokens."""
    params, cfg = _tiny_lm()
    before = set(threading.enumerate())
    ray_tpu_torch.init(num_cpus=8)
    tserve.init()
    engines = []

    class Probed(tserve.LMBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(weakref.ref(self.engine))

    tserve.create_backend("lm", Probed, params, cfg, max_slots=2,
                          device="cpu", config=tserve.BackendConfig(
                              num_replicas=2, health_check_period_s=60.0))
    tserve.create_endpoint("lm", backend="lm")
    h = tserve.get_handle("lm")
    outs = ray_tpu_torch.get([h.remote([1, 2, 3], max_new_tokens=4)
                              for _ in range(4)])

    def pumps():
        return [t for t in threading.enumerate()
                if t not in before and t.name == "lm-engine-pump"]

    assert len(pumps()) == 2 and len(engines) == 2
    tserve.update_backend_config("lm", {"num_replicas": 1})
    assert _wait_for(lambda: len(pumps()) == 1, timeout=10)
    gc.collect()
    # The two replicas are built at once, in either order.
    assert sorted(e() is None for e in engines) == [False, True]
    assert ray_tpu_torch.get(h.remote([1, 2, 3], max_new_tokens=4)) == outs[0]
    tserve.update_backend_config("lm", {"num_replicas": 0})
    assert _wait_for(lambda: not pumps(), timeout=10)
    gc.collect()
    assert all(e() is None for e in engines)


def test_killed_lm_replica_answers_its_batch_then_closes():
    """The port alone: an LMBackend replica killed while a batch waits in
    it answers the batch with the tokens a live replica gives, then closes
    its backend: no pump thread is left."""
    params, cfg = _tiny_lm()
    before = set(threading.enumerate())
    ray_tpu_torch.init(num_cpus=8)
    tserve.init()
    entered, release = threading.Event(), threading.Event()

    class Held(tserve.LMBackend):
        @tserve.accept_batch
        def __call__(self, requests):
            entered.set()
            release.wait(10)
            return super().__call__(requests)

    tserve.create_backend("lm", Held, params, cfg, max_slots=4,
                          device="cpu", config=tserve.BackendConfig(
                              max_batch_size=4, batch_wait_timeout_s=0.5,
                              health_check_period_s=60.0))
    tserve.create_endpoint("lm", backend="lm")
    h = tserve.get_handle("lm")
    prompts = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]]
    release.set()
    want = ray_tpu_torch.get([h.remote(p, max_new_tokens=5)
                              for p in prompts])
    release.clear()
    entered.clear()
    refs = [h.remote(p, max_new_tokens=5) for p in prompts]
    assert entered.wait(10)
    master = ray_tpu_torch.get_actor(tmaster.MASTER_NAME)
    ray_tpu_torch.kill(ray_tpu_torch.get(
        master.get_replicas.remote("lm"))[0])
    release.set()
    assert ray_tpu_torch.get(refs, timeout=30) == want
    assert _wait_for(lambda: not [
        t for t in threading.enumerate()
        if t not in before and t.name == "lm-engine-pump"])


def test_a_probe_under_way_at_shutdown_builds_no_replica():
    """A reconcile pass whose probe is still out when serve.shutdown() runs
    finds the registry cleared when the probe comes back unhealthy, and
    builds no replacement (that replica would outlive its master); its
    thread then ends. The wait is for the reconcile threads this test's
    serves started: under xdist's --dist loadfile a worker runs other files
    in the same process, whose masters' threads (a crashed and restarted
    master's, in test_observability.py) can still be winding down."""
    stale = {t for t in threading.enumerate() if t.name == "serve-reconcile"}

    def prog(rt, sv, master):
        probing, release = threading.Event(), threading.Event()
        built = []

        class Stuck:
            def __init__(self):
                built.append(1)

            def __call__(self, x):
                return x

            def check_health(self):
                probing.set()
                release.wait(10)
                return {"healthy": False, "reason": "stuck"}

        sv.create_backend("st", Stuck, config=sv.BackendConfig(
            health_check_period_s=0.05, health_check_timeout_s=10.0,
            health_check_failures=1))
        assert probing.wait(10)
        sv.shutdown()
        release.set()

        def reconciler():
            return [t for t in threading.enumerate()
                    if t.name == "serve-reconcile" and t not in stale]
        gone = _wait_for(lambda: not reconciler(), timeout=10)
        return len(built), gone

    assert same(prog) == (1, True)

