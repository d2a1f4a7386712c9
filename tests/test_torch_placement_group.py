"""The port's placement groups against the JAX package's, on the CPU: twins
of the local cases of tests/test_placement_group.py (resource translation,
validation, create / wait / use / remove, infeasible and waiting gangs,
pending tasks failed by removal), each program run through ``ray_tpu`` and
then ``ray_tpu_torch`` in one process, with values, resources, the
placement-group tables (the group ids aside: they are random) and error
types held equal. The port's bundles name ``GPU`` where JAX's name
``TPU``."""

import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import resources as jres
from ray_tpu_torch._private import resources as tres

PKGS = (ray_tpu, ray_tpu_torch)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in PKGS:
        rt.shutdown()


def _accel(rt):
    return "TPU" if rt is ray_tpu else "GPU"


def _gpu_key(d):
    names = {"TPU": "GPU", "tpu_memory": "gpu_memory"}
    out = {}
    for k, v in d.items():
        base, _, rest = k.partition("_group_")
        k = names.get(base, base) + ("_group_" + rest if rest else "")
        out[k] = v
    return out


def _no_pg(d, pg):
    """A resource dict with the group's id written as PG, so two runs
    compare."""
    return {k.replace(pg.hex, "PG"): v for k, v in _gpu_key(d).items()}


def _table_row(rt, pg):
    row = dict(rt.placement_group_table(pg)[pg.hex])
    row["bundles"] = [_gpu_key(b) for b in row["bundles"]]
    row["nodes"] = len(row["nodes"])
    return row


def same(program, gpus=0):
    outs = []
    for rt in PKGS:
        accel = "num_tpus" if rt is ray_tpu else "num_gpus"
        rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024,
                **{accel: gpus})
        try:
            outs.append(program(rt))
        finally:
            rt.shutdown()
    assert outs[0] == outs[1]
    return outs[1]


# ---------------------------------------------------------------- unit layer


@pytest.mark.parametrize("args", [
    ("CPU", "ab12", 3), ("CPU", "ab12"), ("memory", "ff00", 0)])
def test_resource_names_round_trip(args):
    name = tres.pg_resource_name(*args)
    assert name == jres.pg_resource_name(*args)
    assert tres.parse_pg_resource(name) == jres.parse_pg_resource(name)
    assert tres.parse_pg_resource("gpu_memory") is None


@pytest.mark.parametrize("index", [1, -1])
def test_translate_bundle_and_wildcard(index):
    t = tres.translate_pg_demand({"CPU": 2.0, "GPU": 4.0}, "ff00", index)
    j = jres.translate_pg_demand({"CPU": 2.0, "TPU": 4.0}, "ff00", index)
    assert t == _gpu_key(j)
    assert tres.translate_pg_demand({}, "ff00", -1) == \
        jres.translate_pg_demand({}, "ff00", -1) == {"bundle_group_ff00": 0.001}


def test_bundle_grants_sum_wildcards():
    t = tres.pg_bundle_grants([{"CPU": 2.0, "GPU": 1.0}, {"CPU": 1.0}],
                              "ee00")
    j = jres.pg_bundle_grants([{"CPU": 2.0, "TPU": 1.0}, {"CPU": 1.0}],
                              "ee00")
    assert t == [_gpu_key(g) for g in j]
    assert t[0]["CPU_group_ee00"] == 2.0 and t[1]["CPU_group_ee00"] == 1.0
    assert t[0]["bundle_group_0_ee00"] == 1000.0


@pytest.mark.parametrize("bundles,strategy", [
    ([], "PACK"), ([{"CPU": 1}], "NOPE"), ([{}], "PACK"),
    ([{"CPU": -1}], "PACK"), ([{"CPU": 0}], "PACK")])
def test_validation(bundles, strategy):
    def prog(rt):
        with pytest.raises(ValueError) as info:
            rt.placement_group(bundles, strategy=strategy)
        return str(info.value)

    same(prog)


# ----------------------------------------------------------- local-mode E2E


def test_lifecycle_create_use_remove():
    def prog(rt):
        before = rt.available_resources()
        pg = rt.placement_group([{"CPU": 2}, {"CPU": 1}], strategy="PACK",
                                name="train")
        assert pg.wait(10)
        created = _table_row(rt, pg)
        during = _no_pg(rt.available_resources(), pg)

        @rt.remote
        def f(x):
            return x + 1

        a = rt.get(f.options(placement_group=pg,
                             placement_group_bundle_index=0).remote(41),
                   timeout=30)
        b = rt.get(f.options(placement_group=pg).remote(1), timeout=30)
        rt.remove_placement_group(pg)
        deadline = time.monotonic() + 10  # the tasks release just after
        while time.monotonic() < deadline:
            after = rt.available_resources()
            if after == before:
                break
            time.sleep(0.01)
        return (created, during, a, b, after == before,
                _table_row(rt, pg)["state"], pg.bundle_count, pg.strategy)

    out = same(prog)
    assert out[0]["state"] == "CREATED" and out[0]["name"] == "train"
    assert out[1]["CPU"] == 5.0 and out[1]["CPU_group_0_PG"] == 2.0
    assert out[1]["CPU_group_PG"] == 3.0
    assert out[2:] == (42, 2, True, "REMOVED", 2, "PACK")


def test_ready_resolves_after_creation():
    def prog(rt):
        pg = rt.placement_group([{"CPU": 1}])
        got = rt.get(pg.ready(), timeout=30) == pg.hex
        rt.remove_placement_group(pg)
        return got

    assert same(prog)


def test_actor_in_bundle():
    def prog(rt):
        pg = rt.placement_group([{"CPU": 1}])

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        c = Counter.options(placement_group=pg,
                            placement_group_bundle_index=0,
                            num_cpus=1).remote()
        got = rt.get(c.incr.remote(), timeout=30)
        held = _no_pg(rt.available_resources(), pg)
        rt.kill(c)
        rt.remove_placement_group(pg)
        return got, held

    got, held = same(prog)
    assert got == 1 and held.get("CPU_group_0_PG", 0.0) == 0.0


def test_accelerator_bundle_holds_the_device():
    """A {GPU: 1, CPU: 1} bundle (JAX's {TPU: 1, CPU: 1}) takes the one
    declared device while it lives, an actor in it uses the bundle's, and
    removal gives the device back."""
    def prog(rt):
        acc = _accel(rt)
        pg = rt.placement_group([{acc: 1, "CPU": 1}])
        assert pg.wait(10)
        held = _no_pg(rt.available_resources(), pg)

        @rt.remote
        class Worker:
            def run(self, x):
                return x * 2

        w = Worker.options(placement_group=pg, placement_group_bundle_index=0,
                           num_cpus=1, resources={acc: 1}).remote()
        got = rt.get(w.run.remote(21), timeout=30)
        inside = _no_pg(rt.available_resources(), pg)
        rt.kill(w)
        rt.remove_placement_group(pg)
        return held, got, inside, _gpu_key(rt.available_resources())

    held, got, inside, after = same(prog, gpus=1)
    assert "GPU" not in held and held["GPU_group_0_PG"] == 1.0
    assert got == 42 and inside.get("GPU_group_0_PG", 0.0) == 0.0
    assert after["GPU"] == 1.0


@pytest.mark.parametrize("bundles,strategy", [
    ([{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD"),
    ([{"CPU": 64}, {"CPU": 64}], "PACK")])
def test_infeasible_gang_is_reported(bundles, strategy):
    def prog(rt):
        pg = rt.placement_group(bundles, strategy=strategy)
        assert not pg.wait(0.2)
        return _table_row(rt, pg)

    row = same(prog)
    assert row["state"] == "PENDING" and row["reason"] == "infeasible"


def test_gang_waits_for_capacity_then_creates():
    def prog(rt):
        release = threading.Event()
        started = threading.Event()

        @rt.remote(num_cpus=8)
        def hog():
            started.set()
            release.wait(30)
            return "done"

        ref = hog.remote()
        assert started.wait(10)
        pg = rt.placement_group([{"CPU": 4}, {"CPU": 4}])
        waited = pg.wait(0.2)
        row = _table_row(rt, pg)
        release.set()
        out = rt.get(ref, timeout=30)
        created = pg.wait(10)
        rt.remove_placement_group(pg)
        return waited, row["reason"], out, created

    assert same(prog) == (False, "waiting-for-capacity", "done", True)


def test_removed_group_fails_pending_tasks():
    def prog(rt):
        pg = rt.placement_group([{"CPU": 1}])
        assert pg.wait(10)

        @rt.remote
        def f():
            return 1

        stuck = f.options(placement_group=pg, placement_group_bundle_index=0,
                          num_cpus=8).remote()
        rt.remove_placement_group(pg)
        with pytest.raises(rt.PlacementGroupError) as info:
            rt.get(stuck, timeout=10)
        return stuck.hex(), str(info.value).replace(pg.hex[:12], "PG")

    same(prog)


def test_bundle_index_out_of_range_and_table_filters():
    def prog(rt):
        pg = rt.placement_group([{"CPU": 1}], name="one")
        assert pg.wait(10)

        @rt.remote
        def f():
            return 1

        with pytest.raises(ValueError) as info:
            f.options(placement_group=pg, placement_group_bundle_index=1)\
                .remote()
        table = rt.placement_group_table()
        rows = [_table_row(rt, pg)]
        rt.remove_placement_group(pg)
        return str(info.value), len(table), rows, pg == pg, repr(pg)[:15]

    out = same(prog)
    assert out[1] == 1 and out[2][0]["name"] == "one"
