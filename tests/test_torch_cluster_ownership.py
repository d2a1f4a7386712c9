"""The port's ownership object plane against the JAX package's, on the CPU:
twins of every test of tests/test_ownership.py. The unit half (owner ring,
owner table, the owner server's wire handlers) runs the same seeded inputs
through both packages' modules and holds their answers equal; the cluster
half runs each program through a ``ray_tpu`` and a ``ray_tpu_torch`` driver
on one cluster of each package (the port's GCS on ``device="cpu"``). The
two drills the reference marks slow (a second driver's tenancy, an owner
killed mid-batch) run both packages side by side."""

import importlib
import random
import signal
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import ownership as jown
from ray_tpu.cluster import wire as jwire
from ray_tpu.cluster.protocol import RpcClient as JClient
from ray_tpu.cluster.testing import Cluster as JCluster
from ray_tpu_torch.cluster import ownership as town
from ray_tpu_torch.cluster import wire as twire
from ray_tpu_torch.cluster.protocol import RpcClient as TClient
from ray_tpu_torch.cluster.testing import Cluster as TCluster

pytestmark = pytest.mark.cluster

PKGS = (ray_tpu, ray_tpu_torch)


def _keys(n, seed):
    rng = random.Random(seed)
    return [bytes(rng.getrandbits(8) for _ in range(4)) for _ in range(n)]


def _oid(i, job=b"JOB0"):
    return i.to_bytes(12, "little") + job + b"\0" * 8


def same_units(program):
    j, t = program(jown), program(town)
    assert j == t
    return t


# ------------------------------------------------------------------ OwnerRing


class TestOwnerRing:
    def test_lookup_stable_and_in_range(self):
        def prog(own):
            ring = own.OwnerRing(shards=8)
            keys = _keys(500, 1)
            first = [ring.lookup(k) for k in keys]
            return first, first == [ring.lookup(k) for k in keys]

        first, stable = same_units(prog)
        assert stable and all(0 <= s < 8 for s in first)

    def test_all_shards_reachable(self):
        def prog(own):
            ring = own.OwnerRing(shards=8)
            return {ring.lookup(k) for k in _keys(2000, 2)}

        assert same_units(prog) == set(range(8))

    def test_resize_moves_a_minority_of_keys(self):
        def prog(own):
            keys = _keys(2000, 3)
            a, b = own.OwnerRing(shards=8), own.OwnerRing(shards=9)
            return sum(1 for k in keys if a.lookup(k) != b.lookup(k))

        assert same_units(prog) < 1000

    def test_shard_count_env_clamped(self, monkeypatch):
        out = []
        for own, var in ((jown, "RAY_TPU_OWNER_SHARDS"),
                         (town, "RAY_TPU_TORCH_OWNER_SHARDS")):
            monkeypatch.setenv(var, "0")
            out.append(own.owner_shards())
            monkeypatch.setenv(var, "bogus")
            out.append(own.owner_shards())
            monkeypatch.delenv(var)
        assert out == [1, 8, 1, 8]
        monkeypatch.setenv("RAY_TPU_OWNER_SHARDS", "3")
        assert town.owner_shards() == 8  # the JAX package's knob is not read


# ----------------------------------------------------------------- OwnerTable


class TestOwnerTable:
    def test_insert_locate_and_idempotence(self):
        def prog(own):
            t = own.OwnerTable(budget=1 << 20)
            oid = _oid(1)
            return (t.insert(oid, 5, b"hello", ("h", 1)),
                    t.insert(oid, 5, b"hello", ("h", 1)),
                    t.locate(oid), t.get_blob(oid), t.stats()["inserted"])

        assert same_units(prog) == (True, False, {"size": 5, "inline": True,
                                                  "addr": ("h", 1)},
                                    b"hello", 1)

    def test_pointer_entry_upgrades_to_blob(self):
        def prog(own):
            t = own.OwnerTable(budget=1 << 20)
            oid = _oid(2)
            t.insert(oid, 7, None, ("h", 2))
            inline = t.locate(oid)["inline"]
            gained = t.insert(oid, 7, b"payload", None)
            return inline, gained, t.get_blob(oid), t.locate(oid)["addr"]

        assert same_units(prog) == (False, True, b"payload", ("h", 2))

    def test_eviction_keeps_tracking_entry(self):
        def prog(own):
            t = own.OwnerTable(budget=64)
            a, b = _oid(3), _oid(4)
            t.insert(a, 48, b"x" * 48, ("h", 3))
            t.insert(b, 48, b"y" * 48, ("h", 3))
            return (t.stats()["evicted"], t.locate(a), t.get_blob(a),
                    t.get_blob(b), t.stats()["blob_bytes"])

        evicted, loc, ba, bb, nbytes = same_units(prog)
        assert evicted >= 1 and loc is not None
        assert (ba is None or bb is None) and nbytes <= 64

    def test_discard_frees_budget(self):
        def prog(own):
            t = own.OwnerTable(budget=1 << 20)
            oid = _oid(5)
            t.insert(oid, 9, b"z" * 9, None)
            t.discard([oid])
            return t.locate(oid), t.stats()["blob_bytes"]

        assert same_units(prog) == (None, 0)

    def test_arrival_latch_sets_on_fresh_insert(self):
        def prog(own):
            t = own.OwnerTable()
            before = t.arrived.is_set()
            t.insert(_oid(6), 1, b"a", None)
            t.arrived.set()  # the server's contract: fresh insert -> latch
            return before, t.arrived.is_set()

        assert same_units(prog) == (False, True)


# ---------------------------------------------------------------- OwnerServer


class TestOwnerServer:
    def test_publish_fetch_locate_over_the_wire(self):
        def prog(own, wire, client):
            table = own.OwnerTable()
            server = own.OwnerServer(table, host="127.0.0.1")
            server.start()
            cli = client("127.0.0.1", server.port)
            try:
                probe = cli.call({"type": "wire_probe"})
                cli.peer_wire = probe["wire"]
                a, b = _oid(10), _oid(11)
                out = [probe["wire"] == wire.WIRE_VERSION]
                out.append(cli.call({
                    "type": "owner_publish", "node_id": "n1",
                    "address": ["127.0.0.1", 7001],
                    "items": [[a, 5, b"bytes"], [b, 3, None]]})["count"])
                out.append(table.locate(a)["inline"])
                out.append(cli.call({"type": "owner_locate",
                                     "object_ids": [a, b, _oid(12)]})
                           ["objects"])
                resp = cli.call({"type": "owner_fetch", "object_ids": [a, b]})
                out += [resp["blobs"], resp["locations"]]
                st = cli.call({"type": "owner_stats"})["stats"]
                out.append((st["publishes"], st["entries"]))
                return out
            finally:
                cli.close()
                server.stop()

        j = prog(jown, jwire, JClient)
        t = prog(town, twire, TClient)
        assert j == t
        a, b = _oid(10), _oid(11)
        assert t == [True, 2, True,
                     {a: {"size": 5, "inline": True},
                      b: {"size": 3, "inline": False}},
                     {a: b"bytes"}, {b: ["127.0.0.1", 7001]}, (1, 2)]


# ----------------------------------------------------------------- cluster E2E


def _run_side_by_side(fn):
    out, errs = {}, {}

    def go(rt):
        try:
            out[rt] = fn(rt)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errs[rt] = e

    threads = [threading.Thread(target=go, args=(rt,)) for rt in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs.values():
        raise e
    return out


def _start(rt, **kw):
    if rt is ray_tpu_torch:
        return TCluster(device="cpu", **kw)
    return JCluster(**kw)


@pytest.fixture(scope="module")
def clusters():
    cs = {}
    try:
        cs.update(_run_side_by_side(
            lambda rt: _start(rt, head_resources={"CPU": 4}, num_workers=2)))
        yield cs
    finally:
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
    j, t = (program(rt, *args) for rt in PKGS)
    assert j == t
    return t


def same_side_by_side(program, clusters):
    out = _run_side_by_side(lambda rt: program(rt, clusters[rt]))
    assert out[ray_tpu] == out[ray_tpu_torch]
    return out[ray_tpu_torch]


def _core(rt):
    return importlib.import_module(
        rt.__name__ + "._private.worker").global_worker().core


def _env(rt):
    return importlib.import_module(
        rt.__name__ + ".cluster.testing")._subprocess_env()


def test_warm_batch_registers_zero_inline_results_at_gcs(drivers):
    """With ownership on, a warm batch adds zero inline results to the GCS
    object table and the auditor stays clean."""
    def prog(rt):
        @rt.remote
        def noop():
            return None

        rt.get([noop.remote() for _ in range(20)], timeout=60)
        core = _core(rt)
        assert core._owner_table is not None
        before = core.gcs.call({"type": "debug_stats"})["handlers"]
        n0 = before.get("inline:gcs_registered", {}).get("count", 0)
        vals = rt.get([noop.remote() for _ in range(400)], timeout=120)
        after = core.gcs.call({"type": "debug_stats"})["handlers"]
        n1 = after.get("inline:gcs_registered", {}).get("count", 0)
        owners = core.gcs.call({"type": "list_owners"})["owners"]
        mine = [o for o in owners
                if bytes.fromhex(o["job"]) == core.job_id.binary()]
        audit = core.gcs.call({"type": "run_audit", "verify": True},
                              timeout=120)
        return (vals == [None] * 400, n1 - n0, bool(mine and mine[0]["alive"]),
                audit.get("findings"))

    assert same(prog) == (True, 0, True, [])


def test_owner_miss_redrives_lineage(drivers):
    """A result dropped from every cache the owner holds is re-driven
    through lineage and resolves to the same value."""
    def prog(rt):
        @rt.remote
        def make():
            return "payload-42"

        ref = make.remote()
        first = rt.get(ref, timeout=60)
        core = _core(rt)
        oid = ref.binary()
        deadline = time.monotonic() + 10.0
        while core._owner_table.locate(oid) is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        core._owner_table.discard([oid])
        core._blob_cache.pop(oid, None)
        again = rt.get(ref, timeout=90)
        events = core.gcs.call({"type": "get_events",
                                "kind": "owner_miss_redrive", "limit": 50})
        return first, again, bool(events.get("events"))

    assert same(prog) == ("payload-42", "payload-42", True)


def _subprocess_driver_script(pkg, address, n):
    return (
        f"import {pkg} as rt\n"
        f"rt.init(address={address!r})\n"
        "@rt.remote\n"
        "def f(i):\n"
        "    return i * 3\n"
        f"vals = rt.get([f.remote(i) for i in range({n})], timeout=120)\n"
        f"assert vals == [i * 3 for i in range({n})]\n"
        f"from {pkg}._private.worker import global_worker\n"
        "core = global_worker().core\n"
        "job = core.job_id.binary()\n"
        "tab = core._owner_table\n"
        "assert tab is not None\n"
        "foreign = [o for o in list(tab._entries) if o[12:16] != job]\n"
        "print('JOB', job.hex(), len(tab), len(foreign), flush=True)\n"
        "rt.shutdown()\n"
    )


def test_multi_driver_tenancy_disjoint_owner_tables(drivers):
    """Two drivers on one cluster each own only their job's objects; the
    GCS lists both owners and the auditor stays clean."""
    def prog(rt, cluster):
        @rt.remote
        def g(i):
            return i + 7

        refs = [g.remote(i) for i in range(60)]
        proc = subprocess.run(
            [sys.executable, "-c",
             _subprocess_driver_script(rt.__name__, cluster.address, 60)],
            env=_env(rt), capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-2000:]
        tag, other_job_hex, n_owned, n_foreign = proc.stdout.split()[:4]
        vals = rt.get(refs, timeout=120)
        core = _core(rt)
        my_job = core.job_id.binary()
        foreign = [o for o in list(core._owner_table._entries)
                   if o[12:16] != my_job]
        jobs = {o["job"] for o in core.gcs.call(
            {"type": "list_owners"})["owners"]}
        audit = core.gcs.call({"type": "run_audit", "verify": True},
                              timeout=120)
        return (tag, int(n_owned) > 0, int(n_foreign),
                vals == [i + 7 for i in range(60)],
                bytes.fromhex(other_job_hex) != my_job, foreign,
                my_job.hex() in jobs and other_job_hex in jobs,
                audit.get("findings"))

    assert same_side_by_side(prog, drivers) == (
        "JOB", True, 0, True, True, [], True, [])


def test_kill_owner_mid_batch_cluster_stays_consistent(drivers):
    """A driver SIGKILLed mid-batch: its owner entry is swept dead once its
    lease lapses, no dead-owner orphan is left, and the surviving driver's
    results are all there, once each."""
    def prog(rt, cluster):
        script = (
            f"import {rt.__name__} as rt\n"
            f"rt.init(address={cluster.address!r})\n"
            "@rt.remote\n"
            "def slow(i):\n"
            "    import time\n"
            "    time.sleep(0.05)\n"
            "    return i\n"
            "refs = [slow.remote(i) for i in range(400)]\n"
            f"from {rt.__name__}._private.worker import global_worker\n"
            "job = global_worker().core.job_id.binary()\n"
            "print('JOB', job.hex(), flush=True)\n"
            "rt.get(refs, timeout=300)\n"
        )
        proc = subprocess.Popen([sys.executable, "-c", script],
                                env=_env(rt), stdout=subprocess.PIPE,
                                text=True)
        line = proc.stdout.readline().split()
        assert line and line[0] == "JOB"
        victim_job = line[1]
        time.sleep(1.0)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

        @rt.remote
        def h(i):
            return i * i

        out = rt.get([h.remote(i) for i in range(100)], timeout=120)
        core = _core(rt)
        deadline = time.monotonic() + 60.0
        victim = None
        while time.monotonic() < deadline:
            owners = core.gcs.call({"type": "list_owners"})["owners"]
            victim = next((o for o in owners if o["job"] == victim_job), None)
            if victim is not None and not victim["alive"]:
                break
            time.sleep(1.0)
        audit = core.gcs.call({"type": "run_audit", "verify": True},
                              timeout=120)
        kinds = {f["kind"] for f in audit.get("findings", [])}
        return (out == [i * i for i in range(100)],
                victim is not None and not victim["alive"],
                sorted(kinds & {"dead_owner_orphan", "dual_tracked_object"}))

    assert same_side_by_side(prog, drivers) == (True, True, [])


def test_kill_switch_reverts_to_gcs_tracked_path(monkeypatch):
    """``*_OWNERSHIP=0``: drivers never register as owners and inline
    results register at the GCS. Each package reads its own variable."""
    monkeypatch.setenv("RAY_TPU_OWNERSHIP", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_OWNERSHIP", "0")
    cs = {}
    try:
        cs.update(_run_side_by_side(lambda rt: _start(
            rt, head_resources={"CPU": 2}, num_workers=1,
            extra_env={"RAY_TPU_OWNERSHIP": "0",
                       "RAY_TPU_TORCH_OWNERSHIP": "0"})))

        def prog(rt, cluster):
            rt.init(address=cluster.address)
            try:
                @rt.remote
                def one():
                    return 1

                vals = rt.get([one.remote() for _ in range(30)], timeout=60)
                core = _core(rt)
                handlers = core.gcs.call({"type": "debug_stats"})["handlers"]
                return (vals == [1] * 30, core._owner_table is None,
                        handlers.get("inline:gcs_registered",
                                     {}).get("count", 0) > 0,
                        core.gcs.call({"type": "list_owners"})["owners"])
            finally:
                rt.shutdown()

        j, t = (prog(rt, cs[rt]) for rt in PKGS)
        assert j == t == (True, True, True, [])
    finally:
        for c in cs.values():
            c.shutdown()
