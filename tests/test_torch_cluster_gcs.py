"""The port's GCS placement seam and wire codec against the JAX package's, on
the CPU.

Twins of tests/test_scheduler.py's ``TestAdaptivePlacementCrossover`` and
``TestUnsentDispatchRecovery`` on a bare ``GcsServer`` of each package (the
port's on ``device="cpu"``). Then the seam itself: ``_place_with("kernel",
...)`` gives JAX's placements bit for bit on seeded demand, availability,
locality and masks at buckets 64, 1024 and 4096 (twice per server, so the
second call takes the reused scheduler's availability update); the gang,
pending-reason and locality passes give JAX's answers under both settings
of their knobs; every device pass counts a ``kernel:<pass>`` cell in the
stats table that ``debug_stats`` ships, a swallowed failure counts
``kernel_fallback:<pass>``, and the GCS refuses to place on the card when
there is none. Last, every frame kind of tests/test_wire_codec.py encodes
to the same bytes in both packages."""

import asyncio

import numpy as np
import pytest

from ray_tpu._private.config import Config as JConfig
from ray_tpu._private.resources import ResourceSet as JRes
from ray_tpu.cluster import gcs as jgcs
from ray_tpu.cluster import wire as jwire
from ray_tpu_torch._private.config import Config as TConfig
from ray_tpu_torch._private.resources import ResourceSet as TRes
from ray_tpu_torch.cluster import gcs as tgcs
from ray_tpu_torch.cluster import wire as twire
from test_wire_codec import _FRAME_CASES

JAX, PORT = "jax", "port"
KNOBS = {"PG": "PG_KERNEL", "REASON": "REASON_KERNEL",
         "LOCALITY": "LOCALITY_KERNEL"}


def _gcs(pkg):
    if pkg == JAX:
        return jgcs.GcsServer(JConfig())
    return tgcs.GcsServer(TConfig(), device="cpu")


def _res(pkg):
    return JRes if pkg == JAX else TRes


def _mod(pkg):
    return jgcs if pkg == JAX else tgcs


def both(program):
    return [program(pkg, _gcs(pkg)) for pkg in (JAX, PORT)]


def same(program):
    j, t = both(program)
    assert j == t
    return t


def _cells(g, prefix="kernel"):
    return {k: v[0] for k, v in g.server.handler_stats.items()
            if k.startswith(prefix + ":") or k.startswith(prefix + "_")}


def _knob(monkeypatch, name, value):
    """Set one routing knob in both packages' spellings."""
    monkeypatch.setenv(f"RAY_TPU_{KNOBS[name]}", value)
    monkeypatch.setenv(f"RAY_TPU_TORCH_{KNOBS[name]}", value)


# ------------------------------------------------ adaptive placement crossover


class TestAdaptivePlacementCrossover:
    def test_bootstrap_uses_static_heuristic(self):
        def prog(pkg, g):
            g._seed = 1  # not a multiple of 16: no exploration
            out = [g._choose_place_backend(8)]
            warmed = []
            g._spawn_place_warmup = lambda bucket: warmed.append(bucket)
            out.append(g._choose_place_backend(1024))  # cold: numpy, warm it
            g._place_perf[("kernel", 1024)] = [0.002, 1]
            out.append(g._choose_place_backend(1024))  # warm: kernel
            return out, warmed

        assert same(prog) == (["numpy", "numpy", "kernel"], [1024])

    def test_small_batches_explore_kernel_boundedly(self):
        def prog(pkg, g):
            warmed = []
            g._spawn_place_warmup = lambda bucket: warmed.append(bucket)
            g._seed = 16
            out = [g._choose_place_backend(8), list(warmed)]
            g._place_perf[("kernel", 8)] = [0.07, 1]
            g._seed = 16
            out.append(g._choose_place_backend(8))
            g._record_place_perf("kernel", 8, 0.07)
            g._record_place_perf("numpy", 8, 0.0005)
            g._record_place_perf("numpy", 8, 0.0005)
            g._seed = 16
            out.append(g._choose_place_backend(8))
            g._seed = 1024
            out.append(g._choose_place_backend(8))
            return out

        assert same(prog) == ["numpy", [8], "kernel", "numpy", "kernel"]

    def test_fast_kernel_wins_small_batches(self):
        def prog(pkg, g):
            g._choose_place_backend(8)
            g._record_place_perf("kernel", 32, 0.0)   # compile visit, dropped
            g._record_place_perf("kernel", 32, 0.0002)
            g._record_place_perf("kernel", 32, 0.0002)
            g._record_place_perf("numpy", 32, 0.002)
            g._record_place_perf("numpy", 32, 0.002)
            return g._choose_place_backend(32)

        assert same(prog) == "kernel"

    def test_first_kernel_sample_is_compile_and_dropped(self):
        def prog(pkg, g):
            g._choose_place_backend(8)
            g._record_place_perf("kernel", 128, 30.0)  # compile
            first = list(g._place_perf[("kernel", 128)])
            g._record_place_perf("kernel", 128, 0.001)
            return first, g._place_perf[("kernel", 128)]

        first, cell = same(prog)
        assert first == [0.0, 0] and cell[1] == 1
        assert abs(cell[0] - 0.001) < 1e-9


# ---------------------------------------------------- unsent dispatch recovery


def _gcs_with_task(pkg, g):
    node = _mod(pkg).NodeEntry("nodeA", ("127.0.0.1", 1), {"CPU": 2.0},
                               index=0)
    g.nodes["nodeA"] = node
    payload = {"task_id": b"t1", "return_ids": [b"o1"],
               "resources": {"CPU": 1.0}, "deps": []}
    rec = {"task_id": b"t1", "payload": payload, "kind": "task",
           "resources": {"CPU": 1.0}, "retries_left": 0,
           "state": "DISPATCHED", "node_id": "nodeA",
           "cancelled": False, "return_ids": [b"o1"]}
    g.task_table[b"t1"] = rec
    return node, payload, rec


class TestUnsentDispatchRecovery:
    def test_send_fallback_redrives_without_burning_retry(self):
        def prog(pkg, g):
            node, payload, rec = _gcs_with_task(pkg, g)
            node.alive = False  # dead before any bytes go out

            async def run():
                driven = []
                g._spawn = lambda coro: (driven.append(True), coro.close())
                await g._send_assign_batch("nodeA", [payload])
                return driven

            driven = asyncio.run(run())
            return rec["state"], rec["node_id"], rec["retries_left"], driven

        assert same(prog) == ("PENDING", None, 0, [True])

    def test_node_death_rescues_buffered_batch(self):
        def prog(pkg, g):
            node, payload, rec = _gcs_with_task(pkg, g)
            g._assign_bufs["nodeA"] = [payload]
            driven = []
            g._spawn = lambda coro: (driven.append(True), coro.close())

            async def run():
                node.alive = False
                await g._on_node_death(node)

            asyncio.run(run())
            return (rec["state"], rec["retries_left"], dict(g.error_objects),
                    bool(driven))

        assert same(prog) == ("PENDING", 0, {}, True)


# --------------------------------------------------------------- the S2 tick


def _tick_inputs(T, N, masked, seed):
    rng = np.random.default_rng(seed)
    R = 5  # the 4 predefined slots and one custom column
    avail = rng.integers(0, 8, size=(N, R)).astype(np.int64) * 1000
    avail[:, 0] = rng.integers(4, 64, size=N) * 1000
    demand = np.zeros((T, R), np.int64)
    demand[:, 0] = rng.choice([500, 1000, 2000], size=T)
    demand[:, 2] = np.where(rng.random(T) < 0.1, 1000, 0)
    demand[:, 4] = np.where(rng.random(T) < 0.05, 1000, 0)
    locality = np.where(rng.random(T) < 0.3,
                        rng.integers(0, N, size=T), -1).astype(np.int32)
    mask = None
    if masked:
        mask = rng.random(N) < 0.8
        mask[0] = True
    return demand, avail, locality, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "draining"])
@pytest.mark.parametrize("T", [50, 1000, 3000],
                         ids=["bucket64", "bucket1024", "bucket4096"])
def test_place_with_kernel_is_bit_identical(T, masked):
    """Two ticks per server (the second updates the reused scheduler's
    availability in place): the port's placements equal JAX's bit for bit,
    the port counts two ``kernel:place`` and no fallback."""
    d1, a1, l1, m1 = _tick_inputs(T, 16, masked, seed=T)
    d2, a2, l2, m2 = _tick_inputs(T, 16, masked, seed=T + 1)

    def prog(pkg, g):
        p1 = g._place_with("kernel", d1, a1, l1, m1)
        p2 = g._place_with("kernel", d2, a2, l2, m2)
        assert not g._kernel_unavailable
        return np.asarray(p1).tolist(), np.asarray(p2).tolist(), _cells(g)

    (j1, j2, jc), (t1, t2, tc) = both(prog)
    assert j1 == t1 and j2 == t2
    assert jc == {} and tc == {"kernel:place": 2}
    assert max(t1) >= 0


def test_place_with_numpy_matches_and_counts_nothing():
    d, a, loc, m = _tick_inputs(300, 8, True, seed=9)

    def prog(pkg, g):
        out = np.asarray(g._place_with("numpy", d, a, loc, m)).tolist()
        return out, _cells(g)

    assert same(prog)[1] == {}


def test_place_fallback_is_counted(monkeypatch):
    """A failing device pass takes the reference's numpy spec, latches the
    kernel off and counts ``kernel_fallback:place``."""
    from ray_tpu_torch.scheduler import kernel as tkernel

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("no device pass")

    monkeypatch.setattr(tkernel, "BatchScheduler", Broken)
    d, a, loc, _ = _tick_inputs(100, 4, False, seed=4)
    g = _gcs(PORT)
    out = g._place_with("kernel", d, a, loc, None)
    ref = g._place_with("numpy", d, a, loc, None)
    assert np.array_equal(out, ref) and g._kernel_unavailable
    assert _cells(g) == {"kernel_fallback:place": 1}
    assert g._choose_place_backend(4096) == "numpy"


def test_warmup_counts_and_installs_the_scheduler():
    g = _gcs(PORT)
    g.nodes["n0"] = tgcs.NodeEntry("n0", ("127.0.0.1", 1), {"CPU": 8.0}, 0)
    g._node_order.append("n0")
    g._spawn_place_warmup(64)
    for t in __import__("threading").enumerate():
        if t.name == "place-warmup-64":
            t.join(60)
    assert _cells(g) == {"kernel:warmup": 1}
    assert g._sched.device.type == "cpu"
    assert g._place_perf[("kernel", 64)][1] == 2
    snap = g.place_perf_snapshot()
    assert snap["device"] == "cpu" and snap["kernel:64"]["samples"] == 2


def test_gcs_device_defaults_to_the_card():
    """No card here: the default device refuses rather than placing on the
    CPU unasked; the CPU is used when named."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgcs.GcsServer(TConfig())
    assert str(tgcs.GcsServer(TConfig(), device="cpu").device) == "cpu"


# ------------------------------------------------------------- S3, S4 and S5


def _pg_pending():
    rng = np.random.default_rng(5)
    strategies = ["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"]
    return [{"strategy": strategies[i % 4],
             "bundles": [{"CPU": float(rng.integers(1, 4))}
                         for _ in range(int(rng.integers(1, 5)))]}
            for i in range(9)]


@pytest.mark.parametrize("knob", ["", "1"], ids=["reference", "kernel"])
def test_pg_place_matches_jax(monkeypatch, knob):
    _knob(monkeypatch, "PG", knob)
    pending = _pg_pending()
    avail = np.random.default_rng(6).integers(1, 6, size=(5, 4)) * 1000
    avail[:, 1:] = 0

    def prog(pkg, g):
        out = [np.asarray(g._pg_place(pending, avail, ())).tolist()
               for _ in range(3)]  # rounds 1..3 draw different bits
        return out, _cells(g)

    (jp, jc), (tp, tc) = both(prog)
    assert jp == tp and jc == {}
    assert tc == ({"kernel:gang": 3} if knob else {})
    assert any(s >= 0 for row in tp for s in row)


def _reason_gcs(pkg, g):
    for i, res in enumerate(({"CPU": 4.0}, {"CPU": 2.0, "GPU"
                             if pkg == PORT else "TPU": 1.0})):
        nid = f"n{i}"
        g.nodes[nid] = _mod(pkg).NodeEntry(nid, ("h", i), res, i)
        g._node_order.append(nid)
    R = _res(pkg)
    accel = "GPU" if pkg == PORT else "TPU"
    work = [(R.from_dict({"CPU": 1.0}), {"state": "PENDING"}),
            (R.from_dict({"CPU": 64.0}), {"state": "PENDING"}),
            (R.from_dict({accel: 1.0}), {"state": "PENDING"}),
            (R.from_dict({accel: 2.0}), {"state": "PENDING"}),
            (R.from_dict({"CPU": 1.0, "tag": 1.0}), {"state": "PENDING"}),
            (R.from_dict({"CPU": 1.0}), None)]
    return work


@pytest.mark.parametrize("knob", ["", "1"], ids=["reference", "kernel"])
def test_reason_pass_matches_jax(monkeypatch, knob):
    _knob(monkeypatch, "REASON", knob)

    def prog(pkg, g):
        work = _reason_gcs(pkg, g)
        g._classify_unplaced(work)
        return ([rec and rec["pending_reason"] for _, rec in work],
                _cells(g, "reason"), _cells(g))

    (jr, jcounts, jc), (tr, tcounts, tc) = both(prog)
    assert jr == tr and jcounts == tcounts and jc == {}
    assert "infeasible" in tr and "waiting-for-capacity" in tr
    assert tc == ({"kernel:reason": 1} if knob else {})


def _locality_entries(pkg, g):
    alive = [f"n{i}" for i in range(4)]
    for i, nid in enumerate(alive):
        g.nodes[nid] = _mod(pkg).NodeEntry(nid, ("h", i), {"CPU": 4.0}, i)
        g._node_order.append(nid)
    rng = np.random.default_rng(7)
    for k in range(12):
        g.objects[bytes([k]) * 24] = {
            "locations": list(rng.choice(alive, size=int(rng.integers(1, 3)),
                                         replace=False)),
            "size": int(rng.integers(1, 1 << 22))}
    R = _res(pkg)
    entries = []
    for i in range(10):
        deps = [bytes([int(k)]) * 24
                for k in rng.choice(14, size=int(rng.integers(0, 4)),
                                    replace=False)]
        loc = "n3" if i == 0 else None  # a user hint is never overridden
        entries.append((R.from_dict({"CPU": 1.0}), loc, None,
                        {"name": f"t{i}", "payload": {"deps": deps}}))
    return entries, alive


@pytest.mark.parametrize("knob", ["", "1", "0"],
                         ids=["reference", "kernel", "off"])
def test_locality_pass_matches_jax(monkeypatch, knob):
    _knob(monkeypatch, "LOCALITY", knob)

    def prog(pkg, g):
        entries, alive = _locality_entries(pkg, g)
        out = g._locality_hints(entries, alive)
        return [loc for _, loc, _, _ in out], _cells(g)

    (jl, jc), (tl, tc) = both(prog)
    assert jl == tl and jc == {}
    assert tl[0] == "n3"
    assert tc == ({"kernel:locality": 1} if knob == "1" else {})
    if knob != "0":
        assert sum(loc is not None for loc in tl) > 1


def test_locality_failure_is_counted(monkeypatch):
    from ray_tpu_torch.scheduler import kernel as tkernel

    monkeypatch.setenv("RAY_TPU_TORCH_LOCALITY_KERNEL", "1")

    def broken(*a, **k):
        raise RuntimeError("no device pass")

    monkeypatch.setattr(tkernel, "score_locality_host", broken)
    g = _gcs(PORT)
    entries, alive = _locality_entries(PORT, g)
    assert g._locality_hints(entries, alive) == entries
    assert _cells(g) == {"kernel_fallback:locality": 1}


# ------------------------------------------------------ wire byte identity


def test_spec_blobs_are_byte_identical():
    spec = {"task_id": b"T" * 16, "fn_id": b"F" * 16, "name": "f-é",
            "max_retries": 3, "return_ids": [b"R" * 24], "deps": [b"D" * 24],
            "pin_refs": [], "resources": {"CPU": 0.5, "custom/tag": 2.0},
            "args": [("value", b"v" * 40), ("ref", b"A" * 24)],
            "kwargs": {"k": ("value", b"w")}, "trace": b"t" * 8}
    assert jwire.encode_task_spec(spec) == twire.encode_task_spec(spec)
    assert jwire.WIRE_VERSION == twire.WIRE_VERSION
    assert set(jwire._DECODERS) == set(twire._DECODERS)


@pytest.mark.parametrize("code", sorted(_FRAME_CASES),
                         ids=lambda c: f"0x{c:02x}")
def test_frame_encodes_to_the_same_bytes(code):
    kind, build = _FRAME_CASES[code]
    outs = []
    for wire in (jwire, twire):
        msg = build()
        if kind == "req":
            bufs = wire.encode(msg)
        else:
            pw = kind[2] if len(kind) > 2 else wire.WIRE_VERSION
            bufs = wire.encode_response(kind[1], msg, peer_wire=pw)
        assert bufs is not None
        outs.append(b"".join(bufs))
    assert outs[0] == outs[1]
    assert outs[1][1] == code
    assert twire.decode(outs[1]) == jwire.decode(outs[0])
