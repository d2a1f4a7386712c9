"""The port's placement passes (ray_tpu_torch.scheduler) against the JAX
package's (ray_tpu.scheduler) on the CPU: the same numpy-seeded inputs
through both, and placements, codes and round counts held equal, bit for
bit. Also the numpy and torch threefry against ``jax.random``, the port's
scalar reference and critical-path module against the JAX package's, and
the north-star workload's digest, which chip_smoke.py holds the card to."""

import hashlib
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.scheduler import critical_path as jcp
from ray_tpu.scheduler import kernel as jk
from ray_tpu.scheduler import reference as jr
from ray_tpu.scheduler.dag import (
    chain_rounds_dag, collapse_chains, fanout_dag, random_dag,
    uniform_cluster,
)
from ray_tpu_torch.scheduler import critical_path as tcp
from ray_tpu_torch.scheduler import dag as tdag
from ray_tpu_torch.scheduler import kernel as tk
from ray_tpu_torch.scheduler import reference as tr

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The passes' tensors here are small: one intra-op thread keeps this
    file light beside the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jkey(seed):
    return jax.random.PRNGKey(seed)


# ------------------------------------------------------------------ threefry


def test_threefry_matches_the_recorded_facts():
    """Key (0, 0), round 3, tasks 0-3: the draws JAX gives, recorded
    before the port, from the numpy and the torch form alike."""
    want = [4096103414, 3646506523, 3984177006, 2863456236]
    jax_bits = jk.task_bits(jkey(0), 3, jnp.arange(4, dtype=jnp.int32))
    assert np.asarray(jax_bits).tolist() == want
    assert tk.task_bits_host(tk.prng_key(0), 3, np.arange(4)).tolist() == want
    assert tk.task_bits(tk.prng_key(0), 3, torch.arange(4)).tolist() == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_threefry_matches_jax_on_random_keys_rounds_and_ticks(seed):
    rng = np.random.default_rng(seed)
    s = int(rng.integers(0, 2 ** 31))
    tick = int(rng.integers(0, 10_000))
    round_idx = int(rng.integers(0, 100_000))
    tasks = rng.integers(0, 2 ** 31 - 1, size=257).astype(np.int32)
    assert np.asarray(jkey(s)).tolist() == tk.prng_key(s).tolist()
    jfold = jax.random.fold_in(jkey(s), tick)
    tfold = tk.fold_in(tk.prng_key(s), tick)
    assert np.asarray(jfold).tolist() == tfold.tolist()
    want = np.asarray(jk.task_bits(jfold, round_idx, jnp.asarray(tasks)))
    got_np = tk.task_bits_host(tfold, round_idx, tasks)
    got_t = tk.task_bits(tfold, round_idx, torch.from_numpy(tasks))
    assert got_np.dtype == np.uint32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want.astype(np.int64))


def test_prng_key_refuses_seeds_outside_32_bits():
    with pytest.raises(ValueError, match="seed"):
        tk.prng_key(-1)
    with pytest.raises(ValueError, match="seed"):
        tk.prng_key(2 ** 32)


# -------------------------------------------------------------- schedule_dag


def run_both(demand, parents, avail, seed=0, locality=None, node_mask=None,
             chunk=256, max_rounds=0):
    """JAX's schedule_dag and the port's on the CPU, same inputs."""
    jp, jr_ = jk.schedule_dag(
        np.asarray(demand), np.asarray(parents), np.asarray(avail),
        jkey(seed), locality=None if locality is None else np.asarray(
            locality),
        node_mask=None if node_mask is None else np.asarray(node_mask),
        chunk=chunk, max_rounds=max_rounds)
    tp, tr_ = tk.schedule_dag(demand, parents, avail, tk.prng_key(seed),
                              locality=locality, node_mask=node_mask,
                              chunk=chunk, max_rounds=max_rounds,
                              device="cpu")
    assert tp.dtype == torch.int32 and tp.device.type == "cpu"
    assert tr_.dtype == torch.int32 and tr_.dim() == 0
    return np.asarray(jp), int(jr_), tp.numpy(), int(tr_)


def _mask(seed, n):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.7
    mask[int(rng.integers(n))] = True
    return mask


def _k3(demand, parents):
    """Parents padded with empty (-1) columns to K = 3, the random DAGs'
    width, so these cases share one JAX compilation with them."""
    pad = np.full((parents.shape[0], 3 - parents.shape[1]), -1,
                  parents.dtype)
    return demand, np.concatenate([parents, pad], axis=1)


def _with_infeasible(demand, parents):
    """Every 50th task wants more CPU than any node has: it and all its
    descendants stay unplaced (INFEASIBLE, NO_PLACEMENT)."""
    demand = demand.copy()
    demand[::50, 0] = 20 * 1000
    return demand, parents


def _survivor_mix(seed):
    T = 512
    rng = np.random.default_rng(seed)
    demand = np.where((np.arange(T) % 2 == 0)[:, None], 600,
                      rng.integers(10, 200, size=(T, 1)))
    return (demand, np.full((T, 1), -1, np.int64),
            np.full((3, 1), 1000, np.int64), dict(seed=seed, chunk=128))


_DAG_CASES = {
    # TestKernelVsReference's cases.
    **{f"random_dag_{s}": (lambda s=s: (*random_dag(2000, seed=s),
                                        uniform_cluster(16), dict(seed=s)))
       for s in (0, 1, 2)},
    "fanout": lambda: (*_k3(*fanout_dag(2000)), uniform_cluster(16, cpu=16),
                       {}),
    "chain": lambda: (*_k3(*chain_rounds_dag(rounds=20, width=100)),
                      uniform_cluster(16, cpu=16), {}),
    "locality": lambda: (*random_dag(2000, seed=3), uniform_cluster(16), dict(
        locality=np.random.default_rng(0).integers(
            -1, 16, size=2000).astype(np.int32))),
    "mixed_demands": lambda: (*random_dag(4000, num_classes=8, seed=7),
                              uniform_cluster(4, cpu=8),
                              dict(seed=7, chunk=128)),
    **{f"node_mask_{s}": (lambda s=s: (*random_dag(1500, seed=s),
                                       uniform_cluster(12),
                                       dict(seed=s, node_mask=_mask(s, 12))))
       for s in range(5)},
    "node_mask_with_locality": lambda: (
        *random_dag(1500, seed=9), uniform_cluster(12),
        dict(seed=9, locality=np.random.default_rng(9).integers(
            -1, 12, size=1500).astype(np.int32),
             node_mask=np.arange(12) % 3 != 2)),
    "all_masked_is_infeasible": lambda: (
        *random_dag(1500, seed=4), uniform_cluster(12),
        dict(node_mask=np.zeros(12, bool))),
    "infeasible_and_blocked": lambda: (
        *_with_infeasible(*random_dag(2000, seed=6)), uniform_cluster(16),
        dict(seed=6)),
    # TestSurvivorsPass's cases.
    "survivors_small_behind_large": lambda: (
        np.array([[900], [900], [50], [50]]), np.full((4, 1), -1),
        np.array([[1000]]), dict(chunk=8)),
    "survivors_never_overcommit": lambda: (
        np.array([[900], [900], [60], [60]]), np.full((4, 1), -1),
        np.array([[1000]]), dict(chunk=8)),
    "survivors_adversarial_0": lambda: _survivor_mix(0),
    "survivors_adversarial_5": lambda: _survivor_mix(5),
    # One round only (a chunk larger than the DAG: BatchScheduler's test).
    "max_rounds_1_locality": lambda: (
        *random_dag(900, seed=12), uniform_cluster(6),
        dict(seed=12, max_rounds=1, locality=np.random.default_rng(
            12).integers(-1, 6, size=900).astype(np.int32))),
}


@pytest.mark.parametrize("case", sorted(_DAG_CASES))
def test_schedule_dag_equals_jax(case):
    demand, parents, avail, kw = _DAG_CASES[case]()
    jp, jrounds, tp, trounds = run_both(demand, parents, avail, **kw)
    np.testing.assert_array_equal(tp, jp)
    assert trounds == jrounds


def test_none_mask_equals_all_true_mask():
    demand, parents = random_dag(1500, seed=11)
    avail = uniform_cluster(12)
    *_, p0, r0 = run_both(demand, parents, avail, seed=11)
    *_, p1, r1 = run_both(demand, parents, avail, seed=11,
                          node_mask=np.ones(12, bool))
    np.testing.assert_array_equal(p0, p1)
    assert r0 == r1


def test_schedule_dag_takes_tensors_and_runs_where_they_lie():
    demand, parents = random_dag(300, seed=2)
    avail = uniform_cluster(4)
    want, rounds = tk.schedule_dag(demand, parents, avail, tk.prng_key(2),
                                   chunk=64, device="cpu")
    got, got_rounds = tk.schedule_dag(
        torch.from_numpy(demand), torch.from_numpy(parents),
        torch.from_numpy(avail), tk.prng_key(2), chunk=64)
    assert got.device.type == "cpu"
    assert torch.equal(got, want) and int(got_rounds) == int(rounds)


def test_out_of_range_indices_cannot_fault():
    """Indices the caller got wrong (a parent past the tasks, a hint past
    the nodes, a group past the strategies) are undefined in JAX's passes;
    here they are clamped, so nothing can fault on the card: such a child
    is never placed, such a hint is no hint, such a bundle is padding."""
    demand = np.zeros((4, 4), np.int32)
    demand[:, 0] = 1000
    parents = np.array([[-1], [7], [1], [-1]], np.int32)
    locality = np.array([9, -1, -1, 1], np.int32)
    placement, rounds = tk.schedule_dag(demand, parents, uniform_cluster(2),
                                        tk.prng_key(0), locality=locality,
                                        chunk=8, device="cpu")
    assert placement[1:3].tolist() == [tk.NO_PLACEMENT] * 2
    assert placement[3] == 1 and placement[0] >= 0 and int(rounds) == 1
    out = tk.admit_gangs_host(np.full((2, 1), 10, np.int32),
                              np.array([0, 5], np.int32),
                              np.array([0], np.int32),
                              np.full((2, 1), 100, np.int32),
                              tk.prng_key(0), device="cpu")
    assert out[0] >= 0 and out[1] == tk.NO_PLACEMENT


# ------------------------------------------------------------ admit_gangs


def _gang_mix(seed, max_groups=8, max_size=6, N=5, R=2, B=32):
    """TestGangAdmission's random mix on N nodes, its bundle rows padded
    (group -1) to B and its groups to max_groups (none of their bundles):
    every seed has one shape, and so one JAX compilation."""
    rng = np.random.default_rng(seed)
    G = int(rng.integers(1, max_groups))
    sizes = [int(rng.integers(1, max_size)) for _ in range(G)]
    group = np.full(B, -1, np.int32)
    group[:sum(sizes)] = np.repeat(np.arange(G), sizes)
    demand = rng.integers(0, 900, size=(B, R)).astype(np.int32)
    demand[group < 0] = 0
    strategy = rng.integers(0, 4, size=max_groups).astype(np.int32)
    avail = rng.integers(100, 2000, size=(N, R)).astype(np.int32)
    return demand, group, strategy, avail


def _gang_fragmentation(seed):
    rng = np.random.default_rng(seed)
    sizes = [4, 1, 3, 1, 4, 2]
    group = np.concatenate(
        [[g] * s for g, s in zip(range(len(sizes)), sizes)]).astype(np.int32)
    demand = np.where(
        (np.arange(len(group)) % 2 == 0)[:, None], 700,
        rng.integers(50, 400, size=(len(group), 1))).astype(np.int32)
    return (demand, group, np.asarray([0, 1, 3, 2, 1, 0], np.int32),
            np.full((3, 1), 1000, np.int32))


def _gang_control_plane(seed):
    """>= 1,024 bundles on 256 nodes, every strategy: the control plane's
    size, as chip_smoke.py runs it."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 9, size=230)
    group = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    demand = rng.integers(0, 4000, size=(len(group), 4)).astype(np.int32)
    strategy = (np.arange(len(sizes)) % 4).astype(np.int32)
    avail = rng.integers(2000, 16000, size=(256, 4)).astype(np.int32)
    return demand, group, strategy, avail


_GANG_CASES = {
    **{f"random_{s}": (lambda s=s: (*_gang_mix(s), s, s % 5))
       for s in range(8)},
    **{f"fragmentation_{s}": (lambda s=s: (*_gang_fragmentation(s), s, 0))
       for s in (0, 3, 7)},
    "strict_pack_single_node": lambda: (
        np.full((3, 1), 300, np.int32), np.zeros(3, np.int32),
        np.asarray([2], np.int32), np.asarray([[500], [1000]], np.int32),
        0, 0),
    "strict_spread_more_bundles_than_nodes": lambda: (
        np.full((3, 1), 100, np.int32), np.zeros(3, np.int32),
        np.asarray([3], np.int32), np.full((2, 1), 1000, np.int32), 0, 0),
    "infeasible_gang_before_feasible": lambda: (
        np.asarray([[5000], [5000], [200], [200]], np.int32),
        np.asarray([0, 0, 1, 1], np.int32), np.asarray([0, 0], np.int32),
        np.full((2, 1), 1000, np.int32), 0, 0),
    "padding_rows_and_empty_groups": lambda: (
        np.asarray([[100], [0], [300], [0]], np.int32),
        np.asarray([0, -1, 2, -1], np.int32),
        np.asarray([1, 3, 0], np.int32), np.full((3, 1), 1000, np.int32),
        1, 2),
    **{f"control_plane_{s}": (lambda s=s: (*_gang_control_plane(s), s, s))
       for s in (0, 1)},
}


@pytest.mark.parametrize("case", sorted(_GANG_CASES))
def test_admit_gangs_host_equals_jax(case):
    demand, group, strategy, avail, seed, round_idx = _GANG_CASES[case]()
    want = jk.admit_gangs_host(demand, group, strategy, avail, jkey(seed),
                               round_idx=round_idx)
    got = tk.admit_gangs_host(demand, group, strategy, avail,
                              tk.prng_key(seed), round_idx=round_idx,
                              device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ref = tr.admit_gangs_reference(demand, group, strategy, avail,
                                   tk.prng_key(seed), round_idx=round_idx)
    np.testing.assert_array_equal(ref, want)


def test_admit_gangs_host_overflow_guard_raises_as_jax():
    demand = np.ones((4, 1), np.int32)
    group = np.zeros(4, np.int32)
    avail = np.full((2, 1), 2 ** 30, np.int32)
    for fn, key in ((jk.admit_gangs_host, jkey(0)),
                    (tk.admit_gangs_host, tk.prng_key(0))):
        kw = {} if fn is jk.admit_gangs_host else {"device": "cpu"}
        with pytest.raises(ValueError, match="int32 scan range"):
            fn(demand, group, np.zeros(1, np.int32), avail, key, **kw)


def test_admit_gangs_host_degenerate_shapes():
    key = tk.prng_key(0)
    out = tk.admit_gangs_host(np.zeros((0, 1), np.int32),
                              np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.full((2, 1), 10, np.int32), key,
                              device="cpu")
    assert out.shape == (0,)
    out = tk.admit_gangs_host(np.ones((2, 1), np.int32),
                              np.zeros(2, np.int32), np.zeros(1, np.int32),
                              np.zeros((0, 1), np.int32), key, device="cpu")
    assert out.tolist() == [tk.NO_PLACEMENT] * 2


# -------------------------------------------------------- classify_pending


def _pending_mix(seed, max_tasks=24, max_nodes=6, R=3):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(0, max_tasks))
    N = int(rng.integers(0, max_nodes))
    demand = rng.integers(0, 3000, size=(T, R)).astype(np.int32)
    totals = rng.integers(100, 2500, size=(N, R)).astype(np.int32)
    placement = rng.integers(-2, max(N, 1), size=T).astype(np.int32)
    return (demand, placement, totals, rng.random(T) < 0.25,
            rng.random(T) < 0.25, rng.random(T) < 0.25)


def _pending_boundaries(seed, totals):
    rng = np.random.default_rng(seed)
    cap = 1000
    rows = [(d, wd, wp, q) for wd in (False, True) for wp in (False, True)
            for q in (False, True) for d in (0, cap, cap + 1, 10 * cap)]
    demand = np.asarray([[r[0]] for r in rows], np.int32)
    T = demand.shape[0]
    return (demand, rng.integers(-2, 1, size=T).astype(np.int32), totals,
            np.asarray([r[1] for r in rows]), np.asarray([r[2] for r in rows]),
            np.asarray([r[3] for r in rows]))


_PENDING_CASES = {
    **{f"random_{s}": (lambda s=s: _pending_mix(s)) for s in range(16)},
    **{f"boundaries_{s}": (lambda s=s: _pending_boundaries(
        s, np.asarray([[1000]], np.int32))) for s in (0, 3, 9)},
    "boundaries_empty_fleet": lambda: _pending_boundaries(
        3, np.zeros((0, 1), np.int32)),
    "control_plane": lambda: _pending_mix(42, max_tasks=4096,
                                          max_nodes=256, R=4),
}


@pytest.mark.parametrize("case", sorted(_PENDING_CASES))
def test_classify_pending_host_equals_jax(case):
    args = _PENDING_CASES[case]()
    want = jk.classify_pending_host(*args)
    got = tk.classify_pending_host(*args, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.classify_pending_reference(*args), want)


# ---------------------------------------------------------- score_locality


def _bytes_random(seed):
    rng = np.random.default_rng(seed)
    T, N = int(rng.integers(0, 32)), int(rng.integers(0, 8))
    b = rng.integers(0, 1 << 40, size=(T, N))
    if T and N:
        b[rng.random((T, N)) < 0.4] = 0
    return b


def _bytes_ties(seed):
    base = np.random.default_rng(seed).integers(0, 1 << 36, size=(16, 1))
    return np.concatenate([base, base, base], axis=1)


def _bytes_control_plane():
    """[2048, 256] int64, a quarter of the counts above 2^31, ties and
    all-zero rows among them."""
    rng = np.random.default_rng(8)
    b = rng.integers(0, 1 << 31, size=(2048, 256))
    big = rng.random(b.shape) < 0.25
    b[big] = rng.integers(1 << 31, 1 << 45, size=int(big.sum()))
    b[rng.random(b.shape) < 0.5] = 0
    b[::97] = 0
    b[1::89, 7] = b[1::89].max(axis=1)
    return b


_BYTES_CASES = {
    **{f"random_{s}": (lambda s=s: _bytes_random(s)) for s in range(16)},
    **{f"ties_{s}": (lambda s=s: _bytes_ties(s)) for s in (0, 7)},
    "semantics": lambda: np.asarray(
        [[10, 200, 30], [0, 0, 0], [5, 5, 5], [0, 0, 1 << 35],
         [(1 << 31) + 1, 1 << 31, (1 << 31) + 1], [-5, 0, 3]], np.int64),
    "empty_tasks": lambda: np.zeros((0, 4), np.int64),
    "empty_fleet": lambda: np.zeros((5, 0), np.int64),
    "control_plane": _bytes_control_plane,
}


@pytest.mark.parametrize("case", sorted(_BYTES_CASES))
def test_score_locality_host_equals_jax(case):
    b = _BYTES_CASES[case]()
    want = jk.score_locality_host(b)
    got = tk.score_locality_host(b, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tr.score_locality_reference(b), want)


def test_score_locality_host_refuses_a_bad_rank():
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        tk.score_locality_host(np.zeros(3, np.int64), device="cpu")


# ---------------------------------------- schedule_dag_collapsed, BatchScheduler


@pytest.mark.parametrize("case", ["pure_chain", "random_dag", "locality"])
def test_schedule_dag_collapsed_equals_jax(case):
    locality = None
    if case == "pure_chain":
        T = 5_000
        demand = np.full((T, 1), 1000, np.int32)
        parents = (np.arange(T, dtype=np.int32) - 1).reshape(-1, 1)
        avail, chunk = uniform_cluster(16, cpu=16.0)[:, :1], 64
    else:
        demand, parents = random_dag(2_000, parent_window=256, seed=3)
        avail, chunk = uniform_cluster(32, cpu=64.0), 512
        if case == "locality":
            locality = np.random.default_rng(3).integers(
                -1, 32, size=2_000).astype(np.int32)
    jp, jrounds = jk.schedule_dag_collapsed(
        demand, parents, jnp.asarray(avail), jkey(1), locality=locality,
        chunk=chunk)
    tp, trounds = tk.schedule_dag_collapsed(
        demand, parents, avail, tk.prng_key(1), locality=locality,
        chunk=chunk, device="cpu")
    np.testing.assert_array_equal(tp, jp)
    assert trounds == jrounds
    if case == "pure_chain":
        assert trounds == 1 and len(set(tp.tolist())) == 1


def test_batch_scheduler_sequence_equals_jax():
    """Ticks with locality and a node mask, update_node between them: each
    tick folds its count into the key, as JAX's does."""
    avail = uniform_cluster(6, cpu=4)
    js = jk.BatchScheduler(avail, seed=3, chunk=64)
    ts = tk.BatchScheduler(avail, seed=3, chunk=64, device="cpu")
    assert ts.avail.device.type == "cpu"
    rng = np.random.default_rng(3)
    for tick in range(8):
        demand = np.zeros((40, 4), np.int32)
        demand[:, 0] = rng.choice([500, 1000, 2000], size=40)
        kw = {}
        if tick % 3 == 1:
            kw["locality"] = rng.integers(-1, 6, size=40).astype(np.int32)
            kw["node_mask"] = np.array([1, 0, 1, 1, 0, 1], bool)
        want = js.place(demand, **kw)
        got = ts.place(demand, **kw)
        np.testing.assert_array_equal(got, want)
        if tick == 4:
            row = np.array([0, 0, 0, 0], np.int32)
            js.update_node(2, row)
            ts.update_node(2, row)
    np.testing.assert_array_equal(ts.avail.numpy(), np.asarray(js.avail))


def test_batch_scheduler_overflow_guard_raises_as_jax():
    big = uniform_cluster(2, cpu=300.0)       # 300,000 a node
    for cls, kw in ((jk.BatchScheduler, {}),
                    (tk.BatchScheduler, {"device": "cpu"})):
        with pytest.raises(ValueError, match="int32 admission-scan range"):
            cls(big, chunk=8192, **kw)
        sched = cls(uniform_cluster(2), chunk=8192, **kw)
        with pytest.raises(ValueError, match="int32 admission-scan range"):
            sched.update_node(1, np.array([300_000, 0, 0, 0], np.int32))


# ------------------------------------------------------ reference, dag, paths


@pytest.mark.parametrize("case", ["random_dag", "locality_mask",
                                  "survivors"])
def test_port_reference_equals_jax_reference(case):
    demand, parents = random_dag(300, num_classes=6, seed=4)
    avail = uniform_cluster(5, cpu=6)
    kw = dict(chunk=128)
    if case == "locality_mask":
        kw.update(locality=np.random.default_rng(4).integers(
            -1, 5, size=300).astype(np.int32),
                  node_mask=np.array([1, 1, 0, 1, 1], bool))
    if case == "survivors":
        demand, parents, avail, extra = _survivor_mix(1)
        kw.update(chunk=extra["chunk"])
    want, wrounds = jr.schedule_dag_reference(demand, parents, avail,
                                              jkey(4), **kw)
    got, grounds = tr.schedule_dag_reference(demand, parents, avail,
                                             tk.prng_key(4), **kw)
    np.testing.assert_array_equal(got, want)
    assert grounds == wrounds


@pytest.mark.parametrize("case", ["pure_chain", "random_dag", "locality"])
def test_schedule_dag_collapsed_reference_equals_the_pass(case):
    """The port's scalar mirror of the chain-collapsed entry gives
    schedule_dag_collapsed's placements and rounds, bit for bit."""
    locality = None
    if case == "pure_chain":
        demand = np.full((400, 1), 1000, np.int32)
        parents = (np.arange(400, dtype=np.int32) - 1).reshape(-1, 1)
        avail, chunk = uniform_cluster(4, cpu=2.0)[:, :1], 64
    else:
        demand, parents = random_dag(300, parent_window=8, seed=5)
        avail, chunk = uniform_cluster(5, cpu=6), 64
        if case == "locality":
            locality = np.random.default_rng(5).integers(
                -1, 5, size=300).astype(np.int32)
    got, grounds = tk.schedule_dag_collapsed(
        demand, parents, avail, tk.prng_key(5), locality=locality,
        chunk=chunk, device="cpu")
    want, wrounds = tr.schedule_dag_collapsed_reference(
        demand, parents, avail, tk.prng_key(5), locality=locality,
        chunk=chunk)
    np.testing.assert_array_equal(got, want)
    assert grounds == wrounds


def test_dag_generators_equal_jax():
    for a, b in ((random_dag(500, seed=1), tdag.random_dag(500, seed=1)),
                 (fanout_dag(50), tdag.fanout_dag(50)),
                 (chain_rounds_dag(4, 5), tdag.chain_rounds_dag(4, 5))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(uniform_cluster(3, cpu=2, tpu=1),
                                  tdag.uniform_cluster(3, cpu=2, gpu=1))
    demand, parents = random_dag(300, parent_window=8, seed=2)
    locality = np.where(np.arange(300) % 7 == 0, 1, -1)
    for x, y in zip(collapse_chains(demand, parents, locality),
                    tdag.collapse_chains(demand, parents, locality)):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_longest_paths_equal_jax(seed):
    rng = random.Random(seed)
    n = rng.randint(1, 160)
    _, parr = random_dag(n, max_parents=rng.randint(1, 4),
                         parent_window=rng.randint(1, 64), seed=seed)
    parents = jcp.parents_from_array(parr)
    assert tcp.parents_from_array(parr) == parents
    exec_us = [rng.randrange(0, 5) * 1000 for _ in range(n)]
    want = jcp.longest_path_ref(exec_us, parents)
    assert tcp.longest_path_ref(exec_us, parents) == want
    assert list(tcp.longest_path_vec(exec_us, parents)) == want


def _rows(parents, exec_s, gap):
    rows, t = [], 1000.0
    for i, ps in enumerate(parents):
        t += gap
        w0 = t
        t += exec_s
        rows.append({
            "task_id": f"{i:032x}", "kind": "task", "state": "FINISHED",
            "name": f"t{i}", "node_id": f"n{i % 3}", "pending_reason": "",
            "deps": [f"{p:032x}" for p in ps], "ts_submit": 1000.0,
            "ts_dispatch": w0 - gap / 2, "ts_exec_start": w0,
            "ts_exec_end": t, "ts_finish": t, "exec_s": exec_s,
            "reason_s": {"waiting-for-capacity": gap / 4}})
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_profile_rows_equal_jax(seed):
    rng = random.Random(100 + seed)
    _, parr = random_dag(rng.randint(2, 80), seed=seed)
    rows = _rows(jcp.parents_from_array(parr), rng.uniform(0.001, 0.02),
                 rng.uniform(0.0, 0.01))
    assert tcp.profile_rows(rows, job_id="j", now=2000.0) == \
        jcp.profile_rows(rows, job_id="j", now=2000.0)
    assert tcp.chrome_trace(rows, "j") == jcp.chrome_trace(rows, "j")


# --------------------------------------------------- the north-star digest


def _chip_smoke_constants():
    text = (ROOT / "chip_smoke.py").read_text()
    sha = re.search(r'^SCHED_A_SHA256 = "([0-9a-f]{64})"$', text, re.M)
    rounds = re.search(r"^SCHED_A_ROUNDS = (\d+)$", text, re.M)
    assert sha and rounds, "chip_smoke.py must define both constants"
    return sha.group(1), int(rounds.group(1))


def _workload_a():
    demand, parents = random_dag(100_000, max_parents=3,
                                 parent_window=100_000, seed=0)
    return demand, parents, uniform_cluster(256, cpu=16.0)


def test_jax_kernel_gives_chip_smokes_digest_on_workload_a():
    """The JAX package places bench.py's 100k-task, 256-node DAG at
    PRNGKey(0) in the rounds and with the placement bytes whose sha256
    chip_smoke.py holds the card to (that machine has no JAX)."""
    sha, rounds = _chip_smoke_constants()
    demand, parents, avail = _workload_a()
    placement, got_rounds = jk.schedule_dag(demand, parents, avail, jkey(0),
                                            chunk=8192)
    placement = np.asarray(placement).astype(np.int32)
    assert int(got_rounds) == rounds
    assert int((placement >= 0).sum()) == 100_000
    assert hashlib.sha256(placement.tobytes()).hexdigest() == sha
