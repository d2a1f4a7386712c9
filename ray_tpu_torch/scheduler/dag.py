"""Benchmark DAG and cluster generators.

Workload shapes mirror the reference's stress suite
(``ci/regression_test/stress_tests/test_many_tasks.py``): wide no-op fan-outs
(stage 1), chained dependency rounds (stage 2), plus mixed-class random DAGs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .._private.resources import KILO, NUM_PREDEFINED


def uniform_cluster(num_nodes: int, cpu: float = 16.0, mem_gb: float = 64.0,
                    gpu: float = 0.0) -> np.ndarray:
    """[N, R] availability matrix in fixed-point kilo-units."""
    avail = np.zeros((num_nodes, NUM_PREDEFINED), dtype=np.int32)
    avail[:, 0] = int(cpu * KILO)
    avail[:, 1] = int(mem_gb * KILO)
    avail[:, 2] = int(gpu * KILO)
    return avail


def random_dag(
    num_tasks: int,
    max_parents: int = 3,
    num_classes: int = 4,
    parent_window: int = 1024,
    edge_prob: float = 0.5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random layered DAG: (demand [T, R], parents [T, K]).

    Task t draws parents from the preceding ``parent_window`` tasks, so depth
    grows with T while keeping wide waves (the scheduling-heavy regime).
    Demands are drawn from ``num_classes`` scheduling classes (CPU 0.5-4).
    """
    rng = np.random.default_rng(seed)
    T, K = num_tasks, max_parents

    classes = np.zeros((num_classes, NUM_PREDEFINED), dtype=np.int32)
    classes[:, 0] = rng.choice([KILO // 2, KILO, 2 * KILO, 4 * KILO], num_classes)
    classes[:, 1] = rng.integers(KILO // 4, 4 * KILO, num_classes)
    demand = classes[rng.integers(0, num_classes, T)]

    parents = np.full((T, K), -1, dtype=np.int32)
    has_parent = rng.random((T, K)) < edge_prob
    lo = np.maximum(0, np.arange(T) - parent_window)
    span = np.maximum(1, np.arange(T) - lo)
    draws = lo[:, None] + (rng.random((T, K)) * span[:, None]).astype(np.int64)
    mask = has_parent & (np.arange(T) > 0)[:, None]
    parents[mask] = draws[mask].astype(np.int32)
    return demand, parents


def fanout_dag(num_tasks: int, cpu: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stage-1 shape: independent no-op tasks (test_many_tasks.py:63-66)."""
    demand = np.zeros((num_tasks, NUM_PREDEFINED), dtype=np.int32)
    demand[:, 0] = int(cpu * KILO)
    parents = np.full((num_tasks, 1), -1, dtype=np.int32)
    return demand, parents


def chain_rounds_dag(rounds: int, width: int,
                     cpu: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stage-2 shape: each round's tasks depend on the previous round
    (test_many_tasks.py:75-86: 20 rounds x 500 tasks)."""
    T = rounds * width
    demand = np.zeros((T, NUM_PREDEFINED), dtype=np.int32)
    demand[:, 0] = int(cpu * KILO)
    parents = np.full((T, 1), -1, dtype=np.int32)
    for r in range(1, rounds):
        start = r * width
        # depend on one task of the previous round (ring offset)
        parents[start : start + width, 0] = np.arange(width) + (r - 1) * width
    return demand, parents


def collapse_chains(
    demand: np.ndarray,       # [T, R]
    parents: np.ndarray,      # [T, K]
    locality: Optional[np.ndarray] = None,  # [T] preferred node or -1
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Collapse linear chains into super-tasks before kernel placement.

    A task with exactly one parent whose parent has exactly one child runs
    strictly after it and (absent a locality hint) is best co-located with
    it — so the pair needs no scheduling round of its own. Chains collapse
    to their head with demand = elementwise max over members (members run
    sequentially, holding at most one member's resources at a time).

    This removes the pure-chain worst case of one-task-per-round placement
    (the reference hits the same wall: one DispatchTasks pass per newly
    ready task, scheduling_policy.cc:31). Returns
    ``(demand', parents', locality', expand)`` where ``expand[t]`` is the
    reduced-problem index whose placement task ``t`` inherits.
    """
    T, K = parents.shape
    in_deg = (parents >= 0).sum(axis=1)
    single_parent = in_deg == 1
    the_parent = np.where(single_parent, parents.max(axis=1), -1)
    out_deg = np.zeros(T, dtype=np.int64)
    edges = parents[parents >= 0]
    np.add.at(out_deg, edges, 1)

    merge = single_parent & (the_parent >= 0)
    merge &= out_deg[np.maximum(the_parent, 0)] == 1
    if locality is not None:
        merge &= np.asarray(locality) < 0  # hinted tasks anchor their own row

    # Chain representative by pointer jumping (parents precede children, so
    # this terminates in O(log chain_len) rounds).
    rep = np.arange(T, dtype=np.int64)
    rep[merge] = the_parent[merge]
    while True:
        nxt = rep[rep]
        if np.array_equal(nxt, rep):
            break
        rep = nxt

    # Chain demand: elementwise max over members, accumulated at the head.
    head_demand = demand.copy()
    np.maximum.at(head_demand, rep, demand)

    heads = np.flatnonzero(rep == np.arange(T))
    new_id = np.full(T, -1, dtype=np.int64)
    new_id[heads] = np.arange(len(heads))

    reduced_parents = parents[heads].copy()
    live = reduced_parents >= 0
    # A head's parent may itself sit inside a chain: inherit its rep.
    reduced_parents[live] = new_id[rep[reduced_parents[live]]].astype(
        parents.dtype)
    reduced_locality = None if locality is None else np.asarray(locality)[heads]
    expand = new_id[rep]
    return head_demand[heads], reduced_parents, reduced_locality, expand
