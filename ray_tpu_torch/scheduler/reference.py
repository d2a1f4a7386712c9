"""Scalar reference implementation of the placement spec.

The sequential, obviously-correct version of the kernel's semantics — the
analogue of running the reference's per-task C++ loop
(``scheduling_policy.cc:31-134``) against which the batched kernel is
verified. ``schedule_dag`` (kernel.py) must produce bit-identical placements
for any input.

Uses the same threefry draws via ``task_bits_host`` (numpy, kernel.py) so
randomness matches exactly; ``key`` is the (2,) uint32 pair of
``kernel.prng_key``. The port's copy of ``ray_tpu/scheduler/reference.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .kernel import (
    INFEASIBLE,
    NO_PLACEMENT,
    PACK,
    REASON_INFEASIBLE,
    REASON_PLACED,
    REASON_QUOTA_THROTTLED,
    REASON_WAITING_CAPACITY,
    REASON_WAITING_DEPS,
    REASON_WAITING_PG,
    SPREAD,
    STRICT_PACK,
    STRICT_SPREAD,
    task_bits_host,
)


def schedule_dag_reference(
    demand: np.ndarray,
    parents: np.ndarray,
    avail: np.ndarray,
    key,
    locality: Optional[np.ndarray] = None,
    node_mask: Optional[np.ndarray] = None,
    chunk: int = 8192,
    max_rounds: int = 0,
) -> Tuple[np.ndarray, int]:
    demand = np.asarray(demand, dtype=np.int64)
    parents = np.asarray(parents, dtype=np.int64)
    avail = np.asarray(avail, dtype=np.int64)
    T, R = demand.shape
    N = avail.shape[0]
    if max_rounds <= 0:
        max_rounds = T + 1
    if locality is None:
        locality = np.full(T, -1, dtype=np.int64)
    # Schedulable-node mask (False = draining): a masked node is
    # infeasible for every task, same spec as the kernel's node_mask.
    mask = (np.ones(N, dtype=bool) if node_mask is None
            else np.asarray(node_mask, dtype=bool))

    feas_any = ((demand[:, None, :] <= avail[None, :, :]).all(-1)
                & mask[None, :]).any(-1)
    placement = np.where(feas_any, NO_PLACEMENT, INFEASIBLE).astype(np.int64)

    round_idx = 0
    while round_idx < max_rounds:
        placed = placement >= 0
        parent_ok = np.ones(T, dtype=bool)
        for k in range(parents.shape[1]):
            p = parents[:, k]
            has = p >= 0
            parent_ok &= ~has | placed[np.clip(p, 0, T - 1)]
        ready = (placement == NO_PLACEMENT) & parent_ok
        ready_idx = np.nonzero(ready)[0][:chunk]
        if len(ready_idx) == 0:
            break

        bits = task_bits_host(key, round_idx, np.asarray(ready_idx))
        # Pass 1 — prefix-sum admission: accumulate the demand of every
        # task that *prefers* a node (admitted or not), in submission
        # order.
        prefix = np.zeros((N, R), dtype=np.int64)
        survivors = []  # (pick, demand_sum, j, t) for deferred tasks
        used = np.zeros((N, R), dtype=np.int64)
        for j, t in enumerate(ready_idx):
            feas = (demand[t] <= avail).all(axis=1) & mask
            cnt = int(feas.sum())
            if cnt == 0:
                continue
            r = int(bits[j] % np.uint32(cnt))
            pick = int(np.nonzero(feas)[0][r])
            loc = int(locality[t])
            if loc >= 0 and feas[loc]:
                pick = loc
            prefix[pick] += demand[t]
            if (prefix[pick] <= avail[pick]).all():
                placement[t] = pick
                used[pick] += demand[t]
            else:
                survivors.append((pick, int(demand[t].sum()), j, t))
        # Pass 2 — survivors vs residual capacity, ascending demand within
        # each node (ties: submission order), prefix counting every
        # survivor in the stream (admitted or not) — mirrors the kernel's
        # second sort+scan bit-for-bit.
        residual = avail - used
        prefix2 = np.zeros((N, R), dtype=np.int64)
        for pick, _, _, t in sorted(survivors):
            prefix2[pick] += demand[t]
            if (prefix2[pick] <= residual[pick]).all():
                placement[t] = pick
            # else: deferred; retries next round with a fresh draw
        round_idx += 1

    return placement.astype(np.int32), round_idx


def classify_pending_reference(demand, placement, totals, waiting_deps,
                               waiting_pg, quota) -> np.ndarray:
    """Scalar spec of ``kernel.classify_pending`` (bit-identical by the
    same contract as the placement/gang references): one sequential pass
    attributing every unplaced task to exactly one pending reason. The
    GCS serves with THIS implementation (pending sets are small off the
    happy path), which is exactly why the kernel must reproduce it
    bit-for-bit."""
    demand = np.asarray(demand, dtype=np.int64)
    placement = np.asarray(placement, dtype=np.int64)
    totals = np.asarray(totals, dtype=np.int64)
    waiting_deps = np.asarray(waiting_deps, dtype=bool)
    waiting_pg = np.asarray(waiting_pg, dtype=bool)
    quota = np.asarray(quota, dtype=bool)
    T = demand.shape[0]
    out = np.empty(T, dtype=np.int32)
    for t in range(T):
        if placement[t] >= 0:
            out[t] = REASON_PLACED
        elif waiting_deps[t]:
            out[t] = REASON_WAITING_DEPS
        elif quota[t]:
            out[t] = REASON_QUOTA_THROTTLED
        elif waiting_pg[t]:
            out[t] = REASON_WAITING_PG
        elif totals.shape[0] and (demand[t] <= totals).all(axis=1).any():
            out[t] = REASON_WAITING_CAPACITY
        else:
            out[t] = REASON_INFEASIBLE
    return out


def admit_gangs_reference(demand, group, strategy, avail, key,
                          round_idx: int = 0):
    """Scalar spec of ``kernel.admit_gangs`` (bit-identical by the same
    contract as ``schedule_dag_reference``): sequential, obviously
    all-or-nothing gang admission. The GCS serves placement groups with
    THIS implementation (gang counts are tiny; numpy beats a compile),
    which is exactly why the kernel must reproduce it bit-for-bit — the
    two stay interchangeable per tick."""
    demand = np.asarray(demand, dtype=np.int64)
    group = np.asarray(group, dtype=np.int64)
    strategy = np.asarray(strategy, dtype=np.int64)
    avail = np.asarray(avail, dtype=np.int64)
    B = demand.shape[0]
    N = avail.shape[0]
    G = strategy.shape[0]
    placement = np.full(B, NO_PLACEMENT, dtype=np.int64)
    if B == 0 or G == 0:
        return placement.astype(np.int32)

    bundles_of = [[] for _ in range(G)]
    for i in range(B):
        g = int(group[i])
        if g >= 0:
            bundles_of[g].append(i)

    if N == 0:
        for g in range(G):
            if strategy[g] == STRICT_SPREAD and bundles_of[g]:
                for i in bundles_of[g]:
                    placement[i] = INFEASIBLE
        return placement.astype(np.int32)

    bits = task_bits_host(key, round_idx, np.arange(G, dtype=np.int32))

    # Phase 1 — candidates: one node per bundle under the group strategy.
    cand: dict = {}
    group_ready = [False] * G
    for g in range(G):
        idxs = bundles_of[g]
        if not idxs:
            continue
        s = int(strategy[g])
        start = int(bits[g] % np.uint32(N))
        total = demand[idxs].sum(axis=0)
        packfeas = (total <= avail).all(axis=1)
        packcnt = int(packfeas.sum())
        ok = True
        picks = {}
        for rank, i in enumerate(idxs):
            feas_i = (demand[i] <= avail).all(axis=1)
            cnt = int(feas_i.sum())
            if s == STRICT_PACK or (s == PACK and packcnt > 0):
                if packcnt == 0:
                    ok = False
                    break
                r = int(bits[g] % np.uint32(packcnt))
                picks[i] = int(np.nonzero(packfeas)[0][r])
            elif s == STRICT_SPREAD:
                if len(idxs) > N:
                    ok = False
                    break
                pick = (start + rank) % N
                if not feas_i[pick]:
                    ok = False
                    break
                picks[i] = pick
            else:  # SPREAD, or PACK with no single node fitting the total
                if cnt == 0:
                    ok = False
                    break
                r = (start + rank) % cnt
                picks[i] = int(np.nonzero(feas_i)[0][r])
        if ok:
            group_ready[g] = True
            cand.update(picks)

    # Phase 2 — admission: one prefix stream over every admissible
    # group's bundles in submission order, segmented by candidate node;
    # a group is admitted iff ALL its bundles' prefixes fit.
    prefix = np.zeros_like(avail)
    fits = np.zeros(B, dtype=bool)
    for i in range(B):
        g = int(group[i])
        if g < 0 or not group_ready[g]:
            continue
        pick = cand[i]
        prefix[pick] += demand[i]
        fits[i] = bool((prefix[pick] <= avail[pick]).all())

    for g in range(G):
        idxs = bundles_of[g]
        if not idxs:
            continue
        if strategy[g] == STRICT_SPREAD and len(idxs) > N:
            for i in idxs:
                placement[i] = INFEASIBLE
            continue
        if group_ready[g] and all(fits[i] for i in idxs):
            for i in idxs:
                placement[i] = cand[i]
    return placement.astype(np.int32)


def score_locality_reference(input_bytes: np.ndarray) -> np.ndarray:
    """Scalar reference for the data plane's locality pass.

    ``input_bytes`` is ``[T, N]`` int64: bytes of task ``t``'s inputs
    already resident on node ``n`` (the GCS directory's size+location
    columns joined over the alive-node order). Returns ``[T]`` int32: the
    preferred node index per task, or ``-1`` when no node holds any input
    bytes (the placement pass then falls back to pure capacity order).

    Semantics the kernel must match bit-for-bit: prefer the node holding
    the LARGEST input bytes; ties keep the LOWEST node index (the existing
    capacity order). Zero rows score -1 — "no preference" beats "prefer
    node 0 for no reason".
    """
    b = np.asarray(input_bytes, dtype=np.int64)
    if b.ndim != 2:
        raise ValueError(f"input_bytes must be [T, N], got {b.shape}")
    T, N = b.shape
    out = np.full(T, -1, dtype=np.int32)
    for t in range(T):
        best_bytes = 0
        best_node = -1
        for n in range(N):
            v = int(b[t, n])
            if v > best_bytes:  # strictly greater: ties keep lowest index
                best_bytes = v
                best_node = n
        out[t] = best_node
    return out


def schedule_dag_collapsed_reference(
    demand: np.ndarray,
    parents: np.ndarray,
    avail: np.ndarray,
    key,
    locality: Optional[np.ndarray] = None,
    chunk: int = 8192,
    max_rounds: int = 0,
) -> Tuple[np.ndarray, int]:
    """Scalar reference of ``schedule_dag_collapsed``: the same chain
    collapse (``dag.collapse_chains``), the reduced DAG placed by
    ``schedule_dag_reference``, each head's node broadcast to its chain."""
    from .dag import collapse_chains

    r_demand, r_parents, r_locality, expand = collapse_chains(
        np.asarray(demand), np.asarray(parents), locality)
    placement, rounds = schedule_dag_reference(
        r_demand, r_parents, avail, key, locality=r_locality, chunk=chunk,
        max_rounds=max_rounds)
    return np.asarray(placement)[expand], int(rounds)
