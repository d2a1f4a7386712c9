"""The batch placement passes, as torch ops on the card (counterpart:
``ray_tpu/scheduler/kernel.py``, whose five ``jax.jit`` programs these
carry op for op, bit for bit).

Replaces the reference's per-task scheduling loop
(``src/ray/raylet/scheduling_policy.cc:31-134``: for each placeable task,
feasibility = ``ResourceSet::IsSubset`` against each node's available-load
(cc:75), uniform-random pick among feasible (cc:85), load bump (cc:91-93))
with a data-parallel spec placed a round at a time:

  round r:
    1. ready    = unplaced tasks whose parents are all placed (wavefront)
    2. chunk    = first C ready tasks in submission order
    3. feasible = demand[t] <= avail[n]  (exact fixed-point IsSubset)
    4. pick     = locality node if feasible, else the k-th feasible node,
                  k = threefry_bits(key, round, t) mod n_feasible
    5. admit    = prefix-sum capacity: task t is admitted iff the cumulative
                  demand of ALL chunk tasks preferring pick[t] up to and
                  including t fits in avail[pick[t]]
    6. pass 2   = the deferred tasks re-run the same prefix-sum against the
                  RESIDUAL capacity (avail minus pass-1 admissions), ordered
                  smallest-demand-first per node; still-deferred tasks retry
                  in round r+1 with a fresh pick.

The spec (and its deliberate difference from the C++ loop: prefix sums over
*preferring* tasks) is the JAX package's; ``reference.py`` is its scalar
form, which these passes must match bit for bit. The RNG is threefry2x32,
written out here in integer ops (``_threefry2x32``): the same function
serves numpy on the host and torch on the card, so both give JAX's bits.

How the JAX constructs map to torch:
  * ``lax.while_loop`` is a host loop whose condition reads one bool from
    the card a round (the one device-to-host sync a round); the last round
    a cap allows runs unconditionally and counts itself on the card, so a
    one-round tick (``BatchScheduler``) never waits inside the loop.
  * ``jnp.nonzero(size=C, fill_value=T)`` is ``torch.nonzero_static``,
    which keeps the static size without a sync.
  * The ``lax.cond`` around pass 2 is dropped: pass 2 runs every round.
    When no survivor fits its node's residual, no survivor's prefix (at
    least its own demand) fits either, so it admits nothing and the bits
    are the same; a guard would cost a second sync a round.
  * Demands and capacities are int32 as in JAX; the cumulative sums are
    int64 (torch's ``cumsum`` of int32), which equals JAX's int32 sums
    wherever those do not wrap, i.e. under the same overflow guard.
  * ``argmax`` over a boolean mask runs on int8 (torch's ``argmax`` takes
    no bool); both return the first maximal index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import Device, default_device

# The placement passes: the JAX package's jax.jit programs, and the chain
# collapse around schedule_dag. Each has its scalar mirror
# ``<name>_reference`` in reference.py, or is the spec itself (the threefry
# draw, whose host twin reference.py imports); the linter's kernel-purity
# rule holds them to that and to pure bodies (ray_tpu_torch/devtools/lint).
PASSES = ("task_bits", "schedule_dag", "admit_gangs", "classify_pending",
          "score_locality", "schedule_dag_collapsed")

NO_PLACEMENT = -1   # not (yet) placed
INFEASIBLE = -2     # cannot fit on any node even when idle

# Placement-group strategies. Codes are part of the gang-admission spec
# shared by admit_gangs / admit_gangs_reference.
PACK, SPREAD, STRICT_PACK, STRICT_SPREAD = 0, 1, 2, 3
STRATEGY_CODES = {"PACK": PACK, "SPREAD": SPREAD,
                  "STRICT_PACK": STRICT_PACK,
                  "STRICT_SPREAD": STRICT_SPREAD}

# Pending-reason codes (the scheduling-explainability spec shared by
# classify_pending / classify_pending_reference — bit-identical by the
# same contract as gang admission). Every task a placement tick leaves
# unplaced gets exactly one reason; precedence is fixed:
# deps > quota > pg > infeasible > capacity.
REASON_PLACED = 0            # placement >= 0: not pending at all
REASON_WAITING_DEPS = 1      # an argument has no live copy yet
REASON_WAITING_CAPACITY = 2  # fits the fleet's totals; nodes busy now
REASON_INFEASIBLE = 3        # fits NO node even idle (autoscaler's cue)
REASON_WAITING_PG = 4        # member of a not-yet-CREATED placement group
REASON_QUOTA_THROTTLED = 5   # held back by an admission quota/weight
REASON_NAMES = ("placed", "waiting-for-deps", "waiting-for-capacity",
                "infeasible", "waiting-for-pg", "quota-throttled")

_INT32_MAX = 2 ** 31 - 1

# ----------------------------------------------------------------- threefry

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """threefry2x32 (20 rounds) of the counter words (x0, x1) under the key
    (k0, k1), as JAX computes it. Operands are Python ints, or int64 numpy
    arrays or torch tensors holding values in [0, 2^32): torch has no
    uint32 shifts, so 32-bit words ride in int64 and are masked. Between
    masks x0 only gathers carries above bit 31 (at most 2^38 here), which
    never reach the low 32 bits that the rotation of x1 reads."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0 & _M32, x1


def _key_ints(key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def prng_key(seed: int) -> np.ndarray:
    """JAX's ``PRNGKey(seed)`` for the threefry RNG: the pair (0, seed) as a
    (2,) uint32 array (seed in [0, 2^32))."""
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return np.array([0, int(seed)], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """JAX's ``random.fold_in(key, data)``: threefry2x32 of (0, data)."""
    k0, k1 = _key_ints(key)
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _M32),
                    dtype=np.uint32)


def _bits_of(k0, k1, task):
    """32 random bits per task: JAX's ``bits(fold_in(k, t))``, the XOR of
    the two words of threefry2x32 of (0, 0) under the folded key."""
    f0, f1 = _threefry2x32(k0, k1, 0, task)
    b0, b1 = _threefry2x32(f0, f1, 0, 0)
    return b0 ^ b1


def task_bits(key, round_idx: int, task_idx: torch.Tensor) -> torch.Tensor:
    """The per-(round, task) draw both implementations share, on the device
    of ``task_idx``: int64 values in [0, 2^32)."""
    k0, k1 = _key_ints(fold_in(key, round_idx))
    return _bits_of(k0, k1, task_idx.to(torch.int64) & _M32)


def task_bits_host(key, round_idx, task_idx: np.ndarray) -> np.ndarray:
    """The same draw in numpy, as uint32 (no padding width: numpy compiles
    nothing per shape)."""
    k0, k1 = _key_ints(fold_in(key, round_idx))
    t = np.asarray(task_idx, dtype=np.int64) & _M32
    return _bits_of(k0, k1, t).astype(np.uint32)


# ---------------------------------------------------------- inputs, device


def _device_of(device: Device, *inputs) -> torch.device:
    """The device a pass runs on: ``device`` when given, else that of its
    tensor inputs, else the card (raising when there is none). A CUDA input
    is never moved to the CPU."""
    if device is None:
        device = next((x.device for x in inputs
                       if isinstance(x, torch.Tensor)), None)
    dev = default_device(device)
    for x in inputs:
        if (isinstance(x, torch.Tensor) and x.device.type == "cuda"
                and dev.type != "cuda"):
            raise ValueError(
                f"a CUDA input is not moved to the {dev.type}; pass "
                f"device='cuda' or host inputs")
    return dev


def _to(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` gives it on a boolean mask."""
    return mask.to(torch.int8).argmax(-1)


def _kth_true(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Index of the (k+1)-th True of each row of ``mask`` (0 when none)."""
    return _first_true((mask.cumsum(-1) == (k + 1)[:, None]) & mask)


def _segmented_admit(d: torch.Tensor, node_key: torch.Tensor,
                     order: torch.Tensor, capacity: torch.Tensor
                     ) -> torch.Tensor:
    """Sort-based segmented prefix-sum admission (``segmented_admit`` and
    admit_gangs' stream in JAX): rows arrive in ``order`` (grouped by
    node_key ascending; key N = ignore), demands cumsum per node segment,
    a row is admitted while its prefix fits capacity[node].

    The scans run along the last axis of [R, C] (resources by rows): on
    CUDA torch scans a tall [C, R] along its first axis one thread a
    column, which took 85% of a round's device time at C = 8192 on an
    H100."""
    N = capacity.shape[0]
    sorted_pick = node_key[order]
    in_node = sorted_pick < N
    sorted_d = (d[order] * in_node[:, None]).T.contiguous()     # [R, C]
    cum = sorted_d.cumsum(1)                                 # int64
    seg_start = torch.ones_like(in_node)
    seg_start[1:] = sorted_pick[1:] != sorted_pick[:-1]
    # cumulative value just before each segment start (cum - own demand),
    # carried forward by a running max: cum is componentwise nondecreasing.
    base = torch.where(seg_start, cum - sorted_d, 0)
    prefix = cum - torch.cummax(base, 1).values
    cap = capacity[sorted_pick.clamp_max(N - 1)].T
    ok = (prefix <= cap).all(0) & in_node
    return torch.zeros_like(ok).scatter_(0, order, ok)


# -------------------------------------------------------------- schedule_dag


class _DagRounds:
    """One ``schedule_dag`` call's state on its device: ``ready()`` and
    ``step()`` are the condition and the body of JAX's while loop."""

    def __init__(self, demand, parents, avail, key, locality, node_mask,
                 chunk: int, dev: torch.device):
        demand = _to(demand, torch.int32, dev)
        self.avail = _to(avail, torch.int32, dev)
        parents = _to(parents, torch.int64, dev)
        T, R = demand.shape
        self.T, self.N, self.chunk, self.key = T, self.avail.shape[0], \
            chunk, key
        self.mask = (None if node_mask is None
                     else _to(node_mask, torch.bool, dev))
        # Tasks that cannot fit on any idle node are permanently
        # infeasible; their descendants never become ready.
        feas_any = (demand[:, None, :] <= self.avail[None]).all(-1)
        if self.mask is not None:
            feas_any &= self.mask[None, :]
        first = torch.where(feas_any.any(-1), NO_PLACEMENT, INFEASIBLE)
        # Two sentinel slots: T takes the fill rows' writes (JAX's
        # mode="drop"), T + 1 stands for "no parent" and reads as placed.
        self.placement = torch.cat([
            first.to(torch.int32),
            torch.full((1,), NO_PLACEMENT, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev)])
        # A parent index past the tasks (the caller's error) reads slot T,
        # never placed, so no index can fault on the card.
        self.parent_idx = torch.where(parents < 0, T + 1,
                                      parents.clamp_max(T))
        self.demand = torch.cat(
            [demand, torch.zeros((1, R), dtype=torch.int32, device=dev)])
        loc = (torch.full((T,), -1, dtype=torch.int64, device=dev)
               if locality is None else _to(locality, torch.int64, dev))
        loc = torch.where(loc < self.N, loc, -1)  # no node past N: no hint
        self.locality = torch.cat(
            [loc, torch.full((1,), -1, dtype=torch.int64, device=dev)])

    def ready(self) -> torch.Tensor:
        placed = self.placement >= 0
        parent_ok = placed[self.parent_idx].all(1)
        return (self.placement[:self.T] == NO_PLACEMENT) & parent_ok

    def step(self, round_idx: int, ready: torch.Tensor) -> None:
        T, N, avail = self.T, self.N, self.avail
        idx = torch.nonzero_static(ready, size=self.chunk,
                                   fill_value=T)[:, 0]           # [C]
        valid = idx < T
        d = self.demand[idx]                                     # [C, R]
        feas = (d[:, None, :] <= avail[None]).all(-1) & valid[:, None]
        if self.mask is not None:
            feas &= self.mask[None, :]
        cnt = feas.sum(-1)
        # bits % cnt: the uint32 modulo of JAX, on non-negative int64.
        r = task_bits(self.key, round_idx, idx) % cnt.clamp_min(1)
        pick = _kth_true(feas, r)
        # Locality fusion: prefer the hinted node when it is feasible.
        loc = self.locality[idx]
        loc_ok = (loc >= 0) & feas.gather(1, loc.clamp_min(0)[:, None])[:, 0]
        pick = torch.where(loc_ok, loc, pick)
        schedulable = valid & (cnt > 0)

        # Pass 1: stable sort by picked node (ties keep submission order).
        sort_key = torch.where(schedulable, pick, N)
        fits = _segmented_admit(d, sort_key,
                                torch.argsort(sort_key, stable=True), avail)
        # Pass 2: survivors vs RESIDUAL capacity, smallest demand first.
        surv = schedulable & ~fits
        used = torch.zeros_like(avail).index_add_(
            0, pick, d * (fits & schedulable)[:, None])
        o1 = torch.argsort(torch.where(surv, d.sum(-1), _INT32_MAX),
                           stable=True)
        key2 = torch.where(surv, pick, N)
        order2 = o1[torch.argsort(key2[o1], stable=True)]
        fits2 = _segmented_admit(d, key2, order2, avail - used)

        new = torch.where((fits | fits2) & schedulable, pick, NO_PLACEMENT)
        self.placement.scatter_(0, idx, new.to(torch.int32))


def schedule_dag(
    demand,                 # [T, R] int32 fixed-point demands
    parents,                # [T, K] int32 parent task indices, -1 = none
    avail,                  # [N, R] int32 per-node available resources
    key,                    # (2,) uint32 threefry key (prng_key)
    locality=None,          # [T] int32 preferred node or -1
    node_mask=None,         # [N] bool, False = unschedulable
    chunk: int = 8192,
    max_rounds: int = 0,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schedule a whole DAG; returns (placement [T] int32, num_rounds, a
    0-d int32 tensor), both on the device it ran on: ``device``, else that
    of the tensor inputs, else the card.

    ``node_mask`` hides nodes from every placement decision without
    removing their rows (a draining node's held shares must stay visible
    to the residual accounting): a False node is infeasible for every
    task."""
    dev = _device_of(device, demand, parents, avail, locality, node_mask)
    st = _DagRounds(demand, parents, avail, key, locality, node_mask, chunk,
                    dev)
    # Each round with a ready task places one at least, so no round past
    # the T-th has one: JAX's default cap of T + 1 rounds is T here.
    max_rounds = st.T if max_rounds <= 0 else min(max_rounds, st.T)
    r = 0
    while r < max_rounds:
        ready = st.ready()
        if r + 1 == max_rounds:
            # The last round the cap allows: with nothing ready it places
            # nothing, so it runs unconditionally and counts on the card.
            st.step(r, ready)
            return st.placement[:st.T], ready.any().to(torch.int32) + r
        if not bool(ready.any()):   # the loop's condition: one sync a round
            break
        st.step(r, ready)
        r += 1
    return st.placement[:st.T], torch.full((), r, dtype=torch.int32,
                                           device=dev)


# ----------------------------------------------------------------- admit_gangs


def admit_gangs(
    demand: torch.Tensor,   # [B, R] int32 bundle demands (padding rows zero)
    group: torch.Tensor,    # [B] int32 group index, ascending-contiguous
    #                         (bundles of a group adjacent, in submission
    #                         order); -1 marks padding rows
    strategy: torch.Tensor,  # [G] int32 strategy code (PACK..STRICT_SPREAD)
    avail: torch.Tensor,    # [N, R] int32 per-node availability
    key,                    # (2,) uint32 threefry key
    round_idx: int,
) -> torch.Tensor:
    """One all-or-nothing gang-admission pass (placement groups), on the
    device of its tensors; the spec is the JAX package's ``admit_gangs``.

    Every pending group draws a candidate node per bundle under its
    strategy (STRICT_PACK: the draw-th node fitting the group total;
    PACK: that, else SPREAD; SPREAD: rank j takes the ((start + j) mod
    n_feasible)-th node feasible for it, start = draw mod N;
    STRICT_SPREAD: node (start + j) mod N, a group larger than N is
    INFEASIBLE), then ONE segmented prefix-sum over the admissible groups'
    bundles decides admission: a group is admitted iff every one of its
    bundles' prefixes fits its node."""
    B, R = demand.shape
    G = strategy.shape[0]
    N = avail.shape[0]
    dev = demand.device
    valid = (group >= 0) & (group < G)      # a group past G: padding
    gidx = torch.where(valid, group.to(torch.int64), G)  # padding -> G
    gclip = gidx.clamp_max(G - 1)                        # safe gather index
    idx = torch.arange(B, device=dev)

    first = torch.full((G + 1,), B, dtype=torch.int64, device=dev
                       ).scatter_reduce_(0, gidx, idx, reduce="amin")
    size = torch.zeros((G + 1,), dtype=torch.int64, device=dev
                       ).index_add_(0, gidx, valid.to(torch.int64))
    total = torch.zeros((G + 1, R), dtype=torch.int32, device=dev
                        ).index_add_(0, gidx, demand * valid[:, None])
    rank = idx - first[gidx]                   # in-group submission rank

    feas = (demand[:, None, :] <= avail[None]).all(-1) & valid[:, None]
    cnt = feas.sum(-1)
    packfeas = (total[:G, None, :] <= avail[None]).all(-1)       # [G, N]
    packcnt = packfeas.sum(-1)

    bits = task_bits(key, round_idx, torch.arange(G, device=dev))
    start = bits % N                                             # [G]
    # Pack candidate per group: the draw-th node fitting the group total.
    pack_pick = _kth_true(packfeas, bits % packcnt.clamp_min(1))
    # Spread candidate per bundle: rank-rotated over ITS feasible nodes.
    srt = start[gclip]
    r_spread = torch.where(cnt > 0, (srt + rank) % cnt.clamp_min(1), 0)
    spread_pick = _kth_true(feas, r_spread)
    # Strict-spread candidate: rank-rotated over ALL nodes.
    ss_pick = (srt + rank) % N
    ss_ok = feas.gather(1, ss_pick.clamp_min(0)[:, None])[:, 0] \
        & (size[gidx] <= N)

    strat = strategy[gclip]
    pack_ok = (packcnt > 0)[gclip]
    use_pack = (strat == STRICT_PACK) | ((strat == PACK) & pack_ok)
    cand = torch.where(use_pack, pack_pick[gclip],
                       torch.where(strat == STRICT_SPREAD, ss_pick,
                                   spread_pick))
    ok = torch.where(strat == STRICT_PACK, pack_ok,
                     torch.where(strat == STRICT_SPREAD, ss_ok, cnt > 0)) \
        & valid

    def group_all(x: torch.Tensor) -> torch.Tensor:
        """Per group (and the padding bucket G): all of its rows true."""
        return torch.ones((G + 1,), dtype=torch.int32, device=dev
                          ).scatter_reduce_(0, gidx, x.to(torch.int32),
                                            reduce="amin") > 0

    ready_g = group_all(ok)
    # Admission: ONE segmented prefix-sum over admissible groups' bundles,
    # grouped by candidate node, submission order within a node.
    node_key = torch.where(valid & ready_g[gidx], cand, N)
    fits = _segmented_admit(demand, node_key,
                            torch.argsort(node_key, stable=True), avail)
    admitted = group_all(fits)[:G] & ready_g[:G]

    placement = torch.where(valid & admitted[gclip], cand, NO_PLACEMENT)
    inf_g = (strategy == STRICT_SPREAD) & (size[:G] > N)
    placement = torch.where(valid & inf_g[gclip], INFEASIBLE, placement)
    return placement.to(torch.int32)


def _peak(avail: torch.Tensor) -> int:
    """The largest capacity, read on the host (0 for an empty fleet)."""
    return int(avail.max()) if avail.numel() else 0


def _pow2_pad(n: int) -> int:
    return (1 << max(n - 1, 1).bit_length()) - n


def admit_gangs_host(demand: np.ndarray, group: np.ndarray,
                     strategy: np.ndarray, avail, key,
                     round_idx: int = 0, device: Device = None) -> np.ndarray:
    """Host entry for the gang pass: the JAX package's power-of-two padding
    on both the bundle and group axes (padding rows and groups change no
    bit), plus the same int32 overflow guard as BatchScheduler."""
    demand = np.asarray(demand, np.int32)
    group = np.asarray(group, np.int32)
    strategy = np.asarray(strategy, np.int32)
    dev = _device_of(device, avail)
    avail = _to(avail, torch.int32, dev)
    B = demand.shape[0]
    if B == 0 or avail.shape[0] == 0:
        return np.full((B,), NO_PLACEMENT, np.int32)
    peak = _peak(avail)
    if peak > 0 and B * peak >= 2 ** 31:
        raise ValueError("gang admission stream exceeds int32 scan range")
    bpad, gpad = _pow2_pad(B), _pow2_pad(strategy.shape[0])
    if bpad:
        demand = np.concatenate(
            [demand, np.zeros((bpad, demand.shape[1]), np.int32)])
        group = np.concatenate([group, np.full(bpad, -1, np.int32)])
    if gpad:
        strategy = np.concatenate([strategy, np.zeros(gpad, np.int32)])
    out = admit_gangs(_to(demand, torch.int32, dev),
                      _to(group, torch.int32, dev),
                      _to(strategy, torch.int32, dev), avail, key, round_idx)
    return out.cpu().numpy()[:B]


# ------------------------------------------------------------ classify_pending


def classify_pending(
    demand: torch.Tensor,        # [T, R] int32 fixed-point demands
    placement: torch.Tensor,     # [T] int32 node index, or NO_PLACEMENT/INFEASIBLE
    totals: torch.Tensor,        # [N, R] int32 per-node TOTAL resources
    waiting_deps: torch.Tensor,  # [T] bool: an arg has no live copy
    waiting_pg: torch.Tensor,    # [T] bool: member of a non-CREATED gang
    quota: torch.Tensor,         # [T] bool: held by an admission quota
) -> torch.Tensor:
    """One data-parallel pending-reason pass: every unplaced task gets
    exactly one of the five pending reasons, feasibility judged against
    node TOTALS. Precedence (highest wins): waiting-for-deps,
    quota-throttled, waiting-for-pg, infeasible, waiting-for-capacity."""
    feas_any = (demand[:, None, :] <= totals[None]).all(-1).any(-1)
    reason = torch.where(feas_any, REASON_WAITING_CAPACITY, REASON_INFEASIBLE)
    reason = torch.where(waiting_pg, REASON_WAITING_PG, reason)
    reason = torch.where(quota, REASON_QUOTA_THROTTLED, reason)
    reason = torch.where(waiting_deps, REASON_WAITING_DEPS, reason)
    reason = torch.where(placement >= 0, REASON_PLACED, reason)
    return reason.to(torch.int32)


def classify_pending_host(demand: np.ndarray, placement: np.ndarray,
                          totals, waiting_deps: np.ndarray,
                          waiting_pg: np.ndarray, quota: np.ndarray,
                          device: Device = None) -> np.ndarray:
    """Host entry for the reason pass. An empty fleet short-circuits to the
    reference, whose answer it is by definition. torch compiles nothing
    per shape, so the JAX package's power-of-two padding is not needed."""
    dev = _device_of(device, totals)
    demand = np.asarray(demand, np.int32)
    placement = np.asarray(placement, np.int32)
    totals = _to(totals, torch.int32, dev)
    if demand.shape[0] == 0:
        return np.zeros((0,), np.int32)
    if totals.shape[0] == 0:
        from .reference import classify_pending_reference

        return classify_pending_reference(
            demand, placement, np.zeros(tuple(totals.shape), np.int32),
            waiting_deps, waiting_pg, quota)
    out = classify_pending(
        _to(demand, torch.int32, dev), _to(placement, torch.int32, dev),
        totals,
        _to(np.asarray(waiting_deps, bool), torch.bool, dev),
        _to(np.asarray(waiting_pg, bool), torch.bool, dev),
        _to(np.asarray(quota, bool), torch.bool, dev))
    return out.cpu().numpy()


# -------------------------------------------------------------- score_locality


def score_locality(input_bytes: torch.Tensor) -> torch.Tensor:
    """One data-parallel locality pass over the directory's [T, N] int64
    input-bytes matrix: the node holding the LARGEST byte count wins, ties
    keep the lowest node index, all-zero rows score -1. torch has int64, so
    the byte counts compare directly where JAX splits them into hi/lo int32
    planes; the answer is the reference's (negative counts clip to 0)."""
    b = input_bytes.clamp_min(0)
    best = b.max(1, keepdim=True).values
    pick = _first_true(b == best)
    return torch.where(best[:, 0] > 0, pick, -1).to(torch.int32)


def score_locality_host(input_bytes: np.ndarray,
                        device: Device = None) -> np.ndarray:
    """Host entry for the locality pass: short-circuits the degenerate
    shapes (no tasks -> empty; no nodes -> all -1)."""
    if input_bytes.ndim != 2:
        raise ValueError(
            f"input_bytes must be [T, N], got {tuple(input_bytes.shape)}")
    dev = _device_of(device, input_bytes)
    T, N = input_bytes.shape
    if T == 0:
        return np.zeros((0,), np.int32)
    if N == 0:
        return np.full(T, -1, np.int32)
    return score_locality(_to(input_bytes, torch.int64, dev)).cpu().numpy()


# ------------------------------------------------------------ host wrappers


def schedule_dag_collapsed(
    demand: np.ndarray,
    parents: np.ndarray,
    avail,
    key,
    locality: Optional[np.ndarray] = None,
    chunk: int = 8192,
    max_rounds: int = 0,
    device: Device = None,
) -> Tuple[np.ndarray, int]:
    """Host wrapper: collapse linear chains (dag.collapse_chains), place the
    reduced DAG with schedule_dag, broadcast each head's node to its chain.

    The production full-DAG entry: a 50k-task pure chain collapses to one
    round instead of 50k. Placements of collapsed members are co-located
    with their head, which is also the locality-optimal choice (each
    consumes only its parent's output)."""
    from .dag import collapse_chains

    r_demand, r_parents, r_locality, expand = collapse_chains(
        np.asarray(demand), np.asarray(parents), locality)
    placement, rounds = schedule_dag(
        r_demand, r_parents, avail, key, locality=r_locality, chunk=chunk,
        max_rounds=max_rounds, device=device)
    return placement.cpu().numpy()[expand], int(rounds)


class BatchScheduler:
    """Stateful wrapper used by the cluster control plane.

    Holds the cluster availability matrix as a device tensor (mirroring the
    reference's ``cluster_resource_map_``, node_manager.h:693) and places
    batches of pending tasks per tick. Single-tick placement is the DAG
    pass with no parents (every pending task is placeable)."""

    def __init__(self, avail, seed: int = 0, chunk: int = 8192,
                 device: Device = None):
        self.device = _device_of(device, avail)
        self.avail = _to(avail, torch.int32, self.device)
        self.key = prng_key(seed)
        self.chunk = chunk
        self._tick = 0
        self._check_overflow_bound()

    def _check_overflow_bound(self) -> None:
        """The JAX package's admission cumsums are int32: a chunk's
        per-node demand stream must not wrap. Feasible demands are bounded
        by max(avail), so chunk * max(avail) < 2^31 guarantees exactness.
        The port sums in int64 but keeps the same bound, so the two
        packages accept the same clusters."""
        peak = _peak(self.avail)
        if peak > 0 and self.chunk * peak >= 2 ** 31:
            raise ValueError(
                f"chunk ({self.chunk}) * max node capacity ({peak}) "
                f"exceeds int32 admission-scan range; lower chunk to "
                f"< {2 ** 31 // peak}")

    def update_node(self, node_index: int, avail_row) -> None:
        self.avail[node_index] = _to(avail_row, torch.int32, self.device)
        self._check_overflow_bound()

    def place(self, demand, locality: Optional[np.ndarray] = None,
              node_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Place one tick's pending tasks; returns node index or -1 each.

        ``node_mask`` (bool [N], False = draining/unschedulable) hides
        nodes from this tick."""
        T = demand.shape[0]
        parents = torch.full((T, 1), -1, dtype=torch.int32,
                             device=self.device)
        key = fold_in(self.key, self._tick)
        self._tick += 1
        placement, _ = schedule_dag(
            demand, parents, self.avail, key, locality=locality,
            node_mask=node_mask, chunk=self.chunk, max_rounds=1,
            device=self.device)
        return placement.cpu().numpy()
