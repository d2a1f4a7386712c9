"""Resource accounting: fixed-point vectors + named custom resources.

The port's copy of ``ray_tpu/_private/resources.py`` with the accelerator
slots renamed for the GPU: slot 2 is ``GPU`` and slot 3 ``gpu_memory``, in
the JAX package's order (its ``TPU``, ``tpu_memory``), so a demand matrix
built by either package has the same columns.

Modeled on the reference's *new* vectorized scheduler data model (reference:
``src/ray/common/scheduling/cluster_resource_scheduler.h:28-217`` — predefined
slots with the accelerator first-class, fixed-point arithmetic so fractional
resources compare exactly) rather than the legacy string-keyed ``ResourceSet``.

All quantities are stored as int64 "kilo-units" (1.0 == 1000), which makes
demand<=available comparisons exact for fractional requests like 0.5 CPU, and
makes the whole cluster state embeddable as an int32/int64 device tensor for the
batch placement passes (see ray_tpu_torch/scheduler/kernel.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

KILO = 1000  # fixed-point scale: 1.0 resource unit == 1000

# Predefined dense slots. Order matters: it is the kernel's resource axis.
CPU, MEM, GPU, GPU_MEM = 0, 1, 2, 3
PREDEFINED = ("CPU", "memory", "GPU", "gpu_memory")
NUM_PREDEFINED = len(PREDEFINED)
_PREDEFINED_INDEX = {name: i for i, name in enumerate(PREDEFINED)}
# Aliases accepted in user-facing resource dicts.
_ALIASES = {"num_cpus": "CPU", "num_gpus": "GPU", "object_store_memory": "memory"}


def to_fixed(value: float) -> int:
    return int(round(value * KILO))


def from_fixed(value: int) -> float:
    return value / KILO


class ResourceSet:
    """An immutable demand/capacity vector: dense predefined slots + custom map.

    Equivalent of the reference's ``TaskRequest``/``NodeResources`` pair
    (``cluster_resource_scheduler.h:137,185``) collapsed into one type.
    """

    __slots__ = ("predefined", "custom", "_key")

    def __init__(
        self,
        predefined: Optional[np.ndarray] = None,
        custom: Optional[Mapping[str, int]] = None,
    ):
        if predefined is None:
            predefined = np.zeros(NUM_PREDEFINED, dtype=np.int64)
        self.predefined = np.asarray(predefined, dtype=np.int64)
        assert self.predefined.shape == (NUM_PREDEFINED,)
        self.custom: Dict[str, int] = {k: v for k, v in (custom or {}).items() if v != 0}
        self._key: Optional[Tuple] = None

    @classmethod
    def from_dict(cls, resources: Optional[Mapping[str, float]]) -> "ResourceSet":
        predefined = np.zeros(NUM_PREDEFINED, dtype=np.int64)
        custom: Dict[str, int] = {}
        for name, qty in (resources or {}).items():
            name = _ALIASES.get(name, name)
            fixed = to_fixed(qty)
            idx = _PREDEFINED_INDEX.get(name)
            if idx is not None:
                predefined[idx] += fixed
            else:
                custom[name] = custom.get(name, 0) + fixed
        return cls(predefined, custom)

    def to_dict(self) -> Dict[str, float]:
        out = {
            PREDEFINED[i]: from_fixed(int(v))
            for i, v in enumerate(self.predefined)
            if v != 0
        }
        out.update({k: from_fixed(v) for k, v in self.custom.items()})
        return out

    def is_empty(self) -> bool:
        return not self.custom and not self.predefined.any()

    def is_subset_of(self, other: "ResourceSet") -> bool:
        """Feasibility test: self (demand) fits in other (available).

        Exactly the reference's ``ResourceSet::IsSubset`` used in the placement
        loop (``scheduling_policy.cc:75``), in fixed-point. Pure-python tuple
        compare: this sits in the dispatch hot loop where a 4-wide numpy
        ufunc launch costs more than the comparison itself.
        """
        a, b = self.key()[0], other.key()[0]
        if (a[0] > b[0] or a[1] > b[1] or a[2] > b[2] or a[3] > b[3]):
            return False
        return all(other.custom.get(k, 0) >= v for k, v in self.custom.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        custom = dict(self.custom)
        for k, v in other.custom.items():
            custom[k] = custom.get(k, 0) + v
        return ResourceSet(self.predefined + other.predefined, custom)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        custom = dict(self.custom)
        for k, v in other.custom.items():
            custom[k] = custom.get(k, 0) - v
        return ResourceSet(self.predefined - other.predefined, custom)

    def key(self) -> Tuple:
        """Hashable interning key (basis of SchedulingClass, ref task_spec.h:190)."""
        if self._key is None:
            self._key = (tuple(self.predefined.tolist()), tuple(sorted(self.custom.items())))
        return self._key

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """Mutable per-node accounting: total and available ResourceSets.

    Mirrors the reference's ``SchedulingResources`` (total/available/load,
    ``common/task/scheduling_resources.h``); load is tracked by the scheduler.
    """

    __slots__ = ("total", "available")

    def __init__(self, total: ResourceSet):
        self.total = total
        self.available = total

    def acquire(self, demand: ResourceSet) -> bool:
        if not demand.is_subset_of(self.available):
            return False
        self.available = self.available.subtract(demand)
        return True

    def release(self, demand: ResourceSet) -> None:
        released = self.available.add(demand)
        # Clamp: a release should never exceed total (defensive vs. double
        # release). Custom keys no longer in total (a removed placement
        # group's bundle resources, a deleted dynamic resource) are
        # dropped — a late release must not resurrect them as phantom
        # availability. New object, not in-place: ResourceSet caches key().
        custom = {k: min(v, self.total.custom[k])
                  for k, v in released.custom.items()
                  if k in self.total.custom}
        self.available = ResourceSet(
            np.minimum(released.predefined, self.total.predefined),
            custom)

    def __repr__(self):
        return f"NodeResources(total={self.total}, available={self.available})"


# --------------------------------------------------------------------------
# Placement-group resource naming (placement_group.py).
#
# A created group's bundles materialize as CUSTOM resources on their nodes
# (reference: the formatted ``CPU_group_0_<id>`` resources placement groups
# create on raylets). Tasks targeting a bundle demand those names instead of
# the base resources, so the ENTIRE existing machinery — kernel placement,
# greedy placer, GCS accounting, controller local admission — schedules
# them with zero special cases: only the bundle's node owns the name.
# --------------------------------------------------------------------------

PG_BUNDLE_MARKER = "bundle"        # synthetic per-bundle membership resource
PG_BUNDLE_CAPACITY = 1000.0        # marker capacity per bundle (ref: 1000)
PG_MARKER_DEMAND = 0.001           # marker slice a member task consumes
_PG_SEP = "_group_"


def pg_resource_name(base: str, pg_hex: str,
                     bundle_index: Optional[int] = None) -> str:
    """``CPU_group_3_<hex>`` (one bundle) or ``CPU_group_<hex>`` (wildcard:
    any bundle of the group)."""
    if bundle_index is None or bundle_index < 0:
        return f"{base}{_PG_SEP}{pg_hex}"
    return f"{base}{_PG_SEP}{bundle_index}_{pg_hex}"


def parse_pg_resource(name: str) -> Optional[Tuple[str, Optional[int], str]]:
    """(base, bundle_index|None, pg_hex) for a placement-group resource
    name; None for ordinary resources."""
    idx = name.rfind(_PG_SEP)
    if idx <= 0:
        return None
    base, tail = name[:idx], name[idx + len(_PG_SEP):]
    head, _, rest = tail.partition("_")
    if rest and head.isdigit():
        return base, int(head), rest
    return (base, None, tail) if tail else None


def translate_pg_demand(resources: Dict[str, float], pg_hex: str,
                        bundle_index: int = -1) -> Dict[str, float]:
    """Rewrite a task/actor demand to its in-group form: every base
    resource becomes the group-scoped name (bundle-specific or wildcard),
    plus a sliver of the bundle marker so even zero-resource tasks are
    pinned to the group's nodes."""
    idx = bundle_index if bundle_index >= 0 else None
    out = {pg_resource_name(k, pg_hex, idx): v
           for k, v in resources.items() if v > 0}
    out[pg_resource_name(PG_BUNDLE_MARKER, pg_hex, idx)] = PG_MARKER_DEMAND
    return out


def pg_bundle_grants(bundles, pg_hex: str):
    """Per-bundle custom-resource grant maps a reservation creates on its
    node: bundle-specific names, wildcard names (any-bundle demand), and
    the membership markers. Returns one dict per bundle; a node hosting
    several bundles sums its dicts."""
    grants = []
    for i, bundle in enumerate(bundles):
        add: Dict[str, float] = {}
        for k, v in bundle.items():
            if v <= 0:
                continue
            add[pg_resource_name(k, pg_hex, i)] = v
            add[pg_resource_name(k, pg_hex)] = \
                add.get(pg_resource_name(k, pg_hex), 0.0) + v
        add[pg_resource_name(PG_BUNDLE_MARKER, pg_hex, i)] = \
            PG_BUNDLE_CAPACITY
        add[pg_resource_name(PG_BUNDLE_MARKER, pg_hex)] = PG_BUNDLE_CAPACITY
        grants.append(add)
    return grants


def dense_matrix(sets: Iterable[ResourceSet], custom_names: Tuple[str, ...] = ()) -> np.ndarray:
    """Pack ResourceSets into an [N, R] int64 matrix for the placement passes.

    Columns are the predefined slots followed by ``custom_names`` in order.
    """
    sets = list(sets)
    ncols = NUM_PREDEFINED + len(custom_names)
    out = np.zeros((len(sets), ncols), dtype=np.int64)
    for i, rs in enumerate(sets):
        out[i, :NUM_PREDEFINED] = rs.predefined
        for j, name in enumerate(custom_names):
            out[i, NUM_PREDEFINED + j] = rs.custom.get(name, 0)
    return out
