"""Placement groups: all-or-nothing gang scheduling.

Reference: ``python/ray/util/placement_group.py`` (a post-snapshot Ray
feature). The port's copy of ``ray_tpu/placement_group.py``. A placement group reserves a set of
resource *bundles* atomically — either every bundle is granted, or none is
and the group stays PENDING. Bundles materialize as group-scoped custom
resources on their nodes (``CPU_group_<i>_<id>``), so tasks and actors
submitted with ``.options(placement_group=pg, placement_group_bundle_index=i)``
flow through the ordinary placement machinery and can only land on the
bundle's node, consuming the bundle's reservation rather than the node's
free pool.

Strategies:

  PACK           prefer one node for every bundle; fall back to spreading.
  SPREAD         rotate bundles across feasible nodes (best effort).
  STRICT_PACK    every bundle on ONE node, or the group is not placed.
  STRICT_SPREAD  every bundle on a DISTINCT node; a group with more
                 bundles than nodes is INFEASIBLE (reported, never a hang).

The local runtime admits a group on its one node when the bundles' sum
fits. The cluster's gang admission (``cluster/gcs.py``) is a data-parallel
prefix-sum pass of the batch placement passes
(``ray_tpu_torch/scheduler/kernel.py::admit_gangs``), mirrored
bit-for-bit by ``scheduler/reference.py::admit_gangs_reference``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from ._private.resources import translate_pg_demand
from ._private.worker import global_worker

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")

_READY_FN = None  # lazily-built probe RemoteFunction (one export per proc)


class PlacementGroup:
    """Handle to a placement group (serializable; identity is the id)."""

    __slots__ = ("id", "bundle_specs", "strategy", "name")

    def __init__(self, pg_id: bytes, bundle_specs: Sequence[Dict[str, float]],
                 strategy: str = "PACK", name: str = ""):
        self.id = pg_id
        self.bundle_specs = [dict(b) for b in bundle_specs]
        self.strategy = strategy
        self.name = name

    @property
    def hex(self) -> str:
        return self.id.hex()

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self):
        """ObjectRef that resolves once every bundle is reserved: a
        zero-resource probe task pinned into the group via the bundle
        marker (reference: bundle_reservation_check_func)."""
        global _READY_FN
        if _READY_FN is None:
            from .remote_function import RemoteFunction

            _READY_FN = RemoteFunction(_bundle_reservation_check,
                                       num_cpus=0, max_retries=0)
        return _READY_FN.options(
            num_cpus=0, placement_group=self,
            placement_group_bundle_index=-1).remote(self.hex)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the group is CREATED; False on timeout (the group
        stays pending and may still be created later)."""
        worker = global_worker()
        worker.check_connected()
        return bool(worker.core.placement_group_wait(self.id, timeout))

    def translated_resources(self, resources: Dict[str, float],
                             bundle_index: int = -1) -> Dict[str, float]:
        if bundle_index >= len(self.bundle_specs):
            raise ValueError(
                f"placement_group_bundle_index {bundle_index} out of range "
                f"for {len(self.bundle_specs)} bundles")
        return translate_pg_demand(resources, self.hex, bundle_index)

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.bundle_specs, self.strategy, self.name))

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return (f"PlacementGroup({self.hex[:12]}, "
                f"{len(self.bundle_specs)} bundles, {self.strategy})")


def _bundle_reservation_check(pg_hex: str) -> str:
    """Probe executed inside the group once reservation lands."""
    return pg_hex


def _validate_bundles(bundles: Sequence[Dict[str, float]]) -> None:
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for i, bundle in enumerate(bundles):
        if not isinstance(bundle, dict) or not bundle:
            raise ValueError(f"bundle {i} must be a non-empty resource dict")
        for k, v in bundle.items():
            if not isinstance(k, str) or v < 0:
                raise ValueError(f"bundle {i} has invalid entry {k!r}: {v}")
        if all(v == 0 for v in bundle.values()):
            raise ValueError(f"bundle {i} is all-zero")


def placement_group(bundles: Sequence[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    """Create a placement group (async — creation is all-or-nothing gang
    admission on the cluster; use ``pg.ready()`` / ``pg.wait()`` to block
    until every bundle is reserved)."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    _validate_bundles(bundles)
    worker = global_worker()
    worker.check_connected()
    pg_id = os.urandom(8)
    pg = PlacementGroup(pg_id, bundles, strategy, name)
    worker.core.create_placement_group(
        pg_id, [dict(b) for b in bundles], strategy, name)
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release every bundle of the group (the resources return to their
    nodes' free pools). Tasks still pending on the group fail with
    PlacementGroupError; running tasks finish."""
    worker = global_worker()
    worker.check_connected()
    worker.core.remove_placement_group(
        pg.id if isinstance(pg, PlacementGroup) else pg)


def placement_group_table(
        pg: Optional[PlacementGroup] = None) -> Dict[str, Dict]:
    """State of all (or one) placement groups: state, strategy, bundles,
    per-bundle node ids, and the pending reason when not yet created."""
    worker = global_worker()
    worker.check_connected()
    table = worker.core.placement_group_table()
    if pg is not None:
        key = pg.id.hex() if isinstance(pg, PlacementGroup) else pg.hex()
        return {key: table[key]} if key in table else {}
    return table
