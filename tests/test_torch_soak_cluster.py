"""The twins of tests/test_soak.py's four cluster workloads (node
failures, many drivers, head failover, the hostile mix), each run through
the reference's ``scripts/soak.py`` and then the port's
(``ray_tpu_torch.scripts.soak``, its clusters' heads on the CPU), at the
reference's durations, floors and marks. Each workload starts and stops
its own cluster."""

import os
import sys

import pytest

from ray_tpu_torch.scripts import soak as t_soak

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import soak as j_soak  # noqa: E402


@pytest.mark.cluster
def test_soak_node_failures():
    # Manages its own Cluster + driver connection.
    assert j_soak.node_failures(10.0) >= 3
    assert t_soak.node_failures(10.0, device="cpu") >= 3


@pytest.mark.cluster
def test_soak_many_drivers():
    # Manages its own Cluster; drivers are subprocesses.
    assert j_soak.many_drivers(10.0) >= 3
    assert t_soak.many_drivers(10.0, device="cpu") >= 3


@pytest.mark.cluster
@pytest.mark.slow
def test_soak_head_failover():
    # Manages its own Cluster + warm standby; kills the leader mid-run.
    assert j_soak.head_failover(25.0) >= 4
    assert t_soak.head_failover(25.0, device="cpu") >= 4


@pytest.mark.cluster
@pytest.mark.slow
def test_soak_hostile_workload():
    # Manages its own Cluster; ~2% hostile task mix (hangers, segfault
    # loopers, oom bombs). The workload itself asserts zero healthy loss,
    # the right typed error per hostile task, quarantine engagement, and a
    # clean consistency audit. The port's controller does not read the
    # chaos worker killer's knob yet (soak.py's docstring).
    assert j_soak.hostile_workload(30.0) >= 4
    assert t_soak.hostile_workload(30.0, device="cpu") >= 4
