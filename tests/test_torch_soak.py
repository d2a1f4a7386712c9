"""Short-mode runs of the port's soak workloads (``ray_tpu_torch.scripts.
soak``): twins of tests/test_soak.py's five tests (the four that start a
cluster are in test_torch_soak_cluster.py), each run through the
reference's ``scripts/soak.py`` and then the port's, at the reference's
durations, floors and marks; and the port's ``lm_serve`` for 3 s on the
CPU, every iteration's outputs pinned to the port's ``generate`` by the
workload itself (its model is the port's own draw: the JAX package's
soak test runs no LM)."""

import os
import sys

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.scripts import soak as t_soak

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import soak as j_soak  # noqa: E402

STORE = 256 * 1024 * 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()


def test_soak_local_workloads():
    for rt, soak in ((ray_tpu, j_soak), (ray_tpu_torch, t_soak)):
        rt.init(num_cpus=8, object_store_memory=STORE)
        try:
            assert soak.many_tasks(3.0) > 0
            assert soak.actor_deaths(3.0) > 0
            assert soak.pbt(3.0) > 0
            assert soak.serve_failure(3.0) > 0
        finally:
            rt.shutdown()


def test_soak_lm_serve_pins_every_iteration():
    """Whole-response, streamed and seeded sampled requests against the
    paged speculative engine (page 16, speculative_k 3, prefill chunk 32)
    at D 8; the workload asserts each output equal to ``generate`` (or to
    the first sample) in every iteration, and that none stalls."""
    ray_tpu_torch.init(num_cpus=8, object_store_memory=STORE)
    assert t_soak.lm_serve(3.0, device="cpu") > 0
    assert len(t_soak.LAST_TIMES["lm_serve"]) > 0
