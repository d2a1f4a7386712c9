"""The port's answers to the reference's review regressions, on the CPU:
twins of every test of tests/test_review_regressions.py (the task pool
under nested blocking tasks, ``set_resource`` waking a queued task, a
cancelled task's pinned args, an actor's restart of itself, broadcast
before map, the GCS's parked ``locations_batch``, ``fetch_batch``'s size
cap, ``as_future``'s shared resolver, a failing constructor's queued
calls).

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py): each local half on a fresh
local runtime, each cluster half on a ``Cluster`` of its own package (the
port's with its GCS on the CPU). The record holds each ``set_resource``
call, every streaming job's sink results as a multiset, and the type of
every value ``get`` returned to the test's own code, or of the error it
raised (the values carry clocks and thread ids; the reference asserts
them); the two records must be equal, and each half passes the
reference's assertions."""

import pytest

from test_torch_streaming import LOCAL_RAY, sink_items
from test_torch_tune import ROOTS, LibTwin


def kind(value):
    """A value by its type, containers element by element."""
    if isinstance(value, (list, tuple)):
        return type(value)(kind(v) for v in value)
    return type(value).__name__


PATCHES = {"": {"get": kind},
           "experimental": {"set_resource": kind},
           "streaming": {"StreamingContext.submit": sink_items}}
_CLUSTERS = [(f'Cluster(head_resources={{"CPU": 2}}, num_workers={n})',
              f'Cluster(head_resources={{"CPU": 2}}, num_workers={n}, '
              f'device="cpu")') for n in (0, 1)]

REVIEW = LibTwin("test_review_regressions", PATCHES, fixtures=LOCAL_RAY,
                 renames=_CLUSTERS)
TWINNED = REVIEW.twin_classes(globals(),
                              module_class="TestReviewRegressions")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_review_regressions

    ref = [n for n in vars(test_review_regressions)
           if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 10
