"""The port's streaming data plane and ``free`` against the JAX package's,
on the CPU: twins of every test of tests/test_streaming_dataplane.py.

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py): each local half on a fresh
local runtime, each cluster half on a ``Cluster`` of its own package (the
port's with its GCS on the CPU). The record holds every job's sink
results as a multiset (arrays by dtype, shape and values) and every
``get`` of the test's own refs, or the type of the error it raised; the
two records must be equal, and each half passes the reference's
assertions. The reference's two cluster tests are ``slow``, and so are
their twins."""

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_streaming import LOCAL_RAY, _value, sink_items
from test_torch_tune import ROOTS, LibTwin

PATCHES = {"": {"get": _value},
           "streaming": {"StreamingContext.submit": sink_items}}
_CLUSTER = 'Cluster(head_resources={"CPU": 2}, num_workers=1'

DATAPLANE = LibTwin("test_streaming_dataplane", PATCHES, fixtures=LOCAL_RAY,
                    renames=[(_CLUSTER, _CLUSTER + ', device="cpu"')])
TWINNED = DATAPLANE.twin_classes(globals(),
                                 module_class="TestStreamingDataplane")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_streaming_dataplane

    ref = [n for n in vars(test_streaming_dataplane)
           if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 4
    slow = [n for n in ref
            if [m.name for m in getattr(getattr(TestStreamingDataplane, n),
                                        "pytestmark", [])] == ["slow"]]
    assert sorted(slow) == ["test_free_api_cluster",
                            "test_ref_plane_beats_inline_on_cluster"]
