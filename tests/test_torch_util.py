"""The port's util library against the JAX package's, on the CPU: twins of
every test of tests/test_util.py (parallel iterators, the actor pool, the
queue, the multiprocessing pool, named actors, the joblib backend).

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py), each half on a fresh local
runtime; every call the test's own code makes into the library is recorded
with its result or the type of the error it raised, and the two records
must be equal: iterator ``take``s (as multisets, since shards are gathered
in the order their actors answer), the pools' maps in order (unordered maps
as multisets), queue reads and sizes, ``get`` of the test's own tasks. The
joblib twin uses each package's own backend name, since joblib's registry
is one for the process. The rest of the file holds the port's own names."""

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_tune import ROOTS, LibTwin, _plain, as_set, consumed, listed

_PATCHES = {
    "": {"get": _plain},
    "util.iter": {"ParallelIterator.take": as_set,
                  "ParallelIterator.num_shards": _plain,
                  "LocalIterator.take": as_set},
    "util.actor_pool": {"ActorPool.map": consumed(listed),
                        "ActorPool.map_unordered": consumed(as_set),
                        "ActorPool.get_next": _plain,
                        "ActorPool.has_next": _plain},
    "util.queue": {"Queue.put": _plain, "Queue.get": _plain,
                   "Queue.get_nowait": _plain, "Queue.put_nowait": _plain,
                   "Queue.size": _plain, "Queue.full": _plain},
    "util.multiprocessing.pool": {
        "Pool.map": _plain, "Pool.apply": _plain, "Pool.starmap": _plain,
        "Pool.imap": consumed(listed),
        "Pool.imap_unordered": consumed(as_set),
        "AsyncResult.get": _plain},
}

UTIL = LibTwin("test_util", _PATCHES, renames=[
    ('parallel_backend("ray_tpu"', 'parallel_backend("ray_tpu_torch"')])
TWINNED = UTIL.twin_classes(globals(), module_class="TestUtil")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_util

    ref = [n for n in vars(test_util) if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 24


def test_named_actor_registries_are_each_packages_own():
    from ray_tpu.util import named_actors as jnamed
    from ray_tpu_torch.util import named_actors as tnamed

    assert jnamed._REGISTRY_NAME == "__ray_tpu_named_actor_registry__"
    assert tnamed._REGISTRY_NAME == "__ray_tpu_torch_named_actor_registry__"


def test_joblib_backends_are_each_packages_own():
    joblib = pytest.importorskip("joblib")
    from joblib.parallel import BACKENDS

    from ray_tpu.util.joblib import register_ray as jregister
    from ray_tpu_torch.util.joblib import register_ray as tregister
    from ray_tpu_torch.util.joblib.ray_backend import RayTpuBackend

    jregister()
    tregister()
    assert BACKENDS["ray_tpu_torch"] is RayTpuBackend
    assert BACKENDS["ray"] is RayTpuBackend          # the last one wins
    assert BACKENDS["ray_tpu"] is not RayTpuBackend
    ray_tpu_torch.init(num_cpus=2)
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(abs)(-i) for i in range(4))
    assert out == [0, 1, 2, 3]
    assert not ray_tpu.is_initialized()
