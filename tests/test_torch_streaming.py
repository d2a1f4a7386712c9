"""The port's streaming library against the JAX package's, on the CPU:
twins of every test of tests/test_streaming.py, and a map stage of K1's
plain version on CPU tensors.

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py), each half on a fresh local
runtime. The record holds every job's sink results (as a multiset: sink
instances answer in thread order, and the reference sorts) and every
``ctx.stats()`` key for key; the two records must be equal, and each half
passes the reference's assertions. Both packages' operators talk over
their own native rings (``rtch-`` and ``rttch-`` segments)."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from chip_smoke import sums_are_exact
from test_torch_tune import ROOTS, LibTwin, _plain, runtime_fixture
from test_torch_wire_codec import JAX, PORT

SEED = 0


def _value(v):
    """A sink item: arrays and tensors by dtype, shape and values."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tolist())
    if isinstance(v, (list, tuple)):
        return type(v)(_value(x) for x in v)
    return _plain(v)


def sink_items(results):
    return sorted((_value(r) for r in results), key=repr)


PATCHES = {"streaming": {"StreamingContext.submit": sink_items,
                         "StreamingContext.stats": _plain}}
LOCAL_RAY = {"local_ray": {
    JAX: runtime_fixture(ray_tpu, num_cpus=8,
                         object_store_memory=256 * 1024 * 1024),
    PORT: runtime_fixture(ray_tpu_torch, num_cpus=8,
                          object_store_memory=256 * 1024 * 1024)}}

STREAMING = LibTwin("test_streaming", PATCHES, fixtures=LOCAL_RAY)
TWINNED = STREAMING.twin_classes(globals(), module_class="TestStreaming")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_streaming

    ref = [n for n in vars(test_streaming) if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 7


# ------------------------------------------------------------ K1 in a stream


def _rms_job(rt, items, map_fn):
    """(index, rms_norm(x)) through a two-instance map stage: the sink's
    pairs by index, the job's stats and every edge's transport."""
    from importlib import import_module

    ctx = import_module(f"{rt.__name__}.streaming").StreamingContext(
        batch_size=4)
    ctx.from_collection(items).map(map_fn, parallelism=2).sink()
    try:
        out = sorted(ctx.submit(), key=lambda iy: iy[0])
        stats = ctx.stats()
        transports = ({} if rt is ray_tpu else {
            k: v for ws in ctx._workers.values() for w in ws
            for k, v in rt.get(w.transports.remote()).items()})
        return out, stats, transports
    finally:
        ctx.shutdown()


def test_a_map_stage_runs_k1_on_cpu_tensors_as_jax_runs_rms_norm():
    """A map stage of the port's ``rms_norm`` over CPU tensors (its plain
    version) gives JAX's ``rms_norm`` through JAX's stream, within f32
    1e-5, with equal stats; every edge of the port's job takes the ring."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops import fused as jfused
    from ray_tpu_torch.ops import fused as tfused

    rng = np.random.RandomState(SEED)
    xs = [rng.randn(16, 64).astype(np.float32) for _ in range(24)]
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    jrms = jax.jit(jfused.rms_norm)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)

    ray_tpu.init(num_cpus=4)
    jout, jstats, _ = _rms_job(
        ray_tpu, list(enumerate(xs)),
        lambda ix: (ix[0], np.asarray(jrms(jnp.asarray(ix[1]), jw))))
    ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    launches = tfused.rms_norm.launches
    tout, tstats, transports = _rms_job(
        ray_tpu_torch, [(i, torch.from_numpy(x)) for i, x in enumerate(xs)],
        lambda ix: (ix[0], tfused.rms_norm(ix[1], tw)))
    assert tfused.rms_norm.launches == launches   # no kernel on the CPU
    assert [i for i, _ in tout] == [i for i, _ in jout] == list(range(24))
    for (_, got), (_, want) in zip(tout, jout):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tstats == jstats
    # source -> 2 maps, 2 maps -> sink: four channels, each on the ring.
    assert sorted(transports.values()) == ["native"] * 4


def test_keyed_reduce_of_k1_outputs_equals_the_eager_loop():
    """Phase 18 (b) of chip_smoke.py at a small size, on the CPU: K1's plain
    version in a two-instance map, keyed by index mod 4 over two key_by
    and two reduce instances, summed in float64, where every sum of these
    bf16 outputs is exact (so arrival order cannot change a bit): the
    sink's four sums equal the eager loop's bit for bit, and keyed routing
    lands each key on the reduce instance that JAX's hash names."""
    from ray_tpu.streaming.worker import _stable_hash as jhash
    from ray_tpu_torch.ops import fused
    from ray_tpu_torch.streaming import StreamingContext
    from ray_tpu_torch.streaming.worker import _stable_hash as thash

    g = torch.Generator().manual_seed(SEED)
    xs = [torch.randn(8, 64, generator=g).to(torch.bfloat16)
          for _ in range(32)]
    w = (1.0 + 0.1 * torch.randn(64, generator=g)).to(torch.bfloat16)
    ys = [fused.rms_norm(x, w) for x in xs]
    eager = {}
    for i, y in enumerate(ys):
        eager[i % 4] = y.double() if i % 4 not in eager \
            else eager[i % 4] + y.double()
    assert all(sums_are_exact(ys[k::4]) for k in range(4))

    ray_tpu_torch.init(num_cpus=4)
    ctx = StreamingContext(batch_size=4)
    (ctx.from_collection(list(enumerate(xs)))
        .map(lambda ix: (ix[0], fused.rms_norm(ix[1], w)), parallelism=2)
        .key_by(lambda iy: iy[0] % 4, parallelism=2)
        .reduce(lambda a, b: (a[0], a[1].double() + b[1].double()),
                parallelism=2)
        .sink())
    try:
        results = ctx.submit()
        per_reduce = [ray_tpu_torch.get(w_.stats.remote())["records_out"]
                      for w_ in ctx._workers[3]]
    finally:
        ctx.shutdown()
    assert sorted(k for k, _ in results) == [0, 1, 2, 3]
    for key, (_, total) in results:
        assert torch.equal(total, eager[key]), key
    assert [thash(k) for k in range(4)] == [jhash(k) for k in range(4)]
    want = [sum(1 for k in range(4) if jhash(k) % 2 == j) for j in range(2)]
    assert per_reduce == want


def test_the_exactness_check_refuses_terms_too_far_apart():
    """``sums_are_exact`` (the premise of the bit-equal sums above) refuses
    terms whose exponents span more than float64 can hold: 1 + 2^-60
    rounds to 1 there."""
    near = [torch.tensor([1.0, 3.0]), torch.tensor([2.0 ** -30, 0.0])]
    far = [torch.tensor([1.0, 3.0]), torch.tensor([2.0 ** -60, 0.0])]
    assert sums_are_exact([t.to(torch.bfloat16) for t in near])
    assert not sums_are_exact([t.to(torch.bfloat16) for t in far])
    assert 1.0 + 2.0 ** -60 == 1.0
