"""The port's state API, profiling, internal kv, dynamic resources, actor
restart and checkpointing, custom serializers and distributed arrays
against the JAX package's, on the CPU: twins of every test of
tests/test_state_and_ft.py, and the arrays' blocks held to JAX's.

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py), each half on a fresh local
runtime; the port's arrays are asked for on the CPU (``device="cpu"``:
with no device they go to the card). The record holds every ``get`` of
the test's own refs, ``cluster_resources()``, and each internal-kv and
``set_resource`` call with its result or the type of the error it raised;
the two records must be equal, and each half passes the reference's
assertions."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from test_torch_streaming import LOCAL_RAY
from test_torch_tune import ROOTS, LibTwin, _plain

_ON_CPU = [(f"ra.random({shape}, seed={seed})",
            f'ra.random({shape}, seed={seed}, device="cpu")')
           for shape, seed in (("(100, 150)", 1), ("(150, 80)", 2))] \
    + [("ra.eye(100)", 'ra.eye(100, device="cpu")')]
_KV = ("_internal_kv_get", "_internal_kv_put", "_internal_kv_exists",
       "_internal_kv_del", "set_resource")

STATE = LibTwin("test_state_and_ft",
                {"": {"get": _plain, "cluster_resources": _plain}},
                fixtures=LOCAL_RAY, renames=_ON_CPU,
                record={name: None for name in _KV})
TWINNED = STATE.twin_classes(globals(), module_class="TestStateAndFt")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_state_and_ft

    ref = [n for n in vars(test_state_and_ft) if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 9


# --------------------------------------------------- the arrays' blocks


def _arrays(rt, **kw):
    """The reference's arrays at BLOCK_SIZE 64, as numpy: random, eye, zeros,
    add, subtract, transpose, dot(eye, a) and dot; and every block of a."""
    import importlib

    ra = importlib.import_module(f"{rt.__name__}.experimental.array")
    old = ra.BLOCK_SIZE
    ra.BLOCK_SIZE = 64
    rt.init(num_cpus=4)
    try:
        a = ra.random((100, 150), seed=1, **kw)
        b = ra.random((150, 80), seed=2, **kw)
        a2 = ra.random((100, 150), seed=3, **kw)
        ident = ra.eye(100, **kw)

        def dense(x):
            x = x.assemble()
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

        out = {"a": dense(a), "b": dense(b), "eye": dense(ident),
               "zeros": dense(ra.zeros((70, 130), **kw)),
               "add": dense(ra.add(a, a2)),
               "subtract": dense(ra.subtract(a, a2)),
               "transpose": dense(ra.transpose(a)),
               "eye_a": dense(ra.dot(ident, a)), "dot": dense(ra.dot(a, b))}
        blocks = [rt.get(a.blocks[i, j]) for i in range(a.num_blocks[0])
                  for j in range(a.num_blocks[1])]
        return out, blocks
    finally:
        rt.shutdown()
        ra.BLOCK_SIZE = old


def test_dist_arrays_hold_jaxs_bits_and_dot_its_bound():
    """On ``device="cpu"`` every block of ``random``, ``eye``, ``zeros``,
    ``add``, ``subtract``, ``transpose`` and ``dot(eye, a)`` is JAX's bit for
    bit, each a float32 CPU tensor; ``dot`` lies within ``_dot_bound`` of
    JAX's (both sum 150 float32 products, in their own orders)."""
    from ray_tpu_torch.experimental.array import _dot_bound

    jout, _ = _arrays(ray_tpu)
    tout, blocks = _arrays(ray_tpu_torch, device="cpu")
    assert all(isinstance(blk, torch.Tensor) and blk.device.type == "cpu"
               and blk.dtype == torch.float32 for blk in blocks)
    assert len(blocks) == 2 * 3
    for name in ("a", "b", "eye", "zeros", "add", "subtract", "transpose",
                 "eye_a"):
        assert tout[name].dtype == jout[name].dtype == np.float32, name
        np.testing.assert_array_equal(tout[name], jout[name], err_msg=name)
    np.testing.assert_array_equal(tout["eye_a"], tout["a"])
    bound = _dot_bound(torch.from_numpy(jout["a"]),
                       torch.from_numpy(jout["b"])).numpy()
    gap = np.abs(tout["dot"].astype(np.float64) - jout["dot"])
    assert (gap <= bound).all(), (gap - bound).max()
    assert gap.max() > 0 or np.array_equal(tout["dot"], jout["dot"])


def test_dot_bound_catches_a_product_off_by_more():
    """``_dot_bound`` is tight enough to fail a product rounded to TF32's
    10-bit mantissa, and holds between a blocked sum and one matmul."""
    from ray_tpu_torch.experimental.array import _dot_bound

    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 256, generator=g)
    b = torch.randn(256, 32, generator=g)
    bound = _dot_bound(a, b)
    blocked = sum(a[:, k:k + 64] @ b[k:k + 64] for k in range(0, 256, 64))
    assert ((blocked.double() - (a @ b).double()).abs() <= bound).all()

    def tf32(x):
        return (x.view(torch.int32) & ~((1 << 13) - 1)).view(torch.float32)

    coarse = tf32(a) @ tf32(b)
    assert ((coarse.double() - (a @ b).double()).abs() > bound).any()
