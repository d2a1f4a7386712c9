"""The port's ops (ray_tpu_torch.ops) against the JAX package's on the
same numpy-seeded inputs, on the CPU: the plain versions that the CUDA
wrappers take for CPU tensors, held against the XLA references and against
the Pallas kernels run in interpret mode (as tests/test_fused_ops.py runs
them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu.ops import fused as jfused
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import fused as tfused


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ RMSNorm


@pytest.mark.parametrize("shape", [(8, 64), (4, 16, 64), (3, 96)])
def test_rms_norm_ref_matches_jax_ref_f32(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape), 1.0 + 0.1 * _rand(rng, shape[-1])
    ours = tfused._rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w),
                                1e-5)
    ref = jfused._rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_rms_norm_ref_matches_pallas_kernel_interpret_f32():
    """The Pallas kernel itself, in interpret mode (fp32, rtol 1e-5: the
    two differ only in summation order)."""
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 256, 256), 1.0 + 0.1 * _rand(rng, 256)
    prev, jfused._INTERPRET = jfused._INTERPRET, True
    try:
        ref = jfused._rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                      256)
    finally:
        jfused._INTERPRET = prev
    ours = tfused.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_rms_norm_ref_bf16_matches_jax_ref():
    """bf16 in, bf16 out: both round x*inv to bf16 before the weight
    multiply; one bf16 ulp (2^-8 relative) of slack for XLA's fusion."""
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 16, 128), 1.0 + 0.1 * _rand(rng, 128)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    ours = tfused._rms_norm_ref(xt, wt, 1e-5)
    ref = jfused._rms_norm_ref(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16), 1e-5)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_rms_norm_wrapper_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(3)
    x, w = torch.from_numpy(_rand(rng, 5, 32)), torch.ones(32)
    before = tfused.rms_norm.launches
    assert torch.equal(tfused.rms_norm(x, w, 1e-5),
                       tfused._rms_norm_ref(x, w, 1e-5))
    assert tfused.rms_norm.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (4, 16, 64), (3, 96)])
def test_add_rms_norm_ref_matches_jax_composite(shape, dtype):
    """(h, y) = (x + a, rms_norm(x + a)) against the JAX model's composite
    on the same inputs: h equal (one rounding of the same sum in both); y
    within the test_rms_norm_ref_* tolerances (f32 rtol 1e-5, atol 1e-6;
    bf16 one ulp, rtol 2^-7)."""
    rng = np.random.default_rng(7)
    x, a = _rand(rng, *shape), _rand(rng, *shape)
    w = 1.0 + 0.1 * _rand(rng, shape[-1])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jh = jnp.asarray(x, jdt) + jnp.asarray(a, jdt)
    jy = jfused.rms_norm(jh, jnp.asarray(w, jdt), 1e-5)
    h, y = tfused.add_rms_norm(*(torch.from_numpy(v).to(tdt)
                                 for v in (x, a, w)), 1e-5)
    assert h.dtype == y.dtype == tdt and h.shape == y.shape == shape
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-6))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)


def test_add_rms_norm_wrapper_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(8)
    x, a = (torch.from_numpy(_rand(rng, 5, 32)) for _ in range(2))
    w = torch.from_numpy(1.0 + 0.1 * _rand(rng, 32))
    counts = (tfused.rms_norm.launches, tfused.add_rms_norm.launches,
              tfused.rms_norm.backward_launches)
    h, y = tfused.add_rms_norm(x, a, w, 1e-5)
    want_h, want_y = tfused._add_rms_norm_ref(x, a, w, 1e-5)
    assert torch.equal(h, x + a) and torch.equal(h, want_h)
    assert torch.equal(y, want_y)
    assert torch.equal(y, tfused._rms_norm_ref(x + a, w, 1e-5))
    xg = x.clone().requires_grad_()
    sum(t.sum() for t in tfused.add_rms_norm(xg, a, w, 1e-5)).backward()
    assert (tfused.rms_norm.launches, tfused.add_rms_norm.launches,
            tfused.rms_norm.backward_launches) == counts


# ------------------------------------------------------- decode attention


def _decode_inputs(B, H, KH, D, S, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, H, D), _rand(rng, B, S, KH, D),
            _rand(rng, B, S, KH, D), np.asarray(lengths, np.int32))


def _port_decode(q, k, v, lens):
    return tatt.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens)).numpy()


@pytest.mark.parametrize("B,H,KH,D,S,block_k,lengths", [
    (4, 2, 2, 128, 32, 8, [0, 7, 16, 31]),   # multi-block, edges, S-1
    (2, 4, 2, 128, 16, 8, [5, 12]),          # GQA group heads
    (2, 8, 1, 128, 16, 8, [3, 15]),          # MQA
], ids=["multiblock", "gqa", "mqa"])
def test_decode_plain_matches_pallas_flash_decode_interpret(
        B, H, KH, D, S, block_k, lengths):
    """f32, atol 2e-5: the Pallas kernel's online softmax against the
    port's one-pass softmax, summed in another order."""
    q, k, v, lens = _decode_inputs(B, H, KH, D, S, lengths)
    prev, jatt._INTERPRET = jatt._INTERPRET, True
    try:
        ref = jatt._flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens), block_k)
    finally:
        jatt._INTERPRET = prev
    np.testing.assert_allclose(_port_decode(q, k, v, lens), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_decode_plain_matches_jax_decode_attention_d64_g1():
    """The flagship's head shape (D=64, G=1), which the JAX package sends
    down its XLA path: same math, atol 2e-5."""
    q, k, v, lens = _decode_inputs(3, 4, 4, 64, 40, [0, 17, 39], seed=4)
    ref = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(_port_decode(q, k, v, lens), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_decode_wrapper_on_cpu_is_uncounted():
    q, k, v, lens = _decode_inputs(2, 4, 2, 64, 8, [1, 7])
    before = tatt.decode_attention.launches
    _port_decode(q, k, v, lens)
    assert tatt.decode_attention.launches == before


@pytest.mark.parametrize("n_split", [1, 2, 5, 17, 32])
def test_decode_split_plan_covers_each_live_tile_once(n_split):
    """The split plan of the decode kernels K6 and K7 (mirrored from
    csrc/decode_tile.cuh): at every length its live splits cover rows
    0..length once, in order, in whole 64-row tiles but the last; split 0
    holds row 0; there are at most n_split, all of one run of tiles but
    the last, whose first row is a row the sequence attends."""
    for length in list(range(0, 700)) + list(range(700, 8192, 37)) + [8191]:
        plan = tatt.split_plan(length, n_split)
        assert 1 <= len(plan) <= n_split and plan[0][0] == 0
        assert plan[-1][1] == length
        for (a, b), (c, _) in zip(plan, plan[1:]):
            assert c == b + 1 and c % 64 == 0
        runs = {b - a + 1 for a, b in plan[:-1]}
        assert len(runs) <= 1 and all(r % 64 == 0 for r in runs)


def test_decode_split_count_is_one_function_for_k6_and_k7():
    """K6 and K7 take their number of splits from one function of B*KH
    (through one scratch helper), so the paged kernel splits a sequence as
    the contiguous one does."""
    from ray_tpu_torch.ops import paged_attention as tpa

    assert tpa._decode_split is tatt._decode_split
    for bkh in (1, 8, 16, 128, 528, 1000):
        n = tatt.decode_splits(bkh)
        assert 1 <= n <= 32
        assert n == 32 or bkh * n >= tatt._SPLIT_BLOCKS > bkh * (n - 1)


# -------------------------------------------------- plain attention math


@pytest.mark.parametrize("per_seq_mask", [False, True],
                         ids=["shared_mask", "per_seq_mask"])
def test_masked_gqa_attention_matches_jax(per_seq_mask):
    rng = np.random.default_rng(5)
    B, T, H, KH, D, S = 2, 3, 4, 2, 16, 10
    q, k, v = _rand(rng, B, T, H, D), _rand(rng, B, S, KH, D), \
        _rand(rng, B, S, KH, D)
    if per_seq_mask:
        mask = rng.random((B, T, S)) < 0.6
        mask[..., 0] = True
    else:
        mask = np.arange(S)[None, :] <= (np.arange(T) + 4)[:, None]
    ours = tatt.masked_gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask)).numpy()
    ref = jatt.masked_gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 6, 2, 16), \
        _rand(rng, 2, 6, 2, 16)
    ours = tatt.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal).numpy()
    ref = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_repeat_kv_matches_jax_head_packing():
    """Query head h = kh * G + g reads kv head kh, in both packages."""
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    ours = tatt._repeat_kv(torch.from_numpy(k), 6).numpy()
    np.testing.assert_array_equal(ours,
                                  np.asarray(jatt._repeat_kv(
                                      jnp.asarray(k), 6)))
    assert jax.default_backend() == "cpu"
