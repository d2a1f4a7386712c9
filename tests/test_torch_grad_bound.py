"""The bound that holds the bf16 flash-attention backward kernels (K4, K5)
to their plain versions on the card (``attention._flash_grad_bounds``),
held to its purpose on the CPU with the plain versions: it accepts the
plain result recomputed with s and dp perturbed by a few f32 ulps before
the bf16 roundings (what another summation order and ex2.approx do), and
rejects the plain result with one 64-row tile's terms left out or with the
causal mask dropped.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tatt

SHAPES = [   # (B, T = S, H, KH, D): small causal GQA shapes, 3 tiles
    (2, 192, 4, 2, 64),
    (1, 150, 8, 2, 128),
]


def _inputs(B, T, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).bfloat16()

    q, k, v, do = bf16(B, T, H, D), bf16(B, T, KH, D), bf16(B, T, KH, D), \
        bf16(B, T, H, D)
    out, lse = tatt._flash_forward_ref(q, k, v, True)
    return q, k, v, do, lse, tatt._flash_dsum(out, do)


def _grads(q, k, v, do, lse, dsum, *, causal=True, noise=None,
           drop_kv=None, drop_q=None):
    """The plain backward's arithmetic (_bwd_probs, then the products of
    _flash_backward_dq_ref and _flash_backward_dkv_ref), with s and dp
    scaled by (1 + noise) before p and ds are formed, and the terms of kv
    rows drop_kv (for dq) or q rows drop_q (for dk, dv) left out."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    s = tatt._scores(q, k, causal)
    dp = torch.einsum("bthd,bshd->bhts", do.float(),
                      tatt._repeat_kv(v, H).float())
    if noise is not None:
        s, dp = s * (1 + noise[0]), dp * (1 + noise[1])
    p = torch.exp(s - lse[..., None])
    ds = p * (dp - dsum[..., None]) * D ** -0.5
    ds_q, ds_k, p_v = ds.clone(), ds.clone(), p.clone()
    if drop_kv is not None:
        ds_q[..., drop_kv] = 0
    if drop_q is not None:
        ds_k[:, :, drop_q] = 0
        p_v[:, :, drop_q] = 0
    dq = torch.einsum("bhts,bshd->bthd", ds_q.to(k.dtype).float(),
                      tatt._repeat_kv(k, H).float()).to(q.dtype)
    dv = torch.einsum("bhts,bthd->bshd", p_v.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds_k.to(q.dtype).float(), q.float())
    G = H // KH
    dk = dk.reshape(B, S, KH, G, D).sum(3).to(k.dtype)
    dv = dv.reshape(B, S, KH, G, D).sum(3).to(v.dtype)
    return dq, dk, dv


def _excess(got, want, bounds):
    """Per gradient, the largest |got - want| / bound (> 1 is rejected;
    0 where both are 0)."""
    out = []
    for g, w, b in zip(got, want, bounds):
        d = (g.float() - w.float()).abs()
        out.append(torch.where(d > 0, d / b, 0.0).max().item())
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_math_of_the_test_is_the_plain_backward(shape):
    args = _inputs(*shape)
    got = _grads(*args)
    want = (tatt._flash_backward_dq_ref(*args, True),
            *tatt._flash_backward_dkv_ref(*args, True))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ulps", [2, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_bound_accepts_reordering_noise(shape, ulps):
    """s and dp with relative noise of up to `ulps` f32 ulps: some bf16
    roundings of p and ds flip, and every gradient stays in its bound."""
    args = _inputs(*shape, seed=ulps)
    want = _grads(*args)
    B, T, H, _, _ = shape
    rng = np.random.default_rng(100 + ulps)
    noise = [torch.from_numpy(rng.uniform(-1, 1, (B, H, T, T)).astype(
        np.float32)) * (ulps * 2.0 ** -24) for _ in range(2)]
    got = _grads(*args, noise=noise)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))
    bounds = tatt._flash_grad_bounds(*args, *want, causal=True)
    assert max(_excess(got, want, bounds)) <= 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_flip_term_is_what_accepts_the_noise(shape):
    """At 8 ulps of noise the bound without its flips term (m = 0)
    rejects what the bound accepts."""
    args = _inputs(*shape, seed=8)
    want = _grads(*args)
    B, T, H, _, _ = shape
    rng = np.random.default_rng(108)
    noise = [torch.from_numpy(rng.uniform(-1, 1, (B, H, T, T)).astype(
        np.float32)) * (8 * 2.0 ** -24) for _ in range(2)]
    got = _grads(*args, noise=noise)
    assert max(_excess(got, want, tatt._flash_grad_bounds(
        *args, *want, causal=True, flips=0))) > 1.0
    assert max(_excess(got, want, tatt._flash_grad_bounds(
        *args, *want, causal=True))) <= 1.0


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bound_rejects_a_dropped_tile(shape, grad):
    """One 64-row tile's terms left out of the sum: kv rows 64-127 for dq,
    q rows 64-127 for dk and dv."""
    args = _inputs(*shape)
    want = _grads(*args)
    tile = slice(64, 128)
    got = _grads(*args, **({"drop_kv": tile} if grad == "dq"
                           else {"drop_q": tile}))
    bounds = tatt._flash_grad_bounds(*args, *want, causal=True)
    i = "dq dk dv".split().index(grad)
    assert _excess(got, want, bounds)[i] > 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_bound_rejects_a_dropped_causal_mask(shape):
    args = _inputs(*shape)
    want = _grads(*args)
    got = _grads(*args, causal=False)
    bounds = tatt._flash_grad_bounds(*args, *want, causal=True)
    assert min(_excess(got, want, bounds)) > 1.0
