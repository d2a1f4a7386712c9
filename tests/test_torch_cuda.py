"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the smoke run does not reach (scalar-load path, wide rows, odd
group sizes, strided cache views, ragged tiles, T != S), gradients through
the kernels against the same on the CPU, the engine on the card against
the engine on the CPU, and the MoE FFN, MoE and vision train steps, the
trainers and a tune trial of a trainer on the card.

Every test needs an NVIDIA card and nvcc and skips without one. On a
machine with a card (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention, fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("R,E,dtype", [
    (1, 1024, torch.float32), (3, 1001, torch.float32),
    (5, 1001, torch.bfloat16), (7, 4096, torch.bfloat16),
    (2, 8192, torch.float32), (300, 2048, torch.bfloat16),
])
def test_rms_norm_kernel_matches_plain(dev, R, E, dtype):
    g = _gen(R + E)
    x = torch.randn(R, E, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(E, generator=g, device=dev)).to(dtype)
    got = fused.rms_norm(x, w, 1e-5)
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(),
                               fused._rms_norm_ref(x, w, 1e-5).float(), **tol)


def test_rms_norm_kernel_unaligned_rows_take_scalar_loads(dev):
    flat = torch.randn(1 + 4 * 64, generator=_gen(1), device=dev)
    x = flat[1:].view(4, 64)            # contiguous, 4 bytes off 16
    w = torch.ones(64, device=dev)
    torch.testing.assert_close(fused.rms_norm(x, w, 1e-5),
                               fused._rms_norm_ref(x, w, 1e-5), atol=1e-6,
                               rtol=1e-5)


# Rows of a decode tick (8), a prefill bucket (64), many (4096); widths
# under a warp's vector reach (64), 16-byte but not 32-byte rows (1000),
# rows the vector loads cannot take (1001), the flagship's (1024), a wide
# row (4096) and one wider than the backward's vector route (3001, scalar).
_K1_ROWS, _K1_WIDTHS = (1, 8, 64, 4096), (64, 1000, 1001, 1024, 3001, 4096)


def _k1_inputs(dev, R, E, dtype, seed):
    g = _gen(seed)
    x, a, gy, gh = (torch.randn(R, E, generator=g, device=dev).to(dtype)
                    for _ in range(4))
    w = (1 + 0.1 * torch.randn(E, generator=g, device=dev)).to(dtype)
    return x, a, w, gy, gh


@pytest.mark.parametrize("E", _K1_WIDTHS)
@pytest.mark.parametrize("R", _K1_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_kernel_gives_add_then_rms_norm_bits(dev, R, E, dtype):
    """The residual form of K1: h equals PyTorch's x + a and y the plain
    K1 launch on that h, bit for bit."""
    x, a, w, _, _ = _k1_inputs(dev, R, E, dtype, R + E)
    h, y = fused.add_rms_norm(x, a, w, 1e-5)
    assert torch.equal(h, x + a)
    assert torch.equal(y, fused.rms_norm(h, w, 1e-5))


def test_add_rms_norm_kernel_unaligned_rows_take_scalar_loads(dev):
    flat = torch.randn(2, 1 + 4 * 64, generator=_gen(2), device=dev)
    x, a = (f[1:].view(4, 64) for f in flat)   # contiguous, 4 bytes off 16
    w = torch.ones(64, device=dev)
    h, y = fused.add_rms_norm(x, a, w, 1e-5)
    assert torch.equal(h, x + a)
    # The same scalar route on h: an unaligned copy of it.
    h_off = torch.empty(1 + 4 * 64, device=dev)[1:].view(4, 64)
    h_off.copy_(h)
    assert torch.equal(y, fused.rms_norm(h_off, w, 1e-5))


@pytest.mark.parametrize("with_gh", [True, False], ids=["g_h", "no_g_h"])
@pytest.mark.parametrize("E", _K1_WIDTHS)
@pytest.mark.parametrize("R", _K1_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_kernel_matches_plain(dev, R, E, dtype, with_gh):
    """The backward kernel against the plain backward (plus g_h, added as
    autograd adds it), and against itself on a second launch (the same
    bits). f32: dx within atol = rtol = 1e-5; dw within
    fused._rms_norm_dw_bound, since over thousands of rows the plain column
    sum is itself further than 1e-5 from the exact one. bf16: dw, and dx
    without g_h, within atol = rtol = 2^-7, the JAX grad test's tolerance;
    dx with g_h within fused._rms_norm_dx_bound, since the plain version
    rounds twice where the kernel rounds once."""
    _, _, w, gy, gh = _k1_inputs(dev, R, E, dtype, 2 * R + E)
    h = torch.randn(R, E, generator=_gen(R), device=dev).to(dtype)
    gh = gh if with_gh else None
    dx, dw = fused._rms_norm_bwd_cuda(h, w, gy, gh, 1e-5)
    dx2, dw2 = fused._rms_norm_bwd_cuda(h, w, gy, gh, 1e-5)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    dx_norm, want_dw = fused._rms_norm_bwd(h, w, gy, 1e-5)
    want_dx = dx_norm + gh if with_gh else dx_norm
    assert dx.dtype == dw.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(dx, want_dx, atol=1e-5, rtol=1e-5)
        blocks = fused._rms_fn("rms_norm_backward_blocks")(R)
        bound = fused._rms_norm_dw_bound(h, gy, 1e-5, want_dw, blocks)
        assert bool(((dw - want_dw).abs() <= bound).all())
    else:
        checks = [(dw, want_dw)] + ([] if with_gh else [(dx, want_dx)])
        for got, want in checks:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2 ** -7, rtol=2 ** -7)
        if with_gh:
            bound = fused._rms_norm_dx_bound(dx, want_dx, dx_norm)
            assert bool(((dx.float() - want_dx.float()).abs()
                         <= bound).all())


def test_rms_norm_backward_counts_one_launch_per_norm_of_a_step(dev):
    """A train step launches K1's forward once plain and 2L times in its
    residual form, and its backward kernel 2L + 1 times."""
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      make_train_step)

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=3,
                            n_heads=2, n_kv_heads=2, d_ff=256,
                            max_seq_len=64)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    init_opt, step = make_train_step(cfg)
    opt = init_opt(params)
    tokens = torch.randint(0, 256, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        before = (fused.rms_norm.launches, fused.add_rms_norm.launches,
                  fused.rms_norm.backward_launches)
        step(params, opt, {"tokens": tokens})
        after = (fused.rms_norm.launches, fused.add_rms_norm.launches,
                 fused.rms_norm.backward_launches)
        L = cfg.n_layers
        assert [b - a for a, b in zip(before, after)] == [1, 2 * L,
                                                          2 * L + 1]


def _split_edges(B, KH, S, count):
    """count lengths below S at the split edges of the decode kernels' plan
    at B*KH (attention.decode_splits): a length whose last row is the first
    row of a split (a split of one row) or the row before it (the last row
    of the split before), spread over the ones there are."""
    n_split = attention.decode_splits(B * KH)
    edges = set()
    for L in range(1, S):
        plan = attention.split_plan(L, n_split)
        if len(plan) > 1 and plan[-1][0] == L:
            edges |= {L - 1, L}
    edges = sorted(edges)
    return [edges[round(i * (len(edges) - 1) / (count - 1))]
            for i in range(count)]


@pytest.mark.parametrize("B,H,KH,D,S,lengths", [
    (2, 6, 2, 128, 100, [99, 0]),        # G = 3, S not a tile multiple
    (3, 4, 4, 64, 65, [63, 64, 1]),      # tile edges
    (1, 16, 1, 64, 300, [200]),          # MQA, G = 16
    (8, 16, 16, 64, 2048, _split_edges(8, 16, 2048, 8)),   # 4 splits
    (4, 32, 4, 128, 1024, [0, 511, 64, 1023]),   # GQA G = 8: 32 splits
    (2, 16, 16, 64, 8192, [8191, 5000]),   # long cache: 16 splits
    (2, 8, 8, 64, 300, [299, 350]),      # S - 1, and past it (clamped)
])
def test_decode_kernel_matches_plain_f32(dev, B, H, KH, D, S, lengths):
    """K6 against its plain version (atol 2e-5: summation order), split
    over blocks as the wrapper's plan says, and a second launch on the same
    inputs gives the same bits (the merge's order is the splits', not
    their arrival's)."""
    g = _gen(S)
    q = torch.randn(B, H, D, generator=g, device=dev)
    # Strided views: rows of a wider pool, as a layer slice of the cache.
    pool_k = torch.randn(2, B, S + 7, KH, D, generator=g, device=dev)
    pool_v = torch.randn(2, B, S + 7, KH, D, generator=g, device=dev)
    k, v = pool_k[1, :, :S], pool_v[1, :, :S]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = attention.decode_attention(q, k, v, lens)
    torch.testing.assert_close(
        got, attention._decode_attention_ref(q, k, v, lens), atol=2e-5,
        rtol=0)
    assert torch.equal(attention.decode_attention(q, k, v, lens), got)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fused.rms_norm(x, torch.ones(64, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        fused.rms_norm(torch.randn(64, 4, device=dev).t(),
                       torch.ones(64, device=dev))
    q = torch.randn(1, 2, 96, device=dev)
    k = torch.randn(1, 8, 2, 96, device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="D in"):
        attention.decode_attention(q, k, k, lens)
    q, k = torch.randn(1, 2, 64, device=dev), torch.randn(1, 8, 2, 64,
                                                         device=dev)
    with pytest.raises(TypeError, match="int32"):
        attention.decode_attention(q, k, k, lens.long())


def test_engine_on_card_matches_engine_on_cpu_f32(dev):
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.models.engine import GenerationEngine

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=256,
                            max_seq_len=128, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4], [20, 21, 22, 23]]
    outs = []
    for device in ("cpu", "cuda"):
        eng = GenerationEngine(params, cfg, max_slots=3, device=device)
        ids = [eng.submit(p, 6) for p in prompts]
        res = eng.run_until_done()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("N,V,dtype,label_dtype", [
    (1, 7, torch.float32, torch.int64), (3, 1001, torch.float32, torch.int32),
    (5, 1001, torch.bfloat16, torch.int64),
    (9, 4096, torch.bfloat16, torch.int32),
])
def test_xent_kernel_matches_plain(dev, N, V, dtype, label_dtype):
    """f32 losses: atol 1e-5, rtol 1e-5 (summation order); bf16 logits are
    widened exactly, so the same tolerance holds."""
    g = _gen(N * V)
    logits = (4 * torch.randn(N, V, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev,
                           dtype=label_dtype)
    torch.testing.assert_close(fused.softmax_cross_entropy(logits, labels),
                               fused._xent_ref(logits, labels), atol=1e-5,
                               rtol=1e-5)


def test_xent_kernel_strided_rows_and_out_of_range_label(dev):
    """Rows of a wider buffer (row stride > V), and a label outside [0, V)
    picks 0, as the Pallas kernel's one-hot does: the loss is the lse."""
    buf = torch.randn(4, 300, generator=_gen(7), device=dev)
    logits = buf[:, :257]
    labels = torch.tensor([0, 256, -1, 257], device=dev)
    got = fused.softmax_cross_entropy(logits, labels)
    lse = torch.logsumexp(logits, -1)
    torch.testing.assert_close(got[:2], fused._xent_ref(logits[:2],
                                                        labels[:2]),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[2:], lse[2:], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T,S,H,KH,D,causal", [
    (1, 1, 1, 1, 1, 64, True),           # one row
    (2, 65, 65, 2, 2, 64, True),         # a tile and one row
    (1, 100, 100, 6, 2, 128, True),      # G = 3, ragged
    (2, 50, 70, 4, 1, 64, False),        # T != S, MQA
    (1, 40, 150, 2, 2, 64, True),        # causal S > T: kv tiles no q sees
    (1, 64, 64, 16, 1, 128, True),       # MQA, G = 16
    (1, 130, 130, 8, 8, 128, False),
    # Tile edges of the tensor-core forward (128 q rows at D 64, 64 at
    # D 128; 64 kv rows a tile).
    (1, 127, 127, 4, 2, 64, True),
    (1, 128, 128, 4, 2, 64, True),
    (2, 129, 129, 4, 2, 64, True),
    (1, 257, 257, 4, 2, 64, False),
    (1, 129, 129, 8, 2, 128, True),
    (1, 100, 300, 4, 2, 64, True),       # causal S > T over 5 kv tiles
    (1, 200, 200, 16, 2, 128, True),     # D 128, G = 8
    # Tile edges of the tensor-core backward (K4: 128 q rows at D 64, 64
    # at D 128, 64 kv rows a tile; K5: 64 kv rows, 64 q rows a tile), and
    # causal S < T (rows past S see every key).
    (1, 63, 63, 4, 2, 64, True),
    (1, 64, 64, 4, 2, 64, False),
    (1, 63, 63, 4, 2, 128, True),
    (1, 65, 65, 4, 2, 128, False),
    (1, 300, 100, 4, 2, 64, True),
    (1, 200, 70, 8, 2, 128, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(dev, B, T, S, H, KH, D, causal, dtype):
    """K3-K5 against the plain versions. f32: out/lse atol 1e-5, grads
    atol 1e-4 (summation order); bf16: atol = rtol = 2e-2 (p rounded to
    bf16 against a running vs the final max; bf16 outputs), and the bf16
    grads also within attention._flash_grad_bounds (roundings of p and ds
    that flip when s and dp are summed in another order)."""
    g = _gen(T * S + D)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KH, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KH, D, generator=g, device=dev).to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    f32 = dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if f32 else dict(atol=2e-2, rtol=2e-2)
    gtol = dict(atol=1e-4, rtol=1e-4) if f32 else tol
    out, lse = attention.flash_forward(q, k, v, causal)
    ref_out, ref_lse = attention._flash_forward_ref(q, k, v, causal)
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    dsum = attention._flash_dsum(ref_out, do)
    _check_grads(q, k, v, do, ref_lse, dsum, causal, gtol)


def _check_grads(q, k, v, do, lse, dsum, causal, gtol):
    args = (q, k, v, do, lse, dsum, causal)
    got = (attention.flash_backward_dq(*args),
           *attention.flash_backward_dkv(*args))
    want = (attention._flash_backward_dq_ref(*args),
            *attention._flash_backward_dkv_ref(*args))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **gtol)
    if q.dtype == torch.bfloat16:
        bounds = attention._flash_grad_bounds(*args[:6], *want, causal=causal)
        for g, w, b in zip(got, want, bounds):
            assert ((g.float() - w.float()).abs() <= b).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_read_strided_views(dev, dtype):
    """q/k/v as head slices of a fused [B, T, 3, H, D] projection, and do
    a head slice of a wider buffer: the kernels read through the strides,
    no copies (in bf16 the cp.async loads do). Tolerances as in
    test_flash_kernels_match_plain."""
    qkv = torch.randn(2, 80, 3, 4, 64, generator=_gen(3), device=dev)
    q, k, v = qkv.to(dtype).unbind(2)
    do = torch.randn(2, 80, 6, 64, generator=_gen(4),
                     device=dev).to(dtype)[:, :, 1:5]
    assert not q.is_contiguous() and not do.is_contiguous()
    out, lse = attention.flash_forward(q, k, v, True)
    ref_out, ref_lse = attention._flash_forward_ref(q, k, v, True)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    _check_grads(q, k, v, do, ref_lse, attention._flash_dsum(ref_out, do),
                 True, dict(atol=1e-4, rtol=1e-4)
                 if dtype == torch.float32 else tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_is_deterministic(dev, dtype):
    """Two launches on the same inputs give the same bits: no atomics, a
    fixed summation order."""
    g = _gen(11)
    q = torch.randn(2, 300, 8, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 300, 2, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 300, 2, 128, generator=g, device=dev).to(dtype)
    for causal in (True, False):
        out1, lse1 = attention.flash_forward(q, k, v, causal)
        out2, lse2 = attention.flash_forward(q, k, v, causal)
        assert torch.equal(out1, out2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(dev, dtype, D):
    """Two launches of K4 and of K5 on the same inputs give the same bits:
    each block writes its own output tile once, no atomics."""
    g = _gen(12)
    q = torch.randn(2, 300, 8, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 300, 2, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 300, 2, D, generator=g, device=dev).to(dtype)
    do = torch.randn(2, 300, 8, D, generator=g, device=dev).to(dtype)
    for causal in (True, False):
        out, lse = attention.flash_forward(q, k, v, causal)
        args = (q, k, v, do, lse, attention._flash_dsum(out, do), causal)
        dq1, dq2 = (attention.flash_backward_dq(*args) for _ in range(2))
        (dk1, dv1), (dk2, dv2) = (attention.flash_backward_dkv(*args)
                                  for _ in range(2))
        assert torch.equal(dq1, dq2)
        assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


def _grads_on(device, fn, *arrays):
    ts = [a.to(device).requires_grad_(a.is_floating_point()) for a in arrays]
    out = fn(*ts)
    seed = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(out, [t for t in ts if t.requires_grad],
                                seed.to(device))
    return [out.detach().cpu()] + [t.cpu() for t in grads]


@pytest.mark.parametrize("op", ["flash_attention", "softmax_cross_entropy",
                                "rms_norm", "add_rms_norm"])
def test_autograd_on_card_matches_cpu_f32(dev, op):
    """torch.autograd.grad through each differentiable wrapper on the card
    (kernel forward) and on the CPU (plain forward), f32: outputs and
    input grads within atol 1e-4, rtol 1e-4 (summation order)."""
    g = torch.Generator().manual_seed(0)
    fn, arrays = {
        "flash_attention": (
            lambda q, k, v: attention.flash_attention(q, k, v, causal=True),
            [torch.randn(2, 70, 4, 64, generator=g),
             torch.randn(2, 70, 2, 64, generator=g),
             torch.randn(2, 70, 2, 64, generator=g)]),
        "softmax_cross_entropy": (
            fused.softmax_cross_entropy,
            [3 * torch.randn(6, 333, generator=g),
             torch.randint(0, 333, (6,), generator=g)]),
        "rms_norm": (
            lambda x, w: fused.rms_norm(x, w, 1e-5),
            [torch.randn(3, 5, 96, generator=g),
             1 + 0.1 * torch.randn(96, generator=g)]),
        "add_rms_norm": (
            lambda x, a, w: torch.stack(fused.add_rms_norm(x, a, w, 1e-5)),
            [torch.randn(3, 5, 96, generator=g),
             torch.randn(3, 5, 96, generator=g),
             1 + 0.1 * torch.randn(96, generator=g)]),
    }[op]
    for got, want in zip(_grads_on(dev, fn, *arrays),
                         _grads_on("cpu", fn, *arrays)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_rms_norm_on_card_is_differentiable_and_decode_refuses_grad(dev):
    """The slice-1 fault: rms_norm's kernel output carried no grad_fn on
    the card. It now does; decode_attention, which has no backward, raises
    instead of returning a constant."""
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    w = torch.ones(64, device=dev, requires_grad=True)
    y = fused.rms_norm(x, w)
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad is not None and w.grad is not None
    q = torch.randn(1, 2, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 8, 2, 64, device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.decode_attention(q, k, k, lens)
    with torch.no_grad():
        assert attention.decode_attention(q, k, k, lens).shape == (1, 2, 64)


def test_flash_wrappers_raise_on_the_card(dev):
    q = torch.randn(1, 8, 2, 96, device=dev)
    with pytest.raises(ValueError, match="D in"):
        attention.flash_forward(q, q, q)
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_forward(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.flash_forward(q, q.cpu(), q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.softmax_cross_entropy(torch.randn(2, 8, device=dev),
                                    torch.zeros(2, dtype=torch.long))


def test_train_step_on_card_matches_cpu_small_f32(dev):
    """Three make_train_step steps of a small GQA config on the card and on
    the CPU from the same weights, f32: losses within 1e-5."""
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      make_train_step)

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=512,
                            max_seq_len=128, dtype=torch.float32)
    tokens = torch.randint(0, 512, (2, 97),
                           generator=torch.Generator().manual_seed(2))
    losses = []
    for device in ("cpu", "cuda"):
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device=device)
        init_opt, step = make_train_step(cfg)
        opt = init_opt(params)
        losses.append([step(params, opt, {"tokens": tokens})[2].item()
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5, rtol=0)


def _paged_inputs(B, H, KH, D, ps, P, lengths, dtype, seed):
    """A pool (a layer slice of a two-layer pool, read through its strides)
    with shuffled pages past the scratch page 0, and tables -1 padded past
    each sequence's pages."""
    g = _gen(seed)
    num_pages = B * P + 3
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(2, num_pages, ps, KH, D, generator=g,
                    device="cuda").to(dtype)[1]
    v = torch.randn(2, num_pages, ps, KH, D, generator=g,
                    device="cuda").to(dtype)[1]
    ids = np.random.default_rng(seed).permutation(B * P) + 1
    table = np.full((B, P), -1, np.int32)
    for b, L in enumerate(lengths):
        used = min(-(-(L + 1) // ps), P)
        table[b, :used] = ids[b * P:b * P + used]
    return (q, k, v, torch.tensor(table, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


_PAGED_SHAPES = [   # (B, H, KH, D, ps, P, lengths): chip_smoke's phase 2
    (6, 16, 16, 64, 128, 16, [0, 127, 128, 600, 2047, 0]),   # flagship
    (4, 32, 4, 128, 64, 16, [0, 63, 500, 1023]),    # GQA, G = 8: 32 splits
    (3, 8, 2, 64, 16, 8, [80, 127, 3]),                      # small page
    (3, 16, 1, 128, 32, 4, [127, 200, 0]),   # MQA, length past P*ps - 1
    (8, 16, 16, 64, 128, 16,                 # 4 splits: their edges
     _split_edges(8, 16, 2048, 7) + [0]),
    (3, 16, 16, 64, 128, 64, [8191, 5000, 0]),   # long: 11 splits
]


@pytest.mark.parametrize("B,H,KH,D,ps,P,lengths", _PAGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(dev, B, H, KH, D, ps, P, lengths,
                                           dtype):
    """K7 against its plain version (f32 atol 2e-5: summation order; bf16
    atol = rtol = 2e-2: the plain version rounds scores to bf16), the last
    row idle (length 0, a table of -1), bit for bit equal to K6 on the
    same rows gathered into a contiguous cache (same split plan, tiles and
    arithmetic), and to itself on a second launch."""
    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, table, lens = _paged_inputs(B, H, KH, D, ps, P, lengths, dtype,
                                         seed=D + ps)
    table[-1] = -1
    lens[-1] = 0
    with torch.inference_mode():
        got = pa.paged_decode_attention(q, k, v, table, lens)
        want = pa._paged_decode_ref(q, k, v, table, lens)
        tol = (dict(atol=2e-5, rtol=0) if dtype == torch.float32
               else dict(atol=2e-2, rtol=2e-2))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(pa.paged_decode_attention(q, k, v, table, lens),
                           got)
        # K6 attends at most S - 1; clamp as K7 clamps at P * ps - 1.
        kc = pa.paged_gather(k, table).contiguous()
        vc = pa.paged_gather(v, table).contiguous()
        k6 = attention.decode_attention(q, kc, vc,
                                        lens.clamp_max(P * ps - 1))
        assert torch.equal(got, k6)


def test_paged_decode_kernel_refuses_grad_and_bad_args(dev):
    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, table, lens = _paged_inputs(2, 4, 2, 64, 16, 4, [10, 30],
                                         torch.float32, seed=1)
    with pytest.raises(RuntimeError, match="no backward"):
        pa.paged_decode_attention(q.requires_grad_(), k, v, table, lens)
    with torch.no_grad():
        assert pa.paged_decode_attention(q, k, v, table, lens).shape == \
            q.shape
        with pytest.raises(TypeError, match="int32"):
            pa.paged_decode_attention(q, k, v, table.long(), lens)
        with pytest.raises(ValueError, match="CUDA tensors"):
            pa.paged_decode_attention(q, k, v, table.cpu(), lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_engine_on_card_equals_contiguous_engine(dev, dtype):
    """Greedy outputs of the paged engine (shared 2-page prefix, page size
    32, chunked prefill for the longest prompt) equal the contiguous
    engine's on the card, token for token."""
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.models.engine import GenerationEngine
    from ray_tpu_torch.models.paged_engine import PagedGenerationEngine

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=512,
                            max_seq_len=512, dtype=dtype)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 512, 64).tolist()
    prompts = [prefix + rng.integers(0, 512, int(n)).tolist()
               for n in rng.integers(4, 60, 9)]
    outs = []
    for cls, kw in ((GenerationEngine, {}),
                    (PagedGenerationEngine, dict(page_size=32))):
        eng = cls(params, cfg, max_slots=4, device="cuda", **kw)
        ids = [eng.submit(p, 12) for p in prompts]
        res = eng.run_until_done()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]


# ------------------------------------------------- speculative decoding

_SPEC_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=512, max_seq_len=64)    # head_dim 64


def _spec_setup(seed):
    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=torch.float32, **_SPEC_CFG)
    params = init_params(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    return cfg, params


def _verify_inputs(which, cfg, lengths, seed):
    """tokens [B, 4] and a random cache (contiguous [L, B, 32, KH, Dh]) or
    pool (paged: 10 pages of 8 rows, tables with -1 entries and a position
    past the table) for the verify forwards, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    B, S = len(lengths), 4
    L, KH, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    if which == "contiguous":
        shape = (L, B, 32, KH, Dh)
        return tokens, lens, None, (torch.randn(shape, generator=g),
                                    torch.randn(shape, generator=g))
    tables = torch.tensor([[3, 5, 7], [4, -1, -1], [3, 6, -1]],
                          dtype=torch.int32)[:B]
    shape = (L, 10, 8, KH, Dh)
    return tokens, lens, tables, (torch.randn(shape, generator=g),
                                  torch.randn(shape, generator=g))


def _run_verify(which, params, cfg, tokens, lens, tables, kv, device):
    from ray_tpu_torch.models import to_compute
    from ray_tpu_torch.models.paged_engine import _paged_verify
    from ray_tpu_torch.models.speculative import _batched_verify

    p = to_compute(params, cfg, device)
    k, v = (t.clone().to(device) for t in kv)
    with torch.inference_mode():
        if which == "contiguous":
            out = _batched_verify(p, tokens.to(device), lens.to(device), k,
                                  v, cfg)
        else:
            out = _paged_verify(p, tokens.to(device), lens.to(device),
                                tables.to(device), k, v, cfg)
    return out.cpu(), k.cpu(), v.cpu()


@pytest.mark.parametrize("which,lengths", [
    ("contiguous", [5, 17, 0]), ("paged", [22, 10, 9])])
def test_verify_on_card_matches_cpu_f32(dev, which, lengths):
    """The verify forward (K1 on the card, plain masked attention) against
    the same forward on the CPU, f32: logits and the written cache or pool
    within atol 1e-4, rtol 1e-4 (summation order)."""
    cfg, params = _spec_setup(0)
    args = _verify_inputs(which, cfg, lengths, seed=1)
    got = _run_verify(which, params, cfg, *args, device=dev)
    want = _run_verify(which, params, cfg, *args, device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_verify_write_past_the_cache_is_clamped_on_card(dev):
    """A chunk that would run past S_max writes at S_max - S, as JAX's
    dynamic_update_slice clamps it, and does not fault the card: logits
    and cache equal the CPU's, and the rows before the clamp are left
    as they were."""
    cfg, params = _spec_setup(0)
    tokens, lens, _, kv = _verify_inputs("contiguous", cfg, [30, 31, 0],
                                         seed=2)
    got = _run_verify("contiguous", params, cfg, tokens, lens, None, kv,
                      device=dev)
    torch.cuda.synchronize()
    want = _run_verify("contiguous", params, cfg, tokens, lens, None, kv,
                       device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert torch.equal(got[1][:, :2, :28], kv[0][:, :2, :28])


def _count_ticks(eng):
    """Wrap the engine's verify and decode passes: the launches of each
    counted kernel in every call, by the pass that made them."""
    from ray_tpu_torch.ops import paged_attention

    counters = {"rms_norm": (fused.rms_norm, "launches"),
                "add_rms_norm": (fused.add_rms_norm, "launches"),
                "decode_attention": (attention.decode_attention,
                                     "launches"),
                "paged_decode_attention": (
                    paged_attention.paged_decode_attention, "launches")}
    seen = {"verify": [], "decode": []}

    def wrap(kind, fn):
        def run(*a):
            before = {n: getattr(f, at) for n, (f, at) in counters.items()}
            out = fn(*a)
            seen[kind].append({n: getattr(f, at) - before[n]
                               for n, (f, at) in counters.items()})
            return out
        return run

    eng._verify_all = wrap("verify", eng._verify_all)
    eng._decode_all = wrap("decode", eng._decode_all)
    return seen


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                      "paged"])
def test_speculative_ticks_launch_the_path_kernels(dev, paged):
    """With speculation on, every verify tick launches K1 2L+1 times (1
    plain, 2L residual) and no decode kernel; the contiguous engine never
    runs its decode pass; a paged tick with no drafts launches K1 2L+1
    times and K7 L times. Greedy outputs equal the same engine's on the
    CPU."""
    from ray_tpu_torch.models.engine import GenerationEngine
    from ray_tpu_torch.models.paged_engine import PagedGenerationEngine

    cfg, params = _spec_setup(0)
    L = cfg.n_layers
    cls, kw = ((PagedGenerationEngine, dict(page_size=8)) if paged
               else (GenerationEngine, {}))
    # The first request runs alone for one tick, on which nothing can
    # draft: its trailing bigram (37, first token) has no earlier match.
    prompts = [[4, 8, 15, 16, 23, 42, 37], [5, 6, 7, 5, 6, 7, 5, 6],
               [4, 8, 15, 16, 23, 42, 37], [9, 9, 9, 9]]
    news = [2, 12, 12, 12]
    outs = []
    for device in ("cpu", "cuda"):
        eng = cls(params, cfg, max_slots=3, speculative_k=3, device=device,
                  **kw)
        seen = _count_ticks(eng)
        res = {}
        for batch in ((0,), (1, 2, 3)):
            ids = {eng.submit(prompts[j], news[j]): j for j in batch}
            res.update({ids[r]: out for r, out in
                        eng.run_until_done().items()})
        outs.append([res[j] for j in range(len(prompts))])
    assert outs[0] == outs[1]
    verify = dict(rms_norm=1, add_rms_norm=2 * L, decode_attention=0,
                  paged_decode_attention=0)
    assert seen["verify"] and all(c == verify for c in seen["verify"])
    if paged:
        decode = dict(verify, paged_decode_attention=L)
        assert seen["decode"] and all(c == decode for c in seen["decode"])
    else:
        assert seen["decode"] == []


# ------------------------------------------------ scheduler passes, substrate


def _sched_dag(seed, T=3000, N=24):
    from ray_tpu_torch.scheduler.dag import random_dag, uniform_cluster

    demand, parents = random_dag(T, num_classes=6, parent_window=300,
                                 seed=seed)
    rng = np.random.default_rng(seed)
    locality = rng.integers(-1, N, size=T).astype(np.int32)
    mask = rng.random(N) < 0.8
    mask[0] = True
    return demand, parents, uniform_cluster(N, cpu=8), locality, mask


@pytest.mark.parametrize("case", ["plain", "locality_mask", "one_round",
                                  "tensors_on_card"])
def test_schedule_dag_on_card_equals_cpu(dev, case):
    """S1 and S2: placements and rounds on the card equal the CPU's, bit
    for bit, and come back on the card."""
    from ray_tpu_torch.scheduler import kernel as sk

    demand, parents, avail, locality, mask = _sched_dag(3)
    kw = dict(chunk=512)
    if case in ("locality_mask", "one_round"):
        kw.update(locality=locality, node_mask=mask)
    if case == "one_round":
        kw.update(max_rounds=1)
    want, want_r = sk.schedule_dag(demand, parents, avail, sk.prng_key(3),
                                   device="cpu", **kw)
    if case == "tensors_on_card":
        demand, parents, avail = (torch.from_numpy(a).to(dev)
                                  for a in (demand, parents, avail))
        got, got_r = sk.schedule_dag(demand, parents, avail,
                                     sk.prng_key(3), **kw)
    else:
        got, got_r = sk.schedule_dag(demand, parents, avail,
                                     sk.prng_key(3), **kw)
    assert got.device.type == got_r.device.type == "cuda"
    assert torch.equal(got.cpu(), want) and int(got_r) == int(want_r)


def test_schedule_dag_round_body_never_syncs(dev):
    """Inside a round nothing waits for the card: the only sync is the
    loop's condition, outside the body."""
    from ray_tpu_torch.scheduler import kernel as sk

    demand, parents, avail, locality, mask = _sched_dag(5)
    st = sk._DagRounds(demand, parents, avail, sk.prng_key(5), locality,
                       mask, 512, torch.device("cuda"))
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in range(3):
            st.step(r, st.ready())
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def test_scheduler_passes_refuse_to_move_card_inputs_to_the_cpu(dev):
    from ray_tpu_torch.scheduler import kernel as sk

    demand, parents, avail, _, _ = _sched_dag(1, T=50)
    with pytest.raises(ValueError, match="not moved"):
        sk.schedule_dag(torch.from_numpy(demand).to(dev), parents, avail,
                        sk.prng_key(0), device="cpu")
    with pytest.raises(ValueError, match="not moved"):
        sk.BatchScheduler(torch.from_numpy(avail).to(dev), device="cpu")


def test_gang_reason_locality_passes_on_card_equal_cpu(dev):
    """S3-S5 at control-plane sizes: the card's codes equal the CPU's."""
    from ray_tpu_torch.scheduler import kernel as sk

    rng = np.random.default_rng(4)
    sizes = rng.integers(1, 9, size=200)
    group = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    gd = rng.integers(0, 4000, size=(len(group), 4)).astype(np.int32)
    strategy = (np.arange(len(sizes)) % 4).astype(np.int32)
    avail = rng.integers(2000, 16000, size=(256, 4)).astype(np.int32)
    for r in range(3):
        args = (gd, group, strategy, avail, sk.prng_key(7))
        np.testing.assert_array_equal(
            sk.admit_gangs_host(*args, round_idx=r),
            sk.admit_gangs_host(*args, round_idx=r, device="cpu"))
    T = 5000
    pend = (rng.integers(0, 20000, size=(T, 4)).astype(np.int32),
            rng.integers(-2, 256, size=T).astype(np.int32), avail,
            rng.random(T) < 0.2, rng.random(T) < 0.2, rng.random(T) < 0.2)
    np.testing.assert_array_equal(sk.classify_pending_host(*pend),
                                  sk.classify_pending_host(*pend,
                                                           device="cpu"))
    b = rng.integers(0, 1 << 40, size=(4096, 256))
    b[rng.random(b.shape) < 0.6] = 0
    b[::50] = 0
    np.testing.assert_array_equal(sk.score_locality_host(b),
                                  sk.score_locality_host(b, device="cpu"))


def test_collapsed_and_batch_scheduler_on_card_equal_cpu(dev):
    from ray_tpu_torch.scheduler import kernel as sk
    from ray_tpu_torch.scheduler.dag import uniform_cluster

    demand, parents, avail, locality, _ = _sched_dag(8)
    got = sk.schedule_dag_collapsed(demand, parents, avail, sk.prng_key(8),
                                    locality=locality, chunk=256)
    want = sk.schedule_dag_collapsed(demand, parents, avail, sk.prng_key(8),
                                     locality=locality, chunk=256,
                                     device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    card = sk.BatchScheduler(uniform_cluster(64), seed=2, chunk=1024)
    cpu = sk.BatchScheduler(uniform_cluster(64), seed=2, chunk=1024,
                            device="cpu")
    assert card.avail.device.type == "cuda"
    rng = np.random.default_rng(2)
    for tick in range(6):
        d = np.zeros((1024, 4), np.int32)
        d[:, 0] = rng.choice([500, 1000, 4000], size=1024)
        np.testing.assert_array_equal(card.place(d), cpu.place(d))
        if tick == 2:
            for s in (card, cpu):
                s.update_node(5, np.array([0, 0, 0, 0], np.int32))


def test_cuda_tensors_roundtrip_through_serialization(dev):
    pytest.importorskip("cloudpickle")
    from ray_tpu_torch._private.serialization import (
        SerializedObject, get_context)

    g = _gen(0)
    f32 = torch.randn(33, 17, generator=g, device=dev)
    value = {"f32": f32, "bf16": [f32.bfloat16()[:, :5]],
             "i64": torch.arange(9, device=dev), "cpu": torch.ones(3)}
    ctx = get_context()
    out = ctx.deserialize(SerializedObject.from_bytes(
        ctx.serialize(value).to_bytes()))
    for got, want in ((out["f32"], f32), (out["bf16"][0], value["bf16"][0]),
                      (out["i64"], value["i64"]), (out["cpu"], value["cpu"])):
        assert got.device.type == want.device.type
        assert got.dtype == want.dtype and torch.equal(got, want)


# ------------------------------------------------- the local runtime (A4)


@pytest.fixture
def runtime(dev):
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_runtime_init_counts_the_card(runtime):
    assert runtime.cluster_resources()["GPU"] == torch.cuda.device_count()
    assert runtime.available_resources()["GPU"] == torch.cuda.device_count()


def test_gpu_task_runs_k1_on_a_put_tensor_without_a_copy(runtime):
    x = torch.randn(64, 1024, generator=_gen(3), device="cuda")
    w = (1 + 0.1 * torch.randn(1024, generator=_gen(4), device="cuda"))
    xr = runtime.put(x)

    @runtime.remote(num_gpus=1)
    def norm(t, weight):
        return t.data_ptr(), fused.rms_norm(t, weight, 1e-5)

    before = fused.rms_norm.launches
    ptr, out = runtime.get(norm.remote(xr, w))
    assert ptr == x.data_ptr() and runtime.get(xr) is x
    assert fused.rms_norm.launches == before + 1
    assert out.device.type == "cuda"
    torch.testing.assert_close(out, fused._rms_norm_ref(x, w, 1e-5),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spilled_cuda_tensor_comes_back_on_the_card(dev, dtype):
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, object_store_memory=5 * 2**20)
    try:
        vals = [torch.randn(2**20, generator=_gen(i), device=dev).to(dtype)
                for i in range(6)]
        refs = [ray_tpu_torch.put(v) for v in vals]
        assert ray_tpu_torch.state.object_store_stats()["spilled_objects"] > 0
        for ref, v in zip(refs, vals):
            got = ray_tpu_torch.get(ref)
            assert got.device == v.device and got.dtype == v.dtype
            assert torch.equal(got.view(torch.uint8), v.view(torch.uint8))
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------ the serve control plane (A5)


def test_lm_backend_behind_serve_on_card_matches_cpu_and_kill_frees(dev):
    """A small f32 LMBackend on the card behind serve gives the CPU
    backend's greedy tokens; killing its replica (C8: the replica closes
    its backend) gives its cache back and ends its pump thread."""
    import gc
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve import LMBackend, ServeRequest
    from ray_tpu_torch.serve.master import MASTER_NAME

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=256,
                            max_seq_len=128, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4], [20, 21, 22, 23]]
    cpu = LMBackend(params, cfg, max_slots=4, device="cpu")
    want = cpu([ServeRequest((p,), {"max_new_tokens": 6}) for p in prompts])
    cpu.close()

    ray_tpu_torch.init(num_cpus=4)
    try:
        serve.init()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        serve.create_backend("lm", LMBackend, params, cfg, max_slots=4,
                             config=serve.BackendConfig(
                                 max_batch_size=4, batch_wait_timeout_s=0.05,
                                 health_check_period_s=60.0))
        serve.create_endpoint("lm", backend="lm")
        h = serve.get_handle("lm")
        got = ray_tpu_torch.get([h.remote(p, max_new_tokens=6)
                                 for p in prompts], timeout=120)
        assert got == want
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - mem0
        assert held > 0
        master = ray_tpu_torch.get_actor(MASTER_NAME)
        replica = ray_tpu_torch.get(master.get_replicas.remote("lm"))[0]
        ray_tpu_torch.kill(replica)
        gc.collect()
        torch.cuda.synchronize()
        # At least the KV cache (k and v: L x slots x max_seq x KH x Dh f32)
        # comes back; the threads' cuBLAS workspaces may stay cached.
        cache = 2 * cfg.n_layers * 4 * cfg.max_seq_len * cfg.n_kv_heads \
            * cfg.head_dim * 4
        assert held - (torch.cuda.memory_allocated() - mem0) >= cache
        assert not any(t.name == "lm-engine-pump"
                       for t in threading.enumerate())
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_cli_started_head_places_on_the_card(dev, tmp_path):
    """``cli start --head`` with no ``--device`` starts a head whose GCS
    places on the card; ``cli stop`` takes it down."""
    import json
    import os
    import subprocess
    import sys

    from ray_tpu_torch.cluster.protocol import RpcClient

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["RAY_TPU_TORCH_SESSION_FILE"] = str(tmp_path / "session.json")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
            env=env, capture_output=True, text=True, timeout=120)

    out = cli("start", "--head", "--num-workers", "1", "--resources",
              '{"CPU": 2, "GPU": 1}')
    assert out.returncode == 0, out.stderr
    try:
        with open(env["RAY_TPU_TORCH_SESSION_FILE"]) as f:
            host, port = json.load(f)["address"].rsplit(":", 1)
        gcs = RpcClient(host, int(port))
        try:
            perf = gcs.call({"type": "debug_stats"})["place_perf"]
        finally:
            gcs.close()
        assert perf["device"].split(":")[0] == "cuda", perf
        status = cli("status")
        assert status.returncode == 0 and "'GPU': 1.0" in status.stdout
    finally:
        stop = cli("stop")
    assert stop.returncode == 0 and "stopped" in stop.stdout
    assert not os.path.exists(env["RAY_TPU_TORCH_SESSION_FILE"])


# ------------------------ the train library and single-device models (A7a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_matches_its_dense_version(dev, dtype):
    """The index-form moe_ffn against _moe_ffn_dense_ref on the card, with
    choices dropped (capacity factor 1.0): routing equal; y and every
    gradient within 1e-5 (f32) or 2^-7 (bf16) of its largest magnitude;
    two forwards the same bits."""
    from ray_tpu_torch.parallel import moe

    cfg = moe.MoEConfig(d_model=256, d_ff=512, n_experts=8, top_k=2,
                        capacity_factor=1.0, dtype=dtype)
    base = moe.init_moe_params(_gen(0), cfg, device=dev)
    x = torch.randn(2, 128, 256, generator=_gen(1), device=dev).to(dtype)
    gy = torch.randn(x.shape, generator=_gen(2), device=dev)
    outs = []
    for fn in (moe.moe_ffn_routed, moe._moe_ffn_dense_ref):
        p = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        xx = x.clone().requires_grad_(True)
        y, aux, r = fn(xx, p, cfg)
        ((y.float() * gy).sum() + aux).backward()
        outs.append((r, [y, aux, xx.grad] + [p[k].grad for k in sorted(p)]))
    (r, got), (rr, want) = outs
    for field in ("expert_idx", "position", "in_cap"):
        assert torch.equal(getattr(r, field), getattr(rr, field)), field
    assert not r.in_cap.all()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    with torch.no_grad():
        assert torch.equal(moe.moe_ffn(x, base, cfg)[0],
                           moe.moe_ffn(x, base, cfg)[0])


def _launch_counts():
    return (fused.rms_norm.launches, fused.add_rms_norm.launches,
            fused.rms_norm.backward_launches,
            fused.softmax_cross_entropy.launches,
            attention.flash_forward.launches,
            attention.flash_backward_dq.launches,
            attention.flash_backward_dkv.launches)


def test_moe_train_step_on_card_matches_cpu_and_launches_the_kernels(dev):
    """A 2-layer f32 MoE transformer (head_dim 64): one train step's loss
    and gradients on the card within 1e-4 and 1e-3 of each gradient's
    largest magnitude of the CPU's, through K1 (1 + 4 forward, 5 backward),
    K2 (1) and K3-K5 (2 each); a bf16 step's loss falls."""
    import dataclasses

    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models import moe_transformer as mt
    from ray_tpu_torch.models.transformer import named_leaves

    cfg = mt.MoETransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                                  n_heads=4, n_kv_heads=4, d_ff=512,
                                  max_seq_len=128, n_experts=4, top_k=2,
                                  dtype=torch.float32)
    gpu = mt.init_params(_gen(5), cfg, device=dev)
    cpu = tree_map(lambda t: t.cpu(), gpu)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 512, (2, 65)))
    runs = []
    for params in (gpu, cpu):
        for t in named_leaves(params).values():
            t.requires_grad_(True)
        before = _launch_counts()
        loss = mt.loss_fn(params, {"tokens": tokens}, cfg)
        loss.backward()
        after = _launch_counts()
        runs.append((loss.item(), {n: t.grad.cpu() for n, t in
                                   named_leaves(params).items()},
                     tuple(b - a for a, b in zip(before, after))))
    (gl, gg, gc), (cl, cg, cc) = runs
    assert gc == (1, 4, 5, 1, 2, 2, 2) and cc == (0,) * 7
    assert abs(gl - cl) < 1e-4
    for name, want in cg.items():
        err = (gg[name] - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item(), name

    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = mt.init_params(_gen(7), bcfg, device=dev)
    init_opt, train_step = mt.make_train_step(bcfg)
    opt = init_opt(params)
    losses = [train_step(params, opt, {"tokens": tokens})[2].item()
              for _ in range(3)]
    assert losses[-1] < losses[0]


def test_vision_step_on_card_matches_cpu(dev):
    """The vision family at the reference test's config (stride-2 blocks,
    projections) on the card: f32 logits and the loss within 1e-4 of the
    CPU's, and MeshTrainer's loss falls over 10 steps."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models import (VisionConfig, init_vision_params,
                                      vision_apply, vision_loss)
    from ray_tpu_torch.train import MeshTrainer

    cfg = VisionConfig(image_size=16, in_channels=1, num_classes=4,
                       widths=(8, 16), blocks_per_stage=2, groups=4)
    rng = np.random.default_rng(8)
    batch = {"images": torch.from_numpy(rng.standard_normal(
        (32, 16, 16, 1)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 4, 32))}
    params = init_vision_params(_gen(9), cfg, device=dev)
    cpu = tree_map(lambda t: t.cpu(), params)
    torch.testing.assert_close(
        vision_apply(params, batch["images"], cfg).cpu(),
        vision_apply(cpu, batch["images"], cfg), atol=1e-4, rtol=1e-4)
    trainer = MeshTrainer(lambda g: init_vision_params(g, cfg, device=dev),
                          lambda p, b: vision_loss(p, b, cfg),
                          learning_rate=3e-3, device=dev)
    stats = [trainer.train_step(batch) for _ in range(10)]
    assert stats[-1] < stats[0]


def test_tpu_trainer_on_card_counts_each_rank_s_launches(dev):
    """Two TPUTrainer workers on the card, a 1-layer flagship-shaped model:
    a step counts exactly twice one rank's launches (the counters'
    increments are atomic), and the loss falls."""
    import ray_tpu_torch
    from ray_tpu_torch.models import TransformerConfig, init_params, loss_fn
    from ray_tpu_torch.train import TPUTrainer

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=1,
                            n_heads=4, n_kv_heads=4, d_ff=512,
                            max_seq_len=128)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, 512, (2, 65))).to(dev)

    def data(rank, world, config):
        while True:
            yield {"tokens": tokens}

    ray_tpu_torch.init(num_cpus=4)
    try:
        t = TPUTrainer(lambda g: init_params(g, cfg, device=dev),
                       lambda p, b: loss_fn(p, b, cfg), data, num_workers=2,
                       device=dev)
        before = _launch_counts()
        losses = [t.train()["loss"] for _ in range(3)]
        after = _launch_counts()
        assert tuple(b - a for a, b in zip(before, after)) == tuple(
            3 * 2 * n for n in (1, 2, 3, 1, 1, 1, 1))
        assert losses[-1] < losses[0]
        t.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_tune_runs_a_trainer_trial_on_the_card(dev, tmp_path):
    """``tune.run`` of ``TPUTrainer.as_trainable`` with
    ``resources_per_trial={"GPU": 0.5}``: the trial's actor holds half the
    card (``num_gpus``), the trainer's parameters lie on the card, and each
    iteration counts one rank's train-step launches (K1 plain, residual and
    backward, K2, K3-K5) and no more."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models import TransformerConfig, init_params, loss_fn
    from ray_tpu_torch.train import TPUTrainer

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=1,
                            n_heads=4, n_kv_heads=4, d_ff=512,
                            max_seq_len=128)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, 512, (2, 65))).to(dev)

    def data(rank, world, config):
        while True:
            yield {"tokens": tokens}

    base = TPUTrainer.as_trainable(
        lambda g: init_params(g, cfg, device=dev),
        lambda p, b: loss_fn(p, b, cfg), data, num_workers=1, device=dev)

    class OnCard(base):
        def step(self):
            result = super().step()
            result["on_card"] = all(
                t.device.type == "cuda"
                for t in tree_leaves(self.trainer.params))
            result["gpu_free"] = ray_tpu_torch.available_resources().get(
                "GPU", 0.0)
            return result

    ray_tpu_torch.init(num_cpus=4)
    try:
        before = _launch_counts()
        analysis = tune.run(
            OnCard, config={"learning_rate": 1e-3},
            resources_per_trial={"CPU": 1, "GPU": 0.5},
            stop={"training_iteration": 3}, local_dir=str(tmp_path),
            verbose=0)
        after = _launch_counts()
        trial = analysis.trials[0]
        assert trial.status == "TERMINATED"
        assert trial.last_result["on_card"] is True
        assert trial.last_result["gpu_free"] == 0.5
        assert tuple(b - a for a, b in zip(before, after)) == tuple(
            3 * n for n in (1, 2, 3, 1, 1, 1, 1))
        assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    finally:
        ray_tpu_torch.shutdown()


def test_mesh_forward_on_the_card_matches_one_process(dev):
    """A 2-rank gloo world sharing the card: the f32 flagship-shaped
    forward under tp2 and sp2 equals one process's within 1e-5 of the
    largest logit, and the host staging of a forward moves exactly the
    bytes the layout's collectives carry (each out and back in): tp2 the
    embedding's and each layer's two all-reduces of [B, T, E] f32, sp2 each
    layer's rotation of K and V [B, T/2, KH, Dh] f32."""
    from ray_tpu_torch.models import (TransformerConfig, forward,
                                      init_params)
    from ray_tpu_torch.parallel import World

    cfg = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
               n_kv_heads=4, d_ff=512, max_seq_len=128)
    B, T = 2, 64

    def rank(spec):
        import torch
        from ray_tpu_torch.models import (TransformerConfig, forward,
                                          init_params, param_shardings)
        from ray_tpu_torch.parallel import P, gather, make_mesh, shard
        from ray_tpu_torch.parallel import collectives as coll
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh(spec)
        c = TransformerConfig(dtype=torch.float32, **cfg)
        params = shard(init_params(torch.Generator(device=mesh.device)
                                   .manual_seed(0), c, device=mesh.device),
                       param_shardings(c, mesh), mesh)
        tokens = torch.arange(B * T, device=mesh.device).reshape(B, T) % 512
        with torch.no_grad():
            coll.reset_staging()
            logits = forward(params, shard(tokens, P("dp"), mesh), c, mesh)
            torch.cuda.synchronize()
            staged = dict(coll.STAGING)
            whole = gather(logits, P("dp", "sp", "tp"), mesh)
        return whole.cpu(), staged, str(mesh.device)

    c = TransformerConfig(dtype=torch.float32, **cfg)
    params = init_params(_gen(0), c, device=dev)
    tokens = torch.arange(B * T, device=dev).reshape(B, T) % 512
    with torch.no_grad():
        want = forward(params, tokens, c).cpu()
    E, L, Dh = c.d_model, c.n_layers, c.head_dim
    expect = {"tp": (1 + 2 * L) * 2 * B * T * E * 4,
              "sp": L * 2 * 2 * B * (T // 2) * c.n_kv_heads * Dh * 4}
    with World(2) as world:
        for axis in ("tp", "sp"):
            for got, staged, where in world.run(rank, {axis: 2}):
                assert where.startswith("cuda")
                torch.testing.assert_close(
                    got, want, atol=1e-5 * want.abs().max().item(), rtol=0)
                assert staged["bytes"] == expect[axis], (axis, staged)
                assert staged["copy_s"] > 0 and staged["comm_s"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tp_engine_on_the_card_matches_one_process(dev, paged):
    """Serving under tp2 on the card: a 2-rank world sharing it, each rank's
    engine over its 2 of 4 kv heads. Every decode tick launches 2L + 1 K1
    and L of K6 (K7 when paged) in each rank, the cache or pool is at KH/tp
    heads, and the f32 greedy tokens equal one process's engine on the
    card."""
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.models.engine import GenerationEngine
    from ray_tpu_torch.models.paged_engine import PagedGenerationEngine
    from ray_tpu_torch.parallel import World

    cfg = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
               n_kv_heads=4, d_ff=512, max_seq_len=256)
    kw = dict(max_slots=4, page_size=64) if paged else dict(max_slots=4)
    prompts = [[(7 * i + j) % 512 for j in range(5 + 9 * i)]
               for i in range(6)]

    def rank():
        import torch
        from ray_tpu_torch.models import TransformerConfig, init_params
        from ray_tpu_torch.models.engine import GenerationEngine
        from ray_tpu_torch.models.paged_engine import PagedGenerationEngine
        from ray_tpu_torch.ops import attention, fused, paged_attention
        from ray_tpu_torch.parallel import make_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh({"tp": 2})
        c = TransformerConfig(dtype=torch.float32, **cfg)
        params = init_params(torch.Generator(device=mesh.device)
                             .manual_seed(0), c, device=mesh.device)
        cls = PagedGenerationEngine if paged else GenerationEngine
        eng = cls(params, c, mesh=mesh, **kw)
        counters = (fused.rms_norm, fused.add_rms_norm,
                    attention.decode_attention,
                    paged_attention.paged_decode_attention)
        decode, ticks = eng._decode_all, []

        def counted():
            before = [f.launches for f in counters]
            logits = decode()
            ticks.append([f.launches - b for f, b in zip(counters, before)])
            return logits

        eng._decode_all = counted
        ids = [eng.submit(p, 12) for p in prompts]
        res = eng.run_until_done()
        store = eng.k_pages if paged else eng.cache_k
        return [res[i] for i in ids], ticks, tuple(store.shape)

    c = TransformerConfig(dtype=torch.float32, **cfg)
    params = init_params(_gen(0), c, device=dev)
    one = (PagedGenerationEngine if paged else GenerationEngine)(
        params, c, **kw)
    ids = [one.submit(p, 12) for p in prompts]
    res = one.run_until_done()
    want = [res[i] for i in ids]
    L = c.n_layers
    per_tick = [1, 2 * L, 0, L] if paged else [1, 2 * L, L, 0]
    with World(2) as world:
        for outs, ticks, shape in world.run(rank):
            assert outs == want
            assert ticks and all(t == per_tick for t in ticks)
            assert shape[-2] == c.n_kv_heads // 2


def test_dist_array_blocks_stay_on_the_card(dev):
    """random, add, subtract, transpose, eye and dot of the distributed
    arrays keep every block a CUDA tensor; the elementwise ops and
    dot(eye, a) are exact, and dot lies within ``_dot_bound`` of one
    torch.matmul on the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import array as ra

    old = ra.BLOCK_SIZE
    ra.BLOCK_SIZE = 128
    rt.init(num_cpus=4, num_gpus=1)
    try:
        a = ra.random((300, 260), seed=1)
        b = ra.random((260, 200), seed=2)
        A, B = a.assemble(), b.assemble()
        assert A.device.type == "cuda" and a.device.type == "cuda"
        blocks = [rt.get(ref) for ref in a.blocks.flat]
        assert all(blk.device == A.device for blk in blocks)
        torch.testing.assert_close(ra.add(a, a).assemble(), A + A, atol=0,
                                   rtol=0)
        torch.testing.assert_close(ra.subtract(a, a).assemble(),
                                   torch.zeros_like(A), atol=0, rtol=0)
        torch.testing.assert_close(ra.transpose(a).assemble(), A.t(),
                                   atol=0, rtol=0)
        torch.testing.assert_close(ra.dot(ra.eye(300), a).assemble(), A,
                                   atol=0, rtol=0)
        gap = (ra.dot(a, b).assemble().double() - (A @ B).double()).abs()
        assert (gap <= ra._dot_bound(A, B)).all()
    finally:
        rt.shutdown()
        ra.BLOCK_SIZE = old


def test_stream_of_cuda_tensors_runs_k1_on_the_ring(dev):
    """A DataStream job of CUDA tensors: K1 in a two-instance map, keyed
    by index mod 4, summed in float64 (exact for these terms); the sums
    equal the eager loop's bits on the card, K1 counted once an item, and
    every edge took the native ring."""
    import ray_tpu_torch as rt
    from chip_smoke import sums_are_exact
    from ray_tpu_torch.streaming import StreamingContext

    g = _gen(18)
    xs = [torch.randn(64, 1024, generator=g, device=dev).to(torch.bfloat16)
          for _ in range(16)]
    w = (1 + 0.1 * torch.randn(1024, generator=g, device=dev)).to(
        torch.bfloat16)
    ys = [fused.rms_norm(x, w, 1e-5) for x in xs]
    assert all(sums_are_exact(ys[k::4]) for k in range(4))
    eager = {}
    for i, y in enumerate(ys):
        eager[i % 4] = y.double() if i % 4 not in eager \
            else eager[i % 4] + y.double()
    rt.init(num_cpus=4, num_gpus=1)
    ctx = StreamingContext(batch_size=4)
    (ctx.from_collection(list(enumerate(xs)))
        .map(lambda ix: (ix[0], fused.rms_norm(ix[1], w, 1e-5)),
             parallelism=2)
        .key_by(lambda iy: iy[0] % 4, parallelism=2)
        .reduce(lambda p, q: (p[0], p[1].double() + q[1].double()),
                parallelism=2)
        .sink())
    try:
        before = fused.rms_norm.launches
        results = ctx.submit()
        assert fused.rms_norm.launches - before == len(xs)
        transports = [t for ws in ctx._workers.values() for wk in ws
                      for t in rt.get(wk.transports.remote()).values()]
        assert transports and set(transports) == {"native"}
    finally:
        ctx.shutdown()
        rt.shutdown()
    assert sorted(k for k, _ in results) == [0, 1, 2, 3]
    for key, (_, total) in results:
        assert total.device.type == "cuda"
        assert torch.equal(total, eager[key]), key
