"""The port's training slice against the JAX package on the CPU, on the same
numpy-seeded inputs: the plain versions of kernels K2-K5 against the Pallas
kernels run in interpret mode (as tests/test_fused_ops.py runs them), the
analytic backwards of RMSNorm and cross-entropy against JAX's custom_vjp
backwards, and forward / loss_fn / make_train_step against the JAX model
and optax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu.ops import attention as jatt
from ray_tpu.ops import fused as jfused
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops import fused as tfused


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class _interpret:
    """Run a JAX module's Pallas kernels in interpret mode inside a with
    block (try/finally restore, as tests/test_fused_ops.py does)."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        self.prev, self.module._INTERPRET = self.module._INTERPRET, True

    def __exit__(self, *exc):
        self.module._INTERPRET = self.prev


# ------------------------------------------------------ K2: cross-entropy


def test_xent_ref_matches_pallas_kernel_interpret():
    """f32, atol 1e-5: max-shifted logsumexp in the Pallas kernel against
    torch.logsumexp, summed in another order."""
    rng = np.random.default_rng(0)
    logits, labels = 3 * _rand(rng, 16, 256), rng.integers(0, 256, 16)
    with _interpret(jfused):
        ref = jfused._xent_pallas(jnp.asarray(logits),
                                  jnp.asarray(labels, jnp.int32), 8)
    ours = tfused.softmax_cross_entropy(*_t(logits, labels))
    assert ours.dtype == torch.float32 and ours.shape == (16,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_grad_matches_jax(dtype):
    """d(sum(g * loss))/dlogits against JAX's _xent_bwd. f32: atol 1e-7;
    bf16 logits: the gradient comes back in bf16 in both, one bf16 ulp
    (2^-8 relative) of slack."""
    rng = np.random.default_rng(1)
    logits, labels = 3 * _rand(rng, 16, 256), rng.integers(0, 256, 16)
    g = _rand(rng, 16)
    jdt = getattr(jnp, dtype)
    jl = jnp.asarray(logits, jdt)
    jgrad = jax.grad(lambda x: jnp.sum(
        jfused.softmax_cross_entropy(x, jnp.asarray(labels)) * g))(jl)
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    (tfused.softmax_cross_entropy(x, torch.from_numpy(labels))
     * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == x.dtype
    tol = (dict(atol=1e-7, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-6, rtol=2 ** -8))
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(jgrad.astype(jnp.float32)), **tol)


def test_xent_wrapper_on_cpu_is_uncounted_and_takes_int32_labels():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(_rand(rng, 5, 40))
    labels = torch.tensor([0, 39, 7, 7, 20], dtype=torch.int32)
    before = tfused.softmax_cross_entropy.launches
    np.testing.assert_allclose(
        tfused.softmax_cross_entropy(logits, labels).numpy(),
        tfused._xent_ref(logits, labels.long()).numpy(), rtol=0, atol=0)
    assert tfused.softmax_cross_entropy.launches == before


# ------------------------------------------- K1: RMSNorm's backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_grads_match_jax(dtype):
    """dx and dw of sum(g * rms_norm(x, w)) against JAX's custom_vjp
    backward. f32: atol 1e-6, rtol 1e-5 (summation order); bf16: the two
    round the forward and the returned grads to bf16, atol = rtol = 2^-7."""
    rng = np.random.default_rng(3)
    x, w, g = _rand(rng, 4, 8, 64), 1 + 0.1 * _rand(rng, 64), \
        _rand(rng, 4, 8, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(
        (jfused.rms_norm(a, b, 1e-5) * g).astype(jnp.float32)),
        argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    (tfused.rms_norm(tx, tw, 1e-5).float()
     * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == "float32"
           else dict(atol=2 ** -7, rtol=2 ** -7))
    for ours, ref in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **tol)


@pytest.mark.parametrize("grads", ["h_and_y", "y_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_grads_match_jax(dtype, grads):
    """dx, da and dw of sum(g_h * h + g_y * y) for (h, y) = add_rms_norm(x,
    a, w) against jax.grad of the JAX composite (h = x + a, y =
    rms_norm(h)); y_only drops the g_h term, so the backward gets no
    gradient for h. Tolerances as test_rms_norm_grads_match_jax: f32 atol
    1e-6, rtol 1e-5; bf16 atol = rtol = 2^-7."""
    rng = np.random.default_rng(9)
    x, a, w = _rand(rng, 4, 8, 64), _rand(rng, 4, 8, 64), \
        1 + 0.1 * _rand(rng, 64)
    gh, gy = _rand(rng, 4, 8, 64), _rand(rng, 4, 8, 64)
    use_h = grads == "h_and_y"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def composite(x, a, w):
        h = x + a
        out = jnp.sum((jfused.rms_norm(h, w, 1e-5) * gy).astype(jnp.float32))
        return out + jnp.sum((h * gh).astype(jnp.float32)) if use_h else out

    want = jax.grad(composite, argnums=(0, 1, 2))(
        *(jnp.asarray(v, jdt) for v in (x, a, w)))
    ts = [torch.from_numpy(v).to(tdt).requires_grad_() for v in (x, a, w)]
    h, y = tfused.add_rms_norm(*ts, 1e-5)
    loss = (y.float() * torch.from_numpy(gy)).sum()
    if use_h:
        loss = loss + (h.float() * torch.from_numpy(gh)).sum()
    loss.backward()
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == "float32"
           else dict(atol=2 ** -7, rtol=2 ** -7))
    for t, ref in zip(ts, want):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **tol)


# --------------------------------------------- K3-K5: flash attention

_FLASH_CASES = {
    "causal_multiblock_d64": (1, 32, 2, 2, 64, True, 16),
    "noncausal_d128": (2, 16, 2, 2, 128, False, 8),
    "gqa_causal_d64": (1, 32, 4, 2, 64, True, 8),
    "gqa_noncausal_d128": (1, 16, 4, 2, 128, False, 8),
    # The small models' head dims (the examples and soak scripts), which
    # the card's K3-K5 take too.
    "gqa_causal_d16": (1, 32, 4, 2, 16, True, 16),
    "noncausal_d16": (2, 16, 2, 2, 16, False, 8),
    "causal_multiblock_d32": (1, 32, 2, 2, 32, True, 8),
    "gqa_noncausal_d32": (1, 16, 4, 2, 32, False, 8),
}


def _flash_inputs(B, T, H, KH, D, seed=4):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, T, H, D), _rand(rng, B, T, KH, D),
            _rand(rng, B, T, KH, D), _rand(rng, B, T, H, D))


def _pallas_flash(q, k, v, do, causal, block):
    with _interpret(jatt):
        o, lse = jatt._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, block, block)
        grads = jatt._flash_backward(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), o, lse, jnp.asarray(do),
                                     causal, block, block)
    return np.asarray(o), np.asarray(lse), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_flash_plain_versions_match_pallas_kernels_interpret(case):
    """f32. out and lse within atol 1e-5 of _flash_forward's (the port
    takes one pass with the final max, the kernel an online softmax over
    blocks); dq, dk, dv within atol 1e-5 of _flash_backward's (magnitudes
    up to ~5; summation order, and dk/dv's group sum in f32)."""
    B, T, H, KH, D, causal, block = _FLASH_CASES[case]
    q, k, v, do = _flash_inputs(B, T, H, KH, D)
    jo, jlse, jgrads = _pallas_flash(q, k, v, do, causal, block)
    out, lse = tatt._flash_forward_ref(*_t(q, k, v), causal)
    np.testing.assert_allclose(out.numpy(), jo, atol=1e-5, rtol=1e-5)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy().reshape(B * H, T), jlse,
                               atol=1e-5, rtol=1e-5)
    grads = tatt._flash_backward_ref(*_t(q, k, v), out, lse,
                                     torch.from_numpy(do), causal)
    for name, ours, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_autograd_matches_attention_reference(causal):
    """The port's flash_attention on the CPU (plain K3 forward, plain K4/K5
    backward) against autograd through attention_reference, GQA with a
    ragged T: out and grads within atol 1e-5 (f32)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_rand(rng, 2, 37, 4, 64), _rand(rng, 2, 37, 2, 64),
                   _rand(rng, 2, 37, 2, 64), _rand(rng, 2, 37, 4, 64))
    results = []
    for fn in (lambda a, b, c: tatt.flash_attention(a, b, c, causal=causal),
               lambda a, b, c: tatt.attention_reference(a, b, c,
                                                        causal=causal)):
        ts = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*ts)
        out.backward(torch.from_numpy(do))
        results.append([out.detach()] + [t.grad for t in ts])
    for ours, ref in zip(*results):
        torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-5)


def test_flash_wrappers_on_cpu_are_plain_and_uncounted():
    q, k, v, do = _t(*_flash_inputs(1, 8, 2, 1, 64))
    counters = (tatt.flash_forward, tatt.flash_backward_dq,
                tatt.flash_backward_dkv)
    before = [f.launches for f in counters]
    out, lse = tatt.flash_forward(q, k, v)
    ref_out, ref_lse = tatt._flash_forward_ref(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    dsum = tatt._flash_dsum(out, do)
    assert torch.equal(tatt.flash_backward_dq(q, k, v, do, lse, dsum),
                       tatt._flash_backward_dq_ref(q, k, v, do, lse, dsum))
    for a, b in zip(tatt.flash_backward_dkv(q, k, v, do, lse, dsum),
                    tatt._flash_backward_dkv_ref(q, k, v, do, lse, dsum)):
        assert torch.equal(a, b)
    assert [f.launches for f in counters] == before


# ------------------------------------------ forward, loss, train step

_CFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=512, max_seq_len=64)


def _models(dtype="float32", seed=0):
    jcfg = jtr.TransformerConfig(dtype=getattr(jnp, dtype), **_CFG)
    tcfg = ttr.TransformerConfig(dtype=getattr(torch, dtype), **_CFG)
    jparams = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = ttr.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(B=2, T=24, seed=6):
    return np.random.default_rng(seed).integers(
        0, _CFG["vocab_size"], (B, T + 1)).astype(np.int32)


def test_forward_logits_match_jax_f32():
    """GQA (4 heads, 2 kv heads), head_dim 64, f32: logits within atol
    1e-5 (magnitudes ~0.5)."""
    jcfg, tcfg, jparams, tparams = _models()
    tokens = _tokens()[:, :-1]
    ref = jtr.forward(jparams, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        ours = ttr.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert ours.shape == (2, 24, 256) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_loss_and_every_gradient_match_jax_value_and_grad():
    """f32: the loss within 1e-5 and every parameter's gradient within
    atol 2e-6, rtol 1e-4 of jax.value_and_grad(loss_fn) (gradients up to
    ~0.4; the port's backward is its own, so sums run in another order)."""
    jcfg, tcfg, jparams, tparams = _models()
    tokens = _tokens()
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    for t in ttr.named_leaves(tparams).values():
        t.requires_grad_(True)
    loss = ttr.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    ours = ttr.named_leaves(tparams)
    ref = ttr.named_leaves(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name].grad.numpy(), ref[name],
                                   atol=2e-6, rtol=1e-4, err_msg=name)


def test_train_step_matches_optax_over_three_steps():
    """make_train_step against JAX's (optax.adamw, weight decay 0.01), 3
    steps on one batch from the same weights, f32: each step's loss within
    1e-5, and the parameters after 3 steps within atol 1e-6 but for at
    most 0.01% of each tensor's entries, which stay within 3 steps x the
    learning rate of 3e-4. Adam divides by sqrt(v): a gradient entry near
    0 that rounds differently in the two backwards moves its parameter by
    a visible fraction of a step (a handful of the ~1.3M entries, up to
    ~2e-5 apart), while a wrong update would move whole tensors."""
    lr = 3e-4
    jcfg, tcfg, jparams, tparams = _models(seed=1)
    tokens = _tokens(seed=7)
    jinit, jstep = jtr.make_train_step(jcfg, learning_rate=lr)
    jopt = jinit(jparams)
    jstep = jax.jit(jstep)
    init_opt, train_step = ttr.make_train_step(tcfg, learning_rate=lr)
    opt = init_opt(tparams)
    for step in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt,
                                     {"tokens": jnp.asarray(tokens)})
        tparams, opt, loss = train_step(tparams, opt,
                                        {"tokens": torch.from_numpy(tokens)})
        assert abs(loss.item() - float(jloss)) < 1e-5, step
    ours = ttr.named_leaves(tparams)
    ref = ttr.named_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    for name in ref:
        diff = np.abs(ours[name].detach().numpy() - ref[name])
        assert diff.max() <= 3 * lr, (name, diff.max())
        assert (diff > 1e-6).mean() <= 1e-4, (name, (diff > 1e-6).sum())
    assert loss.item() < 5.6   # ln 256 = 5.55 at init; the steps learn


def test_bf16_loss_matches_jax_within_bf16_tolerance():
    """bf16 compute, f32 params: the loss within 2e-2 of JAX's (the two
    round activations to bf16 at the same places, but sum bf16 matmuls in
    different orders)."""
    jcfg, tcfg, jparams, tparams = _models("bfloat16", seed=2)
    tokens = _tokens(seed=8)
    jloss = jtr.loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.no_grad():
        loss = ttr.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                           tcfg)
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(jloss)) < 2e-2


def test_train_step_refuses_parallelism_and_foreign_opt_state():
    """A mesh must be the port's (``parallel.make_mesh``); microbatches
    without a pipeline axis are ignored, as the JAX package ignores them;
    an optimizer made for other parameters is refused."""
    _, tcfg, _, tparams = _models()
    with pytest.raises(TypeError, match="Mesh"):
        ttr.make_train_step(tcfg, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        ttr.forward(tparams, torch.zeros(1, 4, dtype=torch.long), tcfg,
                    mesh=object())
    with torch.no_grad():
        assert torch.equal(
            ttr.loss_fn(tparams, {"tokens": _tokens()}, tcfg,
                        num_microbatches=2),
            ttr.loss_fn(tparams, {"tokens": _tokens()}, tcfg))
    init_opt, train_step = ttr.make_train_step(tcfg)
    other = ttr.init_params(torch.Generator().manual_seed(9), tcfg,
                            device="cpu")
    opt = init_opt(other)
    with pytest.raises(ValueError, match="init_opt"):
        train_step(tparams, opt, {"tokens": _tokens()})
