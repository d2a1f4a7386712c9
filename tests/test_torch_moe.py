"""The port's MoE FFN and MoE transformer against the JAX package's on the
CPU, on the same numpy-seeded inputs with the JAX package's weights carried
across (``transformer.params_from_numpy``): routing (experts, queue
positions, capacity drops) bit for bit, outputs, aux losses and every
gradient at f32 tolerances, the index-form dispatch against the dense
formula it replaces, 3 train steps against optax's adamw (weight decay
1e-4), and twins of tests/test_moe_train.py::test_moe_transformer_trains
and the single-device tests of tests/test_parallel_ext.py::TestMoE, each
program run through both packages, and the twin of
tests/test_moe_train.py::test_moe_sharded_on_mesh on an 8-rank gloo world
(test_torch_trainer.py holds the twin of test_moe_train.py's log test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe_transformer as jmt
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.models import moe_transformer as tmt
from ray_tpu_torch.models.transformer import named_leaves, params_from_numpy
from ray_tpu_torch.parallel import moe as tmoe


# JAX's functions under jit (one compile each, where eager mode compiles op
# by op), the config static.
_jinit_moe = jax.jit(jmoe.init_moe_params, static_argnums=1)
_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)
_jinit = jax.jit(jmt.init_params, static_argnums=1)
_jforward = jax.jit(jmt.forward, static_argnums=2)
_jloss = jax.jit(jmt.loss_fn, static_argnums=2)
_jloss_grad = jax.jit(jax.value_and_grad(jmt.loss_fn), static_argnums=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jparams):
    """JAX parameters as the port's, on the CPU, requiring grad."""
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    for t in named_leaves(params).values():
        t.requires_grad_(True)
    return params


def _cfgs(dtype="float32", **kw):
    base = dict(d_model=32, d_ff=64, n_experts=4, top_k=2, **kw)
    return (jmoe.MoEConfig(dtype=getattr(jnp, dtype), **base),
            tmoe.MoEConfig(dtype=getattr(torch, dtype), **base))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_routing(x, params, cfg):
    """JAX's routing, recomputed from JAX's own ops as moe_ffn does it:
    (expert_idx, position, in_cap)."""
    tokens = jnp.asarray(x).reshape(-1, cfg.d_model)
    n, N, K = tokens.shape[0], cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(tokens @ params["router"], axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    one_hot_k = jax.nn.one_hot(expert_idx, N, dtype=jnp.float32)
    flat = one_hot_k.reshape(n * K, N)
    position = (jnp.cumsum(flat, axis=0) - flat).reshape(n, K, N)
    position = jnp.sum(position * one_hot_k, axis=-1).astype(jnp.int32)
    capacity = tmoe.capacity(n, cfg)
    return (np.asarray(expert_idx), np.asarray(position),
            np.asarray(position < capacity))


# ------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("cf", [1.25, 4.0, 0.1])
def test_moe_ffn_matches_jax_routing_outputs_and_gradients(cf):
    """f32 at capacity factors 1.25, 4.0 (nothing dropped) and 0.1 (most
    choices dropped): experts, positions and in_cap bit for bit; y within
    atol 1e-5; aux within 1e-6; d(sum(g * y) + aux) for x and every
    parameter within atol 1e-6, rtol 1e-4 of jax.grad (gradients up to
    ~0.1; the index form sums in another order than the einsums)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jparams = _jinit_moe(jax.random.PRNGKey(0), jcfg)
    x, g = _x((2, 16, 32)), _x((2, 16, 32), seed=2)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(xx, p, jcfg)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))

    params = _carry(jparams)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, r = tmoe.moe_ffn_routed(tx, params, tcfg)
    ((y * torch.from_numpy(g)).sum() + aux).backward()

    idx, pos, in_cap = _jax_routing(x, jparams, jcfg)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.position.numpy(), pos)
    np.testing.assert_array_equal(r.in_cap.numpy(), in_cap)
    if cf == 0.1:
        assert not in_cap.all()
    if cf == 4.0:
        assert in_cap.all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    assert abs(aux.item() - float(jaux)) < 1e-6
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-6,
                               rtol=1e-4)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   np.asarray(jgp[name]), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_form_matches_the_dense_formula(dtype):
    """moe_ffn against _moe_ffn_dense_ref (the JAX package's f32 one-hot
    routing and einsums, transcribed) on the same weights, capacity factor
    1.0 (some choices dropped): routing equal, f32 y within 1e-6 and every
    gradient within atol 1e-7, rtol 1e-5; bf16 (bf16 experts, f32 router)
    y and every gradient within 2 bf16 ulps (atol = rtol = 2^-7): both
    round each product's output to bf16, but sum in other orders."""
    _, tcfg = _cfgs(dtype, capacity_factor=1.0)
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
    x = torch.from_numpy(_x((2, 24, 32), seed=3)).to(tcfg.dtype)
    g = torch.from_numpy(_x((2, 24, 32), seed=4))
    outs = []
    for fn in (tmoe.moe_ffn_routed, tmoe._moe_ffn_dense_ref):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        y, aux, r = fn(xx, p, tcfg)
        ((y.float() * g).sum() + aux).backward()
        outs.append((y.detach().float(), aux.item(), xx.grad.float(),
                     {k: v.grad for k, v in p.items()}, r))
    (y, aux, gx, gp, r), (ry, raux, rgx, rgp, rr) = outs
    for field in ("expert_idx", "position", "in_cap"):
        assert torch.equal(getattr(r, field), getattr(rr, field)), field
    assert not r.in_cap.all()
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == "float32"
           else dict(atol=2 ** -7, rtol=2 ** -7))
    gtol = (dict(atol=1e-7, rtol=1e-5) if dtype == "float32" else tol)
    torch.testing.assert_close(y, ry, **tol)
    assert abs(aux - raux) <= 1e-7
    torch.testing.assert_close(gx, rgx, **gtol)
    for name in gp:
        torch.testing.assert_close(gp[name], rgp[name], **gtol,
                                   msg=lambda m: f"{name}: {m}")


def test_moe_ffn_is_the_same_on_every_run():
    _, tcfg = _cfgs("bfloat16")
    params = tmoe.init_moe_params(torch.Generator().manual_seed(1), tcfg,
                                  device="cpu")
    x = torch.from_numpy(_x((2, 16, 32), seed=5)).bfloat16()
    y0, a0 = tmoe.moe_ffn(x, params, tcfg)
    y1, a1 = tmoe.moe_ffn(x, params, tcfg)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


# ------------------------------------------------- the MoE transformer


def _moe_cfgs(dtype="float32", **over):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=4, d_ff=32, max_seq_len=16, n_experts=4, top_k=2)
    base.update(over)
    return (jmt.MoETransformerConfig(dtype=getattr(jnp, dtype), **base),
            tmt.MoETransformerConfig(dtype=getattr(torch, dtype), **base))


def _tokens(B=2, T=12, seed=6, V=64):
    return np.random.default_rng(seed).integers(0, V, (B, T + 1)).astype(
        np.int32)


def test_moe_forward_loss_and_every_gradient_match_jax():
    """2 layers, f32: logits within 1e-5, aux within 1e-6, the loss within
    1e-5 and every gradient within atol 1e-6, rtol 1e-4 of
    jax.value_and_grad(loss_fn)."""
    jcfg, tcfg = _moe_cfgs()
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    params = _carry(jparams)
    tokens = _tokens()
    jlogits, jaux = _jforward(jparams, jnp.asarray(tokens[:, :-1]), jcfg)
    with torch.no_grad():
        logits, aux = tmt.forward(params, torch.from_numpy(tokens[:, :-1]),
                                  tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    assert abs(aux.item() - float(jaux)) < 1e-6

    jloss, jgrads = _jloss_grad(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg)
    loss = tmt.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    ours, ref = named_leaves(params), named_leaves(_np_tree(jgrads))
    assert sorted(ours) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name].grad.numpy(), ref[name],
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_moe_train_step_matches_optax_over_three_steps():
    """make_train_step against JAX's (optax.adamw, weight decay 1e-4, not
    the dense model's 0.01), 3 steps on one batch, f32: each loss within
    1e-5; the parameters after 3 steps within 3 x the learning rate, and
    within 1e-6 but for at most 0.1% of each tensor's entries (Adam divides
    by sqrt(v): an entry whose gradient is near 0 moves by a visible
    fraction of a step when it rounds differently, as in
    test_torch_train.py)."""
    lr = 3e-4
    jcfg, tcfg = _moe_cfgs()
    jparams = _jinit(jax.random.PRNGKey(1), jcfg)
    params = _carry(jparams)
    tokens = _tokens(seed=7)
    jinit, jstep = jmt.make_train_step(jcfg, learning_rate=lr)
    jopt = jinit(jparams)
    init_opt, train_step = tmt.make_train_step(tcfg, learning_rate=lr)
    opt = init_opt(params)
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    for step in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt,
                                     {"tokens": jnp.asarray(tokens)})
        params, opt, loss = train_step(params, opt,
                                       {"tokens": torch.from_numpy(tokens)})
        assert abs(loss.item() - float(jloss)) < 1e-5, step
    ours, ref = named_leaves(params), named_leaves(_np_tree(jparams))
    for name in ref:
        diff = np.abs(ours[name].detach().numpy() - ref[name])
        assert diff.max() <= 3 * lr, (name, diff.max())
        assert (diff > 1e-6).mean() <= 1e-3, (name, (diff > 1e-6).sum())


def test_moe_bf16_loss_matches_jax_within_bf16_tolerance():
    """bf16 compute, f32 params: the loss within 2e-2 of JAX's (bf16
    products summed in other orders)."""
    jcfg, tcfg = _moe_cfgs("bfloat16")
    jparams = _jinit(jax.random.PRNGKey(2), jcfg)
    params = _carry(jparams)
    tokens = _tokens(seed=8)
    jloss = _jloss(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.no_grad():
        loss = tmt.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                           tcfg)
    assert abs(loss.item() - float(jloss)) < 2e-2


def test_moe_init_params_keys_and_shapes_are_jax_s():
    jcfg, tcfg = _moe_cfgs()
    ref = named_leaves(_np_tree(_jinit(jax.random.PRNGKey(0), jcfg)))
    ours = named_leaves(tmt.init_params(torch.Generator().manual_seed(0),
                                        tcfg, device="cpu"))
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        assert tuple(t.shape) == ref[name].shape, name
        assert t.dtype == torch.float32


def test_moe_refuses_a_mesh():
    """A mesh must be the port's (``parallel.make_mesh``)."""
    _, tcfg = _moe_cfgs()
    params = tmt.init_params(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: tmt.make_train_step(tcfg, mesh=object()),
                 lambda: tmt.forward(params, tokens, tcfg, mesh=object()),
                 lambda: tmt.loss_fn(params, {"tokens": tokens}, tcfg,
                                     mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()


@pytest.fixture(scope="module")
def world8():
    from ray_tpu_torch.parallel import World
    with World(8, device="cpu", threads=1) as w:
        yield w


def test_moe_sharded_on_mesh(world8):
    """Twin of tests/test_moe_train.py::test_moe_sharded_on_mesh on a
    ("dp", "sp", "tp") mesh of 8 ranks, experts over tp: the loss of JAX's
    sharded and single-device runs, the experts sharded, and every gathered
    gradient leaf within 1e-5 of its largest magnitude of JAX's."""
    from jax.sharding import Mesh

    def rank(jparams, tokens, cfg_kw):
        import sys

        import numpy as np
        import torch
        from ray_tpu_torch.models import moe_transformer as tmt
        from ray_tpu_torch.models.transformer import (named_leaves,
                                                      params_from_numpy)
        from ray_tpu_torch.parallel import P, gather, make_mesh, shard
        from ray_tpu_torch.parallel.collectives import reduce_gradients

        mesh = make_mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu")
        cfg = tmt.MoETransformerConfig(dtype=torch.float32, **cfg_kw)
        specs = tmt.param_shardings(cfg, mesh, expert_axis="tp")
        params = shard(params_from_numpy(jparams, device="cpu"), specs, mesh)
        shape = tuple(params["layers"]["moe"]["w_gate"].shape)
        leaves = named_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = tmt.loss_fn(params, {"tokens": shard(
            torch.from_numpy(tokens), P("dp"), mesh)}, cfg, mesh)
        loss.backward()
        reduce_gradients(list(leaves.values()), mesh)
        grads = gather(_grad_tree(params), specs, mesh)
        assert "jax" not in sys.modules
        return loss.item(), shape, {k: np.asarray(v) for k, v in
                                    named_leaves(grads).items()}

    def _grad_tree(tree):
        if isinstance(tree, dict):
            return {k: _grad_tree(v) for k, v in tree.items()}
        return tree.grad

    kw = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
              d_ff=32, max_seq_len=16, n_experts=4, top_k=2)
    jcfg = jmt.MoETransformerConfig(dtype=jnp.float32, **kw)
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 9), 0,
                                           64))
    devices = np.array(jax.devices()[:8]).reshape(2, 2, 2)
    mesh = Mesh(devices, ("dp", "sp", "tp"))
    sharded = jax.tree_util.tree_map(
        jax.device_put, jparams, jmt.param_shardings(jcfg, mesh, "tp"))
    jloss_mesh = float(jax.jit(lambda p, b: jmt.loss_fn(p, b, jcfg, mesh))(
        sharded, {"tokens": tokens}))
    assert np.isfinite(jloss_mesh)
    jl, jgrads = _jloss_grad(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    want = named_leaves(_np_tree(jgrads))
    for loss, shape, grads in world8.run(rank, _np_tree(jparams), tokens, kw):
        assert abs(loss - jloss_mesh) < 1e-5 and abs(loss - float(jl)) < 1e-5
        assert shape == (2, 2, 32, 32)          # [L, N/tp, E, F]
        assert sorted(grads) == sorted(want)
        for name, g in want.items():
            err = np.abs(grads[name] - g).max() / np.abs(g).max()
            assert err < 1e-5, (name, err)


# ---------------------------------------------------------------- twins


def test_moe_transformer_trains():
    """Twin of tests/test_moe_train.py::test_moe_transformer_trains: 6
    steps at learning rate 3e-3 through each package from JAX's initial
    weights; both losses finite and falling, and each step's loss within
    1e-4 of JAX's."""
    jcfg, tcfg = _moe_cfgs()
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0, 64)
    runs = {}
    for pkg, mod, cfg in (("jax", jmt, jcfg), ("torch", tmt, tcfg)):
        jparams = _jinit(jax.random.PRNGKey(0), jcfg)
        params = jparams if pkg == "jax" else _carry(jparams)
        batch = {"tokens": (tokens if pkg == "jax"
                            else torch.tensor(np.asarray(tokens)))}
        init_opt, train_step = mod.make_train_step(cfg, learning_rate=3e-3)
        opt_state = init_opt(params)
        losses = []
        for _ in range(6):
            params, opt_state, loss = train_step(params, opt_state, batch)
            losses.append(float(loss))
        assert np.isfinite(losses).all(), pkg
        assert losses[-1] < losses[0], pkg
        runs[pkg] = losses
    np.testing.assert_allclose(runs["torch"], runs["jax"], atol=1e-4)


def _twin_moe(cf=1.25, shape=(2, 16, 32)):
    """One input and JAX's initial weights through each package's
    moe_ffn: ((y, aux) of JAX, of the port, the port's params)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jparams = _jinit_moe(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), shape)
    params = _carry(jparams)
    return (_jmoe_ffn(x, jparams, jcfg),
            tmoe.moe_ffn(torch.tensor(np.asarray(x)), params, tcfg),
            jparams, params, x, jcfg, tcfg)


class TestMoE:
    """Twins of the single-device tests of
    tests/test_parallel_ext.py::TestMoE."""

    def test_forward_shape_and_finite(self):
        (jy, jaux), (y, aux), *_ = _twin_moe()
        for yy, a in ((np.asarray(jy), float(jaux)),
                      (y.detach().numpy(), aux.item())):
            assert yy.shape == (2, 16, 32)
            assert np.isfinite(yy).all()
            assert a > 0
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=1e-5)

    def test_gating_selects_topk_only(self):
        (jy, _), (y, _), *_ = _twin_moe(cf=4.0, shape=(1, 8, 32))
        assert np.isfinite(np.asarray(jy)).all()
        assert torch.isfinite(y).all()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=1e-5)

    def test_grads_flow_incl_router(self):
        _, _, jparams, params, _, jcfg, tcfg = _twin_moe(shape=(2, 8, 32))
        x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32))

        def jloss(p):
            y, aux = jmoe.moe_ffn(x, p, jcfg)
            return jnp.sum(y ** 2) + aux

        jg = jax.jit(jax.grad(jloss))(jparams)
        y, aux = tmoe.moe_ffn(torch.tensor(np.asarray(x)), params, tcfg)
        ((y ** 2).sum() + aux).backward()
        for name in ("router", "w_gate", "w_up", "w_down"):
            for leaf in (np.asarray(jg[name]), params[name].grad.numpy()):
                assert np.isfinite(leaf).all()
                assert np.abs(leaf).sum() > 0, f"zero grad through {name}"
            np.testing.assert_allclose(params[name].grad.numpy(),
                                       np.asarray(jg[name]), atol=1e-6,
                                       rtol=1e-4, err_msg=name)

    def test_capacity_drops_tokens(self):
        (jy, _), (y, _), *_ = _twin_moe(cf=0.1, shape=(2, 32, 32))
        assert np.isfinite(np.asarray(jy)).all()
        assert torch.isfinite(y).all()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=1e-5)
