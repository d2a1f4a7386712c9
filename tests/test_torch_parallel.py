"""The port's meshes, ring attention and sharded flagship against the JAX
package on the CPU: twins of tests/test_parallel.py. JAX runs on its 8
virtual CPU devices; the port runs the same numpy inputs (JAX's weights
carried by ``params_from_numpy`` + ``shard``) on an 8-rank gloo world of
processes (``parallel.World``), one torch thread a rank, the per-rank
bodies shipped by value, and the results gathered back here."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from ray_tpu.models import (TransformerConfig as JConfig, forward as jforward,
                            init_params as jinit, make_train_step as jstep,
                            param_shardings as jshardings)
from ray_tpu.ops.attention import attention_reference
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.parallel.ring_attention import ring_attention as jring
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel import MeshSpec, World

cloudpickle.register_pickle_by_value(sys.modules[__name__])

MESH = {"dp": 2, "pp": 1, "sp": 2, "tp": 2}


@pytest.fixture(scope="module")
def world():
    with World(8, device="cpu", threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshSpec(dp=2, pp=1, sp=2, tp=2))


def _qkv(B=4, T=64, H=4, KH=4, D=32):
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (B, T, H, D), jnp.float32)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, T, KH, D))
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, T, KH, D))
    return q, k, v


# ------------------------------------------------- per-rank bodies (torch)


def _mesh_shape():
    from ray_tpu_torch.parallel import make_mesh
    return dict(make_mesh(MESH, device="cpu").shape)


def _ring(q, k, v, causal, grad):
    """ring_attention on the global inputs; with ``grad``, also the rank's
    gradients of sum(out ** 2) (nonzero on its own blocks)."""
    from ray_tpu_torch.parallel import make_mesh, ring_attention
    mesh = make_mesh(MESH, device="cpu")
    q, k, v = (torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v))
    out = ring_attention(q, k, v, mesh, causal=causal)
    if not grad:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def _t_cfg():
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=128,
                             dtype=torch.float32)


def _sharded_params(jparams, mesh):
    from ray_tpu_torch.models import param_shardings, params_from_numpy
    from ray_tpu_torch.parallel import shard
    params = params_from_numpy(jparams, device="cpu")
    return shard(params, param_shardings(_t_cfg(), mesh), mesh)


def _forward(jparams, tokens):
    from ray_tpu_torch.models import forward
    from ray_tpu_torch.parallel import P, gather, make_mesh, shard
    mesh = make_mesh(MESH, device="cpu")
    params = _sharded_params(jparams, mesh)
    with torch.no_grad():
        logits = forward(params, shard(torch.from_numpy(tokens), P("dp"),
                                       mesh), _t_cfg(), mesh)
    return gather(logits, P("dp", "sp", "tp"), mesh).numpy()


def _train(jparams, tokens, steps):
    from ray_tpu_torch.models import make_train_step, named_leaves
    from ray_tpu_torch.parallel import P, make_mesh, shard
    mesh = make_mesh(MESH, device="cpu")
    params = _sharded_params(jparams, mesh)
    init_opt, train_step = make_train_step(_t_cfg(), mesh)
    opt = init_opt(params)
    batch = {"tokens": shard(torch.from_numpy(tokens), P("dp"), mesh)}
    losses = []
    for _ in range(steps):
        params, opt, loss = train_step(params, opt, batch)
        losses.append(loss.item())
    assert all(t.grad is not None for t in named_leaves(params).values())
    return losses


# ------------------------------------------------------------------ twins


class TestMesh:
    def test_auto_factorization(self):
        for n in (1, 2, 3, 4, 6, 8, 12, 16, 32):
            for kw in ({}, {"want_tp": 2}, {"want_sp": 2, "want_pp": 2}):
                want = JMeshSpec.auto(n, **kw)
                got = MeshSpec.auto(n, **kw)
                assert got.axis_sizes() == want.axis_sizes(), (n, kw)
                assert got.size == n
        assert MeshSpec.auto(8).size == 8
        assert MeshSpec.auto(1).size == 1

    def test_make_mesh_axes(self, world, jmesh):
        shapes = world.run(_mesh_shape)
        assert all(s == {"dp": 2, "pp": 1, "sp": 2, "tp": 2} for s in shapes)
        assert shapes[0] == dict(jmesh.shape)


class TestRingAttention:
    @pytest.mark.parametrize("causal,H,KH", [(True, 4, 4), (False, 4, 4),
                                             (True, 8, 4)],
                             ids=["matches_reference", "non_causal", "gqa"])
    def test_forward(self, world, jmesh, causal, H, KH):
        q, k, v = _qkv(H=H, KH=KH)
        want = np.asarray(jax.jit(lambda q, k, v: jring(
            q, k, v, jmesh, causal=causal))(q, k, v))
        ref = np.asarray(jax.jit(lambda q, k, v: attention_reference(
            q, k, v, causal=causal))(q, k, v))
        outs = world.run(_ring, *map(np.asarray, (q, k, v)), causal, False)
        for got in outs:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)

    def test_gradients_match(self, world, jmesh):
        q, k, v = _qkv(T=32)
        g_ring = jax.jit(jax.grad(
            lambda q, k, v: (jring(q, k, v, jmesh) ** 2).sum(),
            argnums=(0, 1, 2)))(q, k, v)
        g_ref = jax.jit(jax.grad(
            lambda q, k, v: (attention_reference(q, k, v) ** 2).sum(),
            argnums=(0, 1, 2)))(q, k, v)
        ranks = world.run(_ring, *map(np.asarray, (q, k, v)), True, True)
        got = [sum(r[i] for r in ranks) for i in range(3)]
        for a, b, c in zip(got, g_ring, g_ref):
            np.testing.assert_allclose(a, np.asarray(b), atol=5e-5,
                                       rtol=5e-5)
            np.testing.assert_allclose(a, np.asarray(c), atol=5e-5,
                                       rtol=5e-5)

    def test_under_jit(self, world, jmesh):
        """JAX's ring under jit; the port has no jit, so its eager ring
        gives the jitted values."""
        q, k, v = _qkv()
        want = np.asarray(jax.jit(lambda q, k, v: jring(q, k, v, jmesh))(
            q, k, v))
        for got in world.run(_ring, *map(np.asarray, (q, k, v)), True,
                             False):
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


class TestFlashFallback:
    def test_cpu_falls_back(self):
        q, k, v = _qkv()
        out = flash_attention(*(torch.from_numpy(np.asarray(a))
                                for a in (q, k, v)), causal=True)
        ref = attention_reference(q, k, v, causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def _jcfg():
    return JConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, dtype=jnp.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class TestModel:
    def test_forward_shapes(self):
        from ray_tpu_torch.models import forward, params_from_numpy
        params = params_from_numpy(_np(jinit(jax.random.PRNGKey(0), _jcfg())),
                                   device="cpu")
        logits = forward(params, torch.zeros(2, 32, dtype=torch.long),
                         _t_cfg())
        assert logits.shape == (2, 32, 256)

    def test_causality(self):
        from ray_tpu_torch.models import forward, params_from_numpy
        cfg = _jcfg()
        jparams = jinit(jax.random.PRNGKey(0), cfg)
        params = params_from_numpy(_np(jparams), device="cpu")
        t1 = np.zeros((1, 16), np.int64)
        t2 = t1.copy()
        t2[0, 10] = 7
        with torch.no_grad():
            l1, l2 = (forward(params, torch.from_numpy(t), _t_cfg()).numpy()
                      for t in (t1, t2))
        np.testing.assert_allclose(l1[0, :10], l2[0, :10], atol=1e-5)
        assert not np.allclose(l1[0, 10:], l2[0, 10:])
        np.testing.assert_allclose(
            l2, np.asarray(jforward(jparams, jnp.asarray(t2), cfg)),
            atol=1e-5, rtol=1e-5)

    def test_sharded_matches_single(self, world, jmesh):
        cfg = _jcfg()
        params = jinit(jax.random.PRNGKey(0), cfg)
        tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                               (4, 32), 0, 256))
        single = np.asarray(jforward(params, jnp.asarray(tokens), cfg))
        sharded = np.asarray(jax.jit(lambda p, t: jforward(p, t, cfg, jmesh))(
            jax.device_put(params, jshardings(cfg, jmesh)),
            jax.device_put(tokens, NamedSharding(jmesh, JP("dp", None)))))
        for got in world.run(_forward, _np(params), tokens):
            np.testing.assert_allclose(got, single, atol=2e-4, rtol=2e-4)
            np.testing.assert_allclose(got, sharded, atol=2e-5, rtol=2e-5)

    def test_train_step_sharded(self, world, jmesh):
        """3 AdamW steps on the repeated batch through both packages'
        sharded train steps: the same losses, falling."""
        cfg = _jcfg()
        params = jinit(jax.random.PRNGKey(0), cfg)
        tokens = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (4, 33), 0, 256, dtype=jnp.int32))
        init_opt, train_step = jstep(cfg, jmesh)
        p = jax.device_put(params, jshardings(cfg, jmesh))
        opt = init_opt(p)
        step = jax.jit(train_step)
        want = []
        for _ in range(3):
            p, opt, loss = step(p, opt, {"tokens": jax.device_put(
                tokens, NamedSharding(jmesh, JP("dp", None)))})
            want.append(float(loss))
        ranks = world.run(_train, _np(params), tokens, 3)
        for losses in ranks:
            assert losses == ranks[0]
            np.testing.assert_allclose(losses, want, atol=1e-5, rtol=1e-5)
        assert all(np.isfinite(ranks[0]))
        assert ranks[0][-1] < ranks[0][0]
