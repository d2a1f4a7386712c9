"""The port's Ulysses attention, GPipe, collectives and expert-parallel MoE
against the JAX package on the CPU: twins of tests/test_parallel_ext.py's
mesh tests (its single-device MoE tests have theirs in
test_torch_moe.py). JAX runs on its 8 virtual CPU devices; the port runs
the same numpy inputs on an 8-rank gloo world of processes, one torch
thread a rank, and the results come back here."""

import functools
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.ops.attention import attention_reference
from ray_tpu.parallel import (MoEConfig as JMoEConfig, collectives as jcoll,
                              gpipe as jgpipe, init_moe_params,
                              moe_ffn as jmoe_ffn,
                              moe_param_shardings as jmoe_shardings,
                              ulysses_attention as julysses)
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.parallel.mesh import shard_map_compat
from ray_tpu_torch.parallel import World, collectives

cloudpickle.register_pickle_by_value(sys.modules[__name__])

MESH = {"dp": 2, "pp": 1, "sp": 2, "tp": 2}
PP_MESH = {"dp": 2, "pp": 4, "sp": 1, "tp": 1}


@pytest.fixture(scope="module")
def world():
    with World(8, device="cpu", threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshSpec(dp=2, pp=1, sp=2, tp=2))


@pytest.fixture(scope="module")
def jpp_mesh():
    return jmake_mesh(JMeshSpec(dp=2, pp=4, sp=1, tp=1))


def _qkv(B=4, T=64, H=4, KH=4, D=32):
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (B, T, H, D), jnp.float32)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, T, KH, D))
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, T, KH, D))
    return tuple(map(np.asarray, (q, k, v)))


# ------------------------------------------------- per-rank bodies (torch)


def _mesh(spec):
    from ray_tpu_torch.parallel import make_mesh
    return make_mesh(spec, device="cpu")


def _ulysses(q, k, v, causal, grad):
    from ray_tpu_torch.parallel import ulysses_attention
    q, k, v = (torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v))
    out = ulysses_attention(q, k, v, _mesh(MESH), causal=causal)
    if not grad:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def _layer(kind, p, x):
    y = x @ p["w"]
    if kind == "relu":
        return torch.relu(y + p["b"])
    return torch.tanh(y)


def _gpipe(params, x, n_mb, kind, grad):
    """gpipe over PP_MESH; with ``grad``, the rank's gradients of
    sum(out ** 2), nonzero on its own stage's layers."""
    from ray_tpu_torch.parallel import gpipe
    params = {k: torch.from_numpy(v).requires_grad_(grad)
              for k, v in params.items()}
    out = gpipe(functools.partial(_layer, kind), params, torch.from_numpy(x),
                _mesh(PP_MESH), num_microbatches=n_mb)
    if not grad:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return {k: v.grad.numpy() for k, v in params.items()}


def _gpipe_errors():
    from ray_tpu_torch.parallel import gpipe
    mesh, errors = _mesh(PP_MESH), []

    def layer(p, x):
        return x

    for L, B in ((6, 8), (8, 7)):  # 6 layers over 4 stages; 7 % 2 != 0
        try:
            gpipe(layer, {"w": torch.zeros(L, 8, 8)}, torch.zeros(B, 8),
                  mesh, num_microbatches=2)
        except ValueError as exc:
            errors.append(str(exc))
    return errors


def _collectives(which):
    from ray_tpu_torch.parallel import collectives as c
    mesh = _mesh(MESH)
    tp, sp = mesh.index("tp"), mesh.index("sp")
    if which == "reduce_and_gather":
        # The tp block of arange(8).reshape(8, 1) this rank holds.
        x = torch.arange(8.0).reshape(8, 1)[tp * 4:(tp + 1) * 4]
        return (c.all_reduce_sum(x, mesh, "tp").numpy(),
                c.all_gather(x, mesh, "tp", axis=0).numpy())
    if which == "reduce_scatter":
        return c.reduce_scatter(torch.ones(4, 4), mesh, "tp", axis=0).numpy()
    if which == "ring_permute":
        return c.ring_permute(torch.tensor([[1.0, 2.0][sp]]), mesh,
                              "sp").numpy()
    if which == "broadcast_from":
        return c.broadcast_from(torch.tensor([[3.0, 7.0][tp]]), mesh, "tp",
                                src=1).numpy()
    raise ValueError(which)


def _moe(x, params, cfg_kw):
    from ray_tpu_torch.models import params_from_numpy
    from ray_tpu_torch.parallel import (MoEConfig, P, gather, moe_ffn,
                                        moe_param_shardings, shard)
    mesh = _mesh(MESH)
    cfg = MoEConfig(dtype=torch.float32, **cfg_kw)
    local = shard(params_from_numpy(params, device="cpu"),
                  moe_param_shardings(cfg, mesh, axis="tp"), mesh)
    with torch.no_grad():
        y, aux = moe_ffn(shard(torch.from_numpy(x), P("dp", "sp"), mesh),
                         local, cfg, mesh)
    return gather(y, P("dp", "sp"), mesh).numpy(), aux.item()


# ------------------------------------------------------------------ twins


class TestUlysses:
    @pytest.mark.parametrize("causal,H,KH", [(True, 4, 4), (False, 4, 4),
                                             (True, 8, 2)],
                             ids=["matches_reference_causal",
                                  "matches_reference_non_causal",
                                  "gqa_kv_heads"])
    def test_forward(self, world, jmesh, causal, H, KH):
        q, k, v = _qkv(H=H, KH=KH)
        want = np.asarray(jax.jit(lambda q, k, v: julysses(
            q, k, v, jmesh, causal=causal))(q, k, v))
        ref = np.asarray(jax.jit(lambda q, k, v: attention_reference(
            q, k, v, causal=causal))(q, k, v))
        for got in world.run(_ulysses, q, k, v, causal, False):
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)

    def test_grads_flow(self, world, jmesh):
        """JAX's test checks the gradients are finite; both packages'
        gradients also agree."""
        q, k, v = _qkv(B=2, T=32)
        want = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(julysses(q, k, v, jmesh) ** 2),
            argnums=(0, 1, 2)))(q, k, v)
        ranks = world.run(_ulysses, q, k, v, True, True)
        for i, w in enumerate(want):
            got = sum(r[i] for r in ranks)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, np.asarray(w), atol=5e-5,
                                       rtol=5e-5)


def _relu_case():
    L, B, E = 8, 16, 32
    key = jax.random.PRNGKey(1)
    ws = jax.random.normal(key, (L, E, E)) * 0.3
    bs = jax.random.normal(jax.random.fold_in(key, 1), (L, E)) * 0.1
    x = jax.random.normal(jax.random.fold_in(key, 2), (B, E))
    return {"w": ws, "b": bs}, x


def _tanh_case(L, B, E, seed):
    key = jax.random.PRNGKey(seed)
    params = {"w": jax.random.normal(key, (L, E, E)) * 0.3}
    return params, jax.random.normal(jax.random.fold_in(key, 1), (B, E))


def _jlayer(kind, p, x):
    y = x @ p["w"]
    return jax.nn.relu(y + p["b"]) if kind == "relu" else jnp.tanh(y)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class TestGPipe:
    @pytest.mark.parametrize("case", ["matches_sequential",
                                      "single_microbatch"])
    def test_forward(self, world, jpp_mesh, case):
        """4 stages over 8 stacked relu layers (4 microbatches), and 4 tanh
        layers in one microbatch: the layers run one after another."""
        if case == "matches_sequential":
            (params, x), kind, n_mb = _relu_case(), "relu", 4
        else:
            (params, x), kind, n_mb = _tanh_case(4, 4, 16, 2), "tanh", 1
        want = np.asarray(jax.jit(lambda p, x: jgpipe(
            functools.partial(_jlayer, kind), p, x, jpp_mesh,
            num_microbatches=n_mb))(params, x))
        expect = x
        for i in range(params["w"].shape[0]):
            expect = _jlayer(kind, {k: v[i] for k, v in params.items()},
                             expect)
        for got in world.run(_gpipe, _np(params), np.asarray(x), n_mb, kind,
                             False):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got, np.asarray(expect), atol=1e-5,
                                       rtol=1e-5)

    def test_grads_match_sequential(self, world, jpp_mesh):
        params, x = _tanh_case(4, 8, 16, 3)

        def seq_loss(params):
            y = x
            for i in range(4):
                y = jnp.tanh(y @ params["w"][i])
            return jnp.sum(y ** 2)

        g_seq = np.asarray(jax.jit(jax.grad(seq_loss))(params)["w"])
        g_pipe = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jgpipe(
            functools.partial(_jlayer, "tanh"), p, x, jpp_mesh,
            num_microbatches=2) ** 2)))(params)["w"])
        ranks = world.run(_gpipe, _np(params), np.asarray(x), 2, "tanh", True)
        # Each stage's rows; the dp replicas compute the same thing.
        got = sum(r["w"] for r in ranks[:4])
        np.testing.assert_allclose(got, g_seq, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, g_pipe, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(sum(r["w"] for r in ranks[4:]), got)

    def test_validation_errors(self, world, jpp_mesh):
        def layer(p, x):
            return x

        with pytest.raises(ValueError):
            jgpipe(layer, {"w": jnp.zeros((6, 8, 8))}, jnp.zeros((8, 8)),
                   jpp_mesh, num_microbatches=2)
        with pytest.raises(ValueError):
            jgpipe(layer, {"w": jnp.zeros((8, 8, 8))}, jnp.zeros((7, 8)),
                   jpp_mesh, num_microbatches=2)
        for errors in world.run(_gpipe_errors):
            assert errors == ["6 layers not divisible over 4 stages",
                              "batch 7 not divisible by num_microbatches 2"]


class TestMoE:
    def test_expert_parallel_matches_single_device(self, world, jmesh):
        """Sharding experts over tp (tokens over dp and sp) must not change
        the math: y within 1e-5 and aux within 1e-6 of JAX's single-device
        and sharded runs."""
        kw = dict(d_model=32, d_ff=64, n_experts=4, top_k=2)
        cfg = JMoEConfig(dtype=jnp.float32, **kw)
        params = init_moe_params(jax.random.PRNGKey(0), cfg)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
        y_local, aux_local = jax.jit(functools.partial(jmoe_ffn, cfg=cfg))(
            x, params)
        sharded = jax.tree_util.tree_map(
            jax.device_put, params, jmoe_shardings(cfg, jmesh, axis="tp"))
        y_sh, aux_sh = jax.jit(functools.partial(jmoe_ffn, cfg=cfg))(
            x, sharded)
        for y, aux in world.run(_moe, np.asarray(x), _np(params), kw):
            for want_y, want_aux in ((y_local, aux_local), (y_sh, aux_sh)):
                np.testing.assert_allclose(y, np.asarray(want_y), atol=1e-5,
                                           rtol=1e-5)
                np.testing.assert_allclose(aux, float(want_aux), atol=1e-6)


def _jrun(body, x, jmesh, in_spec, out_specs):
    return shard_map_compat(body, mesh=jmesh, in_specs=in_spec,
                            out_specs=out_specs, check_vma=False)(x)


class TestCollectives:
    def test_all_reduce_and_gather(self, world, jmesh):
        x = jnp.arange(8, dtype=jnp.float32).reshape(8, 1)
        s, g = _jrun(lambda x: (jcoll.all_reduce_sum(x, "tp"),
                                jcoll.all_gather(x, "tp", axis=0)),
                     x, jmesh, JP("tp"), (JP("tp"), JP("tp")))
        assert s.shape == (8, 1) and g.shape == (16, 1)
        s, g = np.asarray(s), np.asarray(g)
        for rank, (ts, tg) in enumerate(world.run(_collectives,
                                                  "reduce_and_gather")):
            tp = rank % 2
            np.testing.assert_array_equal(ts, s[tp * 4:(tp + 1) * 4])
            np.testing.assert_array_equal(tg, g[tp * 8:(tp + 1) * 8])

    def test_reduce_scatter(self, world, jmesh):
        out = _jrun(lambda x: jcoll.reduce_scatter(x, "tp", axis=0),
                    jnp.ones((8, 4), jnp.float32), jmesh, JP("tp"), JP("tp"))
        assert out.shape == (4, 4)
        np.testing.assert_allclose(np.asarray(out), 2.0)
        for got in world.run(_collectives, "reduce_scatter"):
            assert got.shape == (2, 4)
            np.testing.assert_array_equal(got, np.asarray(out)[:2])

    def test_ring_permute(self, world, jmesh):
        out = np.asarray(_jrun(lambda x: jcoll.ring_permute(x, "sp"),
                               jnp.asarray([[1.0], [2.0]]), jmesh, JP("sp"),
                               JP("sp")))
        np.testing.assert_allclose(out, [[2.0], [1.0]])
        for rank, got in enumerate(world.run(_collectives, "ring_permute")):
            sp = rank // 2 % 2
            np.testing.assert_array_equal(got, out[sp])

    def test_broadcast_from(self, world, jmesh):
        out = np.asarray(_jrun(
            lambda x: jcoll.broadcast_from(x, "tp", src=1),
            jnp.asarray([[3.0], [7.0]]), jmesh, JP("tp"), JP("tp")))
        np.testing.assert_allclose(out, [[7.0], [7.0]])
        for got in world.run(_collectives, "broadcast_from"):
            np.testing.assert_array_equal(got, [7.0])

    def test_global_norm(self):
        want = float(jcoll.global_norm({"a": jnp.asarray([3.0]),
                                        "b": jnp.asarray([4.0])}))
        got = collectives.global_norm({"a": torch.tensor([3.0]),
                                       "b": torch.tensor([4.0])})
        assert got.item() == pytest.approx(5.0) == want
