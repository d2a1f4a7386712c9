"""The port's pipelined and sharded flagship against the JAX package on the
CPU: twins of tests/test_pipeline_model.py (the pipelined loss at its four
mesh specs, the pp=2 train step against one device, the loss's invariance
to the microbatch split), and the gradient twin: for dp, tp, sp, pp and
their combinations, the sharded loss and every gathered gradient leaf
against single-device JAX within 1e-5 of the leaf's largest magnitude, in
f32 (the reference's own tests hold only losses after AdamW steps, which
would hide a gradient off by a constant factor).

Each mesh of n ranks runs on a gloo world of n processes, one torch thread
a rank; one world is kept at a time, the tests ordered by world size."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import (TransformerConfig as JConfig, init_params as jinit,
                            loss_fn as jloss, make_train_step as jstep,
                            param_shardings as jshardings)
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.parallel import World

cloudpickle.register_pickle_by_value(sys.modules[__name__])

CFG = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)


@pytest.fixture(scope="module")
def worlds():
    """``worlds(n)``: an n-rank world, the one before it stopped first."""
    held = {}

    def get(n):
        if n not in held:
            for w in held.values():
                w.close()
            held.clear()
            held[n] = World(n, device="cpu", threads=1)
        return held[n]

    yield get
    for w in held.values():
        w.close()


@pytest.fixture(scope="module")
def jcase():
    cfg = JConfig(dtype=jnp.float32, **CFG)
    params = jinit(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 33), 0,
                                cfg.vocab_size, dtype=jnp.int32)
    return cfg, params, {"tokens": tokens}


@pytest.fixture(scope="module")
def jgrads(jcase):
    """Single-device JAX: the loss and every gradient leaf by name."""
    cfg, params, batch = jcase
    loss, grads = jax.jit(jax.value_and_grad(jloss), static_argnums=2)(
        params, batch, cfg)
    return float(loss), {".".join(k): np.asarray(v)
                         for k, v in _flat(grads).items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _size(spec):
    return int(np.prod(list(spec.values())))


def _jspec(spec):
    return JMeshSpec(**{a: spec.get(a, 1) for a in ("dp", "pp", "sp", "tp")})


# ------------------------------------------------- per-rank bodies (torch)


def _setup(spec, jparams, tokens):
    from ray_tpu_torch.models import (TransformerConfig, param_shardings,
                                      params_from_numpy)
    from ray_tpu_torch.parallel import P, make_mesh, shard
    cfg = TransformerConfig(dtype=torch.float32, **CFG)
    mesh = make_mesh(spec, device="cpu")
    specs = param_shardings(cfg, mesh)
    params = shard(params_from_numpy(jparams, device="cpu"), specs, mesh)
    batch = {"tokens": shard(torch.from_numpy(tokens), P("dp"), mesh)}
    return cfg, mesh, specs, params, batch


def _loss_and_grads(spec, jparams, tokens, n_mb):
    """The loss and every gradient leaf, gathered whole, after the train
    step's reduction over dp and sp."""
    from ray_tpu_torch.models import loss_fn, named_leaves
    from ray_tpu_torch.parallel import gather
    from ray_tpu_torch.parallel.collectives import reduce_gradients
    cfg, mesh, specs, params, batch = _setup(spec, jparams, tokens)
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = loss_fn(params, batch, cfg, mesh, num_microbatches=n_mb)
    loss.backward()
    reduce_gradients(list(leaves.values()), mesh)
    grads = gather({"embed": params["embed"].grad,
                    "layers": {k: v.grad for k, v in
                               params["layers"].items()},
                    "final_norm": params["final_norm"].grad}, specs, mesh)
    return loss.item(), {k: v.numpy() for k, v in named_leaves(grads).items()}


def _losses(spec, jparams, tokens, splits):
    from ray_tpu_torch.models import loss_fn
    cfg, mesh, _, params, batch = _setup(spec, jparams, tokens)
    with torch.no_grad():
        return [loss_fn(params, batch, cfg, mesh, num_microbatches=m).item()
                for m in splits]


def _train(spec, jparams, tokens, n_mb, steps):
    from ray_tpu_torch.models import make_train_step
    cfg, mesh, _, params, batch = _setup(spec, jparams, tokens)
    init_opt, train_step = make_train_step(cfg, mesh, num_microbatches=n_mb)
    opt = init_opt(params)
    out = []
    for _ in range(steps):
        params, opt, loss = train_step(params, opt, batch)
        out.append(loss.item())
    return out


# ------------------------------------------------------------------ tests

LAYOUTS = [{"dp": 2}, {"tp": 2}, {"sp": 2}, {"pp": 2},
           {"sp": 2, "tp": 2}, {"pp": 2, "sp": 2},
           {"dp": 2, "pp": 2, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
           {"pp": 4, "tp": 2}]


@pytest.mark.parametrize("spec", LAYOUTS,
                         ids=lambda s: "-".join(f"{a}{n}"
                                                for a, n in s.items()))
def test_gradients_match_single_device(worlds, jcase, jgrads, spec):
    cfg, params, batch = jcase
    loss, want = jgrads
    ranks = worlds(_size(spec)).run(_loss_and_grads, spec, _np(params),
                                    np.asarray(batch["tokens"]), 2)
    for got_loss, got in ranks:
        assert got_loss == pytest.approx(loss, abs=1e-5)
        assert set(got) == set(want)
        for name, g in want.items():
            err = np.abs(got[name] - g).max() / np.abs(g).max()
            assert err < 1e-5, (spec, name, err)


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


def test_pipelined_train_step_matches_pp1(worlds, jcase):
    """3 AdamW steps at (dp2, pp2, tp2) track the single-device run step
    for step, through both packages."""
    cfg, params, batch = jcase

    def run(mesh, n_mb):
        p = params if mesh is None else jax.device_put(
            params, jshardings(cfg, mesh))
        init_opt, train_step = jstep(cfg, mesh, num_microbatches=n_mb)
        opt = init_opt(p)
        step = jax.jit(train_step)
        losses = []
        for _ in range(3):
            p, opt, loss = step(p, opt, batch)
            losses.append(float(loss))
        return losses

    ref = run(None, 0)
    spec = {"dp": 2, "pp": 2, "tp": 2}
    for got in worlds(8).run(_train, spec, _np(params),
                             np.asarray(batch["tokens"]), 2, 3):
        np.testing.assert_allclose(got, ref, atol=5e-4)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        assert got[-1] < got[0], "loss should decrease"


@pytest.mark.parametrize(
    "spec",
    [{"dp": 2, "pp": 2, "sp": 1, "tp": 2},
     {"dp": 1, "pp": 2, "sp": 2, "tp": 2},
     {"dp": 1, "pp": 4, "sp": 1, "tp": 2},
     {"dp": 1, "pp": 2, "sp": 1, "tp": 1}],
    ids=lambda s: "x".join(str(v) for v in s.values()))
def test_pipelined_loss_matches_scan(worlds, jcase, jgrads, spec):
    cfg, params, batch = jcase
    ref = jgrads[0]
    mesh = jmake_mesh(_jspec(spec), jax.devices()[:_size(spec)])
    cfg.validate_for_mesh(mesh)
    sharded = float(jax.jit(
        lambda p, b: jloss(p, b, cfg, mesh, num_microbatches=2))(
            jax.device_put(params, jshardings(cfg, mesh)), batch))
    for got, in worlds(_size(spec)).run(_losses, spec, _np(params),
                                        np.asarray(batch["tokens"]), [2]):
        assert got == pytest.approx(ref, abs=2e-4), (spec, got, ref)
        assert got == pytest.approx(sharded, abs=1e-5)


def test_microbatch_count_invariance(worlds, jcase):
    """The pipelined loss is independent of the microbatch split."""
    cfg, params, batch = jcase
    mesh = jmake_mesh(JMeshSpec(dp=1, pp=2, sp=1, tp=1), jax.devices()[:2])
    p = jax.device_put(params, jshardings(cfg, mesh))
    want = [float(jax.jit(lambda p, b, m=m: jloss(
        p, b, cfg, mesh, num_microbatches=m))(p, batch)) for m in (1, 2, 4)]
    for vals in worlds(2).run(_losses, {"pp": 2}, _np(params),
                              np.asarray(batch["tokens"]), [1, 2, 4]):
        np.testing.assert_allclose(vals, vals[0] * np.ones(3), atol=1e-5)
        np.testing.assert_allclose(vals, want, atol=1e-5)
