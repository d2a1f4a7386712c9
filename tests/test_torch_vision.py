"""The port's vision family against the JAX package's on the CPU, with the
JAX package's weights carried across (``vision_params_from_numpy``, HWIO
kernels to OIHW): logits, loss and every gradient at the reference test's
config (stride-2 blocks and 1x1 projections), XLA's SAME padding at stride
2, GroupNorm, the carried layout's round trip, and twins of
tests/test_vision.py's single-device tests, each program run through both
packages (the port's trains through its MeshTrainer on the CPU), and the
twin of its dp-sharded step on an 8-rank gloo world."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vision as jvis
from ray_tpu.train import MeshTrainer as JMeshTrainer
from ray_tpu_torch.models import vision as tvis
from ray_tpu_torch.models.transformer import named_leaves
from ray_tpu_torch.train import MeshTrainer as TMeshTrainer

_CFG = dict(image_size=16, in_channels=1, num_classes=4, widths=(8, 16),
            blocks_per_stage=2, groups=4)


def _cfgs(**over):
    kw = dict(_CFG, **over)
    return jvis.VisionConfig(**kw), tvis.VisionConfig(**kw)


_jinit = jax.jit(jvis.init_vision_params, static_argnums=1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _quadrant_batch(key, cfg, n=64):
    """tests/test_vision.py's task: the label is the quadrant that holds
    the bright blob (jitted here: one compile, not one per op)."""
    k1, k2 = jax.random.split(key)
    labels = jax.random.randint(k1, (n,), 0, 4)
    size = cfg.image_size
    imgs = 0.1 * jax.random.normal(k2, (n, size, size, cfg.in_channels))
    half = size // 2
    ys = (labels // 2) * half
    xs = (labels % 2) * half

    def paint(img, y0, x0):
        patch = jnp.ones((half, half, cfg.in_channels))
        return jax.lax.dynamic_update_slice(img, patch, (y0, x0, 0))

    imgs = jax.vmap(paint)(imgs, ys, xs)
    return {"images": imgs.astype(jnp.float32),
            "labels": labels.astype(jnp.int32)}


def _torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def test_vision_logits_loss_and_every_gradient_match_jax():
    """f32 at the reference test's config: logits within atol 1e-5, the
    loss within 1e-6 and every gradient within atol 1e-6, rtol 1e-4 of
    jax.value_and_grad(vision_loss), the port's OIHW kernel gradients
    turned back to HWIO."""
    jcfg, tcfg = _cfgs()
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    batch = _quadrant_batch(jax.random.PRNGKey(1), jcfg, n=8)
    jlogits = jax.jit(jvis.vision_apply, static_argnums=2)(
        jparams, batch["images"], jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jvis.vision_loss),
                            static_argnums=2)(jparams, batch, jcfg)

    params = tvis.vision_params_from_numpy(_np_tree(jparams), device="cpu")
    for t in named_leaves(params).values():
        t.requires_grad_(True)
    tb = _torch_batch(batch)
    logits = tvis.vision_apply(params, tb["images"], tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    loss = tvis.vision_loss(params, tb, tcfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-6
    ref = named_leaves(_np_tree(jgrads))
    ours = named_leaves(params)
    assert sorted(ours) == sorted(ref)
    for name, want in ref.items():
        got = ours[name].grad.numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)           # OIHW -> HWIO
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_pads_as_xla_same(size, k, stride):
    """The port's _conv against lax.conv_general_dilated(padding="SAME"),
    f32, within 1e-5: at stride 2 on an even size a 3x3 kernel pads 0
    before and 1 after (padding=1 would shift every window)."""
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = jvis._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = tvis._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert tvis._same_pads(16, 3, 2) == (0, 1)


def test_group_norm_matches_jax():
    """GroupNorm over contiguous channel groups, population variance, eps
    1e-5, on NCHW against the JAX package's NHWC: within 1e-5, with more
    groups than channels clamped to the channel count."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    for groups in (4, 16):
        want = jvis._group_norm(jnp.asarray(x), scale, bias, groups)
        got = tvis._group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias), groups)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)


def test_carried_weights_round_trip_and_init_layout_is_jax_s():
    """vision_params_from_numpy turns each HWIO kernel to OIHW (back again
    it is JAX's array, bit for bit) and keeps every other leaf; the port's
    init gives JAX's keys, list lengths and shapes in its layout."""
    jcfg, tcfg = _cfgs()
    ref = named_leaves(_np_tree(_jinit(jax.random.PRNGKey(0), jcfg)))
    carried = named_leaves(tvis.vision_params_from_numpy(
        _np_tree(_jinit(jax.random.PRNGKey(0), jcfg)), device="cpu"))
    ours = named_leaves(tvis.init_vision_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert sorted(carried) == sorted(ours) == sorted(ref)
    for name, want in ref.items():
        back = carried[name].numpy()
        if want.ndim == 4:
            back = back.transpose(2, 3, 1, 0)
            assert ours[name].shape == carried[name].shape
        np.testing.assert_array_equal(back, want, err_msg=name)
        assert tuple(ours[name].shape) == tuple(carried[name].shape), name


def test_config_refuses_widths_its_groups_do_not_divide():
    for cfg_cls in (jvis.VisionConfig, tvis.VisionConfig):
        with pytest.raises(ValueError, match="not divisible"):
            cfg_cls(widths=(12, 16), groups=8)


def test_vision_entry_points_take_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.init_vision_params(torch.Generator(), _cfgs()[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.vision_params_from_numpy({"stem": np.zeros((3, 3, 1, 8))})


# ---------------------------------------------------------------- twins


def test_shapes_and_determinism():
    """Twin of tests/test_vision.py::test_shapes_and_determinism: logits
    [8, 4], the same bits twice, in each package (the port from JAX's
    weights, within 1e-5 of JAX's logits)."""
    jcfg, tcfg = _cfgs()
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    batch = _quadrant_batch(jax.random.PRNGKey(1), jcfg, n=8)
    jl = jvis.vision_apply(jparams, batch["images"], jcfg)
    assert jl.shape == (8, 4)
    np.testing.assert_array_equal(
        np.asarray(jl), np.asarray(jvis.vision_apply(
            jparams, batch["images"], jcfg)))
    params = tvis.vision_params_from_numpy(_np_tree(jparams), device="cpu")
    images = _torch_batch(batch)["images"]
    tl = tvis.vision_apply(params, images, tcfg)
    assert tl.shape == (8, 4)
    assert torch.equal(tl, tvis.vision_apply(params, images, tcfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_learns_quadrant_task():
    """Twin of tests/test_vision.py::test_learns_quadrant_task: each
    package's MeshTrainer, from JAX's initial weights, 60 steps of AdamW at
    3e-3 on the same batches; each reaches accuracy > 0.9 on the held-out
    batch."""
    jcfg, tcfg = _cfgs()

    def batches(seed):
        key = jax.random.PRNGKey(seed)
        while True:
            key, sub = jax.random.split(key)
            yield _quadrant_batch(sub, jcfg)

    jtrainer = JMeshTrainer(
        lambda key: jvis.init_vision_params(key, jcfg),
        lambda p, b: jvis.vision_loss(p, b, jcfg),
        learning_rate=3e-3,
    )
    init = _np_tree(jvis.init_vision_params(jax.random.PRNGKey(0), jcfg))
    ttrainer = TMeshTrainer(
        lambda gen: tvis.vision_params_from_numpy(init, device="cpu"),
        lambda p, b: tvis.vision_loss(p, b, tcfg),
        learning_rate=3e-3, device="cpu",
    )
    stream = batches(0)
    data = [next(stream) for _ in range(60)]
    jtrainer.train(iter(data), num_steps=60)
    ttrainer.train(iter(_torch_batch(b) for b in data), num_steps=60)
    test_batch = _quadrant_batch(jax.random.PRNGKey(99), jcfg, n=128)
    jacc = float(jvis.vision_accuracy(jtrainer.state.params, test_batch,
                                      jcfg))
    tacc = tvis.vision_accuracy(ttrainer.state.params,
                                _torch_batch(test_batch), tcfg).item()
    assert jacc > 0.9, jacc
    assert tacc > 0.9, tacc


@pytest.fixture(scope="module")
def world8():
    from ray_tpu_torch.parallel import World
    with World(8, device="cpu", threads=1) as w:
        yield w


def test_dp_sharded_step_matches_single_device(world8):
    """Twin of tests/test_vision.py::test_dp_sharded_step_matches_single_device
    on an 8-rank gloo world: the parameters replicated by
    ``vision_param_shardings``, the 16 images split over dp=8; the mean of
    the ranks' losses within 1e-5 of JAX's single-device and sharded
    losses, and every gradient, averaged over dp as the train step does,
    within 1e-5 of its largest magnitude of JAX's."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from ray_tpu.parallel.mesh import MeshSpec, make_mesh

    def rank(jparams, batch, cfg_kw):
        import sys

        import numpy as np
        import torch
        from ray_tpu_torch.models import vision as tvis
        from ray_tpu_torch.models.transformer import named_leaves
        from ray_tpu_torch.parallel import P, gather, make_mesh, shard
        from ray_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                        reduce_gradients)

        mesh = make_mesh({"dp": 8}, device="cpu")
        cfg = tvis.VisionConfig(**cfg_kw)
        specs = tvis.vision_param_shardings(cfg, mesh)
        params = shard(tvis.vision_params_from_numpy(jparams, device="cpu"),
                       specs, mesh)
        leaves = named_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        local = shard({k: torch.from_numpy(v) for k, v in batch.items()},
                      P("dp"), mesh)
        loss = all_reduce_mean(tvis.vision_loss(params, local, cfg), mesh,
                               "dp")
        loss.backward()
        reduce_gradients(list(leaves.values()), mesh)
        grads = gather({k: t.grad for k, t in leaves.items()},
                       {k: P() for k in leaves}, mesh)
        assert "jax" not in sys.modules
        return loss.item(), {k: np.asarray(v) for k, v in grads.items()}

    jcfg, _ = _cfgs()
    params = _jinit(jax.random.PRNGKey(0), jcfg)
    batch = _quadrant_batch(jax.random.PRNGKey(1), jcfg, n=16)
    ref = float(jax.jit(lambda p, b: jvis.vision_loss(p, b, jcfg))(params,
                                                                   batch))
    mesh = make_mesh(MeshSpec(dp=8, pp=1, sp=1, tp=1), jax.devices()[:8])
    p_sharded = jax.device_put(params, jvis.vision_param_shardings(jcfg,
                                                                   mesh))
    b_sharded = jax.device_put(
        batch, {"images": NamedSharding(mesh, JP("dp")),
                "labels": NamedSharding(mesh, JP("dp"))})
    got_jax = float(jax.jit(lambda p, b: jvis.vision_loss(p, b, jcfg))(
        p_sharded, b_sharded))
    assert got_jax == pytest.approx(ref, abs=1e-5)
    jgrads = jax.jit(jax.grad(jvis.vision_loss), static_argnums=2)(
        params, batch, jcfg)
    want = named_leaves(_np_tree(jgrads))
    for loss, grads in world8.run(rank, _np_tree(params), _np_tree(batch),
                                  _CFG):
        assert loss == pytest.approx(ref, abs=1e-5)
        assert loss == pytest.approx(got_jax, abs=1e-5)
        assert sorted(grads) == sorted(want)
        for name, g in want.items():
            got = grads[name]
            if got.ndim == 4:
                got = got.transpose(2, 3, 1, 0)       # OIHW -> HWIO
            err = np.abs(got - g).max() / np.abs(g).max()
            assert err < 1e-5, (name, err)
