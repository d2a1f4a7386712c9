"""The port's train library against the JAX package's on the CPU: twins of
tests/test_train.py's TPUTrainer tests and single-device MeshTrainer tests,
each program run through ``ray_tpu`` and then through ``ray_tpu_torch`` (a
fresh local runtime each) on the same numpy-seeded batches; 5 steps of each
trainer against JAX's (optax.adamw at weight decay 1e-4) with the
parameters held within 1e-5; the twin of its sharded dp=8 test on an
8-rank gloo world, and the refusals of what is not a mesh; the launch
counters' atomic increments under threads; and the twins of
tests/test_moe_train.py::test_tpu_trainer_as_trainable (each trial's loss
at each iteration within 1e-5 of JAX's) and ::test_worker_logs_reach_driver."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.train import MeshTrainer as JMeshTrainer
from ray_tpu.train import TPUTrainer as JTPUTrainer
from ray_tpu_torch._kernels import count_launch
from ray_tpu_torch.train import MeshTrainer as TMeshTrainer
from ray_tpu_torch.train import TPUTrainer as TTPUTrainer
from ray_tpu_torch.train import TrainState

DIM = 8
TRUE_W = np.linspace(-1.0, 1.0, DIM).astype(np.float32)
PKGS = (ray_tpu, ray_tpu_torch)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in PKGS:
        rt.shutdown()


# The reference test's model, once per package: a linear regression.
def _jinit(rng):
    return {"w": jnp.zeros((DIM,), jnp.float32),
            "b": jnp.zeros((), jnp.float32)}


def _jloss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _tinit(gen):
    return {"w": torch.zeros(DIM, device=gen.device),
            "b": torch.zeros((), device=gen.device)}


def _tloss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _batches(seed, batch_size=32, jax_arrays=False):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((batch_size, DIM)).astype(np.float32)
        y = x @ TRUE_W + 0.5
        if jax_arrays:
            yield {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        else:
            yield {"x": x, "y": y}


def _jdata(rank, world_size, config):
    return _batches(seed=1000 + rank, jax_arrays=True)


def _tdata(rank, world_size, config):
    return _batches(seed=1000 + rank)


def _tpu_trainer(rt, **kw):
    """TPUTrainer of ``rt``'s package, on its local runtime."""
    rt.init(num_cpus=8, ignore_reinit_error=True)
    kw.setdefault("num_workers", 2)
    kw.setdefault("learning_rate", 0.1)
    if rt is ray_tpu:
        return JTPUTrainer(_jinit, _jloss, _jdata, **kw)
    return TTPUTrainer(_tinit, _tloss, _tdata, device="cpu", **kw)


def _mesh_trainer(rt, **kw):
    if rt is ray_tpu:
        return JMeshTrainer(_jinit, _jloss, learning_rate=0.1, **kw)
    return TMeshTrainer(_tinit, _tloss, learning_rate=0.1, device="cpu",
                        **kw)


def _data(rt, seed):
    return _batches(seed, jax_arrays=rt is ray_tpu)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------- TPUTrainer


class TestTPUTrainer:
    """Twins of tests/test_train.py::TestTPUTrainer."""

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_loss_decreases(self, rt):
        t = _tpu_trainer(rt)
        try:
            first = t.train(num_steps=2)
            later = t.train(num_steps=20)
            assert later["loss"] < first["loss"]
            assert t.step == 22
        finally:
            t.shutdown()

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_validate(self, rt):
        t = _tpu_trainer(rt)
        try:
            t.train(num_steps=20)
            val = t.validate(num_batches=2)
            assert val["val_loss"] < 3.0
        finally:
            t.shutdown()

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_state_dict_roundtrip(self, rt, tmp_path):
        t = _tpu_trainer(rt)
        try:
            t.train(num_steps=5)
            path = t.save(str(tmp_path / "sgd.pkl"))
            want = _np(t.params["w"]).copy()
        finally:
            t.shutdown()
        t2 = _tpu_trainer(rt)
        try:
            t2.restore(path)
            assert t2.step == 5
            np.testing.assert_array_equal(_np(t2.params["w"]), want)
        finally:
            t2.shutdown()

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_elastic_resize(self, rt):
        t = _tpu_trainer(rt, num_workers=2)
        try:
            t.train(num_steps=3)
            t.resize(3)
            assert len(t.workers) == 3
            stats = t.train(num_steps=3)
            assert stats["num_steps"] == 3
        finally:
            t.shutdown()

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_worker_failure_recovery(self, rt):
        t = _tpu_trainer(rt, num_workers=2, max_retries=2)
        try:
            t.train(num_steps=2)
            # Kill one worker out from under the trainer; the next train()
            # must recover by rebuilding the worker set.
            rt.kill(t.workers[0])
            stats = t.train(num_steps=3)
            assert stats["num_steps"] == 3
            assert stats["retries"] == 1
            assert t.step == 5
        finally:
            t.shutdown()

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_same_init_across_workers(self, rt):
        """All ranks must start from identical params (same seed)."""
        t = _tpu_trainer(rt, num_workers=2)
        try:
            stats = t.train(num_steps=1)
            assert np.isfinite(stats["loss"])
        finally:
            t.shutdown()


def test_tpu_trainer_matches_jax_over_five_steps():
    """2 workers, 5 steps, AdamW at 0.1 (weight decay 1e-4, optax's
    default) on each rank's own shard: every step's mean loss within 1e-5
    and the parameters within atol 1e-5 of JAX's (Adam's update rounds
    differently in torch and optax: ~3e-6 apart after 5 steps of 0.1).
    Each port worker copies
    the pushed parameters into leaves of its own: two workers writing one
    ``.grad`` would double the step's gradient."""
    runs = []
    for rt in PKGS:
        t = _tpu_trainer(rt)
        try:
            losses = [t.train(num_steps=1)["loss"] for _ in range(5)]
            runs.append((losses, {k: _np(v).copy()
                                  for k, v in t.params.items()}))
        finally:
            t.shutdown()
            rt.shutdown()
    (jl, jp), (tl, tp) = runs
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-5,
                                   err_msg=name)


_AS_TRAINABLE_W0 = np.array([0.3, -0.2, 0.1, 0.4], np.float32)
_AS_TRAINABLE_W = np.array([1., -2., 3., 0.5], np.float32)


def _as_trainable_losses(rt, tmp_path):
    """tests/test_moe_train.py::test_tpu_trainer_as_trainable's program
    through ``rt``'s tune and TPUTrainer, from a fixed numpy ``w``: each
    trial's ``loss`` at each of its 4 iterations, trials by learning
    rate."""
    import json
    import os

    rt.init(num_cpus=8)
    if rt is ray_tpu:
        from ray_tpu import tune

        def init_fn(rng):
            return {"w": jnp.asarray(_AS_TRAINABLE_W0)}

        def loss_fn(params, batch):
            return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

        trainable = JTPUTrainer.as_trainable(
            init_fn, loss_fn, _as_trainable_data, num_workers=2)
    else:
        from ray_tpu_torch import tune

        def init_fn(gen):
            return {"w": torch.tensor(_AS_TRAINABLE_W0, device=gen.device)}

        def loss_fn(params, batch):
            return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

        trainable = TTPUTrainer.as_trainable(
            init_fn, loss_fn, _as_trainable_data, num_workers=2,
            device="cpu")
    analysis = tune.run(
        trainable,
        config={"learning_rate": tune.grid_search([0.05, 0.1])},
        stop={"training_iteration": 4}, local_dir=str(tmp_path),
        verbose=0)
    assert len(analysis.trials) == 2
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    out = {}
    for t in analysis.trials:
        path = os.path.join(analysis.local_dir, f"trial_{t.trial_id}",
                            "result.json")
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        assert [r["training_iteration"] for r in rows] == [1, 2, 3, 4]
        out[t.config["learning_rate"]] = [r["loss"] for r in rows]
    return out


def _as_trainable_data(rank, world, config):
    rng = np.random.RandomState(rank)
    while True:
        x = rng.randn(16, 4).astype(np.float32)
        yield {"x": x, "y": x @ _AS_TRAINABLE_W}


def test_tpu_trainer_as_trainable_matches_jax(tmp_path):
    """Twin of tests/test_moe_train.py::test_tpu_trainer_as_trainable: 2
    trials (learning rates 0.05 and 0.1) of a 2-worker TPUTrainer under
    each package's ``tune.run``, 4 iterations each, from the same numpy
    ``w``; every trial's loss at every iteration within 1e-5 of JAX's, as
    test_tpu_trainer_matches_jax_over_five_steps holds the trainer. The
    port's trainable shuts its trainer's workers down at the end."""
    jax_losses = _as_trainable_losses(ray_tpu, tmp_path / "jax")
    ray_tpu.shutdown()
    port_losses = _as_trainable_losses(ray_tpu_torch, tmp_path / "port")
    assert set(port_losses) == set(jax_losses) == {0.05, 0.1}
    for lr, losses in jax_losses.items():
        assert np.isfinite(losses).all()
        np.testing.assert_allclose(port_losses[lr], losses, atol=1e-5,
                                   rtol=1e-5, err_msg=str(lr))
    # Every trial's trainer and its workers are gone with the trials.
    assert ray_tpu_torch.available_resources()["CPU"] == 8


def test_tpu_trainer_workers_hold_their_own_leaves():
    """The driver's parameters come back without grad and with no
    ``.grad`` after a step; the init_fn runs once at the driver and once
    per rank, each from a generator seeded with ``seed``."""
    seen = []

    def init_fn(gen):
        seen.append(torch.randn(3, generator=gen))
        return _tinit(gen)

    ray_tpu_torch.init(num_cpus=8)
    t = TTPUTrainer(init_fn, _tloss, _tdata, num_workers=2, seed=7,
                    device="cpu")
    try:
        t.train(num_steps=2)
        assert len(seen) == 3
        assert all(torch.equal(s, seen[0]) for s in seen)
        for p in t.params.values():
            assert p.grad is None and not p.requires_grad
        assert t.optimizer.param_groups[0]["weight_decay"] == 1e-4
    finally:
        t.shutdown()


@pytest.mark.parametrize("kind", ["tpu_trainer", "mesh_trainer"])
def test_restore_keeps_the_trainers_learning_rate_as_jax(kind, tmp_path):
    """A checkpoint taken at learning rate 0.1 restored into a trainer
    built at 0.01 (a PBT exploit's explored rate) steps at 0.01 with the
    saved moments, as JAX's trainers do (optax's state holds no rate): the
    parameters after 2 more steps within 1e-5 of JAX's."""
    after = []
    for rt in PKGS:
        path = str(tmp_path / f"{rt.__name__}.pkl")
        if kind == "tpu_trainer":
            t = _tpu_trainer(rt)
            t.train(num_steps=3)
            t.save(path)
            t.shutdown()
            t2 = _tpu_trainer(rt, learning_rate=0.01)
            t2.restore(path)
            t2.train(num_steps=2)
            after.append({k: _np(v).copy() for k, v in t2.params.items()})
            t2.shutdown()
        else:
            t = _mesh_trainer(rt)
            t.train(_data(rt, 5), num_steps=3)
            t.save(path)
            if rt is ray_tpu:
                t2 = JMeshTrainer(_jinit, _jloss, learning_rate=0.01)
            else:
                t2 = TMeshTrainer(_tinit, _tloss, learning_rate=0.01,
                                  device="cpu")
                assert t2.state.opt_state.param_groups[0]["lr"] == 0.01
            t2.restore(path)
            t2.train(_data(rt, 6), num_steps=2)
            after.append({k: _np(v).copy()
                          for k, v in t2.state.params.items()})
        rt.shutdown()
    jp, tp = after
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------ MeshTrainer


class TestMeshTrainer:
    """Twins of the single-device tests of tests/test_train.py::
    TestMeshTrainer."""

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_loss_decreases_single_device(self, rt):
        t = _mesh_trainer(rt)
        first = t.train(_data(rt, 0), num_steps=5)
        last = t.train(_data(rt, 1), num_steps=40)
        assert last["loss"] < first["loss"]
        assert t.state.step == 45

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_save_restore_roundtrip(self, rt, tmp_path):
        t = _mesh_trainer(rt)
        t.train(_data(rt, 0), num_steps=10)
        path = str(tmp_path / "ckpt.pkl")
        t.save(path)
        t2 = _mesh_trainer(rt)
        t2.restore(path)
        assert t2.state.step == 10
        np.testing.assert_allclose(_np(t2.state.params["w"]),
                                   _np(t.state.params["w"]))

    @pytest.mark.parametrize("rt", PKGS, ids=lambda m: m.__name__)
    def test_evaluate(self, rt):
        t = _mesh_trainer(rt)
        t.train(_data(rt, 0), num_steps=30)
        val = t.evaluate(_data(rt, 7), num_batches=3)
        assert val["val_loss"] < 3.0


def test_mesh_trainer_matches_jax_over_five_steps():
    """5 steps of AdamW at 0.1 (weight decay 1e-4, optax's default) on the
    same batches: each loss within 1e-5 and the parameters within atol
    1e-5 of JAX's (as the TPUTrainer's)."""
    runs = []
    for rt in PKGS:
        t = _mesh_trainer(rt)
        data = _data(rt, 3)
        runs.append((t, [t.train_step(next(data)) for _ in range(5)]))
    (jt, jl), (tt, tl) = runs
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    for name in ("w", "b"):
        np.testing.assert_allclose(_np(tt.state.params[name]),
                                   _np(jt.state.params[name]), atol=1e-5)


def test_mesh_trainer_restore_continues_the_optimizer(tmp_path):
    """A restored trainer takes the next steps as the saved one does:
    parameters, Adam's moments and the step carry over."""
    t = _mesh_trainer(ray_tpu_torch)
    data = _data(ray_tpu_torch, 4)
    t.train(data, num_steps=5)
    path = str(tmp_path / "state.pkl")
    t.save(path)
    loaded = TrainState.load(path)
    assert loaded.step == 5 and isinstance(loaded.opt_state, dict)
    t2 = _mesh_trainer(ray_tpu_torch)
    t2.restore(path)
    batches = [next(data) for _ in range(3)]
    a = [t.train_step(b) for b in batches]
    b = [t2.train_step(b) for b in batches]
    assert a == b
    assert torch.equal(t.state.params["w"], t2.state.params["w"])
    assert t2.state.step == 8


@pytest.mark.parametrize("kw,err", [({"mesh": object()}, TypeError),
                                    ({"param_shardings": {}}, ValueError),
                                    ({"batch_spec": ("dp",)}, ValueError)],
                         ids=["mesh", "param_shardings", "batch_spec"])
def test_mesh_trainer_refuses_a_mesh(kw, err):
    """A mesh must be the port's (``parallel.make_mesh``); shardings and a
    batch spec without one are refused, not ignored."""
    with pytest.raises(err, match="mesh|Mesh"):
        TMeshTrainer(_tinit, _tloss, device="cpu", **kw)


# ------------------------------------------------- MeshTrainer on a mesh


@pytest.fixture(scope="module")
def world8():
    from ray_tpu_torch.parallel import World
    with World(8, device="cpu", threads=1) as w:
        yield w


def test_sharded_dp_training(world8, tmp_path):
    """Twin of tests/test_train.py::TestMeshTrainer::test_sharded_dp_training:
    30 steps over dp=8 (every rank given the whole batch, keeping its
    block) learn the regression as JAX's do: the same mean loss and
    parameters within 1e-5 on every rank; the checkpoint restores on the
    mesh (the next step the same) and on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    def _dp8_rank(dim, true_w, steps, path):
        """On every rank: the regression MeshTrainer over dp=8 (replicated
        parameters, batches split by P("dp")), ``steps`` steps on the seed-0
        batches, then save to ``path`` (rank 0 writes). Nested helpers only:
        it travels by value, defined in the test."""
        import sys

        import numpy as np
        import torch
        from ray_tpu_torch.parallel import P, make_mesh
        from ray_tpu_torch.train import MeshTrainer

        def init(gen):
            return {"w": torch.zeros(dim), "b": torch.zeros(())}

        def loss(params, batch):
            pred = batch["x"] @ params["w"] + params["b"]
            return torch.mean((pred - batch["y"]) ** 2)

        def batches(seed):
            rng = np.random.default_rng(seed)
            while True:
                x = rng.standard_normal((32, dim)).astype(np.float32)
                yield {"x": x, "y": x @ true_w + 0.5}

        mesh = make_mesh({"dp": 8}, device="cpu")
        t = MeshTrainer(init, loss, learning_rate=0.1, mesh=mesh,
                        param_shardings={"w": P(), "b": P()},
                        batch_spec=P("dp"))
        stats = t.train(batches(0), num_steps=steps)
        val = t.evaluate(batches(7), num_batches=2)
        w = t.state.params["w"].detach().numpy().copy()
        t.save(path)
        again = MeshTrainer(init, loss, learning_rate=0.1, mesh=mesh,
                            param_shardings={"w": P(), "b": P()},
                            batch_spec=P("dp"))
        again.restore(path)
        assert again.state.step == steps
        assert torch.equal(again.state.params["w"], t.state.params["w"])
        nxt = next(batches(9))
        assert again.train_step(nxt) == t.train_step(nxt)
        assert "jax" not in sys.modules
        return stats["loss"], val["val_loss"], w

    from ray_tpu.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(dp=8, pp=1, sp=1, tp=1))
    jt = JMeshTrainer(_jinit, _jloss, learning_rate=0.1, mesh=mesh,
                      param_shardings={"w": NamedSharding(mesh, JP()),
                                       "b": NamedSharding(mesh, JP())},
                      batch_spec=JP("dp"))
    jstats = jt.train(_data(ray_tpu, 0), num_steps=30)
    jw = np.asarray(jt.state.params["w"])
    assert jstats["loss"] < 2.0
    path = str(tmp_path / "dp8.pkl")
    ranks = world8.run(_dp8_rank, DIM, TRUE_W, 30, path)
    for loss, val, w in ranks:
        assert loss < 2.0 and val < 3.0
        assert abs(loss - jstats["loss"]) < 1e-5
        assert np.abs(w - TRUE_W).mean() < 0.5
        np.testing.assert_allclose(w, jw, atol=1e-5)
        np.testing.assert_array_equal(w, ranks[0][2])
    one = _mesh_trainer(ray_tpu_torch)
    one.restore(path)
    assert one.state.step == 30
    np.testing.assert_array_equal(_np(one.state.params["w"]), ranks[0][2])


@pytest.mark.parametrize("make", ["MeshTrainer", "TPUTrainer"])
def test_trainers_take_the_card_by_default(make, monkeypatch):
    """Without a card, a trainer given no device raises; it never moves to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if make == "MeshTrainer":
            TMeshTrainer(_tinit, _tloss)
        else:
            TTPUTrainer(_tinit, _tloss, _tdata)


# ----------------------------------------------- the launch counters


def test_launch_counter_increments_are_atomic_across_threads():
    """8 threads count 20,000 launches each through count_launch: none is
    lost (a plain ``+=`` on a function attribute can lose counts when a
    thread switch falls between its read and its write)."""
    def fn():
        pass

    fn.launches = 0
    fn.backward_launches = 0
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(20_000):
            count_launch(fn)
            count_launch(fn, "backward_launches")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert fn.launches == fn.backward_launches == 160_000


# ------------------------------------------- worker logs on a cluster


@pytest.mark.cluster
def test_worker_logs_reach_driver(capfd):
    """Twin of tests/test_moe_train.py::test_worker_logs_reach_driver: a
    worker process's print reaches the driver's console, through each
    package's cluster (the port's GCS places on the CPU; both clusters
    start side by side)."""
    from ray_tpu.cluster.testing import Cluster as JCluster
    from ray_tpu_torch.cluster.testing import Cluster as TCluster

    clusters = {}

    def start(rt):
        kw = {"device": "cpu"} if rt is ray_tpu_torch else {}
        make = TCluster if rt is ray_tpu_torch else JCluster
        clusters[rt] = make(head_resources={"CPU": 2}, num_workers=1, **kw)

    starters = [threading.Thread(target=start, args=(rt,)) for rt in PKGS]
    for th in starters:
        th.start()
    for th in starters:
        th.join()
    try:
        assert len(clusters) == 2, "a cluster failed to start"
        for rt in PKGS:
            rt.init(address=clusters[rt].address)

            @rt.remote
            def noisy():
                print("HELLO-FROM-WORKER-xyzzy")
                return 1

            assert rt.get(noisy.remote(), timeout=60) == 1
            deadline = time.monotonic() + 10
            seen = ""
            while time.monotonic() < deadline:
                out = capfd.readouterr()
                seen += out.out + out.err
                if "HELLO-FROM-WORKER-xyzzy" in seen:
                    break
                time.sleep(0.2)
            assert "HELLO-FROM-WORKER-xyzzy" in seen, rt.__name__
            rt.shutdown()
    finally:
        for rt in PKGS:
            rt.shutdown()
        for c in clusters.values():
            c.shutdown()
