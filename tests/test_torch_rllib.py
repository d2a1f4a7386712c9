"""The port's rllib against the JAX package's, on the CPU: twins of the 32
tests of tests/test_rllib.py (the core, PPO, PG/A2C, A3C, DQN, APEX,
IMPALA/APPO, DD-PPO, ES/ARS, MARWIL, SAC, QMIX, DDPG/TD3, MAML, Dyna and the
multi-agent and external-env samplers).

Each twin runs the reference test's own program twice (``LibTwin`` of
tests/test_torch_tune.py): as written, against the JAX package, and with
its module paths renamed to the port's, each half on a fresh local runtime
and from the same seeds of the global ``random`` and numpy's. The port's
half gets ``"device": "cpu"`` in every trainer's and policy's config from
the twin's renames: without it the port's learners run on the card. Every
call that the test's own code makes into the numpy parts of the library
(sample batches, GAE, the envs, the replay buffers, offline IO) is recorded
with its arrays, and the two records must be equal. A learning test's
rewards come from each package's own random draws (JAX's keys, torch's
generators), so its record holds none of them and the port is held to what
the reference test asserts.

Two reference tests call jax in their bodies and are written out here in
torch, and a test fails on any reference test that is neither twinned,
written out nor listed as pending (none is)."""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._tree import tree_leaves
from test_torch_tune import (ROOTS, LibTwin, _plain, consumed,
                             runtime_fixture)
from test_torch_wire_codec import JAX, PORT


def arrays(value):
    """A recorded value with each numpy array as (dtype, shape, items)."""
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.shape, value.tolist())
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {k: arrays(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(arrays(v) for v in value)
    return _plain(value)


_PATCHES = {
    "rllib.sample_batch": {
        "SampleBatch.concat_samples": arrays,
        "SampleBatch.shuffle": arrays,
        "SampleBatch.minibatches": consumed(arrays),
        "compute_gae": arrays},
    "rllib.env": {"CartPole.reset": arrays, "CartPole.step": arrays,
                  "VectorEnv.reset": arrays, "VectorEnv.step": arrays,
                  "VectorEnv.pop_episode_stats": arrays},
    "rllib.execution": {"ReplayBuffer.sample": arrays,
                        "PrioritizedReplayBuffer.sample": arrays},
    "rllib.offline": {"JsonReader.all": arrays, "JsonReader.next": arrays},
}

# The reference test's own code reaches these through names it imported
# from the package; each is forwarded at call time to the package module's
# attribute, so that a patch there records the call.
_FORWARDED = {"compute_gae": "rllib.sample_batch"}

# Reference tests whose trainers the port has not yet.
PENDING = ()
# The reference tests that call jax in their bodies, written out below.
WRITTEN_OUT = ("test_trainer_checkpoint_restore",
               "test_model_catalog_convnet_lstm_distributions")

_LOCAL_RAY = {"local_ray": {
    JAX: runtime_fixture(ray_tpu, num_cpus=8,
                         object_store_memory=256 * 1024 * 1024),
    PORT: runtime_fixture(ray_tpu_torch, num_cpus=8,
                          object_store_memory=256 * 1024 * 1024)}}

RLLIB = LibTwin("test_rllib", _PATCHES, fixtures=_LOCAL_RAY, renames=[
    # The port's learners run on the card unless a config names the CPU.
    ('"env": "StatelessBandit"', '"env": "StatelessBandit", "device": "cpu"'),
    ('config={"rollout_fragment_length":',
     'config={"device": "cpu", "rollout_fragment_length":'),
    ('cfg = {"lr": 0.02,', 'cfg = {"device": "cpu", "lr": 0.02,'),
    ('"env": "MoveToTarget"', '"env": "MoveToTarget", "device": "cpu"'),
    ('"env": "TaskBandit"', '"env": "TaskBandit", "device": "cpu"'),
    ('{"seed": 1, "lr": 5e-3,', '{"device": "cpu", "seed": 1, "lr": 5e-3,'),
    ('MARWILTrainer({"input_path":',
     'MARWILTrainer({"device": "cpu", "input_path":')])
for _pkg, _root in ROOTS.items():
    for _name, _path in _FORWARDED.items():
        _mod = RLLIB.mods[_pkg]
        _mod.__dict__[f"_{_name}_home"] = f"{_root.__name__}.{_path}"
        exec(f"def {_name}(*args, **kwargs):\n"
             f"    import importlib\n"
             f"    return getattr(importlib.import_module(_{_name}_home), "
             f"'{_name}')(*args, **kwargs)\n", _mod.__dict__)
TWINNED = RLLIB.twin_classes(globals(), skip=PENDING + WRITTEN_OUT,
                             module_class="TestRllib")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The learners' tensors are small: one intra-op thread runs them as
    fast alone, and does not stall on busy cores beside other test
    workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned_written_out_or_pending():
    import test_rllib

    ref = [n for n in vars(test_rllib) if n.startswith("test_")]
    assert len(ref) == 32 and len(TWINNED) + len(WRITTEN_OUT) == 32
    assert sorted(TWINNED + list(WRITTEN_OUT + PENDING)) == sorted(ref)


# ------------------------------------------------ written out in torch

def test_trainer_checkpoint_restore(tmp_path):
    """Twin of test_rllib.py::test_trainer_checkpoint_restore, its leaves
    compared through the port's own tree (the reference's uses jax's)."""
    from ray_tpu_torch.rllib import PPOTrainer

    ray_tpu_torch.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
    config = {"env": "StatelessBandit", "num_workers": 0,
              "num_envs_per_worker": 8, "rollout_fragment_length": 16,
              "train_batch_size": 128, "sgd_minibatch_size": 64,
              "num_sgd_iter": 4, "lr": 0.02, "hiddens": [16], "seed": 1,
              "device": "cpu"}
    t1 = PPOTrainer(config)
    for _ in range(10):
        t1.train()
    path = t1.save(str(tmp_path / "ckpt"))
    w_before = t1.get_policy().get_weights()
    t1.cleanup()

    t2 = PPOTrainer(config)
    t2.restore(path)
    w_after = t2.get_policy().get_weights()
    leaves = list(zip(tree_leaves(w_before), tree_leaves(w_after)))
    assert len(leaves) == 8   # two layers of (W, b), pi and vf
    for a, b in leaves:
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        np.testing.assert_allclose(a, b)
    t2.cleanup()


def test_model_catalog_convnet_lstm_distributions():
    """Twin of test_rllib.py::test_model_catalog_convnet_lstm_distributions
    on the port's catalog, with a torch.Generator where the reference takes
    a PRNG key."""
    from ray_tpu_torch.rllib.models import (
        Categorical, DiagGaussian, apply_convnet, apply_lstm, init_convnet,
        init_lstm,
    )

    gen = torch.Generator().manual_seed(0)
    # ConvNet: shapes flow, gradient exists
    cp, strides = init_convnet(gen, (16, 16, 3), num_outputs=5)
    imgs = torch.randn((4, 16, 16, 3), generator=gen)
    out = apply_convnet(cp, imgs, strides)
    assert out.shape == (4, 5)
    leaves = [p.requires_grad_() for p in tree_leaves(cp)]
    apply_convnet(cp, imgs, strides).sum().backward()
    assert all(p.grad is not None for p in leaves)

    # LSTM: sequence output + state carry; carrying state continues the seq
    lp = init_lstm(gen, 6, hidden=8, num_outputs=3)
    xs = torch.randn((2, 10, 6), generator=gen)
    ys, (h, c) = apply_lstm(lp, xs)
    assert ys.shape == (2, 10, 3) and h.shape == (2, 8)
    ys2, _ = apply_lstm(lp, xs[:, 5:], state=None)
    ys_cont, _ = apply_lstm(lp, xs[:, 5:],
                            state=apply_lstm(lp, xs[:, :5])[1])
    np.testing.assert_allclose(ys_cont.numpy(), ys[:, 5:].numpy(),
                               atol=1e-5)
    assert not np.allclose(ys2.numpy(), ys[:, 5:].numpy(),
                           atol=1e-5)  # state matters

    # Distributions: logp of the argmax beats a random action; entropy >= 0
    logits = torch.tensor([[2.0, 0.0, -1.0]])
    a = Categorical.sample(torch.Generator().manual_seed(1), logits)
    assert Categorical.logp(logits, torch.tensor([0])) > \
        Categorical.logp(logits, torch.tensor([2]))
    assert Categorical.entropy(logits)[0] >= 0
    assert a.shape == (1,)

    mean = torch.zeros((3, 2))
    log_std = torch.full((3, 2), -1.0)
    acts = DiagGaussian.sample(torch.Generator().manual_seed(2), mean,
                               log_std)
    assert acts.shape == (3, 2)
    assert DiagGaussian.logp(mean, log_std, mean).shape == (3,)
    # logp is maximized at the mean
    assert (DiagGaussian.logp(mean, log_std, mean)
            > DiagGaussian.logp(mean, log_std, mean + 1.0)).all()
    assert DiagGaussian.entropy(log_std).shape == (3,)
