"""The port's rllib models, losses and learners against the JAX package's,
on the CPU, on carried weights: each test builds a network or a policy in
JAX, carries its weights into the port (``set_weights`` of numpy trees, as
a checkpoint does), feeds both the same numpy-seeded inputs and compares.

Tolerance is f32 on the CPU: 1e-5 absolute and relative (``TOL``) unless a
test states and derives another. Integer outputs (greedy and epsilon-greedy
actions) are equal. PPO's update runs on JAX's own permutations, passed in
where the port draws its own from the policy's generator, and TD3's
smoothing noise is the draw JAX's update takes from its key. A JAX
``policy.pkl`` (of every trainer with one), ``marwil.pkl`` and
``flat_params.npy`` restore into the port and act as in JAX.
``get_weights()`` on another thread while a ``LearnerThread`` steps
returns only trees that the sequential updates produced."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib.agents import a3c as ja3c
from ray_tpu.rllib.agents import pg as jpg
from ray_tpu_torch._tree import tree_leaves, tree_map
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib.agents import a3c as ta3c
from ray_tpu_torch.rllib.agents import pg as tpg
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGPS, NEXT_OBS, OBS, REWARDS, SampleBatch,
    VALUE_TARGETS,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = {"device": "cpu"}


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, **tol):
    """Two trees (torch, jax or numpy leaves) leaf by leaf, in the JAX
    package's structure."""
    got = jax.tree_util.tree_leaves(tree_map(
        lambda v: v.detach().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v), got))
    want = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), **(tol or TOL))


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
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()


# ------------------------------------------------------------- the catalog

def he(rng, *shape, fan_in):
    return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def mlp_tree(rng, sizes):
    """A numpy MLP tree in the JAX package's layout, [(W, b), ...]."""
    return [(he(rng, din, dout, fan_in=din),
             rng.randn(dout).astype(np.float32) * 0.1)
            for din, dout in zip(sizes[:-1], sizes[1:])]


def test_mlp_and_flat_params_carry_across():
    rng = np.random.RandomState(0)
    host = mlp_tree(rng, [5, 16, 16, 3])
    x = rng.randn(7, 5).astype(np.float32)
    tp = tpolicy.to_device(host, torch.device("cpu"))
    close(tmodels.apply_mlp(tp, t(x)), jmodels.apply_mlp(host, x))
    # JAX's leaf order, W0, b0, W1, b1, ...: the same flat vector, and the
    # same tree back from it.
    flat = np.asarray(jmodels.flatten_params(host))
    assert np.array_equal(tmodels.flatten_params(tp).numpy(), flat)
    close(tmodels.unflatten_like(t(flat), tp),
          jmodels.unflatten_like(jnp.asarray(flat), host))
    assert tmodels.num_params(tp) == jmodels.num_params(host) == 419
    # dicts flatten by sorted key, as jax's trees do
    lstm = {"wx": np.ones((2, 4), np.float32), "wh": np.zeros((1, 4),
            np.float32), "b": np.full(4, 2.0, np.float32)}
    assert np.array_equal(
        tmodels.flatten_params(tpolicy.to_device(lstm, torch.device("cpu")))
        .numpy(), np.asarray(jmodels.flatten_params(lstm)))


@pytest.mark.parametrize("size", [16, 15], ids=["even", "odd"])
def test_convnet_carries_across(size):
    """NHWC in, HWIO weights carried as they are; XLA's SAME padding on an
    even input (one pixel after at stride 2) and an odd one."""
    filters = [(8, 4, 2), (16, 3, 2), (8, 3, 1)]
    rng = np.random.RandomState(1)
    conv, cin, hw = [], 3, size
    for cout, k, s in filters:
        conv.append((he(rng, k, k, cin, cout, fan_in=k * k * cin),
                     rng.randn(cout).astype(np.float32) * 0.1))
        cin, hw = cout, -(-hw // s)
    host = {"conv": conv, "head": mlp_tree(rng, [hw * hw * cin, 32, 5])}
    strides = tuple(s for _, _, s in filters)
    x = rng.randn(4, size, size, 3).astype(np.float32)
    tp = tpolicy.to_device(host, torch.device("cpu"))
    close(tmodels.apply_convnet(tp, t(x), strides),
          jmodels.apply_convnet(host, x, strides))
    tinit, tstrides = tmodels.init_convnet(
        torch.Generator().manual_seed(0), (size, size, 3), filters=filters,
        head_sizes=(32,), num_outputs=5)
    assert tstrides == strides
    assert [p.shape for p in tree_leaves(tinit)] == \
        [np.shape(p) for p in tree_leaves(host)]


def test_lstm_carries_across_with_and_without_state():
    rng = np.random.RandomState(2)
    host = {"wx": rng.randn(6, 32).astype(np.float32) * 0.4,
            "wh": rng.randn(8, 32).astype(np.float32) * 0.4,
            "b": rng.randn(32).astype(np.float32) * 0.1,
            "head": mlp_tree(rng, [8, 3])}
    xs = rng.randn(2, 10, 6).astype(np.float32)
    tp = tpolicy.to_device(host, torch.device("cpu"))
    jys, jstate = jmodels.apply_lstm(host, xs)
    tys, tstate = tmodels.apply_lstm(tp, t(xs))
    close(tys, jys)
    close(tstate, jstate)
    carried = jmodels.apply_lstm(host, xs[:, :5])[1]
    close(tmodels.apply_lstm(tp, t(xs[:, 5:]),
                             state=tmodels.apply_lstm(tp, t(xs[:, :5]))[1]),
          jmodels.apply_lstm(host, xs[:, 5:], state=carried))
    tinit = tmodels.init_lstm(torch.Generator().manual_seed(0), 6, 8, 3)
    assert [p.shape for p in tree_leaves(tinit)] == \
        [np.shape(p) for p in tree_leaves(host)]


def test_distributions_match():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 4).astype(np.float32) * 3
    actions = rng.randint(0, 4, size=6)
    close(tmodels.Categorical.logp(t(logits), t(actions)),
          jmodels.Categorical.logp(logits, actions))
    close(tmodels.Categorical.entropy(t(logits)),
          jmodels.Categorical.entropy(logits))
    mean, log_std = rng.randn(6, 2).astype(np.float32), \
        rng.randn(6, 2).astype(np.float32) * 0.3
    acts = rng.randn(6, 2).astype(np.float32)
    close(tmodels.DiagGaussian.logp(t(mean), t(log_std), t(acts)),
          jmodels.DiagGaussian.logp(mean, log_std, acts))
    close(tmodels.DiagGaussian.entropy(t(log_std)),
          jmodels.DiagGaussian.entropy(log_std))
    # The draws (their bits are torch's, not JAX's) follow softmax(logits):
    # 40,000 of them, each frequency within 0.01 (4.4 standard errors at
    # p = 0.5) of its probability.
    gen = torch.Generator().manual_seed(0)
    row = torch.tensor(logits[0])
    draws = tmodels.Categorical.sample(gen, row.expand(40_000, 4))
    freq = torch.bincount(draws, minlength=4).double() / 40_000
    np.testing.assert_allclose(freq.numpy(), np.asarray(
        jax.nn.softmax(logits[0])), atol=0.01)


# ------------------------------------------------------------ the learners

OBS_DIM, N_ACT = 4, 3


def ppo_batch(n: int, seed: int) -> SampleBatch:
    rng = np.random.RandomState(seed)
    return SampleBatch({
        OBS: rng.randn(n, OBS_DIM).astype(np.float32),
        ACTIONS: rng.randint(0, N_ACT, size=n),
        LOGPS: np.log(rng.uniform(0.2, 0.6, size=n)).astype(np.float32),
        ADVANTAGES: rng.randn(n).astype(np.float32),
        VALUE_TARGETS: rng.randn(n).astype(np.float32),
        REWARDS: rng.randn(n).astype(np.float32),
        DONES: (rng.rand(n) < 0.2).astype(np.float32),
        NEXT_OBS: rng.randn(n, OBS_DIM).astype(np.float32)})


def jbatch(batch, keys):
    return {k: jnp.asarray(np.asarray(batch[k]).astype(np.float32))
            for k in keys}


def tbatch(batch, keys):
    return tpolicy.batch_to(batch, keys, torch.device("cpu"))


def carried(jpol, tpol):
    """The JAX policy's weights set into the port's."""
    tpol.set_weights(jpol.get_weights())
    return tpol


def closure(jitted, name):
    """A function that a JAX policy's jitted update closes over."""
    fn = jitted.__wrapped__
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


PPO_CFG = {"hiddens": [16, 16], "lr": 0.01, "num_sgd_iter": 3,
           "sgd_minibatch_size": 16, "clip_param": 0.2,
           "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "seed": 4}


def test_ppo_loss_and_gradients_match():
    jpol = jpolicy.PPOPolicy(OBS_DIM, N_ACT, PPO_CFG)
    tpol = carried(jpol, tpolicy.PPOPolicy(OBS_DIM, N_ACT,
                                           {**PPO_CFG, **CPU}))
    batch = ppo_batch(24, seed=5)
    keys = tpol._batch_keys
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        closure(jpol._update, "loss_fn"), has_aux=True))(
            jpol.params, jbatch(batch, keys))
    tloss, tstats, tgrads = tpolicy.value_and_grad(
        tpol._loss_fn, tpol.params, tbatch(batch, keys))
    close(tloss, jloss)
    close(tstats, jstats)
    close(tgrads, jgrads)


@pytest.mark.parametrize("n", [40, 10], ids=["unused_rows", "padded"])
def test_ppo_update_matches_on_jaxs_permutations(n):
    """3 epochs of n // 16 minibatches: at n 40 the last 8 rows of each
    epoch's permutation sit it out; at n 10 the batch is tiled to one
    minibatch first, as learn_on_batch does. Parameters, Adam's moments
    and the last epoch's mean stats after 6 and 3 Adam steps."""
    jpol = jpolicy.PPOPolicy(OBS_DIM, N_ACT, PPO_CFG)
    tpol = carried(jpol, tpolicy.PPOPolicy(OBS_DIM, N_ACT,
                                           {**PPO_CFG, **CPU}))
    batch = ppo_batch(n, seed=6)
    if n < 16:
        batch = SampleBatch({k: np.tile(v, (2,) + (1,) * (v.ndim - 1))[:16]
                             for k, v in batch.items()})
    key = jax.random.PRNGKey(7)
    perms = [t(jax.random.permutation(k, batch.count))
             for k in jax.random.split(key, PPO_CFG["num_sgd_iter"])]
    keys = tpol._batch_keys
    jp, jstate, jstats = jpol._update(jpol.params, jpol.opt_state,
                                      jbatch(batch, keys), key)
    tp, tstate, tstats = tpol.update(tpol.params, tpol.opt_state,
                                     tbatch(batch, keys), perms)
    steps = PPO_CFG["num_sgd_iter"] * max(batch.count // 16, 1)
    assert int(tstate["step"]) == int(jstate[0].count) == steps
    close(tp, jp)
    close(tstate["mu"], jstate[0].mu)
    close(tstate["nu"], jstate[0].nu)
    close(tstats, jstats)


def test_ppo_learn_on_batch_pads_a_short_batch():
    """learn_on_batch on 10 rows: one minibatch of 16 a epoch (the tiled
    batch), from the policy's own generator; the stats are finite and the
    parameters moved."""
    tpol = tpolicy.PPOPolicy(OBS_DIM, N_ACT, {**PPO_CFG, **CPU})
    before = tpol.get_weights()
    stats = tpol.learn_on_batch(ppo_batch(10, seed=8))
    assert int(tpol.opt_state["step"]) == PPO_CFG["num_sgd_iter"]
    assert set(stats) == {"policy_loss", "vf_loss", "entropy"}
    assert all(np.isfinite(v) for v in stats.values())
    assert not np.array_equal(tpol.get_weights()["pi"][0][0],
                              before["pi"][0][0])


A2C_CFG = {"hiddens": [16], "lr": 0.02, "vf_loss_coeff": 0.5,
           "entropy_coeff": 0.01, "use_critic": True, "seed": 9}


@pytest.mark.parametrize("use_critic", [True, False], ids=["a2c", "pg"])
def test_a2c_loss_gradients_and_adam_step_match(use_critic):
    cfg = {**A2C_CFG, "use_critic": use_critic}
    jpol = jpg.A2CPolicy(OBS_DIM, N_ACT, cfg)
    tpol = carried(jpol, tpg.A2CPolicy(OBS_DIM, N_ACT, {**cfg, **CPU}))
    batch = ppo_batch(32, seed=10)
    keys = tpol._batch_keys
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        jpg.make_a2c_loss(0.5, 0.01, use_critic), has_aux=True))(
            jpol.params, jbatch(batch, keys))
    tloss, tstats, tgrads = tpolicy.value_and_grad(
        tpg.make_a2c_loss(0.5, 0.01, use_critic), tpol.params,
        tbatch(batch, keys))
    close(tloss, jloss)
    close(tstats, jstats)
    close(tgrads, jgrads)
    jstats_step = jpol.learn_on_batch(batch)
    tstats_step = tpol.learn_on_batch(batch)
    close(tpol.params, jpol.params)
    assert tstats_step.keys() == jstats_step.keys()
    np.testing.assert_allclose([tstats_step[k] for k in jstats_step],
                               list(jstats_step.values()), **TOL)


def test_a3c_compute_and_apply_gradients_match():
    cfg = {**A2C_CFG, "seed": 11}
    jpol = ja3c.A3CPolicy(OBS_DIM, N_ACT, cfg)
    tpol = carried(jpol, ta3c.A3CPolicy(OBS_DIM, N_ACT, {**cfg, **CPU}))
    for step in range(2):
        batch = ppo_batch(32, seed=12 + step)
        jgrads, jstats = jpol.compute_gradients(batch)
        tgrads, tstats = tpol.compute_gradients(batch)
        # numpy trees in JAX's structure, as the object store carries them
        assert jax.tree_util.tree_structure(tgrads) == \
            jax.tree_util.tree_structure(jgrads)
        close(tgrads, jgrads)
        np.testing.assert_allclose([tstats[k] for k in jstats],
                                   list(jstats.values()), **TOL)
        jpol.apply_gradients(jgrads)
        tpol.apply_gradients(jgrads)
        close(tpol.params, jpol.params)


DQN_CFG = {"hiddens": [16, 16], "lr": 0.01, "gamma": 0.9, "seed": 13,
           "epsilon_timesteps": 40, "final_epsilon": 0.1}


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "importance_weighted"])
def test_dqn_td_error_gradient_and_adam_step_match(weighted):
    """Loss, per-row |td|, the Adam step, and the gradient through Adam's
    first moment (mu = (1 - b1) g after one step)."""
    jpol = jpolicy.DQNPolicy(OBS_DIM, N_ACT, DQN_CFG)
    tpol = carried(jpol, tpolicy.DQNPolicy(OBS_DIM, N_ACT,
                                           {**DQN_CFG, **CPU}))
    # a target network that differs from the online one
    jpol.target_params = jax.tree_util.tree_map(lambda w: w * 0.9,
                                                jpol.params)
    tpol.set_weights(jpol.get_weights())
    batch = ppo_batch(32, seed=14)
    if weighted:
        batch["weights"] = np.random.RandomState(15).uniform(
            0.2, 1.0, size=32).astype(np.float32)
    jstats = jpol.learn_on_batch(batch)
    tstats = tpol.learn_on_batch(batch)
    np.testing.assert_allclose(tpol.last_td_error, jpol.last_td_error,
                               **TOL)
    np.testing.assert_allclose([tstats[k] for k in jstats],
                               list(jstats.values()), **TOL)
    close(tpol.opt_state["mu"], jpol.opt_state[0].mu)
    close(tpol.params, jpol.params)
    tpol.update_target()
    jpol.update_target()
    close(tpol.get_weights()["target"], jpol.get_weights()["target"])


def test_dqn_epsilon_greedy_actions_are_jaxs_bit_for_bit():
    jpol = jpolicy.DQNPolicy(OBS_DIM, N_ACT, DQN_CFG)
    tpol = carried(jpol, tpolicy.DQNPolicy(OBS_DIM, N_ACT,
                                           {**DQN_CFG, **CPU}))
    obs = np.random.RandomState(16).randn(8, OBS_DIM).astype(np.float32)
    runs = {}
    for name, pol in (("jax", jpol), ("port", tpol)):
        np.random.seed(17)
        runs[name] = [pol.compute_actions(obs)[0] for _ in range(8)]
        runs[name].append(pol.compute_actions(obs, explore=False)[0])
    for j, p in zip(runs["jax"], runs["port"]):
        assert j.dtype == p.dtype and np.array_equal(j, p)
    assert tpol.steps == jpol.steps == 64
    assert tpol.epsilon == jpol.epsilon


@pytest.mark.parametrize("policy", ["ppo", "a2c"])
def test_greedy_actions_and_values_match(policy):
    jcls, tcls, cfg = {
        "ppo": (jpolicy.PPOPolicy, tpolicy.PPOPolicy, PPO_CFG),
        "a2c": (jpg.A2CPolicy, tpg.A2CPolicy, A2C_CFG)}[policy]
    jpol = jcls(OBS_DIM, N_ACT, cfg)
    tpol = carried(jpol, tcls(OBS_DIM, N_ACT, {**cfg, **CPU}))
    obs = np.random.RandomState(18).randn(256, OBS_DIM).astype(np.float32)
    ja, _, _ = jpol.compute_actions(obs, explore=False)
    ta, _, _ = tpol.compute_actions(obs, explore=False)
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
    np.testing.assert_allclose(tpol.value(obs), jpol.value(obs), **TOL)
    # exploring: valid actions, and logp and value of the drawn action as
    # JAX computes them for it
    a, logp, v = tpol.compute_actions(obs, explore=True)
    assert a.dtype == np.int32 and ((0 <= a) & (a < N_ACT)).all()
    jlogp = jmodels.Categorical.logp(
        jmodels.apply_mlp(jpol.params["pi"], obs), jnp.asarray(a))
    np.testing.assert_allclose(logp, np.asarray(jlogp), **TOL)
    np.testing.assert_allclose(v, jpol.value(obs), **TOL)


# --------------------------------------------------- checkpoints carried

def test_a_jax_policy_pkl_restores_into_the_port(tmp_path):
    """A JAX PPOTrainer's checkpoint (policy.pkl of numpy trees) restores
    into the port's PPOTrainer: the same greedy actions on CartPole
    observations, values within TOL, the step counters."""
    from ray_tpu.rllib import PPOTrainer as JPPO
    from ray_tpu_torch.rllib import PPOTrainer as TPPO

    cfg = {"env": "CartPole", "num_workers": 0, "num_envs_per_worker": 4,
           "rollout_fragment_length": 32, "train_batch_size": 128,
           "sgd_minibatch_size": 64, "num_sgd_iter": 2, "hiddens": [16],
           "seed": 3}
    ray_tpu.init(num_cpus=2)
    jt = JPPO(cfg)
    for _ in range(2):
        jt.train()
    path = jt.save(str(tmp_path / "jax"))
    with open(f"{path}/policy.pkl", "rb") as f:
        assert all(isinstance(x, np.ndarray) for x in
                   jax.tree_util.tree_leaves(pickle.load(f)["weights"]))
    ray_tpu_torch.init(num_cpus=2)
    tt = TPPO({**cfg, **CPU})
    tt.restore(path)
    obs = np.random.RandomState(19).randn(128, 4).astype(np.float32) * 0.5
    jpol, tpol = jt.get_policy(), tt.get_policy()
    assert np.array_equal(tpol.compute_actions(obs, explore=False)[0],
                          jpol.compute_actions(obs, explore=False)[0])
    np.testing.assert_allclose(tpol.value(obs), jpol.value(obs), **TOL)
    assert [tt.compute_action(o) for o in obs[:16]] == \
        [jt.compute_action(o) for o in obs[:16]]
    assert (tt._steps_sampled, tt._steps_trained) == \
        (jt._steps_sampled, jt._steps_trained)
    jt.cleanup()
    tt.cleanup()


def test_a_jax_flat_params_npy_restores_into_the_port(tmp_path):
    """A JAX ESTrainer's flat_params.npy loads into the port's ESTrainer:
    the same flat vector, and the same greedy actions from it (JAX's leaf
    order W0, b0, W1, b1 is the port's)."""
    from ray_tpu.rllib.agents import es as jes
    from ray_tpu_torch.rllib.agents import es as tes

    cfg = {"env": "CartPole", "num_workers": 1, "episodes_per_batch": 4,
           "max_episode_steps": 20, "hiddens": [16]}
    ray_tpu.init(num_cpus=2)
    jt = jes.ESTrainer(cfg)
    jt.train()
    jt.save_checkpoint(str(tmp_path))
    ray_tpu_torch.init(num_cpus=2)
    tt = tes.ESTrainer({**cfg, **CPU})
    tt.load_checkpoint(str(tmp_path))
    assert tt.flat.dtype == np.float32 and np.array_equal(tt.flat, jt.flat)
    jw = jes._ESWorker("CartPole", [16], 0.05, 0)
    tw = tes._ESWorker("CartPole", [16], 0.05, 0, "cpu")
    obs = np.random.RandomState(20).randn(256, 4).astype(np.float32) * 0.5
    ja = np.asarray(jw._apply(jnp.asarray(jt.flat), jnp.asarray(obs)))
    ta = tw._apply(t(tt.flat), t(obs)).numpy()
    assert np.array_equal(ta, ja)
    assert tt._broadcast_and_eval() == jt._broadcast_and_eval()
    jt.cleanup()
    tt.cleanup()


# ------------------------------------------- snapshots under the learner

class _Learner:
    """A LearnerThread's local worker: ``learn_on_batch`` of a PPOPolicy,
    recording the host copy of every tree its updates produce."""

    def __init__(self, policy):
        self.policy = policy
        self.produced = [policy.get_weights()]
        update = policy.update

        def recording(*args):
            out = update(*args)
            self.produced.append(tpolicy.to_host(out[0]))
            return out

        policy.update = recording

    def learn_on_batch(self, batch):
        return self.policy.learn_on_batch(batch)

    def get_weights(self):
        return self.policy.get_weights()


def test_get_weights_never_sees_a_half_updated_tree():
    """While a LearnerThread runs 12 PPO updates (4 Adam steps each), the
    main thread's get_weights() snapshots are each exactly one of the trees
    the sequential updates produced, the initial one included."""
    from ray_tpu_torch.rllib import LearnerThread

    cfg = {**PPO_CFG, **CPU, "hiddens": [64, 64], "num_sgd_iter": 2,
           "sgd_minibatch_size": 32}
    worker = _Learner(tpolicy.PPOPolicy(OBS_DIM, N_ACT, cfg))
    learner = LearnerThread(worker)
    for i in range(12):
        learner.inqueue.put(ppo_batch(64, seed=100 + i))
    snaps = []
    learner.start()
    while learner.steps_trained < 12 * 64 and learner.is_alive():
        snaps.append(worker.get_weights())
    learner.stop()
    learner.join(timeout=30)
    assert learner.errors == 0 and learner.num_updates == 12
    assert len(worker.produced) == 13 and len(snaps) > 12

    def key(tree):
        return b"".join(np.ascontiguousarray(x).tobytes()
                        for x in tree_leaves(tree))

    produced = {key(tree): i for i, tree in enumerate(worker.produced)}
    seen = [produced.get(key(s)) for s in snaps]
    assert None not in seen
    assert seen == sorted(seen) and len(set(seen)) > 1


# ------------------------------------------- IMPALA's weight broadcasts (C17)

class _Ref:
    def __init__(self, batch):
        self.batch = batch


class _Remote:
    def __init__(self, fn):
        self.remote = fn


class _Sampler:
    """A rollout worker whose sample() is ready at once (a 32-row batch)
    and whose set_weights() calls are counted."""

    def __init__(self, name, calls):
        self.sample = _Remote(lambda: _Ref(SampleBatch(
            {OBS: np.zeros((32, 1), np.float32)})))
        self.set_weights = _Remote(lambda w: calls.append(name))


class _SlowLearner:
    """A learner that finishes one update for every two batches put: at
    the k-th put (from 1) it has finished floor((k - 1) / 2) updates."""

    def __init__(self):
        self.puts = self.weights_seq = 0
        self.num_updates = self.steps_trained = 0
        self.last_stats = {}
        self.inqueue = self

    def put(self, batch):
        self.puts += 1
        self.weights_seq = (self.puts - 1) // 2

    def qsize(self):
        return 0


def _broadcasts(impala, rt_name):
    """The samplers' set_weights calls over 4 train steps of 64 rows, the
    two samplers' batches landing in turns (the oldest ready ref first)."""
    calls = []
    trainer = impala.ImpalaTrainer.__new__(impala.ImpalaTrainer)
    samplers = [_Sampler("A", calls), _Sampler("B", calls)]
    trainer.raw_config = {"train_batch_size": 64, "broadcast_interval": 1}
    trainer.aggregators = []
    trainer.learner = _SlowLearner()
    trainer._steps_sampled = 0
    trainer._last_broadcast_seq = {} if rt_name == "ray_tpu_torch" else 0
    trainer.workers = type("W", (), {
        "remote_workers": lambda self: samplers,
        "local_worker": lambda self: type("L", (), {
            "get_weights": lambda self: "weights"})()})()
    trainer._inflight = {s.sample.remote(): s for s in samplers}
    stub = type("Runtime", (), {
        "wait": staticmethod(lambda refs, num_returns: (refs[:1], refs[1:])),
        "get": staticmethod(lambda ref: ref.batch),
        "put": staticmethod(lambda x: x)})
    mp = pytest.MonkeyPatch()
    mp.setattr(impala, rt_name, stub)
    try:
        for _ in range(4):
            trainer._train_step()
    finally:
        mp.undo()
    return calls


def test_impala_refreshes_every_sampler_c17():
    """C17. With two samplers whose batches land in turns and a learner
    that finishes one update for every two batches, the JAX package's one
    broadcast sequence sends every refresh to the first sampler and none
    to the second, which samples its first policy for ever (IMPALA and APPO
    on the card then plateau at the two policies' mean reward); the port
    keeps a sequence a sampler, and both are refreshed after every update."""
    from ray_tpu.rllib.agents import impala as jimpala
    from ray_tpu_torch.rllib.agents import impala as timpala

    jax_calls = _broadcasts(jimpala, "ray_tpu")
    port_calls = _broadcasts(timpala, "ray_tpu_torch")
    assert jax_calls == ["A", "A", "A"]
    assert port_calls == ["A", "B", "A", "B", "A", "B"]


# -------------------------------------------- the second part's learners

def close_leafwise(got, want, rel=TOL["rtol"]):
    """Two trees leaf by leaf within ``rel`` of each leaf's largest
    magnitude: an element of a gradient is a sum over the batch of terms
    as large as the leaf's largest, so its rounding scales with those."""
    got = jax.tree_util.tree_leaves(tree_map(
        lambda v: v.detach().numpy(), got))
    want = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def adam_close(tstate, jstate, leafwise=False):
    """The port's Adam state against optax's: the step count, both
    moments (mu is (1 - b1) g after the first step: the gradient)."""
    assert int(tstate["step"]) == int(jstate[0].count)
    check = close_leafwise if leafwise else close
    check(tstate["mu"], jstate[0].mu)
    check(tstate["nu"], jstate[0].nu)


def test_adam_matches_moments_to_parameters_by_key():
    """C19. The JAX package's trees come with sorted keys (SAC's
    ``log_alpha`` first), the port's in the order they were built: a step
    on parameters carried in from JAX takes each moment and gradient of
    the leaf with its key, as a step in the built order does."""
    gen = torch.Generator().manual_seed(0)
    built = {"pi": [(torch.randn(3, 2, generator=gen), torch.zeros(2))],
             "log_alpha": torch.tensor(-1.0)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), built)
    opt = tpolicy.Adam(0.1)
    state = opt.init(built)
    want, wstate = opt.step(built, grads, state)
    want, wstate = opt.step(want, grads, wstate)
    carried_in = {"log_alpha": built["log_alpha"], "pi": built["pi"]}
    got, gstate = opt.step(carried_in, {"pi": grads["pi"],
                                        "log_alpha": grads["log_alpha"]},
                           state)
    got, gstate = opt.step(got, grads, gstate)
    for tree_a, tree_b in ((got, want), (gstate["mu"], wstate["mu"]),
                           (gstate["nu"], wstate["nu"])):
        assert all(torch.equal(a, b) for a, b in
                   zip(tpolicy.aligned(tree_a, built),
                       tpolicy.aligned(tree_b, built)))


def stats_close(tstats, jstats):
    assert set(tstats) == set(jstats)
    np.testing.assert_allclose([float(tstats[k]) for k in jstats],
                               [float(v) for v in jstats.values()], **TOL)


OBS2, ACT2 = 3, 2


def continuous_batch(n: int, seed: int) -> SampleBatch:
    rng = np.random.RandomState(seed)
    return SampleBatch({
        OBS: rng.randn(n, OBS2).astype(np.float32),
        ACTIONS: rng.uniform(-1, 1, size=(n, ACT2)).astype(np.float32),
        REWARDS: rng.randn(n).astype(np.float32),
        DONES: (rng.rand(n) < 0.2).astype(np.float32),
        NEXT_OBS: rng.randn(n, OBS2).astype(np.float32)})


DDPG_CFG = {"hiddens": [16, 16], "lr": 0.01, "gamma": 0.9, "tau": 0.1,
            "seed": 21}
DDPG_CASES = {
    "ddpg": {},
    # the actor's update every other step: steps 1, 3, ... are skipped
    "ddpg_delayed": {"policy_delay": 2},
    # TD3 with smoothing noise wide enough that its clip bites
    "td3": {"twin_q": True, "target_noise": 0.6, "target_noise_clip": 0.3,
            "policy_delay": 2},
}


@pytest.mark.parametrize("case", DDPG_CASES)
def test_ddpg_and_td3_updates_match(case):
    """Four updates on carried weights (a target that differs from the
    online tree): both critics, the actor, one Adam step over the whole
    tree and the polyak step, against JAX's update on the same batches.
    TD3's smoothing noise is the draw JAX's update takes from its key,
    injected into the port's. On a step the delay skips, the actor's
    loss is 0 and its gradient zeros, and Adam still moves it."""
    from ray_tpu.rllib.agents import ddpg as jddpg
    from ray_tpu_torch.rllib.agents import ddpg as tddpg

    cfg = {**DDPG_CFG, **DDPG_CASES[case]}
    jpol = jddpg.DDPGPolicy(OBS2, ACT2, cfg)
    jpol.target = jax.tree_util.tree_map(lambda w: w * 0.9, jpol.params)
    tpol = carried(jpol, tddpg.DDPGPolicy(OBS2, ACT2, {**cfg, **CPU}))
    delay = cfg.get("policy_delay", 1)
    keys = tpol._batch_keys
    for step in range(4):
        batch = continuous_batch(32, seed=30 + step)
        key = jax.random.PRNGKey(40 + step)
        noise = t(jax.random.normal(key, (32, ACT2)))
        if cfg.get("target_noise"):
            assert (np.abs(cfg["target_noise"] * noise.numpy())
                    > cfg["target_noise_clip"]).any()
        actor_before = tpol.params["actor"]
        (jpol.params, jpol.target, jpol.opt_state, jpol._updates,
         jstats) = jpol._update(jpol.params, jpol.target, jpol.opt_state,
                                jpol._updates, jbatch(batch, keys), key)
        (tpol.params, tpol.target, tpol.opt_state, tpol._updates,
         tstats) = tpol.update(tpol.params, tpol.target, tpol.opt_state,
                               tpol._updates, tbatch(batch, keys), noise)
        assert tpol._updates == int(jpol._updates) == step + 1
        stats_close(tstats, jstats)
        close(tpol.params, jpol.params)
        close(tpol.target, jpol.target)
        adam_close(tpol.opt_state, jpol.opt_state)
        if step % delay:
            assert float(tstats["actor_loss"]) == 0.0
            assert all(not torch.equal(a, b) for a, b in zip(
                tree_leaves(actor_before), tree_leaves(tpol.params["actor"])))
    # learn_on_batch draws its own noise and steps the counter
    stats = tpol.learn_on_batch(continuous_batch(32, seed=50))
    assert tpol._updates == 5 and set(stats) == {"critic_loss", "actor_loss"}


def test_ddpg_actions_match():
    from ray_tpu.rllib.agents import ddpg as jddpg
    from ray_tpu_torch.rllib.agents import ddpg as tddpg

    jpol = jddpg.DDPGPolicy(OBS2, ACT2, DDPG_CFG)
    tpol = carried(jpol, tddpg.DDPGPolicy(OBS2, ACT2, {**DDPG_CFG, **CPU}))
    obs = np.random.RandomState(51).randn(64, OBS2).astype(np.float32)
    ta, _, _ = tpol.compute_actions(obs, explore=False)
    ja, _, _ = jpol.compute_actions(obs, explore=False)
    assert ta.dtype == ja.dtype == np.float32
    np.testing.assert_allclose(ta, ja, **TOL)
    # exploring: the greedy action plus N(0, 0.2) noise, kept in [-1, 1]
    te, _, _ = tpol.compute_actions(obs, explore=True)
    assert te.shape == ta.shape and (np.abs(te) <= 1.0).all()
    assert 0.1 < np.std(te - ta) < 0.3


SAC_CFG = {"hiddens": [16, 16], "lr": 0.01, "gamma": 0.9, "tau": 0.1,
           "initial_alpha": 0.3, "seed": 22}


@pytest.mark.parametrize("target_entropy", [None, 0.05],
                         ids=["default_entropy", "given_entropy"])
def test_sac_update_matches_including_log_alpha(target_entropy):
    """Three updates: the critics, the actor and the temperature in one
    Adam step (log_alpha a 0-dim leaf of the tree), the stats (alpha and
    the entropy among them) and the polyak targets, against JAX's."""
    from ray_tpu.rllib.agents import sac as jsac
    from ray_tpu_torch.rllib.agents import sac as tsac

    cfg = {**SAC_CFG, "target_entropy": target_entropy}
    jpol = jsac.SACPolicy(OBS_DIM, N_ACT, cfg)
    jpol.target = jax.tree_util.tree_map(lambda w: w * 0.9, jpol.target)
    tpol = carried(jpol, tsac.SACPolicy(OBS_DIM, N_ACT, {**cfg, **CPU}))
    assert tpol.params["log_alpha"].shape == ()
    assert tpol.target_entropy == (target_entropy
                                   or 0.98 * float(np.log(N_ACT)))
    keys = tpol._batch_keys
    for step in range(3):
        batch = ppo_batch(32, seed=60 + step)
        jpol.params, jpol.target, jpol.opt_state, jstats = jpol._update(
            jpol.params, jpol.target, jpol.opt_state, jbatch(batch, keys))
        tpol.params, tpol.target, tpol.opt_state, tstats = tpol.update(
            tpol.params, tpol.target, tpol.opt_state, tbatch(batch, keys))
        stats_close(tstats, jstats)
        close(tpol.params, jpol.params)
        close(tpol.target, jpol.target)
        adam_close(tpol.opt_state, jpol.opt_state)
    assert float(tpol.params["log_alpha"]) != float(np.log(0.3))
    obs = np.random.RandomState(63).randn(128, OBS_DIM).astype(np.float32)
    ta, _, _ = tpol.compute_actions(obs, explore=False)
    ja, _, _ = jpol.compute_actions(obs, explore=False)
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
    a, _, _ = tpol.compute_actions(obs, explore=True)
    assert a.dtype == np.int32 and ((0 <= a) & (a < N_ACT)).all()


def maml_batches(n_tasks: int, seed: int, rows: int = 32):
    rng = np.random.RandomState(seed)
    return [SampleBatch({
        OBS: rng.randn(rows, 1).astype(np.float32),
        ACTIONS: rng.randint(0, 4, size=rows),
        REWARDS: (rng.rand(rows) < 0.3).astype(np.float32),
        DONES: (rng.rand(rows) < 0.5).astype(np.float32)})
        for _ in range(n_tasks)]


MAML_CFG = {"hiddens": [16], "inner_lr": 3.0, "meta_lr": 0.03,
            "rollout_fragment_length": 8, "seed": 23}


@pytest.mark.parametrize("inner_steps", [1, 2])
def test_maml_meta_gradient_and_adapt_match(inner_steps):
    """At inner_lr 3.0 (the reference test's): ``adapt``'s weights, the
    second-order meta-gradient over 4 tasks and the meta-step's Adam
    update, against JAX's. A first-order meta-gradient (the query
    gradient at the adapted weights) misses JAX's by far more than TOL,
    so the second-order terms are what match."""
    from ray_tpu.rllib.agents import maml as jmaml
    from ray_tpu_torch.rllib.agents import maml as tmaml

    cfg = {**MAML_CFG, "inner_steps": inner_steps}
    jpol = jmaml.MAMLPolicy(1, 4, cfg)
    tpol = carried(jpol, tmaml.MAMLPolicy(1, 4, {**cfg, **CPU}))
    sups, qrys = maml_batches(4, 70), maml_batches(4, 71)
    close(tpol.adapt(sups[0]), jpol.adapt(sups[0]))

    adapt_fn = closure(jpol._meta_update, "adapt_fn")
    surrogate = closure(jpol._meta_update, "surrogate_loss")
    jsup = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[jpol._to_device(b) for b in sups])
    jqry = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[jpol._to_device(b) for b in qrys])

    def jmeta(params):
        return jnp.mean(jax.vmap(lambda s, q: surrogate(
            adapt_fn(params, s), q))(jsup, jqry))

    jloss, jgrads = jax.jit(jax.value_and_grad(jmeta))(jpol.params)
    tsup, tqry = tpol._to_device(sups), tpol._to_device(qrys)
    tloss, _, tgrads = tpolicy.value_and_grad(tpol.meta_loss, tpol.params,
                                              tsup, tqry)
    close(tloss, jloss)
    close(tgrads, jgrads)

    first = [torch.autograd.grad(
        tmaml.surrogate_loss(a, q), tree_leaves(a))
        for a, q in ((tree_map(lambda p: p.requires_grad_(True),
                               tpol.adapt_fn(tpol.params, s)), q)
                     for s, q in zip(tsup, tqry))]
    first = [sum(g[i] for g in first) / len(first)
             for i in range(len(first[0]))]
    gap = max(float(np.abs(f.numpy() - np.asarray(j)).max())
              for f, j in zip(first, jax.tree_util.tree_leaves(jgrads)))
    assert gap > 100 * TOL["atol"]

    jloss_step = jpol.meta_learn(sups, qrys)
    tloss_step = tpol.meta_learn(sups, qrys)
    np.testing.assert_allclose(tloss_step, jloss_step, **TOL)
    close(tpol.params, jpol.params)
    adam_close(tpol.opt_state, jpol.opt_state)


def test_maml_actions_match():
    from ray_tpu.rllib.agents import maml as jmaml
    from ray_tpu_torch.rllib.agents import maml as tmaml

    jpol = jmaml.MAMLPolicy(1, 4, MAML_CFG)
    tpol = carried(jpol, tmaml.MAMLPolicy(1, 4, {**MAML_CFG, **CPU}))
    obs = np.random.RandomState(72).randn(64, 1).astype(np.float32)
    ja, _, _ = jpol.compute_actions(obs, explore=False)
    ta, _, _ = tpol.compute_actions(obs, explore=False)
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
    a, logp, v = tpol.compute_actions(obs, explore=True)
    assert a.dtype == np.int32 and v.dtype == np.float32 and not v.any()
    jlogp = jmodels.Categorical.logp(jmodels.apply_mlp(jpol.params, obs),
                                     jnp.asarray(a))
    np.testing.assert_allclose(logp, np.asarray(jlogp), **TOL)


DYNA_CFG = {"model_hiddens": [16, 16], "model_lr": 0.01, "seed": 24}


def test_dyna_model_step_and_imagined_batch_match():
    """Three train steps of the dynamics model (state, reward and done
    heads; the done head's loss is the stable sigmoid cross-entropy) and
    an imagined batch from the trained model, its DONES bits thresholded
    on the host as JAX's."""
    from ray_tpu.rllib.agents import dyna as jdyna
    from ray_tpu_torch.rllib.agents import dyna as tdyna

    jm = jdyna._DynamicsModel(OBS_DIM, N_ACT, DYNA_CFG)
    tm = tdyna._DynamicsModel(OBS_DIM, N_ACT, {**DYNA_CFG, **CPU})
    tm.params = tpolicy.to_device(jax.device_get(jm.params),
                                  torch.device("cpu"))
    for step in range(3):
        batch = ppo_batch(32, seed=80 + step)
        # logits far from 0 on some rows: the cross-entropy's stable form
        batch[DONES] = (np.random.RandomState(step).rand(32) < 0.5).astype(
            np.float32)
        np.testing.assert_allclose(tm.train_on_batch(batch),
                                   jm.train_on_batch(batch), **TOL)
        close(tm.params, jm.params)
        adam_close(tm.opt_state, jm.opt_state)
    rng = np.random.RandomState(83)
    obs = rng.randn(256, OBS_DIM).astype(np.float32) * 2
    actions = rng.randint(N_ACT, size=256)
    jb, tb = jm.imagine_batch(obs, actions), tm.imagine_batch(obs, actions)
    assert set(tb) == set(jb)
    for k in (OBS, ACTIONS, REWARDS, NEXT_OBS):
        assert tb[k].dtype == np.asarray(jb[k]).dtype
        np.testing.assert_allclose(tb[k], jb[k], **TOL)
    assert tb[DONES].dtype == jb[DONES].dtype
    assert np.array_equal(tb[DONES], jb[DONES])
    assert 0 < tb[DONES].sum() < 256


QMIX_CFG = {"hiddens": [16], "mixing_embed": 8, "lr": 0.01, "gamma": 0.9,
            "seed": 25, "epsilon_timesteps": 40, "final_epsilon": 0.1}


def qmix_batch(n, n_agents, obs_dim, seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(n, n_agents, obs_dim).astype(np.float32)
    nxt = rng.randn(n, n_agents, obs_dim).astype(np.float32)
    return {"obs": obs, "state": obs.reshape(n, -1),
            "actions": rng.randint(0, 2, size=(n, n_agents)),
            "rewards": rng.randn(n).astype(np.float32),
            "next_obs": nxt, "next_state": nxt.reshape(n, -1),
            "dones": (rng.rand(n) < 0.3).astype(np.float32)}


def carried_qmix(n_agents=2, obs_dim=4):
    from ray_tpu.rllib.agents import qmix as jqmix
    from ray_tpu_torch.rllib.agents import qmix as tqmix

    cfg = dict(jqmix.QMIX_CONFIG, **QMIX_CFG)
    jpol = jqmix.QMIXPolicy(n_agents, obs_dim, 2, n_agents * obs_dim, cfg)
    tpol = tqmix.QMIXPolicy(n_agents, obs_dim, 2, n_agents * obs_dim,
                            {**cfg, **CPU})
    tpol.params = tpolicy.to_device(jax.device_get(jpol.params),
                                    torch.device("cpu"))
    tpol.target = tpolicy.to_device(jax.device_get(jpol.target),
                                    torch.device("cpu"))
    return jpol, tpol


def test_qmix_mix_and_update_match():
    """The mixer (abs'd hypernetwork weights, einsum, ELU) on random agent
    Qs and states; then four updates with a hard target sync after the
    second, against JAX's. The TD loss starts near 200, and the moments'
    elements range over three decades within a leaf: they are held
    within TOL of each leaf's largest (``close_leafwise``)."""
    jpol, tpol = carried_qmix()
    rng = np.random.RandomState(90)
    chosen = rng.randn(16, 2).astype(np.float32) * 3
    state = rng.randn(16, 8).astype(np.float32)
    jmix = closure(jpol._update, "mix")
    close(tpol.mix(tpol.params, t(chosen), t(state)),
          jmix(jpol.params, chosen, state))
    close(tpol.agent_qs(tpol.params, t(state.reshape(16, 2, 4))),
          jpol._agent_qs(jpol.params, state.reshape(16, 2, 4)))
    for step in range(4):
        batch = qmix_batch(32, 2, 4, seed=91 + step)
        jstats = jpol.learn_on_batch(batch)
        tstats = tpol.learn_on_batch(batch)
        stats_close(tstats, jstats)
        close(tpol.params, jpol.params)
        adam_close(tpol.opt_state, jpol.opt_state, leafwise=True)
        if step == 1:
            jpol.update_target()
            tpol.update_target()
            close(tpol.target, jpol.target)


def test_qmix_epsilon_greedy_actions_are_jaxs_bit_for_bit():
    jpol, tpol = carried_qmix()
    obs = np.random.RandomState(95).randn(30, 2, 4).astype(np.float32)
    runs = {}
    for name, pol in (("jax", jpol), ("port", tpol)):
        runs[name] = [pol.compute_actions(o) for o in obs]
        runs[name] += [pol.compute_actions(o, explore=False) for o in obs]
    for j, p in zip(runs["jax"], runs["port"]):
        assert j.dtype == p.dtype and np.array_equal(j, p)
    assert tpol.steps == jpol.steps == 60
    assert tpol.epsilon == jpol.epsilon


def marwil_data(tmp_path, n=300, seed=0):
    """The reference test's expert rows: arm 2 seven times in ten."""
    from ray_tpu_torch.rllib import JsonWriter

    rng = np.random.RandomState(seed)
    acts = np.array([2 if rng.rand() < 0.7 else rng.randint(4)
                     for _ in range(n)])
    w = JsonWriter(str(tmp_path))
    w.write(SampleBatch({
        OBS: rng.randn(n, 1).astype(np.float32),
        ACTIONS: acts,
        REWARDS: (acts == 2).astype(np.float32),
        DONES: (rng.rand(n) < 0.3).astype(np.float32)}))
    w.close()
    return str(tmp_path)


@pytest.mark.parametrize("beta", [1.0, 0.0], ids=["marwil", "bc"])
def test_marwil_update_and_step_match(beta, tmp_path):
    """One update's loss terms and Adam step on carried weights, then a
    step() of 3 updates on the rows both draw from their seeded
    RandomState, against JAX's."""
    from ray_tpu.rllib.agents import marwil as jmarwil
    from ray_tpu_torch.rllib.agents import marwil as tmarwil

    cfg = {"input_path": marwil_data(tmp_path), "obs_dim": 1,
           "num_actions": 4, "beta": beta, "lr": 0.01, "hiddens": [16],
           "updates_per_step": 3, "train_batch_size": 64, "seed": 26}
    jt = jmarwil.MARWILTrainer(cfg)
    tt = tmarwil.MARWILTrainer({**cfg, **CPU})
    tt.params = tpolicy.to_device(jax.device_get(jt.params),
                                  torch.device("cpu"))
    idx = np.arange(0, 300, 5)
    rows = jt._rows
    jp, jstate, jbc, jvf = jt._update(
        jt.params, jt.opt_state, jnp.asarray(rows[OBS][idx]),
        jnp.asarray(rows[ACTIONS][idx]), jnp.asarray(rows["returns"][idx]))
    tp, tstate, tstats = tt.update(tt.params, tt.opt_state, {
        k: v[t(idx)] for k, v in tt._dev_rows.items()})
    np.testing.assert_allclose([float(tstats["bc_loss"]),
                                float(tstats["vf_loss"])],
                               [float(jbc), float(jvf)], **TOL)
    close(tp, jp)
    adam_close(tstate, jstate)
    jr, tr = jt.train(), tt.train()
    assert jr["num_samples"] == tr["num_samples"] == 300
    np.testing.assert_allclose([tr["bc_loss"], tr["vf_loss"]],
                               [jr["bc_loss"], jr["vf_loss"]], **TOL)
    close(tt.params, jt.params)
    assert tt.compute_action(np.zeros(1)) == jt.compute_action(np.zeros(1))


def test_marwil_weights_use_the_population_std():
    """On 4 rows Bessel's correction would scale the normalized advantage
    by sqrt(3/4): the port's loss is JAX's (population std) and not the
    corrected one."""
    from ray_tpu_torch.rllib.agents import marwil as tmarwil

    rng = np.random.RandomState(27)
    params = {"pi": mlp_tree(rng, [1, 8, 4]), "vf": mlp_tree(rng, [1, 8, 1])}
    obs = rng.randn(4, 1).astype(np.float32)
    acts = np.array([0, 2, 2, 3])
    rets = np.array([0.0, 1.0, 1.0, 3.0], np.float32)

    def jloss(std_ddof):
        logp = jax.nn.log_softmax(jmodels.apply_mlp(params["pi"], obs))[
            jnp.arange(4), acts]
        adv = rets - jmodels.apply_mlp(params["vf"], obs)[..., 0]
        w = jnp.exp(jnp.clip((adv - adv.mean())
                             / (jnp.std(adv, ddof=std_ddof) + 1e-8), -5, 5))
        return float(-jnp.mean(w * logp))

    tp = tpolicy.to_device(params, torch.device("cpu"))
    loss, stats = tmarwil.make_marwil_loss(1.0, 0.0)(
        tp, {OBS: t(obs), ACTIONS: t(acts), "returns": t(rets)})
    np.testing.assert_allclose(float(stats["bc_loss"]), jloss(0), **TOL)
    assert abs(jloss(1) - jloss(0)) > 1e-3


# (trainer, env): a JAX trainer's policy.pkl restores into the port's.
RESTORED = {
    "ddpg": ("DDPGTrainer", "MoveToTarget"),
    "td3": ("TD3Trainer", "MoveToTarget"),
    "sac": ("SACTrainer", "StatelessBandit"),
    "maml": ("MAMLTrainer", "TaskBandit"),
    "dyna": ("DynaTrainer", "StatelessBandit"),
}


@pytest.mark.parametrize("algo", RESTORED)
def test_a_jax_policy_pkl_of_the_second_part_restores_into_the_port(
        algo, tmp_path):
    """A JAX trainer's checkpoint after 2 iterations restores into the
    port's: the same greedy actions (continuous ones within TOL), the
    target trees where the policy keeps them, the step counters."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    name, env = RESTORED[algo]
    cfg = {"env": env, "num_workers": 0, "num_envs_per_worker": 4,
           "rollout_fragment_length": 16, "learning_starts": 32,
           "train_batch_size": 32, "num_train_batches_per_step": 2,
           "meta_batch_size": 2, "hiddens": [16], "model_hiddens": [16],
           "seed": 3}
    ray_tpu.init(num_cpus=2)
    jt = getattr(jrl, name)(cfg)
    for _ in range(2):
        jt.train()
    path = jt.save(str(tmp_path / "jax"))
    ray_tpu_torch.init(num_cpus=2)
    tt = getattr(trl, name)({**cfg, **CPU})
    tt.restore(path)
    jpol, tpol = jt.get_policy(), tt.get_policy()
    dim = jt.workers.local_worker().vec_env.observation_dim
    obs = np.random.RandomState(28).randn(64, dim).astype(np.float32)
    ja = jpol.compute_actions(obs, explore=False)[0]
    ta = tpol.compute_actions(obs, explore=False)[0]
    assert ta.dtype == ja.dtype
    if algo in ("ddpg", "td3"):
        np.testing.assert_allclose(ta, ja, **TOL)
    else:
        assert np.array_equal(ta, ja)
    close(tpol.get_weights(), jpol.get_weights())
    assert (tt._steps_sampled, tt._steps_trained) == \
        (jt._steps_sampled, jt._steps_trained)
    jt.cleanup()
    tt.cleanup()


def test_a_jax_marwil_pkl_restores_into_the_port(tmp_path):
    from ray_tpu.rllib.agents import marwil as jmarwil
    from ray_tpu_torch.rllib.agents import marwil as tmarwil

    cfg = {"input_path": marwil_data(tmp_path / "data"), "obs_dim": 1,
           "num_actions": 4, "hiddens": [16], "updates_per_step": 2}
    jt = jmarwil.MARWILTrainer(cfg)
    jt.train()
    (tmp_path / "ckpt").mkdir()
    jt.save_checkpoint(str(tmp_path / "ckpt"))
    tt = tmarwil.MARWILTrainer({**cfg, **CPU})
    tt.load_checkpoint(str(tmp_path / "ckpt"))
    close(tt.params, jt.params)
    obs = np.random.RandomState(29).randn(16, 1).astype(np.float32)
    assert [tt.compute_action(o) for o in obs] == \
        [jt.compute_action(o) for o in obs]
