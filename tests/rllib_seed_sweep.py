"""Diagnostic sweep, not a test: the seven learning tests of rllib's second
part (tests/test_rllib.py: MARWIL, SAC, QMIX, TD3, DDPG, MAML, Dyna) at
their configs, iteration caps and bars, over seeds 0-4, through the JAX
package and the port (on the CPU). Prints one line a trainer with each
package's passes out of five, and each run's final metric.

    JAX_PLATFORMS=cpu python tests/rllib_seed_sweep.py [name ...]
"""

import os
import sys
import tempfile

import numpy as np

import ray_tpu
import ray_tpu_torch

SEEDS = range(5)


def _until(trainer, key, bar, iters):
    result = None
    for _ in range(iters):
        result = trainer.train()
        if result[key] >= bar:
            break
    return result


def sac(rl, seed, extra):
    t = rl.SACTrainer({"env": "StatelessBandit", "num_workers": 0,
                       "num_envs_per_worker": 4, "rollout_fragment_length": 8,
                       "train_batch_size": 32, "learning_starts": 64,
                       "num_train_batches_per_step": 8, "lr": 0.01,
                       "target_entropy": 0.05, "hiddens": [16], "seed": seed,
                       **extra})
    r = _until(t, "episode_reward_mean", 0.8, 40)
    t.cleanup()
    return r["episode_reward_mean"] >= 0.8, r["episode_reward_mean"]


def dyna(rl, seed, extra):
    t = rl.DynaTrainer({"env": "StatelessBandit", "num_workers": 0,
                        "num_envs_per_worker": 4, "rollout_fragment_length": 8,
                        "train_batch_size": 32, "learning_starts": 64,
                        "num_train_batches_per_step": 2,
                        "imagined_batches_per_step": 6,
                        "model_train_batches_per_step": 6,
                        "epsilon_timesteps": 300, "final_epsilon": 0.02,
                        "lr": 0.01, "model_lr": 0.01, "hiddens": [16],
                        "model_hiddens": [16], "seed": seed, **extra})
    r = _until(t, "episode_reward_mean", 0.8, 50)
    t.cleanup()
    ok = r["episode_reward_mean"] >= 0.8 and r["model_loss"] < 0.15
    return ok, r["episode_reward_mean"]


def _continuous(cls, bar):
    def run(rl, seed, extra):
        t = getattr(rl, cls)({"env": "MoveToTarget", "num_workers": 0,
                              "num_envs_per_worker": 8,
                              "rollout_fragment_length": 4,
                              "train_batch_size": 64, "learning_starts": 128,
                              "num_train_batches_per_step": 16, "lr": 3e-3,
                              "exploration_noise": 0.15, "hiddens": [32, 32],
                              "seed": seed, **extra})
        r = _until(t, "episode_reward_mean", bar, 70)
        t.cleanup()
        return r["episode_reward_mean"] >= bar, r["episode_reward_mean"]
    return run


def maml(rl, seed, extra):
    t = rl.MAMLTrainer({"env": "TaskBandit", "num_workers": 0,
                        "num_envs_per_worker": 8, "rollout_fragment_length": 8,
                        "meta_batch_size": 8, "inner_lr": 3.0,
                        "meta_lr": 0.03, "hiddens": [16], "seed": seed,
                        **extra})
    r = _until(t, "post_adapt_reward_mean", 0.6, 50)
    t.cleanup()
    post, pre = r["post_adapt_reward_mean"], r["pre_adapt_reward_mean"]
    return post >= 0.6 and post - pre >= 0.2, post


def qmix(rl, seed, extra):
    t = rl.QMIXTrainer("TwoStepGame", {
        "seed": seed, "lr": 5e-3, "episodes_per_step": 8,
        "epsilon_timesteps": 800, "final_epsilon": 0.02,
        "learning_starts": 64, "num_train_batches_per_step": 4,
        "target_update_freq": 5, "hiddens": [32], "mixing_embed": 8,
        **extra})
    r = _until(t, "episode_reward_mean", 15.0, 80)
    t.stop()
    return r["episode_reward_mean"] >= 15.0, r["episode_reward_mean"]


def marwil(rl, seed, extra):
    rng = np.random.RandomState(0)
    obs, acts, rews = [], [], []
    for _ in range(300):
        a = 2 if rng.rand() < 0.7 else rng.randint(4)
        obs.append([0.0])
        acts.append(a)
        rews.append(1.0 if a == 2 else 0.0)
    with tempfile.TemporaryDirectory() as d:
        w = rl.JsonWriter(d)
        w.write(rl.SampleBatch({
            "obs": np.asarray(obs, dtype=np.float32),
            "actions": np.asarray(acts),
            "rewards": np.asarray(rews, dtype=np.float32),
            "dones": np.ones(300, np.float32)}))
        w.close()
        t = rl.MARWILTrainer({"input_path": d, "obs_dim": 1,
                              "num_actions": 4, "beta": 1.0, "lr": 0.01,
                              "hiddens": [16], "updates_per_step": 20,
                              "seed": seed, **extra})
        for _ in range(15):
            r = t.train()
    ok = t.compute_action(np.zeros(1)) == 2 and r["bc_loss"] < 2.0
    return ok, r["bc_loss"]


RUNS = {"MARWIL": marwil, "SAC": sac, "QMIX": qmix,
        "TD3": _continuous("TD3Trainer", -0.15),
        "DDPG": _continuous("DDPGTrainer", -0.18), "MAML": maml,
        "Dyna": dyna}


def main(names) -> int:
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ray_tpu.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
    ray_tpu_torch.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
    try:
        for name in names or RUNS:
            line = [f"{name:6s}"]
            for pkg, rl, extra in (("jax", jrl, {}),
                                   ("port", trl, {"device": "cpu"})):
                got = [RUNS[name](rl, seed, extra) for seed in SEEDS]
                line.append(f"{pkg} {sum(ok for ok, _ in got)}/5 ("
                            + ", ".join(f"{v:.3f}" for _, v in got) + ")")
            print("  ".join(line), flush=True)
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
