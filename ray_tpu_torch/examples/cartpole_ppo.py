"""PPO on CartPole with remote rollout workers
(counterpart: ``examples/cartpole_ppo.py``; reference: rllib's canonical
first example — `rllib train --run PPO --env CartPole-v0`).

The policy is a torch actor-critic on ``device`` (the card unless
``--device cpu`` is given); rollout workers are actors with vectorized
envs; the PPO epoch loop runs on the learner's device.

Run:  python -m ray_tpu_torch.examples.cartpole_ppo [--smoke] [--device cpu]
"""

import argparse

import ray_tpu_torch
from ray_tpu_torch.rllib import PPOTrainer


def main(smoke: bool = False, device=None):
    dev = str(ray_tpu_torch.default_device(device))
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    trainer = PPOTrainer({
        "env": "CartPole",
        "num_workers": 2,
        "num_envs_per_worker": 4,
        "rollout_fragment_length": 64,
        "train_batch_size": 512,
        "sgd_minibatch_size": 128,
        "num_sgd_iter": 4,
        "lr": 3e-4,
        "hiddens": [32, 32],
        "seed": 0,
        "device": dev,
    })
    iters = 3 if smoke else 30
    result = None
    for i in range(iters):
        result = trainer.train()
        if not smoke and (i + 1) % 5 == 0:
            print(f"iter {i+1}: reward_mean="
                  f"{result['episode_reward_mean']:.1f}")
    print(f"final: reward_mean={result['episode_reward_mean']:.1f} "
          f"({result['episodes_total']} episodes, "
          f"{result['timesteps_total']} steps)")
    trainer.cleanup()
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args()
    try:
        main(a.smoke, a.device)
    finally:
        ray_tpu_torch.shutdown()
