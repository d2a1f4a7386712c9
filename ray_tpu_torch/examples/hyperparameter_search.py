"""Hyperparameter search with Tune + ASHA
(counterpart: ``examples/hyperparameter_search.py``; reference:
doc/examples/hyperparameter/ — tune.run over a training function).

Trains a tiny torch MLP on a synthetic two-blob classification task with
plain SGD (p <- p - lr * g, as optax.sgd computes it); ASHA kills
underperforming learning rates early. Each trial trains on ``device``: the
card unless ``--device cpu`` is given.

Run:  python -m ray_tpu_torch.examples.hyperparameter_search [--smoke]
          [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune.schedulers import AsyncHyperBandScheduler


def make_blobs(seed=0, n=256):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n // 2, 2).astype(np.float32) + np.array([2.0, 0.0])
    x1 = rng.randn(n // 2, 2).astype(np.float32) + np.array([-2.0, 0.0])
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.int32)
    return x, y


def draw_params():
    """The MLP's initial weights, from seed 0, on the CPU."""
    g = torch.Generator().manual_seed(0)
    return {"w1": torch.randn(2, 16, generator=g) * 0.5,
            "b1": torch.zeros(16),
            "w2": torch.randn(16, 2, generator=g) * 0.5,
            "b2": torch.zeros(2)}


def train_mlp(config):
    dev = torch.device(config["device"])
    x, y = make_blobs()
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.long, device=dev)
    params = {k: v.to(device=dev, dtype=torch.float32).requires_grad_(True)
              for k, v in draw_params().items()}
    lr = config["lr"]

    def loss_fn(p):
        h = torch.relu(x @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        return -torch.mean(
            torch.log_softmax(logits, -1)[torch.arange(len(y)), y])

    for i in range(20):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = loss.detach()
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(lr * g)
        tune.report(loss=loss.item(), training_iteration=i + 1)


def main(smoke: bool = False, device=None):
    dev = str(ray_tpu_torch.default_device(device))
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    lrs = [0.001, 0.1] if smoke else [0.0001, 0.001, 0.01, 0.1, 0.5, 1.0]
    analysis = tune.run(
        train_mlp,
        config={"lr": tune.grid_search(lrs), "device": dev},
        scheduler=AsyncHyperBandScheduler(
            metric="loss", mode="min", max_t=20, grace_period=5),
        local_dir=tempfile.mkdtemp(prefix="ray_tpu_torch_tune_"),
        verbose=0,
    )
    best = analysis.get_best_config("loss", mode="min")
    print(f"best lr: {best['lr']}  "
          f"(final loss {analysis.get_best_trial('loss', mode='min').last_result['loss']:.4f})")
    return best


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
