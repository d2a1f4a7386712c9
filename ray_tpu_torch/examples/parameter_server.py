"""Parameter-server training, sync and async
(counterpart: ``examples/parameter_server.py``; reference:
doc/examples/parameter_server/ — the canonical Ray actor demo).

One ParameterServer actor owns the weights; worker tasks compute gradients
against the current weights and the server applies them — synchronously
(barrier per round) or asynchronously (apply-as-they-arrive). The model is
a linear regression whose gradient, mean((x @ w - y)^2)'s, is computed by
autograd on ``device`` (the card unless ``--device cpu`` is given); the
data and the weights stay numpy. The server hands out snapshots of its
weights: in one process an actor's result is the object itself, and the
reference's server hands out the array it then updates in place, so
under load a sync round's later gradients could read the round's first
updates. With snapshots the sync run is deterministic.

Run:  python -m ray_tpu_torch.examples.parameter_server [--async] [--smoke]
          [--device cpu]
"""

import argparse

import numpy as np
import torch

import ray_tpu_torch


def make_data(seed: int = 0, n: int = 512, d: int = 8):
    # One shared ground truth; each shard (seed) samples its own inputs.
    w_true = np.random.RandomState(1234).randn(d).astype(np.float32)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = x @ w_true + 0.01 * rng.randn(n).astype(np.float32)
    return x, y, w_true


def grad_fn(w, x, y, device: str) -> np.ndarray:
    """d/dw mean((x @ w - y)^2), on ``device``."""
    w = torch.tensor(np.asarray(w), device=device, requires_grad=True)
    x = torch.from_numpy(x).to(device)
    y = torch.from_numpy(y).to(device)
    loss = torch.mean((x @ w - y) ** 2)
    (g,) = torch.autograd.grad(loss, w)
    return g.cpu().numpy()


@ray_tpu_torch.remote
class ParameterServer:
    def __init__(self, dim: int, lr: float):
        self.w = np.zeros(dim, dtype=np.float32)
        self.lr = lr

    def apply_gradient(self, grad):
        self.w -= self.lr * np.asarray(grad)
        return self.w.copy()

    def get_weights(self):
        return self.w.copy()


@ray_tpu_torch.remote
def compute_grad(w, shard_seed, device):
    x, y, _ = make_data(seed=shard_seed)
    return grad_fn(w, x, y, device)


def train_sync(num_workers: int, rounds: int, device: str,
               lr: float = 0.1) -> float:
    ps = ParameterServer.remote(8, lr)
    for _ in range(rounds):
        w = ps.get_weights.remote()
        grads = [compute_grad.remote(w, s, device)
                 for s in range(num_workers)]
        for g in grads:  # barrier: all gradients of this round
            ps.apply_gradient.remote(g)
    return final_loss(ray_tpu_torch.get(ps.get_weights.remote()), device)


def train_async(num_workers: int, rounds: int, device: str,
                lr: float = 0.05) -> float:
    ps = ParameterServer.remote(8, lr)
    inflight = {compute_grad.remote(ps.get_weights.remote(), s, device): s
                for s in range(num_workers)}
    for _ in range(rounds * num_workers):
        [done], _ = ray_tpu_torch.wait(list(inflight), num_returns=1)
        shard = inflight.pop(done)
        w = ps.apply_gradient.remote(done)  # apply, no barrier
        inflight[compute_grad.remote(w, shard, device)] = shard
    return final_loss(ray_tpu_torch.get(ps.get_weights.remote()), device)


def final_loss(w, device: str) -> float:
    x, y, _ = make_data(seed=0)
    x = torch.from_numpy(x).to(device)
    y = torch.from_numpy(y).to(device)
    w = torch.tensor(np.asarray(w), device=device)
    return float(torch.mean((x @ w - y) ** 2))


def main(use_async: bool = False, smoke: bool = False, device=None) -> float:
    dev = str(ray_tpu_torch.default_device(device))
    rounds = 5 if smoke else 50
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    loss = (train_async if use_async else train_sync)(4, rounds, dev)
    mode = "async" if use_async else "sync"
    print(f"parameter server ({mode}): final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--async", dest="use_async", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args()
    try:
        main(a.use_async, a.smoke, a.device)
    finally:
        ray_tpu_torch.shutdown()
