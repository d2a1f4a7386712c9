"""dp x pp x tp transformer training in one step over 8 ranks
(counterpart: ``examples/pipelined_transformer.py``; net-new over the
reference — Ray 0.9 has no model parallelism: GPipe microbatching over pp
composed with tensor parallelism over tp and data parallelism over dp).

The step is ``make_train_step`` under a ``make_mesh`` of dp2 x pp2 x sp1 x
tp2, each rank holding its ``param_shardings`` block of the weights and its
dp shard of the batch, in a gloo world of 8 rank processes
(``parallel.launch``). On one card the 8 ranks share it: any 8 devices, as
the reference says, and 8 ranks on one card are 8 such devices. With
``--device cpu`` the ranks run on the CPU.

Run:  python -m ray_tpu_torch.examples.pipelined_transformer [--smoke]
          [--device cpu]
"""

import argparse
import time

import torch

import ray_tpu_torch
from ray_tpu_torch.models import TransformerConfig, init_params

RANKS = 8
MESH = dict(dp=2, pp=2, sp=1, tp=2)
MICROBATCHES = 2
BATCH = 4
KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")


def config(smoke: bool) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256, d_model=64 if smoke else 256,
        n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=128 if smoke else 512, max_seq_len=64 if smoke else 256,
        dtype=torch.float32)


def draw(cfg: TransformerConfig):
    """The model's random weights (seed 0) and the token batch [BATCH,
    T + 1] (seed 1), on the CPU."""
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq_len + 1),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    return params, tokens


def rank_train(cfg: TransformerConfig, params, tokens, steps: int) -> dict:
    """One rank's part: its blocks of the weights and the batch on its
    device, then 1 + ``steps`` train steps. Returns each step's loss (the
    global mean, the same on every rank), wall (ending in a synchronize)
    and the rank's K3, K4, K5 launches."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models import make_train_step, param_shardings
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import MeshSpec, P, make_mesh, shard

    mesh = make_mesh(MeshSpec(**MESH))
    cfg.validate_for_mesh(mesh)
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params = tree_map(lambda t: t.to(dev),
                      shard(params, param_shardings(cfg, mesh), mesh))
    batch = {"tokens": shard(tokens, P("dp"), mesh).to(dev)}
    init_opt, train_step = make_train_step(cfg, mesh,
                                           num_microbatches=MICROBATCHES)
    opt = init_opt(params)
    losses, walls, launches = [], [], []
    for _ in range(1 + steps):
        before = [getattr(attention, k).launches for k in KERNELS]
        sync()
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, batch)
        losses.append(loss.item())
        sync()
        walls.append(time.perf_counter() - t0)
        launches.append([getattr(attention, k).launches - b
                         for k, b in zip(KERNELS, before)])
    return {"losses": losses, "walls": walls, "launches": launches}


def run(smoke: bool = False, device=None) -> dict:
    """The example's training on ``RANKS`` ranks: every rank's
    ``rank_train`` record, by rank, and the world's wall with start-up."""
    from ray_tpu_torch.parallel import launch

    dev = str(ray_tpu_torch.default_device(device))
    cfg = config(smoke)
    params, tokens = draw(cfg)
    t0 = time.perf_counter()
    ranks = launch(rank_train, RANKS, cfg, params, tokens,
                   3 if smoke else 20, device=dev, threads=1)
    return {"ranks": ranks, "wall_s": time.perf_counter() - t0,
            "tokens_per_step": BATCH * cfg.max_seq_len}


def main(smoke: bool = False, device=None):
    out = run(smoke, device)
    r0 = out["ranks"][0]
    print(f"first step: {r0['walls'][0]:.1f}s  loss={r0['losses'][0]:.4f}")
    steps, dt = len(r0["walls"]) - 1, sum(r0["walls"][1:])
    tok_s = steps * out["tokens_per_step"] / dt
    print(f"{steps} steps: {dt:.2f}s  ({tok_s:,.0f} tok/s)  "
          f"final loss={r0['losses'][-1]:.4f}")
    return float(r0["losses"][-1])


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args()
    main(a.smoke, a.device)
