"""Mixture-of-experts transformer (counterpart:
``ray_tpu/models/moe_transformer.py``): the flagship with every MLP block a
top-k routed MoE (``parallel/moe.py``).

Parameters keep the JAX package's keys and layout, so its weights carry
over through ``transformer.params_from_numpy``: the dense flagship's
attention weights and norms, with ``layers.moe`` = {router [L, E, N],
w_gate, w_up [L, N, E, F], w_down [L, N, F, E]} in place of the MLP.

The layer loop is the dense model's (``transformer._decoder``), with the
routed experts as its feed-forward: 1 plain and 2L residual launches of
K1 a forward, K3-K5 in each layer's attention, K2 in the loss. The
router runs in f32 on the f32 parameter; the experts cast their weights
to ``cfg.dtype`` where they are used, inside autograd.

Under a mesh (``param_shardings``), attention is split over tp as in the
dense model and the experts over the expert axis (tp by default; see
``parallel/moe.py``). The embedding stays replicated, where the dense
model splits it over tp, so the head gives whole rows of logits on every
rank. The blocks are not pipelined: over a pp axis every stage holds the
whole model.

Not re-exported from ``models`` (as in the JAX package): its names mirror
the dense model's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import Device, default_device
from ..ops.fused import softmax_cross_entropy
from ..parallel.collectives import all_reduce_mean
from ..parallel.mesh import P
from ..parallel.moe import MoEConfig, _check_expert_axis, moe_ffn
from .transformer import (TransformerConfig, _attention, _check_mesh,
                          _decoder, _positions, _seq_block, adamw_train_step,
                          unbind_layers)

Params = Any


@dataclasses.dataclass(frozen=True)
class MoETransformerConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            aux_loss_weight=self.aux_loss_weight, dtype=self.dtype,
            param_dtype=self.param_dtype)


def init_params(generator: torch.Generator, cfg: MoETransformerConfig, *,
                device: Device = None) -> Params:
    """Random parameters, N(0, 0.02) matrices and unit norms, drawn from
    ``generator`` on its own device and placed on ``device``; the JAX
    package's keys and [L, ...] stacking, the port's own draws."""
    dev = default_device(device)
    E, H, KH, Dh, F, L, N = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.n_layers,
                             cfg.n_experts)
    pd = cfg.param_dtype

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=pd)
        return (w * 0.02).to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "embed": normal(cfg.vocab_size, E),
        "layers": {
            "attn_norm": ones(L, E),
            "wq": normal(L, E, H * Dh),
            "wk": normal(L, E, KH * Dh),
            "wv": normal(L, E, KH * Dh),
            "wo": normal(L, H * Dh, E),
            "mlp_norm": ones(L, E),
            "moe": {
                "router": normal(L, E, N),
                "w_gate": normal(L, N, E, F),
                "w_up": normal(L, N, E, F),
                "w_down": normal(L, N, F, E),
            },
        },
        "final_norm": ones(E),
    }


def param_shardings(cfg: MoETransformerConfig, mesh,
                    expert_axis: str = "tp") -> Params:
    """Experts sharded over ``expert_axis``; attention over tp like the
    dense model; the embedding, norms and router replicated."""
    _check_expert_axis(mesh, expert_axis)
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(None, None),
            "moe": {
                "router": P(None, None, None),
                "w_gate": P(None, expert_axis, None, None),
                "w_up": P(None, expert_axis, None, None),
                "w_down": P(None, expert_axis, None, None),
            },
        },
        "final_norm": P(None),
    }


def forward(params: Params, tokens: torch.Tensor, cfg: MoETransformerConfig,
            mesh=None, *, expert_axis: str = "tp"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, V] in ``cfg.dtype``, the layers'
    aux losses summed in layer order, f32). Under a mesh: this rank's shard
    by ``param_shardings`` and its [B/dp, T] tokens -> its [B/dp, T/sp, V]
    logits and the global aux loss."""
    _check_mesh(mesh)
    dt = cfg.dtype
    moe = cfg.moe_cfg()
    if mesh is not None:
        tokens = _seq_block(tokens, mesh)
    embed = params["embed"].to(dt)
    x = embed[tokens]
    positions = _positions(tokens.shape[1], mesh, x.device)
    layers = [{k: (w if k == "moe" else w.to(dt)) for k, w in layer.items()}
              for layer in unbind_layers(params["layers"], cfg.n_layers)]
    auxes = []

    def ffn(y, layer):
        out, aux = moe_ffn(y, layer["moe"], moe, mesh,
                           expert_axis=expert_axis)
        auxes.append(aux)
        return out

    y = _decoder(x, layers, params["final_norm"], cfg.norm_eps,
                 lambda i, layer, y: _attention(y, layer, cfg, positions,
                                                mesh),
                 ffn)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxes:
        total = total + aux
    return y @ embed.T, total


def loss_fn(params: Params, batch: Dict[str, Any], cfg: MoETransformerConfig,
            mesh=None, *, expert_axis: str = "tp") -> torch.Tensor:
    """Next-token cross entropy (K2 on the card) averaged over B * T, plus
    the aux loss; batch = {"tokens": [B, T+1]}, moved to the parameters'
    device. Under a mesh, the rank's dp shard of the batch; the global
    mean over dp and sp plus the global aux loss (module docstring of
    ``transformer`` for the gradients)."""
    _check_mesh(mesh)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg, mesh, expert_axis=expert_axis)
    if mesh is not None:
        targets = _seq_block(targets, mesh)
    B, T, V = logits.shape
    ce = softmax_cross_entropy(logits.float().reshape(B * T, V),
                               targets.reshape(B * T)).mean()
    if mesh is not None:
        ce = all_reduce_mean(ce, mesh, ("dp", "sp"))
    return ce + aux


def make_train_step(cfg: MoETransformerConfig, mesh=None,
                    learning_rate: float = 3e-4):
    """(init_opt, train_step) as ``transformer.make_train_step``, with the
    JAX package's ``optax.adamw(learning_rate)``: weight decay 1e-4,
    optax's default (the dense flagship passes 0.01)."""
    _check_mesh(mesh)
    return adamw_train_step(
        lambda params, batch: loss_fn(params, batch, cfg, mesh),
        learning_rate, weight_decay=1e-4, mesh=mesh)
