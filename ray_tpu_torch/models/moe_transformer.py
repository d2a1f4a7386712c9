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

Not re-exported from ``models`` (as in the JAX package): its names mirror
the dense model's. The mesh and ``param_shardings`` come with the
parallelism slice (A7b) of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import Device, default_device
from ..ops.fused import softmax_cross_entropy
from ..parallel.moe import MoEConfig, moe_ffn
from .transformer import (TransformerConfig, _attention, _decoder,
                          _no_parallelism, adamw_train_step, unbind_layers)

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


def forward(params: Params, tokens: torch.Tensor, cfg: MoETransformerConfig,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, V] in ``cfg.dtype``, the layers'
    aux losses summed in layer order, f32)."""
    _no_parallelism(mesh)
    dt = cfg.dtype
    moe = cfg.moe_cfg()
    embed = params["embed"].to(dt)
    x = embed[tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    layers = [{k: (w if k == "moe" else w.to(dt)) for k, w in layer.items()}
              for layer in unbind_layers(params["layers"], cfg.n_layers)]
    auxes = []

    def ffn(y, layer):
        out, aux = moe_ffn(y, layer["moe"], moe)
        auxes.append(aux)
        return out

    y = _decoder(x, layers, params["final_norm"], cfg.norm_eps,
                 lambda i, layer, y: _attention(y, layer, cfg, positions),
                 ffn)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxes:
        total = total + aux
    return y @ embed.T, total


def loss_fn(params: Params, batch: Dict[str, Any], cfg: MoETransformerConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy (K2 on the card) averaged over B * T, plus
    the aux loss; batch = {"tokens": [B, T+1]}, moved to the parameters'
    device."""
    _no_parallelism(mesh)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg)
    B, T, V = logits.shape
    ce = softmax_cross_entropy(logits.float().reshape(B * T, V),
                               targets.reshape(B * T)).mean()
    return ce + aux


def make_train_step(cfg: MoETransformerConfig, mesh=None,
                    learning_rate: float = 3e-4):
    """(init_opt, train_step) as ``transformer.make_train_step``, with the
    JAX package's ``optax.adamw(learning_rate)``: weight decay 1e-4,
    optax's default (the dense flagship passes 0.01)."""
    _no_parallelism(mesh)
    return adamw_train_step(lambda params, batch: loss_fn(params, batch, cfg),
                            learning_rate, weight_decay=1e-4)
