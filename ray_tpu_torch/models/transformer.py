"""Flagship decoder-only transformer (counterpart:
``ray_tpu/models/transformer.py``): RMSNorm, RoPE, SwiGLU, GQA.

Parameters are a plain dict of tensors with the JAX package's layout, so
the JAX weights carry over unchanged (``params_from_numpy``):

  embed       [V, E]            tied LM head: logits = x @ embed.T
  layers.*    [L, ...]          stacked on a leading layer axis
              attn_norm, mlp_norm [L, E]; wq [L, E, H*Dh]; wk, wv
              [L, E, KH*Dh]; wo [L, H*Dh, E]; w_gate, w_up [L, E, F];
              w_down [L, F, E]
  final_norm  [E]

Matrices are kept [in, out] and applied as ``x @ w`` (not transposed to
``nn.Linear``'s [out, in]). Parameters are stored in ``param_dtype`` (f32);
the JAX package casts each weight to the compute dtype ``cfg.dtype`` at
every use. Serving casts once (``to_compute``), which gives the same
numbers; training (``forward``, ``loss_fn``, ``make_train_step``) casts
inside autograd, so the gradients reach the f32 parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from .. import Device, default_device
from ..ops.attention import flash_attention
from ..ops.fused import add_rms_norm, rms_norm, softmax_cross_entropy

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16     # activation/weight compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(generator: torch.Generator, cfg: TransformerConfig, *,
                device: Device = None) -> Params:
    """Random parameters, N(0, 0.02) matrices and unit norms, drawn from
    ``generator`` on its own device and placed on ``device``. The draws
    are the port's own, not the JAX package's."""
    dev = default_device(device)
    E, H, KH, Dh, F, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.n_layers)
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
            "w_gate": normal(L, E, F),
            "w_up": normal(L, E, F),
            "w_down": normal(L, F, E),
        },
        "final_norm": ones(E),
    }


def params_from_numpy(tree: Params, *, device: Device = None,
                      dtype: torch.dtype = torch.float32) -> Params:
    """The JAX package's parameter pytree, given as numpy arrays (or
    anything ``np.asarray`` takes), as the port's parameters: same keys,
    same [L, ...] stacking and [in, out] layout, stored in ``dtype``."""
    dev = default_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return conv(tree)


def to_compute(params: Params, cfg: TransformerConfig,
               device: Device = None) -> Params:
    """Every parameter cast to the compute dtype ``cfg.dtype`` once (the
    JAX package's ``.astype(dt)`` at each use, hoisted), on ``device``
    (default: where each already lies). Tensors already in place and in
    that dtype are returned as they are."""
    if isinstance(params, dict):
        return {k: to_compute(v, cfg, device) for k, v in params.items()}
    return params.to(device=device, dtype=cfg.dtype)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights: views into the stacked [L, ...] tensors."""
    return {k: v[i] for k, v in params["layers"].items()}


def _layers(params: Params, cfg: TransformerConfig) -> List[Params]:
    """Every layer's weights, in order (``layer_params`` of each)."""
    return [layer_params(params, i) for i in range(cfg.n_layers)]


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float) -> torch.Tensor:
    # Hand-written CUDA kernel on the card, plain version on the CPU.
    return rms_norm(x, weight.to(x.dtype), eps)


def _add_rms_norm(x: torch.Tensor, a: torch.Tensor, weight: torch.Tensor,
                  eps: float):
    # (x + a, its norm) in one launch of the same kernel on the card.
    return add_rms_norm(x, a, weight.to(x.dtype), eps)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; rotate pairs (d, d + D/2) at ``positions`` [T]
    (shared by the batch) or [B, T] (per sequence: a speculative verify
    chunk starts at each slot's own length), in f32, cast back to x's
    dtype. The angles broadcast over the batch, so one launch serves every
    slot, with the per-element f32 math of the JAX package's vmap."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs     # [(B,) T, half]
    cos = torch.cos(angles).unsqueeze(-2)             # [(B,) T, 1, half]
    sin = torch.sin(angles).unsqueeze(-2)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ layer["w_gate"])
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]


def _decoder(x: torch.Tensor, layers: List[Params], final_norm: torch.Tensor,
             eps: float, attend: Callable[[int, Params, torch.Tensor],
                                          torch.Tensor]) -> torch.Tensor:
    """The layer loop that training, prefill and decode share (the JAX
    ``block``: h = x + attn(norm(x)); x = h + mlp(norm(h)); then the final
    norm). x is the embedded input [.., E]; layers holds each layer's
    weights in the compute dtype; ``attend(i, layer, y)`` returns layer i's
    attention output (after ``wo``) for its normed input y. Every residual
    add is fused into the norm that follows it, so the loop is one plain
    RMSNorm and 2L ``add_rms_norm``: 2L + 1 launches of kernel K1 on the
    card, and no launch of an add. Returns the final norm's output."""
    y = _rms_norm(x, layers[0]["attn_norm"] if layers else final_norm, eps)
    for i, layer in enumerate(layers):
        h, y = _add_rms_norm(x, attend(i, layer, y), layer["mlp_norm"], eps)
        nxt = (layers[i + 1]["attn_norm"] if i + 1 < len(layers)
               else final_norm)
        x, y = _add_rms_norm(h, _mlp(y, layer), nxt, eps)
    return y


# ------------------------------------------------------------- training


def _no_parallelism(mesh, num_microbatches: int = 0) -> None:
    if mesh is not None or num_microbatches > 0:
        raise NotImplementedError(
            "a mesh and pipelined microbatches are not ported yet; they come "
            "with the parallelism slice of ROADMAP.md")


def named_leaves(tree: Params, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a nested dict by dotted name (``"layers.wq"``), in the
    dict's order; any leaf type, so a gradient tree of numpy arrays walks
    the same way."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(named_leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _attention(x: torch.Tensor, layer: Params, cfg: TransformerConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of one layer through ``flash_attention``
    (kernels K3, K4, K5 on the card); ``layer``'s weights are already in the
    compute dtype."""
    B, T, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _rope((x @ layer["wq"]).reshape(B, T, H, Dh), positions,
              cfg.rope_theta)
    k = _rope((x @ layer["wk"]).reshape(B, T, KH, Dh), positions,
              cfg.rope_theta)
    v = (x @ layer["wv"]).reshape(B, T, KH, Dh)
    out = flash_attention(q, k, v, causal=True)
    return out.reshape(B, T, H * Dh) @ layer["wo"]


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in ``cfg.dtype``, differentiable
    in the parameters. The layer loop walks the stacked [L, ...] tensors
    (JAX's ``scan``) and casts each weight to ``cfg.dtype`` where it is
    used, inside autograd."""
    _no_parallelism(mesh)
    dt = cfg.dtype
    T = tokens.shape[1]
    embed = params["embed"].to(dt)
    x = embed[tokens]                                         # [B, T, E]
    positions = torch.arange(T, device=x.device)
    names = list(params["layers"])
    # unbind: the backward stacks each weight's L gradients in one op.
    stacks = [params["layers"][k].unbind(0) for k in names]
    layers = [{k: w.to(dt) for k, w in zip(names, weights)}
              for weights in zip(*stacks)]
    y = _decoder(x, layers, params["final_norm"], cfg.norm_eps,
                 lambda i, layer, y: _attention(y, layer, cfg, positions))
    return y @ embed.T


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            mesh=None, *, num_microbatches: int = 0) -> torch.Tensor:
    """Next-token cross entropy, averaged over B * T; batch =
    {"tokens": [B, T+1]} (a tensor, or anything ``torch.as_tensor`` takes,
    moved to the parameters' device). The logits are cast to f32 before
    ``softmax_cross_entropy`` (kernel K2 on the card)."""
    _no_parallelism(mesh, num_microbatches)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = forward(params, inputs, cfg).float()
    B, T, V = logits.shape
    losses = softmax_cross_entropy(logits.reshape(B * T, V),
                                   targets.reshape(B * T))
    return losses.mean()


def make_train_step(cfg: TransformerConfig, mesh=None,
                    learning_rate: float = 3e-4, num_microbatches: int = 0):
    """Returns (init_opt, train_step), the JAX package's contract:
    ``opt_state = init_opt(params)`` and ``params, opt_state, loss =
    train_step(params, opt_state, batch)``. The optimizer is
    ``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=0.01)`` over every parameter, optax's
    ``adamw(lr, weight_decay=0.01)``. ``init_opt`` marks the parameters as
    requiring grad; ``train_step`` updates them in place and returns the
    same dict, the optimizer, and the loss before the update (detached).
    The parameters' ``.grad`` hold that step's gradients afterwards."""
    _no_parallelism(mesh, num_microbatches)

    def init_opt(params: Params) -> torch.optim.AdamW:
        leaves = list(named_leaves(params).values())
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)

    def train_step(params: Params, opt_state: torch.optim.AdamW,
                   batch: Dict[str, Any]):
        group = opt_state.param_groups[0]["params"]
        leaves = list(named_leaves(params).values())
        if len(group) != len(leaves) or any(
                a is not b for a, b in zip(group, leaves)):
            raise ValueError("opt_state was not made by init_opt(params) for "
                             "these parameters")
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_opt, train_step
