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
every use, and the port casts once (``to_compute``), which gives the same
numbers. The forward pass, loss and train step arrive with the training
slice; this slice holds what the serving path needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .. import Device, default_device
from ..ops.fused import rms_norm

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


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float) -> torch.Tensor:
    # Hand-written CUDA kernel on the card, plain version on the CPU.
    return rms_norm(x, weight.to(x.dtype), eps)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; rotate pairs (d, d + D/2) at ``positions`` [T],
    in f32, cast back to x's dtype."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, None].float() * freqs[None, :]          # [T, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ layer["w_gate"])
    up = x @ layer["w_up"]
    return (gate * up) @ layer["w_down"]
