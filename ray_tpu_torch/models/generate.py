"""KV-cache autoregressive generation for the flagship transformer
(counterpart: ``ray_tpu/models/generate.py``).

The cache is a pair of preallocated [L, B, S, KH, Dh] tensors written in
place (the JAX package threads them through ``lax.scan``); the layer loop
and the token loop are Python loops. Sampling is greedy at temperature 0,
categorical otherwise, from an explicit ``torch.Generator`` (its draws are
not the JAX package's).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import Device, default_device
from ..ops.attention import masked_gqa_attention
from .transformer import (
    Params, TransformerConfig, _decoder, _layers, _rope, to_compute,
)

KVCache = Dict[str, object]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               device: Device = None) -> KVCache:
    dev = default_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": 0,
    }


def _forward_cached(params, x, cfg, cache, start: int, positions, mask):
    """The decoder over cached KV, x [B, T, E]: each layer projects this
    chunk's K/V, writes them into its cache [B, S, KH, Dh] at ``start`` IN
    PLACE, then attends the cache under ``mask``. Returns the last
    position's logits."""
    B, T, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def attend(i, layer, h):
        ck, cv = cache["k"][i], cache["v"][i]
        q = _rope((h @ layer["wq"]).reshape(B, T, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(B, T, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(B, T, KH, Dh)
        ck[:, start:start + T] = k
        cv[:, start:start + T] = v
        attn = masked_gqa_attention(q, ck, cv, mask).reshape(B, T, H * Dh)
        return attn @ layer["wo"]

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend)
    return x[:, -1] @ params["embed"].T


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt [B, T0] through the model, filling cache[0:T0] in
    place. Returns (last-position logits [B, V], cache with length T0)."""
    params = to_compute(params, cfg)
    _, T0 = tokens.shape
    S = cache["k"].shape[2]
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(T0, device=dev)
    mask = torch.arange(S, device=dev)[None, :] <= positions[:, None]
    logits = _forward_cached(params, x, cfg, cache, 0, positions, mask)
    cache["length"] = T0
    return logits, cache


def decode_step(params: Params, token: torch.Tensor, cfg: TransformerConfig,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token [B] -> next-token logits [B, V]; the cache advances by one
    row, written in place."""
    params = to_compute(params, cfg)
    S = cache["k"].shape[2]
    pos = int(cache["length"])
    dev = token.device
    x = params["embed"][token][:, None, :]                      # [B, 1, E]
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    mask = torch.arange(S, device=dev)[None, :] <= pos          # [1, S]
    logits = _forward_cached(params, x, cfg, cache, pos, positions, mask)
    cache["length"] = pos + 1
    return logits, cache


def _pick(logits: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.inference_mode()
def generate(params: Params, prompt, cfg: TransformerConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, *,
             device: Device = None) -> torch.Tensor:
    """prompt [B, T0] int -> generated tokens [B, max_new_tokens] int32.

    The cache is sized exactly T0 + max_new_tokens. ``generator`` (on
    ``device``) drives sampling at temperature > 0."""
    dev = default_device(device)
    params = to_compute(params, cfg, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    B, T0 = prompt.shape
    cache = init_cache(cfg, B, T0 + max_new_tokens, device=dev)
    logits, cache = prefill(params, prompt, cfg, cache)
    token = _pick(logits, temperature, generator)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, token, cfg, cache)
        token = _pick(logits, temperature, generator)
        out.append(token)
    return torch.stack(out, dim=1)
