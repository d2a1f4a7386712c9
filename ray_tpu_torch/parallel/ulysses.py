"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding
(counterpart: ``ray_tpu/parallel/ulysses.py``).

Where ring attention rotates K/V blocks, Ulysses re-shards
[B, T/S, H, D] -> [B, T, H/S, D] with one all-to-all on each side of
attention, so every rank runs dense attention over the whole sequence for
its H/S heads: ``flash_attention``, kernels K3 (forward) and K4/K5
(backward) on the card. Two collectives in all, where the ring makes S - 1
hops; better while H >= S and the sequence fits. Both ride the ``sp`` axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import _repeat_kv, flash_attention
from .collectives import all_to_all
from .mesh import Mesh
from .ring_attention import _global


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh: Mesh, *,
                              axis_name: str = "sp", causal: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """This rank's sequence shard: q [B, T/S, H, D], k/v [B, T/S, KH, D] ->
    [B, T/S, H, D]. Needs H % S == 0. Where KH % S == 0 the KH heads move
    (H/KH times less traffic) and ``flash_attention`` groups the rank's
    H/S query heads over its KH/S K/V heads itself; else K/V are repeated
    to H heads first so the head split is uniform."""
    sp = mesh.size(axis_name)
    n_heads, kv_heads, D = q.shape[2], k.shape[2], q.shape[-1]
    if n_heads % sp != 0:
        raise ValueError(f"n_heads={n_heads} not divisible by sp={sp}")

    def a2a(t):  # [B, T/S, h, D] -> [B, T, h/S, D]
        return all_to_all(t, mesh, axis_name, split_axis=2, concat_axis=1)

    if kv_heads % sp != 0:
        k, v = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    q_full, k_full, v_full = a2a(q), a2a(k), a2a(v)
    if scale is not None and scale != D ** -0.5:
        # flash_attention fixes scale = D**-0.5; fold a custom scale into q.
        q_full = q_full * (scale * D ** 0.5)
    out = flash_attention(q_full, k_full, v_full, causal=causal)
    # [B, T, H/S, D] -> [B, T/S, H, D]: back to sequence sharding.
    return all_to_all(out, mesh, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, *, causal: bool = True) -> torch.Tensor:
    """Global entry: q [B, T, H, D], k/v [B, T, KH, D], the same on every
    rank, split over (dp, sp, tp) with all-to-all re-sharding on sp around
    dense attention; every rank returns the whole output."""
    return _global(ulysses_attention_sharded, q, k, v, mesh, causal)
