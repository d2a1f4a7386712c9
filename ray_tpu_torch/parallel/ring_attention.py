"""Ring attention: exact attention over a sequence-sharded axis
(counterpart: ``ray_tpu/parallel/ring_attention.py``).

Each rank holds a T/S slice of Q, K and V. The K and V blocks rotate around
the ``sp`` axis (``collectives.ring_permute``) while each rank folds the
arriving block into an online-softmax accumulator, in f32, so memory a rank
stays O(T/S) in the sequence. The JAX package writes the fold as XLA
einsums, not Pallas, so no kernel runs here: plain torch ops, differentiable
by autograd (the backward rotates the gradients the other way).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF, _repeat_kv
from .collectives import all_gather, ring_permute
from .mesh import Mesh, P, shard


def _block_step(q, k, v, q_off, k_off, o, m, l, *, causal: bool,
                scale: float):
    """Fold one KV block into the online-softmax accumulator (all f32).
    Autograd keeps about 2 f32 [B, H, Tq, Tk] tensors a fold (the
    probabilities, and their rounded copy for the product with v)."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q, k.float()) * scale
    if causal:
        q_pos = q_off + torch.arange(Tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    # The running max only keeps exp() in range: the output does not depend
    # on it, so no gradient flows through it (as in FlashAttention; JAX's
    # gradients through the max cancel), and s need not be saved for it.
    m_cur = s.detach().amax(-1)                           # [B, H, Tq]
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new[..., None])                   # [B, H, Tq, Tk]
    corr = torch.exp(m - m_new)                           # [B, H, Tq]
    l_new = l * corr + p.sum(-1)
    # As the JAX package: p rounded to v's dtype, the product in f32.
    pv = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: Mesh, *,
                           axis_name: str = "sp", causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """This rank's shard: q [B, T/S, H, D], k/v [B, T/S, KH, D] at sequence
    offset ``index(axis_name) * T/S`` -> [B, T/S, H, D] in q's dtype. The
    raw KH-head K/V rotate (H/KH times less traffic than repeating first)
    and are repeated to H heads only inside the fold; S - 1 rotations, the
    last arriving block folded without a wasted final hop."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    sp, my = mesh.size(axis_name), mesh.index(axis_name)
    q32 = q.float()
    o = q32.new_zeros(B, T, H, D)
    m = q32.new_full((B, H, T), NEG_INF)
    l = q32.new_zeros(B, H, T)
    k_blk, v_blk = k, v
    for i in range(sp):
        src = (my - i) % sp                    # origin shard of this block
        o, m, l = _block_step(q32, _repeat_kv(k_blk, H), _repeat_kv(v_blk, H),
                              my * T, src * T, o, m, l, causal=causal,
                              scale=scale)
        if i < sp - 1:
            k_blk = ring_permute(k_blk, mesh, axis_name)
            v_blk = ring_permute(v_blk, mesh, axis_name)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _global(body, q, k, v, mesh: Mesh, causal: bool) -> torch.Tensor:
    """``body`` on this rank's block of the global q/k/v by
    P("dp", "sp", "tp", None), the blocks gathered back: every rank returns
    the whole output (the JAX package's global entry). Differentiable; a
    rank's gradient of the global inputs is nonzero on its own block only,
    so their sum over the mesh is the whole gradient."""
    spec = P("dp", "sp", "tp", None)
    out = body(*shard((q, k, v), spec, mesh), mesh, causal=causal)
    for dim, axis in ((2, "tp"), (1, "sp"), (0, "dp")):
        out = all_gather(out, mesh, axis, axis=dim)
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, *, causal: bool = True) -> torch.Tensor:
    """Global entry: q [B, T, H, D], k/v [B, T, KH, D], the same on every
    rank, split over (dp, sp, tp) with K/V rotating on sp."""
    return _global(ring_attention_sharded, q, k, v, mesh, causal)
