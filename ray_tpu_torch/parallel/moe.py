"""Mixture-of-Experts FFN (counterpart: ``ray_tpu/parallel/moe.py``): top-k
softmax gating with capacity dropping and the load-balancing auxiliary loss
(Shazeer et al.; the public Switch/GShard recipe).

The JAX package dispatches densely: a one-hot tensor ``dispatch`` [n, K, N,
C] contracted with the tokens and the experts' outputs, which keeps every
op a static-shaped matmul for XLA. Here the same values move by index. A
token's top-k experts are distinct and each kept choice owns one slot of
its expert's queue, so every (token, expert, slot) cell of the dense
``dispatch_tok`` and ``combine`` holds at most one term:

- each kept choice writes its token row into its expert slot of ``xs``
  [N, C, E] (empty slots stay zero);
- the experts run as batched products over [N, C, .];
- each token gathers its K choices' output rows, weights each by its gate
  rounded to ``cfg.dtype`` (the JAX package casts ``combine``; a dropped
  choice's gate is 0), sums the K rows in f32 and rounds once.

In the backward, a token's gradient sums its K rows, and a slot row gets
one choice's gradient plus at most a few exact zeros, so the result is the
same on every run; no index is shared by many rows, which would serialise
the backward's accumulation. Routing waits on the host nowhere. At the
flagship's training shapes (16,384 tokens, 8 experts, 5,120 slots each)
the dense route would keep ~5 GB of ``dispatch`` a layer for the router's
gradient and spend ~1.4 TFLOP a contraction; ``_moe_ffn_dense_ref`` keeps
that formula for the tests and small checks.

Under a mesh (``moe_ffn(..., mesh)``) the experts are sharded over the
expert axis (``moe_param_shardings``, "tp" by default) while the tokens are
split over dp and sp and replicated over that axis, so every expert rank
already holds its tokens and no all-to-all is needed: each rank gathers
the slots of its own experts only ([N/ep, C, E]), runs them, and combines
its experts' share of y; an all-reduce over the expert axis sums the
shares. Routing stays global, as GSPMD keeps it: the capacity counts every
token of the mesh, each choice's queue position is its place in the global
token-major order b*T + t (the [b, t, K] expert indices are all-gathered
over dp and sp, rebuilt as [B, T, K] and scanned as on one device, the
rank keeping its own slice), and the aux loss's means run over the global
tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import Device, default_device
from .collectives import (_gather_raw, _reduce_raw, all_reduce_grad,
                          all_reduce_mean, all_reduce_sum)
from .mesh import P

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int              # per-expert hidden size
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def init_moe_params(generator: torch.Generator, cfg: MoEConfig, *,
                    device: Device = None) -> Params:
    """N(0, 0.02) router [E, N] and stacked experts w_gate, w_up [N, E, F],
    w_down [N, F, E], drawn from ``generator`` on its own device and placed
    on ``device``: the JAX package's layout, the port's own draws."""
    dev = default_device(device)
    E, F_, N = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=cfg.param_dtype)
        return (w * 0.02).to(dev)

    return {
        "router": normal(E, N),
        "w_gate": normal(N, E, F_),
        "w_up": normal(N, E, F_),
        "w_down": normal(N, F_, E),
    }


def moe_param_shardings(cfg: MoEConfig, mesh, axis: str = "tp") -> Params:
    """Experts sharded over the expert-parallel axis (tp by default), the
    router replicated."""
    _check_expert_axis(mesh, axis)
    return {"router": P(None, None), "w_gate": P(axis, None, None),
            "w_up": P(axis, None, None), "w_down": P(axis, None, None)}


def _check_expert_axis(mesh, axis: str) -> None:
    if axis in ("dp", "sp") and mesh.size(axis) > 1:
        raise ValueError(
            f"experts over {axis!r}, which splits the tokens, need an "
            "all-to-all dispatch the port does not have; shard them over "
            "tp or pp")


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert, C = ceil(k * n * cf / N), at least 1."""
    return int(max(1, math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                                / cfg.n_experts)))


class Routing(NamedTuple):
    """Where each (token, k) choice goes: ``expert_idx`` [n, K] (long),
    its place in that expert's queue ``position`` [n, K] (long, token-major
    order), ``in_cap`` [n, K] (bool, position < capacity), ``gates`` [n, K]
    f32 (renormalised top-k probabilities, zero where dropped), ``probs``
    [n, N] f32, the ``capacity`` C and the auxiliary loss."""
    expert_idx: torch.Tensor
    position: torch.Tensor
    in_cap: torch.Tensor
    gates: torch.Tensor
    probs: torch.Tensor
    capacity: int
    aux: torch.Tensor


_DATA = ("dp", "sp")


def route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          mesh=None, block: Tuple[int, int] = None) -> Routing:
    """Top-k gating of ``tokens`` [n, E] in f32, as the JAX package routes:
    softmax over the router logits, top-k renormalised, the aux loss
    ``w * mean(frac_routed * mean_prob)``, and each choice's queue position
    by a cumulative sum over choices in token-major order (integers here,
    f32 counts there; equal while n * K < 2^24). Under a ``mesh`` whose dp
    or sp split the tokens, ``tokens`` is this rank's ``block`` (b, t) of
    the global [B, T] and the routing is the global one (module
    docstring): the counts and means over every token of the mesh, and
    the positions from the [B, T, K] expert indices gathered over dp and
    sp, scanned as one device would, this rank keeping its slice."""
    n = tokens.shape[0]
    N, K = cfg.n_experts, cfg.top_k
    logits = tokens.float() @ router.float()                     # [n, N]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)         # [n, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # hits[e, j]: choice j (token-major) went to expert e. Laid out [N, n*K]
    # so the cumulative sum scans N long rows; no op here waits on the host.
    flat = expert_idx.reshape(1, -1)                             # [1, n*K]
    hits = flat == torch.arange(N, device=flat.device)[:, None]  # [N, n*K]
    counts, mean_prob, n_all = hits.sum(1), probs.mean(0), n
    split = mesh is not None and mesh.size(_DATA) > 1
    if split:
        b, t = block
        n_all = n * mesh.size(_DATA)
        counts = _reduce_raw(counts, mesh, _DATA)
        mean_prob = all_reduce_mean(mean_prob, mesh, _DATA)
        # sp's blocks along T, then dp's along B.
        idx = _gather_raw(expert_idx.reshape(b, t, K), mesh, "sp", 1)
        idx = _gather_raw(idx, mesh, "dp", 0)
        flat = idx.reshape(1, -1)
        hits = flat == torch.arange(N, device=flat.device)[:, None]
    frac_routed = (counts.float() / n_all) * (N / K)
    aux = cfg.aux_loss_weight * torch.mean(frac_routed * (mean_prob * N))

    C = capacity(n_all, cfg)
    earlier = hits.cumsum(1) - hits.long()
    position = earlier.gather(0, flat)
    if split:
        i, j = mesh.index("dp"), mesh.index("sp")
        position = position.reshape(idx.shape)[i * b:(i + 1) * b,
                                               j * t:(j + 1) * t]
    position = position.reshape(n, K)
    in_cap = position < C
    gates = gate_vals * in_cap
    return Routing(expert_idx, position, in_cap, gates, probs, C, aux)


def _experts(xs: torch.Tensor, params: Params, dt: torch.dtype):
    """SwiGLU of every expert over its slots: xs [N, C, E] -> [N, C, E]."""
    gate = F.silu(torch.bmm(xs, params["w_gate"].to(dt)))
    up = torch.bmm(xs, params["w_up"].to(dt))
    return torch.bmm(gate * up, params["w_down"].to(dt))


def moe_ffn(x: torch.Tensor, params: Params, cfg: MoEConfig, mesh=None, *,
            expert_axis: str = "tp") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, E] -> (y [B, T, E] in x's dtype, aux loss f32 scalar),
    differentiable in x and every parameter. Index-form dispatch and
    combine; the values of the JAX package's dense einsums. Under a
    ``mesh``, x is this rank's [b, t, E] block (split over dp and sp) and
    ``params`` its shard by ``moe_param_shardings``; y is this rank's block
    and aux the global loss."""
    y, aux, _ = moe_ffn_routed(x, params, cfg, mesh, expert_axis=expert_axis)
    return y, aux


def moe_ffn_routed(x: torch.Tensor, params: Params, cfg: MoEConfig,
                   mesh=None, *, expert_axis: str = "tp"):
    """``moe_ffn`` that also returns its ``Routing``. Where the expert axis
    splits the experts, this rank holds experts [lo, lo + N_l) and runs
    only their slots; the tokens and gates enter that work through f
    (``all_reduce_grad``) and the shares leave through g
    (``all_reduce_sum``), so the router and the input get their whole
    gradient on every rank of the axis."""
    if mesh is not None:
        _check_expert_axis(mesh, expert_axis)
    B, T, E = x.shape
    K, dt = cfg.top_k, cfg.dtype
    tokens = x.reshape(B * T, E)
    n = tokens.shape[0]
    r = route(tokens, params["router"], cfg, mesh, (B, T))
    C = r.capacity
    N_l = params["w_gate"].shape[0]
    ep = mesh is not None and mesh.size(expert_axis) > 1
    kept, gates = r.in_cap, r.gates
    lo = 0
    if ep:
        lo = mesh.index(expert_axis) * N_l
        kept = kept & (r.expert_idx >= lo) & (r.expert_idx < lo + N_l)
        tokens = all_reduce_grad(tokens, mesh, expert_axis)
        gates = all_reduce_grad(gates, mesh, expert_axis) * kept

    # Each kept choice's slot in the flattened [N_l * C] queues. Dispatch
    # writes each choice's token row there (a dropped choice, or one of
    # another rank's experts, writes row N_l * C, past the end), so empty
    # slots stay zero and the backward gathers each choice's gradient row.
    kept = kept.reshape(-1)
    slot = ((r.expert_idx - lo) * C + r.position).reshape(-1)    # [n*K]
    rows = tokens.to(dt).repeat_interleave(K, dim=0)             # [n*K, E]
    xs = tokens.new_zeros(N_l * C + 1, E, dtype=dt).index_put(
        (torch.where(kept, slot, N_l * C),), rows)[:N_l * C]

    out = _experts(xs.reshape(N_l, C, E), params, dt).reshape(N_l * C, E)
    # Combine gathers each choice's output row. A choice not kept here,
    # whose gate is 0, reads the row of its own index (mod N_l * C) rather
    # than one shared row, so the backward adds at most a few exact zeros
    # to a row.
    spread = torch.arange(n * K, device=x.device) % (N_l * C)
    picked = out[torch.where(kept, slot, spread)].reshape(n, K, E)
    w = gates.to(dt).float()
    y = (picked.float() * w[..., None]).sum(1)
    if ep:
        y = all_reduce_sum(y, mesh, expert_axis)
    return y.to(dt).reshape(B, T, E).to(x.dtype), r.aux, r


def _route_dense_ref(tokens: torch.Tensor, router: torch.Tensor,
                     cfg: MoEConfig) -> Routing:
    """``route`` as the JAX package writes it: the aux loss's counts and
    the queue positions from an f32 one-hot [n, K, N] and its f32
    cumulative sum."""
    n = tokens.shape[0]
    N, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    one_hot_k = F.one_hot(expert_idx, N).float()                # [n, K, N]
    frac_routed = one_hot_k.sum(1).mean(0) * (N / K)
    aux = cfg.aux_loss_weight * torch.mean(frac_routed * probs.mean(0) * N)
    C = capacity(n, cfg)
    flat = one_hot_k.reshape(n * K, N)
    position = (flat.cumsum(0) - flat).reshape(n, K, N)
    position = (position * one_hot_k).sum(-1).long()
    in_cap = position < C
    return Routing(expert_idx, position, in_cap, gate_vals * in_cap, probs,
                   C, aux)


def _moe_ffn_dense_ref(x: torch.Tensor, params: Params, cfg: MoEConfig):
    """The JAX package's dense formula, transcribed: its routing
    (``_route_dense_ref``), one-hot ``dispatch`` [n, K, N, C],
    ``dispatch_tok`` and ``combine`` [n, N, C], and einsums against them.
    The plain version of ``moe_ffn_routed`` for tests and small checks;
    nothing on a main path calls it. Returns (y, aux, routing)."""
    B, T, E = x.shape
    N, dt = cfg.n_experts, cfg.dtype
    tokens = x.reshape(B * T, E)
    r = _route_dense_ref(tokens, params["router"], cfg)
    C = r.capacity
    one_hot_k = F.one_hot(r.expert_idx, N).float()              # [n, K, N]
    # jax.nn.one_hot of a position >= C is all zeros.
    slot_oh = F.one_hot(r.position.clamp(max=C), C + 1)[..., :C].float()
    dispatch = (one_hot_k[..., None] * slot_oh[:, :, None, :]
                * r.in_cap.float()[..., None, None])             # [n,K,N,C]
    dispatch_tok = dispatch.sum(1)
    combine = (dispatch * r.gates[..., None, None]).sum(1)
    xs = torch.einsum("ne,ngc->gce", tokens.to(dt), dispatch_tok.to(dt))
    out = _experts(xs, params, dt)
    y = torch.einsum("gce,ngc->ne", out, combine.to(dt))
    return y.reshape(B, T, E).to(x.dtype), r.aux, r
