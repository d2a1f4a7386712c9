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

Under a ``Mesh`` (``parallel.make_mesh``) each rank holds its shard of the
parameters by ``param_shardings`` (``parallel.shard``) and its dp shard of
the batch, P("dp"), whole along the sequence; the model splits the
sequence over sp itself. The layer loop is ``_decoder`` on the rank's
[b, t, E] block, the JAX package's manual-SPMD ``_block_manual``: the
vocab-parallel embedding (masked lookup, then g over tp), attention over
the rank's H/tp heads (``flash_attention`` where the sequence is whole on
the rank, ring attention over sp where it is not) and the MLP over its
d_ff/tp columns, each entering through f and leaving through g
(``parallel.collectives``). The residual add follows each all-reduce, so a
rank launches K1 as on one device. With pp > 1 the blocks run as a GPipe
pipeline (``forward_pipelined``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import Device, default_device
from .._tree import tree_map
from ..ops.attention import flash_attention
from ..ops.fused import add_rms_norm, rms_norm, softmax_cross_entropy
from ..parallel.collectives import (all_gather, all_reduce_grad,
                                    all_reduce_mean, all_reduce_sum,
                                    reduce_gradients)
from ..parallel.mesh import Mesh, P
from ..parallel.pipeline import gpipe_sharded
from ..parallel.ring_attention import ring_attention_sharded

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

    def validate_for_mesh(self, mesh: Mesh) -> None:
        tp = mesh.shape["tp"]
        assert self.n_heads % tp == 0, "n_heads must divide tp"
        assert self.n_kv_heads % tp == 0, "n_kv_heads must divide tp"
        assert self.d_ff % tp == 0 and self.vocab_size % tp == 0
        pp = mesh.shape.get("pp", 1)
        assert self.n_layers % pp == 0, "n_layers must divide pp"


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
    same [L, ...] stacking and [in, out] layout, stored in ``dtype``.
    Dicts, lists and tuples are walked (the MoE model's nested ``"moe"``
    dict, the vision model's lists of blocks)."""
    dev = default_device(device)

    def conv(node):
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return tree_map(conv, tree)


def to_compute(params: Params, cfg: TransformerConfig,
               device: Device = None) -> Params:
    """Every parameter cast to the compute dtype ``cfg.dtype`` once (the
    JAX package's ``.astype(dt)`` at each use, hoisted), on ``device``
    (default: where each already lies). Tensors already in place and in
    that dtype are returned as they are."""
    if isinstance(params, dict):
        return {k: to_compute(v, cfg, device) for k, v in params.items()}
    return params.to(device=device, dtype=cfg.dtype)


# Per-layer partition specs of the stacked [L, ...] weights: the leading
# layer dim over pp; Megatron's layout over tp (column-parallel qkv, gate
# and up, row-parallel wo and w_down).
_LAYER_PSPECS = {
    "attn_norm": P("pp", None),
    "wq": P("pp", None, "tp"),
    "wk": P("pp", None, "tp"),
    "wv": P("pp", None, "tp"),
    "wo": P("pp", "tp", None),
    "mlp_norm": P("pp", None),
    "w_gate": P("pp", None, "tp"),
    "w_up": P("pp", None, "tp"),
    "w_down": P("pp", "tp", None),
}


def param_shardings(cfg: TransformerConfig, mesh: Mesh) -> Params:
    """Megatron layout: the embedding split over tp on the vocab axis,
    attention and MLP column then row parallel over tp, layers over pp."""
    return {"embed": P("tp", None), "layers": dict(_LAYER_PSPECS),
            "final_norm": P(None)}


def decode_shardings(cfg: TransformerConfig, mesh: Mesh) -> Params:
    """Megatron layout over tp alone, for serving: the layer-stacked
    weights split over tp and whole along every other axis (a serving
    engine runs no pipeline), the embedding over tp on the vocab axis. The
    engines split their KV caches on the kv-head axis the same way."""
    tp = max(mesh.shape.get("tp", 1), 1)
    if (cfg.n_kv_heads % tp or cfg.n_heads % tp or cfg.d_ff % tp
            or cfg.vocab_size % tp):
        raise ValueError(
            f"tp ({tp}) must divide n_heads ({cfg.n_heads}), n_kv_heads "
            f"({cfg.n_kv_heads}), d_ff ({cfg.d_ff}) and vocab_size "
            f"({cfg.vocab_size}) for sharded decode")

    def strip_pp(spec: P) -> P:
        return P(*[None if axis == "pp" else axis for axis in spec])

    return {"embed": P("tp", None),
            "layers": {k: strip_pp(v) for k, v in _LAYER_PSPECS.items()},
            "final_norm": P(None)}


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
                                          torch.Tensor],
             ffn: Callable[[torch.Tensor, Params], torch.Tensor] = _mlp,
             ) -> torch.Tensor:
    """The layer loop that training, prefill and decode share (the JAX
    ``block``: h = x + attn(norm(x)); x = h + ffn(norm(h)); then the final
    norm). x is the embedded input [.., E]; layers holds each layer's
    weights in the compute dtype; ``attend(i, layer, y)`` returns layer i's
    attention output (after ``wo``) for its normed input y, and
    ``ffn(y, layer)`` its feed-forward output (the SwiGLU ``_mlp``, or the
    MoE model's routed experts). Every residual add is fused into the norm
    that follows it, so the loop is one plain RMSNorm and 2L
    ``add_rms_norm``: 2L + 1 launches of kernel K1 on the card, and no
    launch of an add. Returns the final norm's output; with ``final_norm``
    None (a pipeline stage's share of the layers), the residual stream
    after the last layer instead, whose add is then a plain one (2L - 1
    residual K1)."""
    y = _rms_norm(x, layers[0]["attn_norm"] if layers else final_norm, eps)
    for i, layer in enumerate(layers):
        h, y = _add_rms_norm(x, attend(i, layer, y), layer["mlp_norm"], eps)
        nxt = (layers[i + 1]["attn_norm"] if i + 1 < len(layers)
               else final_norm)
        if nxt is None:
            return h + ffn(y, layer)
        x, y = _add_rms_norm(h, ffn(y, layer), nxt, eps)
    return y


# ------------------------------------------------------------- training


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a ray_tpu_torch.parallel Mesh "
                        f"(parallel.make_mesh), not {type(mesh).__name__}")


def named_leaves(tree: Params, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a tree of dicts, lists and tuples by dotted name
    (``"layers.wq"``, ``"stage0.1.conv1"``), in order; any leaf type, so a
    gradient tree of numpy arrays walks the same way."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for key, val in items:
        if isinstance(val, (dict, list, tuple)):
            out.update(named_leaves(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def unbind_layers(layers: Params, n_layers: int) -> List[Params]:
    """The stacked [L, ...] layer tree (nested dicts) as L per-layer trees
    of views. Unbinding each stack once lets the backward stack each
    weight's L gradients in one op."""
    if isinstance(layers, dict):
        subs = {k: unbind_layers(v, n_layers) for k, v in layers.items()}
        return [{k: sub[i] for k, sub in subs.items()}
                for i in range(n_layers)]
    return list(layers.unbind(0))


def _attention(x: torch.Tensor, layer: Params, cfg: TransformerConfig,
               positions: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """Causal self-attention of one layer through ``flash_attention``
    (kernels K3, K4, K5 on the card); ``layer``'s weights are already in the
    compute dtype. Under a mesh with tp > 1, over this rank's H/tp heads
    (x through f, the ``wo`` partials through g); with sp > 1, as ring
    attention over the rank's sequence block at ``positions``."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    split = mesh is not None and mesh.size("tp") > 1
    H, KH = _heads(cfg, mesh)
    if split:
        x = all_reduce_grad(x, mesh, "tp")
    q = _rope((x @ layer["wq"]).reshape(B, T, H, Dh), positions,
              cfg.rope_theta)
    k = _rope((x @ layer["wk"]).reshape(B, T, KH, Dh), positions,
              cfg.rope_theta)
    v = (x @ layer["wv"]).reshape(B, T, KH, Dh)
    if mesh is not None and mesh.size("sp") > 1:
        out = ring_attention_sharded(q, k, v, mesh, causal=True)
    else:
        out = flash_attention(q, k, v, causal=True)
    out = out.reshape(B, T, H * Dh) @ layer["wo"]
    return all_reduce_sum(out, mesh, "tp") if split else out


def _mlp_tp(mesh: Mesh):
    """The MLP over this rank's d_ff/tp columns: f in, g out."""
    if mesh is None or mesh.size("tp") == 1:
        return _mlp
    return lambda y, layer: all_reduce_sum(
        _mlp(all_reduce_grad(y, mesh, "tp"), layer), mesh, "tp")


def _seq_block(tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a [b, T] tensor along the sequence (sp)."""
    sp, j = mesh.size("sp"), mesh.index("sp")
    T = tokens.shape[1]
    if T % sp:
        raise ValueError(f"sequence length {T} does not split over sp={sp}")
    t = T // sp
    return tokens[:, j * t:(j + 1) * t]


def _positions(t: int, mesh: Mesh, device) -> torch.Tensor:
    offset = mesh.index("sp") * t if mesh is not None else 0
    return offset + torch.arange(t, device=device)


def _embed(embed: torch.Tensor, tokens: torch.Tensor,
           mesh: Mesh) -> torch.Tensor:
    """The lookup of ``tokens`` in the rank's vocab rows ``embed`` [V/tp,
    E]: a token outside them gives zeros, and the sum over tp (g) gives
    every token its row."""
    if mesh is None or mesh.size("tp") == 1:
        return embed[tokens]
    V_l = embed.shape[0]
    local = tokens - mesh.index("tp") * V_l
    inside = (local >= 0) & (local < V_l)
    x = embed[local.clamp(0, V_l - 1)] * inside[..., None].to(embed.dtype)
    return all_reduce_sum(x, mesh, "tp")


def _head(y: torch.Tensor, embed: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tied head over the rank's vocab rows: logits [.., V/tp]."""
    if mesh is not None and mesh.size("tp") > 1:
        y = all_reduce_grad(y, mesh, "tp")
    return y @ embed.T


def _heads(cfg: TransformerConfig, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """The query and kv heads this rank attends over: H/tp and KH/tp."""
    tp = 1 if mesh is None else mesh.size("tp")
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


def _attn_out(attn: torch.Tensor, wo: torch.Tensor,
              mesh: Optional[Mesh]) -> torch.Tensor:
    """The attention output through ``wo``; under tp the rank's row-parallel
    partial, summed over tp."""
    out = attn @ wo
    return out if mesh is None else all_reduce_sum(out, mesh, "tp")


def _logits(y: torch.Tensor, embed: torch.Tensor,
            mesh: Optional[Mesh]) -> torch.Tensor:
    """The tied head; under tp the rank's [.., V/tp] block gathered over tp,
    so every rank holds the same full [.., V] logits."""
    out = _head(y, embed, mesh)
    return out if mesh is None else all_gather(out, mesh, "tp", axis=-1)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Mesh = None) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in ``cfg.dtype``, differentiable
    in the parameters. The layer loop walks the stacked [L, ...] tensors
    (JAX's ``scan``) and casts each weight to ``cfg.dtype`` where it is
    used, inside autograd. Under a mesh: this rank's parameter shard and
    its [B/dp, T] tokens -> its [B/dp, T/sp, V/tp] block of the logits
    (the JAX package's P("dp", "sp", "tp")); with pp > 1 the blocks run as
    a pipeline of one microbatch."""
    _check_mesh(mesh)
    if mesh is not None and mesh.size("pp") > 1:
        return forward_pipelined(params, tokens, cfg, mesh,
                                 num_microbatches=1)
    dt = cfg.dtype
    if mesh is not None:
        tokens = _seq_block(tokens, mesh)
    embed = params["embed"].to(dt)
    x = _embed(embed, tokens, mesh)                           # [B, T, E]
    positions = _positions(tokens.shape[1], mesh, x.device)
    layers = [tree_map(lambda w: w.to(dt), layer)
              for layer in unbind_layers(params["layers"], cfg.n_layers)]
    y = _decoder(x, layers, params["final_norm"], cfg.norm_eps,
                 lambda i, layer, y: _attention(y, layer, cfg, positions,
                                                mesh),
                 _mlp_tp(mesh))
    return _head(y, embed, mesh)


def forward_pipelined(params: Params, tokens: torch.Tensor,
                      cfg: TransformerConfig, mesh: Mesh, *,
                      num_microbatches: int) -> torch.Tensor:
    """``forward`` with the blocks run as a GPipe pipeline over pp
    (``parallel.gpipe_sharded``): this rank holds layers [s L/pp,
    (s+1) L/pp) of stage s. Every stage embeds its tokens; the embedded
    block enters the pipeline on stage 0 (through f over pp, so the
    embedding's gradient is whole on every stage), and the last stage's
    output comes back to every stage, which runs the final norm and the
    head. A stage's microbatch is one plain K1, 2 L/pp - 1 residual K1 and
    a plain add; K3-K5 once a layer (where sp is 1)."""
    _check_mesh(mesh)
    dt = cfg.dtype
    tokens = _seq_block(tokens, mesh)
    b, t = tokens.shape
    M = num_microbatches
    if b % M:
        raise ValueError(f"batch {b} not divisible by num_microbatches {M}")
    embed = params["embed"].to(dt)
    x = all_reduce_grad(_embed(embed, tokens, mesh), mesh, "pp")
    positions = _positions(t, mesh, x.device)
    stacked = {k: w.to(dt) for k, w in params["layers"].items()}
    mlp = _mlp_tp(mesh)

    def stage_fn(stacked, x_mb):
        layers = unbind_layers(stacked, stacked["wq"].shape[0])
        return _decoder(x_mb, layers, None, cfg.norm_eps,
                        lambda i, layer, y: _attention(y, layer, cfg,
                                                       positions, mesh),
                        mlp)

    out = gpipe_sharded(stage_fn, stacked, x.reshape(M, b // M, t, -1),
                        mesh, axis_name="pp")
    y = _rms_norm(out.reshape(b, t, -1), params["final_norm"], cfg.norm_eps)
    return _head(y, embed, mesh)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            mesh: Mesh = None, *, num_microbatches: int = 0) -> torch.Tensor:
    """Next-token cross entropy, averaged over B * T; batch =
    {"tokens": [B, T+1]} (a tensor, or anything ``torch.as_tensor`` takes,
    moved to the parameters' device). The logits are cast to f32 before
    ``softmax_cross_entropy`` (kernel K2 on the card).

    Under a mesh, the rank's dp shard of the batch ([B/dp, T+1]); the
    rank's logits block is all-gathered over tp (in ``cfg.dtype``, each
    rank's gradient its own slice) and K2 runs on whole rows of the rank's
    tokens. Returns the global mean over dp and sp, whose gradient is the
    rank's share: the train step averages the gradients over dp and sp.
    With pp > 1 the blocks run pipelined with ``num_microbatches`` splits
    (default 2 * pp)."""
    _check_mesh(mesh)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is None:
        logits = forward(params, inputs, cfg).float()
    else:
        targets = _seq_block(targets, mesh)
        pp = mesh.size("pp")
        if pp > 1:
            logits = forward_pipelined(
                params, inputs, cfg, mesh,
                num_microbatches=num_microbatches or 2 * pp)
        else:
            logits = forward(params, inputs, cfg, mesh)
        logits = all_gather(logits, mesh, "tp", axis=-1).float()
    B, T, V = logits.shape
    losses = softmax_cross_entropy(logits.reshape(B * T, V),
                                   targets.reshape(B * T))
    if mesh is None:
        return losses.mean()
    return all_reduce_mean(losses.mean(), mesh, ("dp", "sp"))


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
    The parameters' ``.grad`` hold that step's gradients afterwards.

    Under a mesh, ``params`` is the rank's shard (``param_shardings``) and
    ``batch`` its dp shard; the gradients are averaged over dp and sp
    before the update, which AdamW, being elementwise, makes on the
    shards."""
    _check_mesh(mesh)
    return adamw_train_step(
        lambda params, batch: loss_fn(params, batch, cfg, mesh,
                                      num_microbatches=num_microbatches),
        learning_rate, weight_decay=0.01, mesh=mesh)


def adamw_train_step(loss: Callable[[Params, Dict[str, Any]], torch.Tensor],
                     learning_rate: float, weight_decay: float,
                     mesh: Mesh = None):
    """(init_opt, train_step) of ``make_train_step`` for any
    ``loss(params, batch)`` and AdamW's weight decay; under a mesh the
    gradients are averaged over dp and sp before each update."""

    def init_opt(params: Params) -> torch.optim.AdamW:
        leaves = list(named_leaves(params).values())
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)

    def train_step(params: Params, opt_state: torch.optim.AdamW,
                   batch: Dict[str, Any]):
        group = opt_state.param_groups[0]["params"]
        leaves = list(named_leaves(params).values())
        if len(group) != len(leaves) or any(
                a is not b for a, b in zip(group, leaves)):
            raise ValueError("opt_state was not made by init_opt(params) for "
                             "these parameters")
        opt_state.zero_grad(set_to_none=True)
        value = loss(params, batch)
        value.backward()
        reduce_gradients(leaves, mesh)
        opt_state.step()
        return params, opt_state, value.detach()

    return init_opt, train_step
