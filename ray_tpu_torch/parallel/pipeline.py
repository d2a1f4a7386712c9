"""Pipeline parallelism over the ``pp`` mesh axis (counterpart:
``ray_tpu/parallel/pipeline.py``).

A GPipe microbatch schedule. Stages are the ranks along ``pp``, each
holding its share of the stacked layers; activations hop to the next stage
by ``ring_permute``.

Schedule (S stages, M microbatches, M + S - 1 ticks):

    tick t:  stage s computes f_s on microbatch (t - s), if 0 <= t - s < M;
             then shifts its activation to stage s + 1.

The JAX package computes the bubble ticks too and masks their results out,
because a TPU program branches at a higher price than it computes. Here the
ranks run eagerly, so a stage skips its bubble ticks and sends zeros: each
stage calls ``stage_fn`` exactly M times in the forward (and backs each call
up once), whatever S. The last tick's hop, which no stage reads, is not made.

The backward runs the same schedule in reverse, by hand: every rank makes
every tick's hop (the gradients rotating the other way) in the same order,
and backs up its own ticks' ``stage_fn`` graphs between them. Collectives
inside ``stage_fn`` (tp's, sp's) run among ranks of one stage, which share
its ticks. Autograd left to itself would issue a bubble tick's hop on one
rank and not on its neighbour.
"""

from __future__ import annotations

from typing import Callable

import torch

from .._tree import tree_leaves, tree_map
from .collectives import _broadcast_raw, _permute_raw, all_reduce_grad
from .mesh import Mesh


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _schedule(stage_fn, params, microbatches, mesh, axis, record):
    """The forward ticks; with ``record``, each tick's graph is kept as
    (microbatch, input, output) for the backward. Returns the last stage's
    [M, ...] outputs, on every stage."""
    S, s = mesh.size(axis), mesh.index(axis)
    M = microbatches.shape[0]
    ticks = M + S - 1
    zeros = torch.zeros_like(microbatches[0])
    out = torch.zeros_like(microbatches)
    state, records = zeros, []
    for t in range(ticks):
        m = t - s
        send = zeros
        if 0 <= m < M:
            x = microbatches[m] if s == 0 else state
            if record:
                x = x.detach().requires_grad_()
            y = stage_fn(params, x)
            if record:
                records.append((m, x, y))
            send = y.detach()
            if s == S - 1:
                out[m] = send
        if t < ticks - 1:
            state = _permute_raw(send, mesh, axis, 1)
    return _broadcast_raw(out, mesh, axis, S - 1), records


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, mesh, axis, microbatches, *leaves):
        with torch.enable_grad():
            own = [leaf.detach().requires_grad_(leaf.requires_grad)
                   for leaf in leaves]
            out, records = _schedule(stage_fn, _unflatten(tree, own),
                                     microbatches.detach(), mesh, axis, True)
        ctx.mesh, ctx.axis, ctx.records, ctx.own = mesh, axis, records, own
        ctx.mb_shape = microbatches.shape
        return out

    @staticmethod
    def backward(ctx, g_out):
        mesh, axis, own = ctx.mesh, ctx.axis, ctx.own
        S, s = mesh.size(axis), mesh.index(axis)
        M = ctx.mb_shape[0]
        by_tick = {m + s: (m, x, y) for m, x, y in ctx.records}
        ctx.records = None
        wanted = [p for p in own if p.requires_grad]
        grads = [None] * len(wanted)
        g_mb = g_out.new_zeros(ctx.mb_shape)
        zeros = torch.zeros_like(g_mb[0])
        g_state = None      # gradient of the state received after tick t
        for t in reversed(range(M + S - 1)):
            # Tick t's hop carried `send` to stage s + 1; its gradient comes
            # back from there (the hop after the last tick was not made).
            g_send = (zeros if g_state is None
                      else _permute_raw(g_state, mesh, axis, -1))
            g_state = zeros
            if t in by_tick:
                m, x, y = by_tick[t]
                g_y = g_send + g_out[m] if s == S - 1 else g_send
                got = torch.autograd.grad(y, [x] + wanted, g_y,
                                          allow_unused=True)
                for i, g in enumerate(got[1:]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                g_x = got[0] if got[0] is not None else zeros
                if s == 0:
                    g_mb[m] = g_x
                else:
                    g_state = g_x
        it = iter(grads)
        leaf_grads = [next(it) if p.requires_grad else None for p in own]
        return (None, None, None, None, g_mb, *leaf_grads)


def gpipe_sharded(stage_fn: Callable, stage_params, microbatches:
                  torch.Tensor, mesh: Mesh, *,
                  axis_name: str = "pp") -> torch.Tensor:
    """Per-rank GPipe: ``stage_fn(stage_params, x_mb) -> y_mb`` (same shape)
    with this stage's ``stage_params``; ``microbatches`` [M, ...] is read on
    stage 0 and gives the shapes elsewhere. Returns the last stage's [M, ...]
    outputs on every stage (the JAX package's masked psum). Differentiable
    in ``microbatches`` and in every tensor of ``stage_params``: the outputs'
    consumer is replicated over the axis, so only the last stage's gradient
    of them is used."""
    if mesh.size(axis_name) == 1:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    leaves = tree_leaves(stage_params)
    if torch.is_grad_enabled() and (microbatches.requires_grad or any(
            leaf.requires_grad for leaf in leaves)):
        return _GPipe.apply(stage_fn, stage_params, mesh, axis_name,
                            microbatches, *leaves)
    return _schedule(stage_fn, stage_params, microbatches, mesh, axis_name,
                     False)[0]


def gpipe(stage_fn: Callable, params, x: torch.Tensor, mesh: Mesh, *,
          num_microbatches: int, axis_name: str = "pp") -> torch.Tensor:
    """Global entry: runs ``stage_fn(layer_params, x) -> x``, ONE layer, as a
    pipeline over ``mesh``'s ``axis_name`` with ``num_microbatches`` splits
    of the batch. ``params`` is the whole tree with a leading [L, ...] layer
    dim on every rank, L % S == 0; stage s scans layers [s L/S, (s+1) L/S),
    views of it, so a rank's gradient of a leaf is nonzero on its own
    stage's rows only (their sum over the axis is the whole gradient). ``x``
    [B, ...] is the same on every rank; the output [B, ...] too."""
    n_stage = mesh.size(axis_name)
    batch = x.shape[0]
    if batch % num_microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {num_microbatches}")
    n_layers = tree_leaves(params)[0].shape[0]
    if n_layers % n_stage != 0:
        raise ValueError(f"{n_layers} layers not divisible over "
                         f"{n_stage} stages")
    per = n_layers // n_stage
    s = mesh.index(axis_name)
    stage_params = tree_map(lambda w: w[s * per:(s + 1) * per], params)

    def stage_body(stage_params, x_mb):
        for i in range(per):
            x_mb = stage_fn(tree_map(lambda w: w[i], stage_params), x_mb)
        return x_mb

    # x is replicated over the stages and read on the first only.
    x = all_reduce_grad(x, mesh, axis_name)
    mb = x.reshape(num_microbatches, batch // num_microbatches, *x.shape[1:])
    out = gpipe_sharded(stage_body, stage_params, mb, mesh,
                        axis_name=axis_name)
    return out.reshape(batch, *x.shape[1:])
