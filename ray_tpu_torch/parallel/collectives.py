"""Named collectives over a mesh axis (counterpart:
``ray_tpu/parallel/collectives.py``).

Each function takes the tensor, the ``Mesh`` and the axis name (or a tuple
of names) explicitly; an axis of size 1 costs nothing. They run on this
rank's shard, the JAX package's ``shard_map`` bodies. Where gradients cross
a collective, its backward is the JAX package's transpose as it shows from
outside a ``shard_map``, under one of two readings of a value that every
rank of the axis holds:

- over a model axis (tp, pp) a replicated value carries its whole
  gradient on every rank (Megatron's f and g): ``all_reduce_sum`` of
  partial products (g) passes the gradient through unchanged, and
  ``all_reduce_grad`` (f), which marks a replicated value entering
  per-rank work, sums the per-rank gradients;
- over a data axis (dp, sp) each rank's loss is its share of a mean: the
  train step averages every gradient over dp and sp afterwards
  (``tree_all_reduce_mean``), so ``all_reduce_mean`` of a loss passes the
  gradient through unchanged too.

``ring_permute``'s backward is the inverse permutation and
``all_to_all``'s is the reverse all-to-all, as in JAX.

Transport: the world is gloo, whose collectives take host tensors. A CUDA
tensor is copied to pinned host memory, reduced or moved there, and copied
back, in ``_Staged`` and nowhere else; ``STAGING`` counts the bytes copied
each way, the seconds copying took (the stream drained first, so queued
kernels are not counted) and the seconds in gloo.
"""

from __future__ import annotations

import time
from typing import Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

AxisName = Union[str, Tuple[str, ...]]

# Host staging of CUDA tensors: bytes copied (out and in), seconds copying,
# seconds in gloo's collectives, staged collectives.
STAGING = {"bytes": 0, "copy_s": 0.0, "comm_s": 0.0, "calls": 0}


def reset_staging() -> None:
    STAGING.update(bytes=0, copy_s=0.0, comm_s=0.0, calls=0)


def _axes(mesh: Mesh, axis: AxisName) -> Tuple[str, ...]:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if mesh.size(a) > 1)


class _Staged:
    """The host copy of ``x`` for gloo (pinned when ``x`` is on the card),
    and the way back to ``x``'s device."""

    def __init__(self, x: torch.Tensor):
        self.device = x.device
        self.cuda = x.is_cuda
        x = x.contiguous()
        if not self.cuda:
            self.host = x
            return
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x)
        STAGING["copy_s"] += time.perf_counter() - t0
        STAGING["bytes"] += x.numel() * x.element_size()
        STAGING["calls"] += 1
        self.t_comm = time.perf_counter()

    def back(self, host: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return host
        t0 = time.perf_counter()
        STAGING["comm_s"] += t0 - self.t_comm
        out = host.to(self.device)
        STAGING["copy_s"] += time.perf_counter() - t0
        STAGING["bytes"] += host.numel() * host.element_size()
        return out


def _reduce_raw(x: torch.Tensor, mesh: Mesh, axis: AxisName,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    names = _axes(mesh, axis)
    if not names:
        return x
    st = _Staged(x)
    h = st.host.clone() if not st.cuda else st.host
    for a in names:
        dist.all_reduce(h, op=op, group=mesh.group(a))
    return st.back(h)


def _gather_raw(x: torch.Tensor, mesh: Mesh, axis: AxisName,
                dim: int) -> torch.Tensor:
    """Blocks concatenated along ``dim`` in the order of ``mesh.index``:
    for a tuple of axes, the innermost gathered first."""
    names = _axes(mesh, axis)
    if not names:
        return x
    st = _Staged(x)
    h = st.host
    for a in reversed(names):
        parts = [torch.empty_like(h) for _ in range(mesh.size(a))]
        dist.all_gather(parts, h.contiguous(), group=mesh.group(a))
        h = torch.cat(parts, dim=dim)
    return st.back(h)


def _own(x: torch.Tensor, mesh: Mesh, axis: AxisName,
         dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``."""
    n = mesh.size(axis)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * c, c)


def _permute_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                 shift: int) -> torch.Tensor:
    n = mesh.size(axis)
    if n == 1:
        return x
    ranks, me = mesh.ranks(axis), mesh.index(axis)
    st = _Staged(x)
    out = torch.empty_like(st.host)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, st.host, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return st.back(out)


def _all_to_all_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                    split_axis: int, concat_axis: int) -> torch.Tensor:
    n = mesh.size(axis)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {axis} ({n} ranks)")
    # Chunk j of split_axis goes to rank j; the chunks move as the leading
    # dim of one buffer.
    chunks = torch.stack(x.chunk(n, dim=split_axis))
    st = _Staged(chunks)
    out = torch.empty_like(st.host)
    dist.all_to_all_single(out, st.host, group=mesh.group(axis))
    got = st.back(out)
    return torch.cat(got.unbind(0), dim=concat_axis)


def _broadcast_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                   src: int) -> torch.Tensor:
    if mesh.size(axis) == 1:
        return x
    st = _Staged(x)
    h = st.host.clone() if not st.cuda else st.host
    dist.broadcast(h, src=mesh.ranks(axis)[src], group=mesh.group(axis))
    return st.back(h)


# ------------------------------------------------- differentiable forms


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce_raw(x, mesh, axis) / mesh.size(axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_raw(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, replicated):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.replicated = replicated
        return _gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = _reduce_raw(g, ctx.mesh, ctx.axis)
        return (_own(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(_reduce_raw(x, mesh, axis), mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _permute_raw(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return (_permute_raw(g, ctx.mesh, ctx.axis, -ctx.shift), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        return _all_to_all_raw(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, *ctx.args), None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.own = mesh.index(axis) == src
        return _broadcast_raw(x, mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.own else torch.zeros_like(g)), None, None, None


# ------------------------------------------------------------ the names


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   axis_name: AxisName) -> torch.Tensor:
    """Sum across the axis (Megatron's g: the row-parallel partials of
    ``wo`` and ``w_down``). Backward: the gradient unchanged, the sum's
    consumer being replicated over the axis."""
    if not _axes(mesh, axis_name):
        return x
    return _AllReduceSum.apply(x, mesh, axis_name)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh,
                    axis_name: AxisName) -> torch.Tensor:
    """Mean across the axis (a loss over dp and sp). Backward: the
    gradient unchanged; the train step averages the gradients over the
    data axes afterwards."""
    if not _axes(mesh, axis_name):
        return x
    return _AllReduceMean.apply(x, mesh, axis_name)


def all_reduce_max(x: torch.Tensor, mesh: Mesh,
                   axis_name: AxisName) -> torch.Tensor:
    """Max across the axis; not differentiable (the result is detached)."""
    return _reduce_raw(x.detach(), mesh, axis_name, dist.ReduceOp.MAX)


def all_reduce_grad(x: torch.Tensor, mesh: Mesh,
                    axis_name: AxisName) -> torch.Tensor:
    """Identity; its gradient is summed across the axis (Megatron's f: a
    replicated activation entering column-parallel products, ``wq/wk/wv``,
    ``w_gate/w_up`` and the vocab-parallel head, or entering the pipeline
    on its first stage)."""
    if not _axes(mesh, axis_name):
        return x
    return _AllReduceGrad.apply(x, mesh, axis_name)


def all_gather(x: torch.Tensor, mesh: Mesh, axis_name: AxisName, *,
               axis: int = 0, tiled: bool = True,
               replicated: bool = True) -> torch.Tensor:
    """Concatenate the ranks' shards along ``axis`` (``tiled``; else
    stacked on a new leading ``axis``). Backward: where the consumer is
    replicated over the axis (``replicated``, the default: the tp-gathered
    logits feeding one loss on every rank), each rank takes its own slice
    of the gradient; where each rank consumes the result differently, the
    gradients are reduce-scattered."""
    if not tiled:
        x = x.unsqueeze(axis)
    axis = axis % x.dim()
    if not _axes(mesh, axis_name):
        return x
    return _AllGather.apply(x, mesh, axis_name, axis, replicated)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis_name: AxisName, *,
                   axis: int = 0) -> torch.Tensor:
    """Sum, then keep this rank's block along ``axis`` (gloo has no
    reduce-scatter of its own everywhere: an all-reduce and a slice).
    Backward: all-gather."""
    axis = axis % x.dim()
    if not _axes(mesh, axis_name):
        return x
    return _ReduceScatter.apply(x, mesh, axis_name, axis)


def ring_permute(x: torch.Tensor, mesh: Mesh, axis_name: str, *,
                 shift: int = 1) -> torch.Tensor:
    """Rank i's shard goes to rank i + shift around the axis ring (the
    ring-attention and pipeline hop). Backward: the inverse rotation."""
    if mesh.size(axis_name) == 1:
        return x
    return _RingPermute.apply(x, mesh, axis_name, shift)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis_name: str, *,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` across the ranks while gathering
    ``concat_axis`` (the Ulysses re-sharding). Backward: the all-to-all
    with the two axes swapped."""
    if mesh.size(axis_name) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis_name, split_axis % x.dim(),
                           concat_axis % x.dim())


def broadcast_from(x: torch.Tensor, mesh: Mesh, axis_name: str, *,
                   src: int = 0) -> torch.Tensor:
    """Every rank gets rank ``src``'s value. Backward: ``src`` keeps its
    own gradient and the others pass none, the result's consumer being
    replicated over the axis (the pipeline's last stage feeding the head on
    every stage)."""
    if mesh.size(axis_name) == 1:
        return x
    return _Broadcast.apply(x, mesh, axis_name, src)


def axis_index(mesh: Mesh, axis_name: AxisName) -> int:
    return mesh.index(axis_name)


def axis_size(mesh: Mesh, axis_name: AxisName) -> int:
    return mesh.size(axis_name)


def barrier_value(mesh: Mesh, axis_name: AxisName) -> torch.Tensor:
    """The axis size as an int32 scalar, summed across the axis: every rank
    waits for the others."""
    one = torch.ones((), dtype=torch.int32)
    return _reduce_raw(one, mesh, axis_name)


def pvary(x: torch.Tensor, mesh: Mesh, axis_name: AxisName) -> torch.Tensor:
    """Identity: JAX's mark for shard_map's replication checks, which the
    port does not have."""
    return x


def tree_all_reduce_mean(tree, mesh: Mesh, axis_name: AxisName):
    """``all_reduce_mean`` of every leaf (the whole-gradient data-parallel
    reduction): the leaves of one dtype and device travel as one flat
    buffer, one collective each."""
    from .._tree import tree_leaves, tree_map

    leaves = tree_leaves(tree)
    if not _axes(mesh, axis_name):
        return tree
    groups = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault((leaf.dtype, leaf.device), []).append(i)
    out = list(leaves)
    for idx in groups.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = all_reduce_mean(flat, mesh, axis_name)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(leaves[i])
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def reduce_gradients(leaves, mesh: Mesh) -> None:
    """Average the leaves' ``.grad`` over dp and sp, in place (a missing
    gradient counts as zeros, so every rank sends the same buffers)."""
    if mesh is None or mesh.size(("dp", "sp")) == 1:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    for p, g in zip(leaves, tree_all_reduce_mean(grads, mesh, ("dp", "sp"))):
        p.grad = g


def global_norm(tree, mesh: Mesh = None,
                axis_name: AxisName = None) -> torch.Tensor:
    """L2 norm over a (possibly sharded) tree of tensors; with an axis, the
    squares are summed across it first."""
    from .._tree import tree_leaves

    sq = sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree))
    if axis_name is not None:
        sq = all_reduce_sum(sq, mesh, axis_name)
    return torch.sqrt(sq)
