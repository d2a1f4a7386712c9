"""Block-distributed arrays (reference: python/ray/experimental/array/distributed/).

A DistArray is a grid of block ObjectRefs; linalg ops are remote tasks per
output block. Each block is a float32 torch tensor on the array's device,
the card unless ``device="cpu"`` is asked for, and stays there between ops:
an output block's task reads its input blocks where they lie and writes its
own there. Block size defaults to 512.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch

BLOCK_SIZE = 512


def _num_blocks(n: int) -> int:
    return max(1, math.ceil(n / BLOCK_SIZE))


@ray_tpu_torch.remote
def _zeros_block(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


@ray_tpu_torch.remote
def _random_block(shape, seed, device):
    # numpy's draws, so that both packages hold the same float32 bits.
    block = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(block).to(device)


@ray_tpu_torch.remote
def _eye_block(shape, is_diag, device):
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    if is_diag:
        out.fill_diagonal_(1.0)
    return out


@ray_tpu_torch.remote
def _binary_op_block(a, b, op):
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    raise ValueError(op)


@ray_tpu_torch.remote
def _matmul_block(*blocks):
    """One output block: sum_k A[i,k] @ B[k,j], summed in k order.

    Blocks arrive as positional args (first half = A row, second half = B
    column) because only top-level args are dependency-resolved — same
    calling convention as the reference's blockwise ops.
    """
    k = len(blocks) // 2
    acc = None
    for a, b in zip(blocks[:k], blocks[k:]):
        part = torch.matmul(a, b)
        acc = part if acc is None else acc + part
    return acc


@ray_tpu_torch.remote
def _transpose_block(block):
    return block.t().contiguous()


class DistArray:
    def __init__(self, shape: Tuple[int, int],
                 blocks: Optional[np.ndarray] = None,
                 device: ray_tpu_torch.Device = None):
        self.shape = tuple(shape)
        self.device = ray_tpu_torch.default_device(device)
        self.num_blocks = (_num_blocks(shape[0]), _num_blocks(shape[1]))
        if blocks is None:
            blocks = np.empty(self.num_blocks, dtype=object)
        self.blocks = blocks  # [bi, bj] of ObjectRef

    def _block_shape(self, bi: int, bj: int) -> Tuple[int, int]:
        rows = min(BLOCK_SIZE, self.shape[0] - bi * BLOCK_SIZE)
        cols = min(BLOCK_SIZE, self.shape[1] - bj * BLOCK_SIZE)
        return rows, cols

    def assemble(self) -> torch.Tensor:
        """Fetch all blocks and stitch the dense array on the array's
        device (reference DistArray.assemble)."""
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.device)
        for bi in range(self.num_blocks[0]):
            for bj in range(self.num_blocks[1]):
                block = ray_tpu_torch.get(self.blocks[bi, bj])
                r0, c0 = bi * BLOCK_SIZE, bj * BLOCK_SIZE
                out[r0:r0 + block.shape[0], c0:c0 + block.shape[1]] = block
        return out


def _build(shape, make_ref, device) -> DistArray:
    # The device resolves here, in the driver, before any task is queued.
    arr = DistArray(shape, device=device)
    for bi in range(arr.num_blocks[0]):
        for bj in range(arr.num_blocks[1]):
            arr.blocks[bi, bj] = make_ref(bi, bj, arr._block_shape(bi, bj),
                                          arr.device)
    return arr


def zeros(shape: Tuple[int, int],
          device: ray_tpu_torch.Device = None) -> DistArray:
    return _build(shape, lambda bi, bj, s, dev: _zeros_block.remote(s, dev),
                  device)


def eye(n: int, device: ray_tpu_torch.Device = None) -> DistArray:
    return _build((n, n),
                  lambda bi, bj, s, dev: _eye_block.remote(s, bi == bj, dev),
                  device)


def random(shape: Tuple[int, int], seed: int = 0,
           device: ray_tpu_torch.Device = None) -> DistArray:
    return _build(
        shape,
        lambda bi, bj, s, dev: _random_block.remote(
            s, seed * 10007 + bi * 101 + bj, dev), device)


def _elementwise(a: DistArray, b: DistArray, op: str) -> DistArray:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    out = DistArray(a.shape, device=a.device)
    for bi in range(out.num_blocks[0]):
        for bj in range(out.num_blocks[1]):
            out.blocks[bi, bj] = _binary_op_block.remote(
                a.blocks[bi, bj], b.blocks[bi, bj], op)
    return out


def add(a: DistArray, b: DistArray) -> DistArray:
    return _elementwise(a, b, "add")


def subtract(a: DistArray, b: DistArray) -> DistArray:
    return _elementwise(a, b, "sub")


def dot(a: DistArray, b: DistArray) -> DistArray:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch {a.shape} x {b.shape}")
    out = DistArray((a.shape[0], b.shape[1]), device=a.device)
    for bi in range(out.num_blocks[0]):
        for bj in range(out.num_blocks[1]):
            row = [a.blocks[bi, k] for k in range(a.num_blocks[1])]
            col = [b.blocks[k, bj] for k in range(b.num_blocks[0])]
            out.blocks[bi, bj] = _matmul_block.remote(*row, *col)
    return out


def _dot_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How far apart two float32 products ``a @ b`` may lie, elementwise,
    when each sums its K terms in its own order (``dot``'s blocks, one
    ``torch.matmul``, another library's): each is within gamma_K * (|a| @
    |b|) of the exact product, gamma_K = K u / (1 - K u) with u = 2^-24,
    however its sums are grouped, so the two are within twice that. |a| @
    |b| is taken in float64. TF32 products (u = 2^-11) break the bound."""
    K = a.shape[-1]
    u = 2.0 ** -24
    gamma = K * u / (1 - K * u)
    return 2 * gamma * torch.matmul(a.double().abs(), b.double().abs())


def transpose(a: DistArray) -> DistArray:
    out = DistArray((a.shape[1], a.shape[0]), device=a.device)
    for bi in range(out.num_blocks[0]):
        for bj in range(out.num_blocks[1]):
            out.blocks[bi, bj] = _transpose_block.remote(a.blocks[bj, bi])
    return out
