"""Attention ops (counterpart: ``ray_tpu/ops/attention.py``).

The serving slice needs the plain attention math (``attention_reference``,
``masked_gqa_attention``) and single-query decode attention.
``decode_attention`` launches the CUDA kernel ``csrc/decode_attention.cu``
on CUDA tensors and runs the plain version on CPU tensors; it never falls
back from the one to the other. Flash attention forward and backward (the
JAX module's training kernels) arrive with the training slice.

Layouts follow the JAX package: q [B, T, H, D], caches [B, S, KH, D], and
query head h = kh * G + g shares kv head kh (G = H // KH).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "decode_attention_forward": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L,
         ctypes.c_float, _I, _P], _I),
    "decode_attention_smem_bytes": ([_I, _I], _L),
}


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, KH, D] -> [B, S, H, D] by repeating each kv head."""
    kh = k.shape[2]
    if kh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kh, dim=2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        k_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention, q [B, T, H, D] against k/v [B, S, KH, D]; f32
    scores and softmax whatever the input dtype."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(S, device=q.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def masked_gqa_attention(q: torch.Tensor, buf_k: torch.Tensor,
                         buf_v: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """q [B, T, H, Dh] against cache buffers [B, S, KH, Dh]; mask [T, S]
    (shared) or [B, T, S] (per sequence), True where attendable. Scores are
    formed in the input dtype and divided by sqrt(Dh) before an f32
    softmax, as in the JAX package."""
    B, T, H, Dh = q.shape
    KH = buf_k.shape[2]
    G = H // KH
    if mask.dim() == 2:
        mask = mask[None]
    qg = q.reshape(B, T, KH, G, Dh)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, buf_k) / math.sqrt(Dh)
    scores = scores.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", probs.to(q.dtype), buf_v)
    return out.reshape(B, T, H, Dh)


def _decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Plain decode attention: rows 0..lengths[b] inclusive."""
    S = k.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= lengths[:, None])[:, None, :]
    return masked_gqa_attention(q[:, None], k, v, mask)[:, 0]


def _check_decode_args(q, k, v, lengths) -> None:
    ts = (q, k, v, lengths)
    if not all(t.is_cuda for t in ts):
        raise ValueError(
            "decode_attention kernel takes CUDA tensors, got "
            f"{[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("decode_attention operands lie on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "decode_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B, H, D] and k/v [B, S, KH, D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    _, S, KH, Dk = k.shape
    if k.shape[0] != B or Dk != D or lengths.shape != (B,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if D not in (64, 128):
        raise ValueError(f"decode_attention kernel takes D in (64, 128), "
                         f"got {D}")
    if H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of kv heads {KH}")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q and lengths must be contiguous")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name}'s last two dims must be contiguous")
        if t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned per row")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")


def _decode_attention_cuda(q, k, v, lengths) -> torch.Tensor:
    from .._kernels.build import load

    _check_decode_args(q, k, v, lengths)
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    lib = load("decode_attention", _SIGNATURES)
    smem = lib.decode_attention_smem_bytes(G, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"decode_attention: G={G}, D={D} needs {smem} bytes of shared "
            f"memory per block, above the card's {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, S, KH, G, D, k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(D ** -0.5), _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-position cached attention with per-sequence lengths
    (attends cache rows 0..lengths[b] inclusive).

    q [B, H, D]; k/v [B, S, KH, D]; lengths [B] int32 -> [B, H, D]. CUDA
    tensors go through the hand-written flash-decode kernel
    (``decode_attention.launches`` counts its launches); CPU tensors
    through the plain version."""
    if q.device.type == "cpu":
        return _decode_attention_ref(q, k, v, lengths)
    return _decode_attention_cuda(q, k, v, lengths)


decode_attention.launches = 0
