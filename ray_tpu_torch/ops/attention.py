"""Attention ops (counterpart: ``ray_tpu/ops/attention.py``).

The plain attention math (``attention_reference``, ``masked_gqa_attention``),
flash attention for training (``flash_attention``: forward K3, backward K4
and K5) and single-query decode attention (``decode_attention``, K6).

Each kernel wrapper (``flash_forward``, ``flash_backward_dq``,
``flash_backward_dkv``, ``decode_attention``) launches its CUDA kernel
(``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``) on CUDA tensors
and runs its plain version on CPU tensors; it never falls back from the one
to the other, and counts its launches in ``<wrapper>.launches``.

Layouts follow the JAX package: q [B, T, H, D], k/v and caches
[B, S, KH, D], and query head h = kh * G + g shares kv head kh
(G = H // KH).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch

from .._kernels import count_launch

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The head dims the kernels are built for (csrc/*.cu); each wrapper raises
# on any other. The decode kernels K6 and K7 take the small models' 8-32
# (the soak's d_model 32 over 4 heads is D 8), the flash kernels K3-K5
# 16-32 beside the flagship's 64 and 128.
DECODE_HEAD_DIMS = (8, 16, 32, 64, 128)
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LL = ctypes.POINTER(ctypes.c_longlong)
_F = ctypes.c_float
_SIGNATURES = {
    "decode_attention_forward": (
        [_P] * 7 + [_I] * 6 + [_L] * 4 + [_F, _I, _P], _I),
    "decode_attention_smem_bytes": ([_I, _I, _I], _L),
}
_FLASH_SIGNATURES = {
    "flash_forward": ([_P] * 5 + [_I] * 6 + [_LL, _F, _I, _I, _P], _I),
    "flash_backward_dq": ([_P] * 7 + [_I] * 6 + [_LL, _F, _I, _I, _P], _I),
    "flash_backward_dkv": ([_P] * 8 + [_I] * 6 + [_LL, _F, _I, _I, _P], _I),
    "flash_smem_bytes": ([_I, _I, _I], _L),
}


def unsharded_operands(*tensors) -> bool:
    """True when every operand lies whole on one device. Under the port's
    meshes each rank holds plain tensors (its own shard), so this is True
    for them; a ``torch.distributed.tensor.DTensor`` whose mesh spans more
    than one device is False. The decode wrappers refuse such an operand:
    the port has no partitioned plain path to hand it to."""
    if all(type(t) is torch.Tensor for t in tensors):
        return True   # the decode path's case, without the import below
    from torch.distributed.tensor import DTensor

    return not any(isinstance(t, DTensor) and t.device_mesh.size() > 1
                   for t in tensors)


def _check_unsharded(name: str, *tensors) -> None:
    if not unsharded_operands(*tensors):
        raise ValueError(
            f"{name} takes each rank's own tensors, not a DTensor over a "
            f"mesh of several devices; pass its local shard")


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


# Split-K of the flash-decode kernels K6 and K7 (csrc/decode_tile.cuh).
_DECODE_TILE = 64        # cache rows per tile
# Blocks the split aims at, about 4 on each of an H100's 132 SMs; 512 by
# timing (flash_variants.py): at B*KH = 128 it gives 4 splits, which beat 5
# at ~600 and ~2000 rows.
_SPLIT_BLOCKS = 512
_MAX_SPLIT = 32          # the kernels take up to 64


def decode_splits(bkh: int) -> int:
    """Blocks per (sequence, kv head) of the flash-decode kernels K6 and
    K7: enough that the B*KH (sequence, kv head) pairs fill an H100 (132
    SMs) about four blocks deep. One function of a shape both kernels know,
    never of the cache's length, the page size or the card it runs on, so
    K7 on a page table gives K6's bits on the same rows, on every card."""
    return max(1, min(_MAX_SPLIT, -(-_SPLIT_BLOCKS // bkh)))


def split_plan(length: int, n_split: int) -> List[Tuple[int, int]]:
    """The live splits of one sequence under the kernels' split plan
    (``split_range`` in csrc/decode_tile.cuh), as (first row, last row),
    inclusive: the length // 64 + 1 live tiles in runs of ceil(tiles /
    n_split), split 0 first; the splits past them are empty."""
    tiles = length // _DECODE_TILE + 1
    per = -(-tiles // n_split)
    return [(t * _DECODE_TILE, min((t + per) * _DECODE_TILE, length + 1) - 1)
            for t in range(0, tiles, per)]


# Per (device, stream): the kernels' split tickets, int32, 0 between
# launches (the block that merges a (sequence, kv head) resets its ticket).
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _decode_split(q: torch.Tensor, bkh: int, G: int,
                  D: int) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """The number of splits (``decode_splits``) and the split kernels'
    scratch on q's device: the partials, one ``torch.empty`` from the
    caching allocator (every value the merge reads is written first in the
    same launch), and the tickets of the current stream, zeroed once when
    first made or grown."""
    n_split = decode_splits(bkh)
    partials = torch.empty(bkh * n_split * (G * D + 2 * G),
                           dtype=torch.float32, device=q.device)
    key = (q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < bkh:
        tickets = torch.zeros(max(bkh, 1024), dtype=torch.int32,
                              device=q.device)
        _TICKETS[key] = tickets
    return n_split, partials, tickets


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
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes D in "
                         f"{DECODE_HEAD_DIMS}, got {D}")
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

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # The kernel's output would carry no grad_fn; JAX cannot
        # differentiate its _flash_decode either.
        raise RuntimeError(
            "decode_attention has no backward; call it under "
            "torch.no_grad() or torch.inference_mode()")
    _check_decode_args(q, k, v, lengths)
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    lib = load("decode_attention", _SIGNATURES)
    smem = lib.decode_attention_smem_bytes(G, D, _DTYPES[q.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"decode_attention: G={G}, D={D} needs {smem} bytes of shared "
            f"memory per block, above the card's {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        n_split, partials, tickets = _decode_split(q, B * KH, G, D)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), partials.data_ptr(), tickets.data_ptr(), B, S,
            KH, G, D, n_split, k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), float(D ** -0.5), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {err}")
    count_launch(decode_attention)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-position cached attention with per-sequence lengths
    (attends cache rows 0..lengths[b] inclusive).

    q [B, H, D]; k/v [B, S, KH, D]; lengths [B] int32 -> [B, H, D]. CUDA
    tensors go through the hand-written flash-decode kernel
    (``decode_attention.launches`` counts its launches); CPU tensors
    through the plain version. It has no backward: on the card it raises
    when grad mode is on and an input requires grad.

    The JAX package's ``block_k`` and ``truncate_dma`` are Pallas tiling
    knobs that no caller passes; the kernel here plans its own splits, so
    the port takes neither. A DTensor over several devices raises
    ValueError (``unsharded_operands``)."""
    _check_unsharded("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return _decode_attention_ref(q, k, v, lengths)
    return _decode_attention_cuda(q, k, v, lengths)


decode_attention.launches = 0


# ------------------------------------------------------ flash attention


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores [B, H, T, S]: f32 dot products of q [B, T, H, D] with k
    [B, S, KH, D] (repeated to H heads), scaled afterwards, NEG_INF where
    causal masks (k > q)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     _repeat_kv(k, H).float()) * D ** -0.5
    if causal:
        future = (torch.arange(S, device=q.device)[None, :]
                  > torch.arange(T, device=q.device)[:, None])
        s = s.masked_fill(future, NEG_INF)
    return s


def _flash_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True):
    """Plain flash forward: (out [B, T, H, D] in q's dtype, lse [B, H, T]
    f32), the Pallas kernel's arithmetic in one pass: p rounded to v's
    dtype for PV, o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    H = q.shape[2]
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)            # [B, H, T, 1]
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(),
                       _repeat_kv(v, H).float())
    out = (acc / den.transpose(1, 2)).to(q.dtype)
    return out, (m + torch.log(den))[..., 0]


def _flash_dsum(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * out) in f32, [B, H, T]: the backward's one torch op
    outside the kernels, as in the JAX package."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, dsum, causal: bool):
    """p = exp(s - lse) and ds = p * (dp - dsum) * scale, [B, H, T, S]."""
    H, D = q.shape[2], q.shape[3]
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(),
                      _repeat_kv(v, H).float())
    return p, p * (dp - dsum[..., None]) * D ** -0.5


def _flash_backward_dq_ref(q, k, v, do, lse, dsum, causal: bool = True):
    """Plain K4: dq = ds @ k, ds rounded to k's dtype, in q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, dsum, causal)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(),
                      _repeat_kv(k, q.shape[2]).float())
    return dq.to(q.dtype)


def _flash_backward_dkv_ref(q, k, v, do, lse, dsum, causal: bool = True):
    """Plain K5: dv = p^T @ do (p rounded to do's dtype) and dk = ds^T @ q
    (ds rounded to q's dtype), summed over each group's G query heads in
    f32, in k's and v's dtypes."""
    B, S, KH, D = k.shape
    G = q.shape[2] // KH
    p, ds = _bwd_probs(q, k, v, do, lse, dsum, causal)
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(B, S, KH, G, D).sum(3)
    dv = dv.reshape(B, S, KH, G, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_ref(q, k, v, out, lse, do, causal: bool = True):
    """Plain backward: (dq, dk, dv), P recomputed from lse and
    dsum = rowsum(do * out)."""
    dsum = _flash_dsum(out, do)
    dq = _flash_backward_dq_ref(q, k, v, do, lse, dsum, causal)
    return (dq, *_flash_backward_dkv_ref(q, k, v, do, lse, dsum, causal))


# m of _rounded_sum_bound: the bf16 roundings of an intermediate that may
# flip, per output element, between two computations of the same sum.
# Derivation: the kernels form s and dp on the tensor cores in another
# order than the plain einsums, and exp by ex2.approx; the f32 values
# before rounding typically differ by a relative 2^-20 or less (a few f32
# ulps of the dot products' partial sums, 2^-22 from ex2.approx). A value
# rounds the other way when it lies that close to a bf16 rounding
# boundary, a chance of 2^-20 / 2^-8 = 2^-12 per term (twice that for ds,
# whose dp - dsum cancels). Over n terms that is a Poisson count of mean
# n 2^-11: 1 at n = 2048 (dq at T = S = 2048), 4 at n = 8192 (dk, dv at
# G 8, T 1024); its largest value over the 2^20 - 2^24 outputs of such a
# call is about 9 and 16. Each flip moves the sum by one bf16 ulp of a_c
# times |b_c|, at most 2^-7 max|a| max|b|.
_FLIP_TERMS = 16


def _rounded_sum_bound(a: torch.Tensor, b: torch.Tensor, y_ref: torch.Tensor,
                       a_err: torch.Tensor, flips: int = _FLIP_TERMS
                       ) -> torch.Tensor:
    """Elementwise bound on |y - y_ref| for y = a @ b, where a [..., R, C]
    holds bf16-rounded intermediates (ds or p, in f32), b [..., C, N] the
    bf16 operand, and y_ref [..., R, N] the plain result in bf16, when y
    comes from the same math done in another order. Four terms: one bf16
    ulp of |y_ref| (the final rounding); C 2^-24 (|a| @ |b|) (the f32 sum
    reordered); flips 2^-7 max_c|a| max_c|b| (roundings of a that flipped,
    row max times column max); a_err @ |b|, a_err [..., R, C] bounding the
    f32 error of a before its rounding (where dp - dsum cancels, ds may
    differ by more than its own ulp, and a row of such terms, like row 0
    under the causal mask, has no larger term to carry the flips term).
    Used by the card's checks of the bf16 backward kernels, never on the
    main path."""
    y = y_ref.float().abs()
    ulp = torch.where(y > 0, torch.ldexp(torch.ones_like(y),
                                         torch.frexp(y).exponent - 8), 0.0)
    a, b = a.float().abs(), b.float().abs()
    return (ulp + a.shape[-1] * 2.0 ** -24 * (a @ b) + a_err @ b
            + flips * 2.0 ** -7 * a.amax(-1, keepdim=True)
            * b.amax(-2, keepdim=True))


def _flash_grad_bounds(q, k, v, do, lse, dsum, dq, dk, dv,
                       causal: bool = True, flips: int = _FLIP_TERMS):
    """_rounded_sum_bound for the plain backward's dq, dk, dv (given), in
    their layouts: dq sums ds (rounded to k's dtype) times k over S; dk
    and dv sum ds^T (q's dtype) times q and p^T (do's dtype) times do over
    the G query heads of a group and T. The f32 error of p and ds before
    rounding: each of the two orders of a dot product of D exact products
    is within D 2^-24 sum|products|, so s scale within
    e_s = 2 D 2^-24 scale (|q| @ |k|) and dp within e_dp = 2 D 2^-24
    (|do| @ |v|); p within p (e_s + 2^-21) (ex2.approx, and the rounding
    of its argument); ds within scale (p e_dp + |dp - dsum| e_p)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    p, ds = _bwd_probs(q, k, v, do, lse, dsum, causal)     # [B, H, T, S]
    kr, vr = _repeat_kv(k, H).float(), _repeat_kv(v, H).float()
    dot_err = 2 * D * 2.0 ** -24
    e_p = p * (dot_err * scale * torch.einsum(
        "bthd,bshd->bhts", q.float().abs(), kr.abs()) + 2.0 ** -21)
    e_dp = dot_err * torch.einsum("bthd,bshd->bhts", do.float().abs(),
                                  vr.abs())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), vr)
    e_ds = scale * (p * e_dp + (dp - dsum[..., None]).abs() * e_p)
    del dp, e_dp
    b_dq = _rounded_sum_bound(ds.to(k.dtype), kr.transpose(1, 2),
                              dq.transpose(1, 2), e_ds,
                              flips).transpose(1, 2)

    def over_group(a, err, x, y):   # a, err [B, H, T, S]; x [B, T, H, D]
        def t(z):
            return z.reshape(B, KH, G, T, S).permute(0, 1, 4, 2, 3).reshape(
                B, KH, S, G * T)
        x = x.transpose(1, 2).reshape(B, KH, G * T, D)
        return _rounded_sum_bound(t(a), x, y.transpose(1, 2), t(err),
                                  flips).transpose(1, 2)

    return (b_dq, over_group(ds.to(q.dtype), e_ds, q, dk),
            over_group(p.to(do.dtype), e_p, do, dv))


def _check_flash_args(q, k, v, do=None, lse=None, dsum=None) -> None:
    """Refuse what the flash kernels do not take: shapes and dtypes first,
    then devices, then layout."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B, T, H, D] and k/v [B, S, KH, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or T == 0 or S == 0 or B == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take D in "
                         f"{FLASH_HEAD_DIMS}, got {D}")
    if KH == 0 or H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of kv heads {KH}")
    ts = [q, k, v] + ([do] if do is not None else [])
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(
            "flash attention kernels take float32 or bfloat16 q/k/v"
            f"{'/do' if do is not None else ''} of one dtype, got "
            f"{[str(t.dtype) for t in ts]}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    stats = [t for t in (lse, dsum) if t is not None]
    for t in stats:
        if (t.dtype != torch.float32 or t.shape != (B, H, T)
                or not t.is_contiguous()):
            raise ValueError(
                f"lse/dsum must be contiguous float32 [B, H, T], got "
                f"{t.dtype} {tuple(t.shape)}")
    every = ts + stats
    if not all(t.is_cuda for t in every):
        raise ValueError(
            "flash attention kernels take CUDA tensors, got "
            f"{[str(t.device) for t in every]}")
    if len({t.device for t in every}) != 1:
        raise ValueError("flash attention operands lie on different devices")
    vec = 16 // q.element_size()
    for t in ts:
        if t.stride(3) != 1:
            raise ValueError("q/k/v/do must have a contiguous last axis")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("q/k/v/do rows must be 16-byte aligned")


def _launch_flash(fn_name: str, which: int, q, k, v, tensors, outputs,
                  strided, causal: bool) -> None:
    from .._kernels.build import load

    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    lib = load("flash_attention", _FLASH_SIGNATURES)
    smem = lib.flash_smem_bytes(which, D, _DTYPES[q.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{fn_name}: D={D} needs {smem} bytes of shared "
                         f"memory per block, above the card's {_SMEM_LIMIT}")
    strides = [st for t in strided for st in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(
            *[t.data_ptr() for t in tensors + outputs], B, T, S, H, KH, D,
            strides, float(D ** -0.5), int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True):
    """(out [B, T, H, D], lse [B, H, T] f32). CUDA tensors go through the
    hand-written kernel K3 (``flash_forward.launches``): bf16 on the tensor
    cores, f32 on FMA loops (no TF32); CPU tensors through
    ``_flash_forward_ref``."""
    if q.device.type == "cpu":
        return _flash_forward_ref(q, k, v, causal)
    _check_flash_args(q, k, v)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch_flash("flash_forward", 0, q, k, v, [q, k, v], [out, lse],
                  [q, k, v], causal)
    count_launch(flash_forward)
    return out, lse


def flash_backward_dq(q, k, v, do, lse, dsum, causal: bool = True):
    """dq [B, T, H, D]. CUDA tensors go through the hand-written kernel K4
    (``flash_backward_dq.launches``); CPU tensors through
    ``_flash_backward_dq_ref``."""
    if q.device.type == "cpu":
        return _flash_backward_dq_ref(q, k, v, do, lse, dsum, causal)
    _check_flash_args(q, k, v, do, lse, dsum)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_flash("flash_backward_dq", 1, q, k, v, [q, k, v, do, lse, dsum],
                  [dq], [q, k, v, do], causal)
    count_launch(flash_backward_dq)
    return dq


def flash_backward_dkv(q, k, v, do, lse, dsum, causal: bool = True):
    """(dk, dv) [B, S, KH, D]. CUDA tensors go through the hand-written
    kernel K5 (``flash_backward_dkv.launches``); CPU tensors through
    ``_flash_backward_dkv_ref``."""
    if q.device.type == "cpu":
        return _flash_backward_dkv_ref(q, k, v, do, lse, dsum, causal)
    _check_flash_args(q, k, v, do, lse, dsum)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_flash("flash_backward_dkv", 2, q, k, v,
                  [q, k, v, do, lse, dsum], [dk, dv], [q, k, v, do], causal)
    count_launch(flash_backward_dkv)
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dsum = _flash_dsum(out, do)
        dq = flash_backward_dq(q, k, v, do, lse, dsum, ctx.causal)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, dsum, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention, q [B, T, H, D] against k/v [B, S, KH, D] ->
    [B, T, H, D], differentiable in q, k and v. On the card the forward is
    kernel K3 and the backward kernels K4 (dq) and K5 (dk, dv); on the CPU
    their plain versions. D in ``FLASH_HEAD_DIMS`` (16, 32, 64, 128) on
    the card, any T, S and G = H // KH.

    The JAX package's ``block_q`` and ``block_k`` are Pallas tiling knobs
    that no caller passes; the kernels here choose their own tiles, so the
    port takes neither."""
    return _FlashAttention.apply(q, k, v, causal)
