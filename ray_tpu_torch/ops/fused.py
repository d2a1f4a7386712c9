"""Fused RMSNorm (counterpart: ``ray_tpu/ops/fused.py``).

``rms_norm`` launches the CUDA kernel ``csrc/rms_norm.cu`` on a CUDA tensor
and runs the plain version ``_rms_norm_ref`` on a CPU tensor; it never
falls back from the one to the other. The two round differently in bf16,
as the JAX package's Pallas kernel and XLA reference do: the plain version
rounds ``x * inv`` to the input dtype before the weight multiply, the
kernel computes ``x * inv * w`` in f32 and rounds once.

Softmax cross-entropy (the JAX module's second kernel) and RMSNorm's
backward arrive with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rms_norm_forward": (
    [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P], _I)}


def _rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm, the XLA reference's arithmetic."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight


def _check_rms_norm_args(x: torch.Tensor, weight: torch.Tensor) -> None:
    if not (x.is_cuda and weight.is_cuda):
        raise ValueError(
            f"rms_norm kernel takes CUDA tensors, got {x.device} and "
            f"{weight.device}")
    if x.device != weight.device:
        raise ValueError(f"x on {x.device} but weight on {weight.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"rms_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if weight.dtype != x.dtype:
        raise TypeError(
            f"weight dtype {weight.dtype} differs from x dtype {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"rms_norm needs a non-empty tensor, got {x.shape}")
    if weight.shape != x.shape[-1:]:
        raise ValueError(
            f"weight shape {tuple(weight.shape)} does not match the last "
            f"axis of x {tuple(x.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel takes contiguous tensors")


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    from .._kernels.build import load

    _check_rms_norm_args(x, weight)
    E = x.shape[-1]
    R = x.numel() // E
    y = torch.empty_like(x)
    vec_width = 16 // x.element_size()
    vec = int(E % vec_width == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, weight, y)))
    fn = load("rms_norm", _SIGNATURES).rms_norm_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(), R, E,
                 float(eps), _DTYPES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight over the last axis.

    CUDA tensors go through the hand-written kernel (``rms_norm.launches``
    counts its launches); CPU tensors through the plain version."""
    if x.device.type == "cpu":
        return _rms_norm_ref(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


rms_norm.launches = 0
