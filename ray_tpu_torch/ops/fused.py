"""Fused RMSNorm and softmax cross-entropy (counterpart:
``ray_tpu/ops/fused.py``).

Each op is a ``torch.autograd.Function``. Its forward launches a CUDA
kernel on a CUDA tensor (``csrc/rms_norm.cu``, ``csrc/softmax_xent.cu``)
and runs the plain version on a CPU tensor; it never falls back from the
one to the other. The backwards are plain PyTorch transcriptions of the JAX
package's ``custom_vjp`` backwards, which are XLA there too.

RMSNorm rounds differently in bf16 on the two routes, as the JAX package's
Pallas kernel and XLA reference do: the plain version rounds ``x * inv`` to
the input dtype before the weight multiply, the kernel computes
``x * inv * w`` in f32 and rounds once.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_RMS_SIGNATURES = {"rms_norm_forward": (
    [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P], _I)}
_XENT_SIGNATURES = {"softmax_xent_forward": (
    [_P, _P, _P, _L, _L, _I, _I, _I, _P], _I)}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}

# --------------------------------------------------------------- RMSNorm


def _rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm, the XLA reference's arithmetic."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight


def _rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                  eps: float):
    """(dx, dw) of RMSNorm, transcribed from the JAX ``_rms_norm_bwd``:
    f32 inside, dx in x's dtype and dw in weight's."""
    E = x.shape[-1]
    xf, gf, wf = x.float(), g.float(), weight.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    gw = gf * wf
    # d/dx [x_i * inv]: inv * g_i - x_i * inv^3 * mean(gw * x)
    dx = inv * gw - xf * inv ** 3 * (gw * xf).mean(-1, keepdim=True)
    dw = ((xf * inv).reshape(-1, E) * gf.reshape(-1, E)).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


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
    fn = load("rms_norm", _RMS_SIGNATURES).rms_norm_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), y.data_ptr(), R, E,
                 float(eps), _DTYPES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm.launches += 1
    return y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _rms_norm_ref(x, weight, eps)
        return _rms_norm_cuda(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight over the last axis,
    differentiable in x and weight.

    CUDA tensors go through the hand-written kernel (``rms_norm.launches``
    counts its launches); CPU tensors through the plain version."""
    return _RMSNorm.apply(x, weight, eps)


rms_norm.launches = 0

# ------------------------------------------------- softmax cross-entropy


def _xent_ref(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain per-row ``logsumexp(logits) - logits[label]`` in f32, the XLA
    reference's arithmetic."""
    lf = logits.float()
    picked = lf.gather(-1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(lf, dim=-1) - picked


def _xent_bwd(logits: torch.Tensor, labels: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """dlogits = (softmax(logits) - onehot(labels)) * g, in f32, cast to
    the logits' dtype: the JAX ``_xent_bwd``. The one-hot is subtracted in
    place at the label (x - 1 there, x - 0 elsewhere, the same values)
    rather than materialised."""
    d = torch.softmax(logits.float(), dim=-1)
    rows = torch.arange(d.shape[0], device=d.device)
    d[rows, labels.long()] -= 1.0
    d *= g.float()[:, None]
    return d.to(logits.dtype)


def _check_xent_args(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dtype not in _DTYPES:
        raise TypeError(f"softmax_cross_entropy kernel takes float32 or "
                        f"bfloat16 logits, got {logits.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(
            f"labels must be int32 or int64, got {labels.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"want logits [N, V] and labels [N], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.numel() == 0:
        raise ValueError(f"softmax_cross_entropy needs non-empty logits, "
                         f"got {tuple(logits.shape)}")
    if not (logits.is_cuda and labels.is_cuda):
        raise ValueError(
            f"softmax_cross_entropy kernel takes CUDA tensors, got "
            f"{logits.device} and {labels.device}")
    if logits.device != labels.device:
        raise ValueError(
            f"logits on {logits.device} but labels on {labels.device}")
    if logits.stride(1) != 1 or not labels.is_contiguous():
        raise ValueError("logits rows and labels must be contiguous")


def _xent_cuda(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    from .._kernels.build import load

    _check_xent_args(logits, labels)
    N, V = logits.shape
    out = torch.empty(N, dtype=torch.float32, device=logits.device)
    fn = load("softmax_xent", _XENT_SIGNATURES).softmax_xent_forward
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), labels.data_ptr(), out.data_ptr(), N, V,
                 logits.stride(0), _DTYPES[logits.dtype],
                 _LABEL_DTYPES[labels.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"softmax_cross_entropy kernel launch failed: CUDA error {err}")
    softmax_cross_entropy.launches += 1
    return out


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        if logits.device.type == "cpu":
            return _xent_ref(logits, labels)
        return _xent_cuda(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return _xent_bwd(logits, labels, g), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``-log softmax(logits)[label]``: logits [N, V] (f32 or
    bf16) x labels [N] (int32 or int64) -> [N] f32, differentiable in the
    logits. A label outside [0, V) picks 0 on the card, as the Pallas
    kernel's one-hot does, and raises on the CPU.

    CUDA tensors go through the hand-written kernel
    (``softmax_cross_entropy.launches`` counts its launches); CPU tensors
    through the plain version."""
    return _SoftmaxXent.apply(logits, labels)


softmax_cross_entropy.launches = 0
