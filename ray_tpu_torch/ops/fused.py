"""Fused RMSNorm and softmax cross-entropy (counterpart:
``ray_tpu/ops/fused.py``).

Each op is differentiable through a ``torch.autograd.Function``. On a CUDA
tensor it launches a CUDA kernel (``csrc/rms_norm.cu``,
``csrc/softmax_xent.cu``), on a CPU tensor it runs the plain version; it
never falls back from the one to the other. RMSNorm's backward is a kernel
too (``rms_norm.backward_launches``); cross-entropy's is a plain PyTorch
transcription of the JAX package's ``custom_vjp`` backward, which is XLA
there too. With grad off (the engines run under ``torch.inference_mode``)
the RMSNorm wrappers call the kernel without the autograd machinery.

``add_rms_norm`` is RMSNorm with the residual add before it fused in:
``h = x + a`` (rounded as PyTorch's add rounds it) and ``y = rms_norm(h)``
in one launch, the composite each layer of the JAX model computes.

RMSNorm rounds differently in bf16 on the two routes, as the JAX package's
Pallas kernel and XLA reference do: the plain version rounds ``x * inv`` to
the input dtype before the weight multiply, the kernel computes
``x * inv * w`` in f32 and rounds once. Its backward kernel likewise adds
the residual's gradient in f32 and rounds once, where the plain version
rounds the norm's dx first and then adds, as autograd did.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_RMS_SIGNATURES = {
    "rms_norm_forward": ([_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P], _I),
    "rms_norm_backward_blocks": ([_I], _I),
    "rms_norm_backward": (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P], _I),
}
_XENT_SIGNATURES = {"softmax_xent_forward": (
    [_P, _P, _P, _L, _L, _I, _I, _I, _P], _I)}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}

# The ctypes functions of csrc/rms_norm.cu, by name, once loaded.
_RMS_FNS: dict = {}
# The current CUDA device's index, and the raw pointer of a device's current
# stream: torch's CUDA build has both in torch._C, where the public calls
# (torch.cuda.current_device, current_stream().cuda_stream) cost more.
_current_device = getattr(torch._C, "_cuda_getDevice", None) or (
    lambda: torch.cuda.current_device())
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def _rms_fn(name: str):
    fn = _RMS_FNS.get(name)
    if fn is None:
        from .._kernels.build import load

        fn = _RMS_FNS[name] = getattr(load("rms_norm", _RMS_SIGNATURES), name)
    return fn


def _launch(index: int, fn, *args) -> int:
    """fn(*args, stream): a launcher called on the current stream of CUDA
    device ``index``, made the current device for the call unless it
    already is."""
    if index == _current_device():
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def _vec(E: int, x: torch.Tensor, *ptrs: int) -> int:
    """1 when the kernel may take 16-byte vectors: E a multiple of the
    vector width of x's dtype and every pointer 16-byte aligned."""
    any_ptr = 0
    for p in ptrs:
        any_ptr |= p
    return int(E % (16 // x.element_size()) == 0 and any_ptr % 16 == 0)

# --------------------------------------------------------------- RMSNorm


def _rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm, the XLA reference's arithmetic."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight


def _add_rms_norm_ref(x: torch.Tensor, a: torch.Tensor,
                      weight: torch.Tensor, eps: float):
    """Plain (h, y): h = x + a, y = _rms_norm_ref(h)."""
    h = x + a
    return h, _rms_norm_ref(h, weight, eps)


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


def _rms_norm_dw_bound(h: torch.Tensor, g_y: torch.Tensor, eps: float,
                       dw_ref: torch.Tensor, blocks: int) -> torch.Tensor:
    """Elementwise bound on |dw - dw_ref| in f32, for the kernel's dw
    against the plain one (dw_ref), which sum the same R terms
    t = (h inv) g_y of a column in different orders. The f32 tolerance of
    atol = rtol = 1e-5 does not hold at thousands of rows: the plain column
    sum is itself further than that from the exact sum (a column's sum is
    ~sqrt(R) while its terms' magnitudes add up to ~0.6 R). So both
    are held to the exact sum S of the plain terms (in f64):
    |dw - dw_ref| <= |dw_ref - S| + |dw - S|, the first measured, the
    second within d 2^-24 sum|t| for a summation tree of depth d: the
    kernel's is ceil(R / blocks) rows in a block (blocks: its number of
    partial rows, ``rms_norm_backward_blocks``), ceil(blocks / 32) partial
    rows a thread and 32 threads in order (``csrc/rms_norm.cu``), plus 64
    for its own terms: two roundings each, and inv, whose sum of squares
    over E (a tree of depth under 64) and rsqrtf (2 ulps) differ from the
    plain version's. Used by the card's checks, never on the main path."""
    E = h.shape[-1]
    R = h.numel() // E
    hf, gf = h.float().reshape(R, E), g_y.float().reshape(R, E)
    inv = torch.rsqrt((hf * hf).mean(-1, keepdim=True) + eps)
    t = (hf * inv) * gf
    exact = t.double().sum(0)
    depth = -(-R // blocks) + -(-blocks // 32) + 32 + 64
    return ((dw_ref.double() - exact).abs()
            + depth * 2.0 ** -24 * t.abs().double().sum(0)).float()


def _rms_norm_dx_bound(got: torch.Tensor, want: torch.Tensor,
                       dx_norm: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |got - want| for the backward's dx with the
    residual's gradient g_h, in bf16: the kernel (got) rounds d + g_h
    once; the plain version (want) rounds the norm's d to dx_norm, then
    dx_norm + g_h, as autograd did. A rounding to bf16 moves a value by at
    most 2^-8 of its magnitude before or after, so
    |got - want| <= 2^-8 |got| + |d_kernel - d_plain| + 2^-8 |dx_norm|
    + 2^-8 |want|, where the two f32 d differ by at most the f32 check's
    1e-5 + 1e-5 |d|. The bf16 tolerance atol = rtol = 2^-7 does not hold
    where g_h cancels a large d: the plain version's first rounding, up to
    2^-8 |d|, survives into a small sum. Used by the card's checks, never
    on the main path."""
    got, want, d = (t.float().abs() for t in (got, want, dx_norm))
    return 2.0 ** -8 * (got + want) + (2.0 ** -8 + 2e-5) * d + 1e-5


def _check_rms_norm_args(x: torch.Tensor, weight: torch.Tensor,
                         a: Optional[torch.Tensor] = None,
                         b: Optional[torch.Tensor] = None) -> None:
    """The kernels' gate, in order dtypes, shapes, devices, layout: x and
    weight, and a and b where given (the residual a, or the backward's
    gradients), which must match x."""
    dtype, shape = x.dtype, x.shape
    others = [t for t in (a, b) if t is not None]
    if dtype not in _DTYPES:
        raise TypeError(
            f"rms_norm kernel takes float32 or bfloat16, got {dtype}")
    for t in (weight, *others):
        if t.dtype != dtype:
            raise TypeError(f"dtype {t.dtype} differs from x dtype {dtype}")
    if not shape or x.numel() == 0:
        raise ValueError(f"rms_norm needs a non-empty tensor, got {shape}")
    if weight.shape != shape[-1:]:
        raise ValueError(
            f"weight shape {tuple(weight.shape)} does not match the last "
            f"axis of x {tuple(shape)}")
    for t in others:
        if t.shape != shape:
            raise ValueError(f"shape {tuple(t.shape)} differs from x's "
                             f"{tuple(shape)}")
    index = x.get_device()
    for t in (x, weight, *others):
        if not t.is_cuda:
            raise ValueError(f"rms_norm kernel takes CUDA tensors, got "
                             f"{t.device}")
        if t.get_device() != index:
            raise ValueError(f"x on {x.device} but an operand on {t.device}")
        if not t.is_contiguous():
            raise ValueError("rms_norm kernel takes contiguous tensors")


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   a: Optional[torch.Tensor] = None):
    """K1 on the card: y, or (h, y) with h = x + a when a is given."""
    _check_rms_norm_args(x, weight, a)
    E = x.shape[-1]
    y = torch.empty_like(x)
    h = None if a is None else torch.empty_like(x)
    ptrs = (x.data_ptr(), 0 if a is None else a.data_ptr(),
            weight.data_ptr(), 0 if h is None else h.data_ptr(),
            y.data_ptr())
    err = _launch(x.get_device(), _rms_fn("rms_norm_forward"), *ptrs,
                  x.numel() // E, E, eps, _DTYPES[x.dtype],
                  _vec(E, x, *ptrs))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    if a is None:
        rms_norm.launches += 1
        return y
    add_rms_norm.launches += 1
    return h, y


def _rms_norm_bwd_cuda(h: torch.Tensor, weight: torch.Tensor,
                       g_y: torch.Tensor, g_h: Optional[torch.Tensor],
                       eps: float):
    """The backward kernel: (dx, dw), dx = g_h + the norm's dx, rounded
    once. Gradients arrive in whatever layout autograd made; they are made
    contiguous, not refused."""
    g_y = g_y.contiguous()
    g_h = None if g_h is None else g_h.contiguous()
    _check_rms_norm_args(h, weight, g_y, g_h)
    E = h.shape[-1]
    R = h.numel() // E
    blocks = _rms_fn("rms_norm_backward_blocks")(R)
    dx = torch.empty_like(h)
    dw = torch.empty_like(weight)
    part = torch.empty(blocks, E, dtype=torch.float32, device=h.device)
    ptrs = (h.data_ptr(), weight.data_ptr(), g_y.data_ptr(),
            0 if g_h is None else g_h.data_ptr(), dx.data_ptr(),
            dw.data_ptr())
    err = _launch(h.get_device(), _rms_fn("rms_norm_backward"), *ptrs,
                  part.data_ptr(), R, E, eps, _DTYPES[h.dtype],
                  _vec(E, h, *ptrs))
    if err != 0:
        raise RuntimeError(
            f"rms_norm backward kernel launch failed: CUDA error {err}")
    rms_norm.backward_launches += 1
    return dx, dw


def _norm_forward(x, a, weight, eps):
    """y (a None) or (h, y): the plain version on the CPU, else K1."""
    if x.is_cpu:
        if a is None:
            return _rms_norm_ref(x, weight, eps)
        return _add_rms_norm_ref(x, a, weight, eps)
    return _rms_norm_cuda(x, weight, eps, a)


def _norm_backward(h, weight, g_y, g_h, eps):
    """(dx, dw) of y = rms_norm(h) with h's own gradient g_h added to dx:
    on the CPU the plain backward and then the add autograd did, else the
    kernel."""
    if g_y is None:
        return g_h, None
    if h.is_cpu:
        dx, dw = _rms_norm_bwd(h, weight, g_y, eps)
        return (dx if g_h is None else dx + g_h), dw
    return _rms_norm_bwd_cuda(h, weight, g_y, g_h, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _norm_forward(x, None, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _norm_backward(x, weight, g, None, ctx.eps)
        return dx, dw, None


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, weight, eps):
        h, y = _norm_forward(x, a, weight, eps)
        ctx.save_for_backward(h, weight)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return h, y

    @staticmethod
    def backward(ctx, g_h, g_y):
        h, weight = ctx.saved_tensors
        dx, dw = _norm_backward(h, weight, g_y, g_h, ctx.eps)
        return dx, dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * weight over the last axis,
    differentiable in x and weight.

    CUDA tensors go through the hand-written kernel (``rms_norm.launches``
    counts its launches, ``rms_norm.backward_launches`` those of the
    backward kernel, which ``add_rms_norm`` shares); CPU tensors through
    the plain version."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _norm_forward(x, None, weight, eps)


def add_rms_norm(x: torch.Tensor, a: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, y): the residual h = x + a (in x's dtype, rounded as PyTorch's
    add rounds it) and y = rms_norm(h, weight, eps), differentiable in x, a
    and weight. x and a have one shape and dtype.

    CUDA tensors go through one launch of the RMSNorm kernel in its
    residual form (``add_rms_norm.launches``), whose y is the plain
    kernel's y on h bit for bit; the backward kernel adds h's own gradient
    to dx and returns it for x and a. CPU tensors go through the plain
    version."""
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad
                                    or weight.requires_grad):
        return _AddRMSNorm.apply(x, a, weight, eps)
    return _norm_forward(x, a, weight, eps)


rms_norm.launches = 0
rms_norm.backward_launches = 0
add_rms_norm.launches = 0

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
