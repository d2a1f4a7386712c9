"""Vision model family (counterpart: ``ray_tpu/models/vision.py``): a
ResNet-style convnet of pre-activation residual blocks with GroupNorm,
global average pooling and a linear head.

``vision_apply`` keeps the JAX package's contract, images [N, H, W, C]
(NHWC), and runs in NCHW inside for ``F.conv2d`` (cuDNN on the card). The
parameters keep its keys, ``stage{s}`` a list of block dicts, but store
convolution kernels as [out, in, kh, kw] (OIHW) where the JAX package keeps
[kh, kw, in, out] (HWIO); ``vision_params_from_numpy`` carries its weights
across. Padding is XLA's SAME: at stride 2 on an even size a 3x3 kernel
pads 0 before and 1 after, which ``padding=1`` would not give, so the pads
are computed and applied explicitly.

Under a mesh the family trains data-parallel (``vision_param_shardings``):
every parameter replicated, the batch split over dp, the gradients
averaged over dp by the train step (``train.MeshTrainer``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import Device, default_device
from .._tree import tree_map
from ..parallel.mesh import P

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    widths: Tuple[int, ...] = (32, 64, 128)   # one stage per entry, stride 2
    blocks_per_stage: int = 2
    groups: int = 8                            # GroupNorm groups
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        for w in self.widths:
            g = min(self.groups, w)
            if w % g:
                raise ValueError(
                    f"width {w} not divisible by GroupNorm groups {g}; "
                    f"pick widths that are multiples of groups={self.groups}")


def init_vision_params(generator: torch.Generator, cfg: VisionConfig, *,
                       device: Device = None) -> Params:
    """He-normal convolutions (std sqrt(2 / (kh * kw * in))), unit GroupNorm
    scales, zero biases, an N(0, 0.01) head, drawn from ``generator`` on its
    own device and placed on ``device``; the JAX package's keys, the port's
    own draws and OIHW kernels."""
    dev = default_device(device)
    pd = cfg.param_dtype

    def randn(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)

    def conv(k, cin, cout):
        w = randn(cout, cin, k, k) * math.sqrt(2.0 / (k * k * cin))
        return w.to(device=dev, dtype=pd)

    def full(value, n):
        return torch.full((n,), value, dtype=pd, device=dev)

    params: Params = {"stem": conv(3, cfg.in_channels, cfg.widths[0])}
    cin = cfg.widths[0]
    for s, width in enumerate(cfg.widths):
        stage = []
        for b in range(cfg.blocks_per_stage):
            # GroupNorm1 acts on the block INPUT (cin channels,
            # pre-activation layout); everything after conv1 is `width`.
            block = {
                "conv1": conv(3, cin, width),
                "conv2": conv(3, width, width),
                "scale1": full(1.0, cin), "bias1": full(0.0, cin),
                "scale2": full(1.0, width), "bias2": full(0.0, width),
            }
            if cin != width or (b == 0 and s > 0):
                block["proj"] = conv(1, cin, width)
            stage.append(block)
            cin = width
        params[f"stage{s}"] = stage
    params["head_w"] = (randn(cfg.widths[-1], cfg.num_classes)
                        * 0.01).to(device=dev, dtype=pd)
    params["head_b"] = full(0.0, cfg.num_classes)
    return params


_CONVS = ("stem", "conv1", "conv2", "proj")


def vision_params_from_numpy(tree: Params, *, device: Device = None
                             ) -> Params:
    """The JAX package's vision parameters (numpy arrays, or anything
    ``np.asarray`` takes) as the port's: the same keys and lists, every
    convolution kernel turned from HWIO to OIHW."""
    dev = default_device(device)

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node, dtype=np.float32)
        if key in _CONVS:
            arr = arr.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(arr)).to(dev)

    return conv(tree)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of NCHW x, population
    variance, ``min(groups, c)`` groups (the JAX package's math)."""
    return F.group_norm(x, min(groups, x.shape[1]), scale.to(x.dtype),
                        bias.to(x.dtype), eps)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x NCHW, w OIHW, SAME padding."""
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


def _block(x: torch.Tensor, p: Params, cfg: VisionConfig,
           stride: int) -> torch.Tensor:
    """Pre-activation residual block (He 2016 v2)."""
    h = F.relu(_group_norm(x, p["scale1"], p["bias1"], cfg.groups))
    h = _conv(h, p["conv1"], stride)
    h = F.relu(_group_norm(h, p["scale2"], p["bias2"], cfg.groups))
    h = _conv(h, p["conv2"])
    if "proj" in p:
        x = _conv(x, p["proj"], stride)
    return x + h


def vision_apply(params: Params, images: Any,
                 cfg: VisionConfig) -> torch.Tensor:
    """images [N, H, W, C] (NHWC; a tensor, or anything ``torch.as_tensor``
    takes, moved to the parameters' device) -> logits [N, num_classes]."""
    x = torch.as_tensor(images, device=params["stem"].device)
    x = x.to(cfg.dtype).permute(0, 3, 1, 2)
    x = _conv(x, params["stem"])
    for s in range(len(cfg.widths)):
        for b, block in enumerate(params[f"stage{s}"]):
            stride = 2 if (b == 0 and s > 0) else 1
            x = _block(x, block, cfg, stride)
    x = x.mean(dim=(2, 3))  # global average pool
    return x @ params["head_w"].to(x.dtype) + params["head_b"].to(x.dtype)


def _labels(batch: Dict[str, Any], logits: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(batch["labels"], device=logits.device).long()


def vision_loss(params: Params, batch: Dict[str, Any],
                cfg: VisionConfig) -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` [N] under the logits of
    ``batch["images"]``."""
    logits = vision_apply(params, batch["images"], cfg)
    labels = _labels(batch, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(labels.shape[0], device=logits.device),
                 labels].mean()


def vision_accuracy(params: Params, batch: Dict[str, Any],
                    cfg: VisionConfig) -> torch.Tensor:
    logits = vision_apply(params, batch["images"], cfg)
    return (logits.argmax(-1) == _labels(batch, logits)).float().mean()


def vision_param_shardings(cfg: VisionConfig, mesh) -> Params:
    """dp training: every parameter replicated (P()), the batch split over
    dp by the caller; convolutions this small are compute-bound per
    example, so dp is the first axis to use."""
    shapes = init_vision_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    return tree_map(lambda _: P(), shapes)
