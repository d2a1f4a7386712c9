"""Compute ops: hand-written CUDA kernels beside their plain PyTorch
versions (counterpart: ``ray_tpu/ops``)."""

from .attention import (  # noqa: F401
    attention_reference, decode_attention, masked_gqa_attention,
)
from .fused import rms_norm  # noqa: F401
from .paged_attention import PagePool, paged_decode_attention  # noqa: F401
