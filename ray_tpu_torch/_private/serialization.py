"""Serialization: cloudpickle control plane + zero-copy buffer data plane.

Equivalent role to the reference's ``SerializationContext`` (reference:
``python/ray/serialization.py:88`` — cloudpickle with pickle5 out-of-band
buffers for zero-copy numpy, plus custom serializers for handles/refs). The
port's copy of ``ray_tpu/_private/serialization.py``, with ``torch.Tensor``
in place of the JAX package's device arrays: a tensor leaves by one
device-to-host copy (none for a contiguous CPU tensor) into an out-of-band
buffer of its raw bytes, so large tensors never pass through pickle's byte
stream, and its placeholder records the torch dtype (bf16 has no numpy
dtype), the shape and the device type it came from. It comes back through
``torch.from_numpy`` on that buffer and then ``.to(device)``: a CUDA tensor
on the card, raising where there is none, a CPU tensor on the CPU.

Wire format of a serialized object:
    header  = pickle.dumps(obj, protocol=5, buffer_callback=...)
    buffers = list of raw PickleBuffer payloads (zero-copy views when possible)
"""

from __future__ import annotations

import pickle
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import cloudpickle
import numpy as np

from .. import default_device


@dataclass
class SerializedObject:
    header: bytes
    buffers: List[pickle.PickleBuffer]
    # ObjectIDs (binary) of ObjectRefs pickled inside this object. Not part
    # of the wire format: the serializing process reports them to its ref
    # counter so contained refs keep their targets alive (reference:
    # reference_count.h nested/contained refs, AddNestedObjectIds).
    contained_refs: List[bytes] = field(default_factory=list)

    def total_bytes(self) -> int:
        return len(self.header) + sum(b.raw().nbytes for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten to one byte string (for cross-process transport)."""
        parts = [len(self.header).to_bytes(8, "little"), self.header,
                 len(self.buffers).to_bytes(4, "little")]
        for b in self.buffers:
            raw = b.raw()
            parts.append(raw.nbytes.to_bytes(8, "little"))
            parts.append(raw.tobytes() if raw.ndim else bytes(raw))
        return b"".join(parts)

    def framed_size(self) -> int:
        """Size of the to_bytes() framing without materializing it."""
        return (8 + len(self.header) + 4
                + sum(8 + b.raw().nbytes for b in self.buffers))

    def write_into(self, view: memoryview) -> int:
        """Write the to_bytes() layout directly into ``view`` (e.g. a shm
        arena slot) — one copy from source buffers instead of two."""
        off = 0

        def w(b: bytes):
            nonlocal off
            view[off:off + len(b)] = b
            off += len(b)

        w(len(self.header).to_bytes(8, "little"))
        w(self.header)
        w(len(self.buffers).to_bytes(4, "little"))
        for b in self.buffers:
            raw = b.raw()
            w(raw.nbytes.to_bytes(8, "little"))
            try:
                flat = raw.cast("B")
            except TypeError:
                flat = memoryview(raw.tobytes())
            view[off:off + raw.nbytes] = flat
            off += raw.nbytes
        return off

    @classmethod
    def from_bytes(cls, data: bytes) -> "SerializedObject":
        view = memoryview(data)
        hlen = int.from_bytes(view[:8], "little")
        header = bytes(view[8 : 8 + hlen])
        off = 8 + hlen
        nbuf = int.from_bytes(view[off : off + 4], "little")
        off += 4
        buffers = []
        for _ in range(nbuf):
            blen = int.from_bytes(view[off : off + 8], "little")
            off += 8
            buffers.append(pickle.PickleBuffer(view[off : off + blen]))
            off += blen
        return cls(header, buffers)


class _TensorPlaceholder:
    """Pickled stand-in for a torch.Tensor; its bytes travel out-of-band."""

    __slots__ = ("dtype", "shape", "buffer_index", "device_type")

    def __init__(self, dtype, shape, buffer_index, device_type):
        self.dtype = dtype              # torch dtype name, e.g. "bfloat16"
        self.shape = shape
        self.buffer_index = buffer_index
        self.device_type = device_type  # "cuda" or "cpu"


class SerializationContext:
    """Process-wide serializer with custom-type hooks."""

    def __init__(self):
        self._custom: Dict[Type, Tuple[Callable, Callable]] = {}

    def register_custom_serializer(
        self, cls: Type, serializer: Callable, deserializer: Callable
    ) -> None:
        self._custom[cls] = (serializer, deserializer)

    # -- serialize ------------------------------------------------------------
    def serialize(self, value: Any) -> SerializedObject:
        from ..object_ref import ObjectRef

        buffers: List[pickle.PickleBuffer] = []
        oob_arrays: List[Any] = []  # tensors exported out-of-band
        contained: List[bytes] = []

        def reducer_override(obj):
            custom = self._custom.get(type(obj))
            if custom is not None:
                ser, de = custom
                payload = ser(obj)
                return (_apply_deserializer, (de, payload))
            if isinstance(obj, ObjectRef):
                # Record and fall through to ObjectRef.__reduce__.
                contained.append(obj.id.binary())
                return NotImplemented
            # No tensor exists in a process that has not imported torch.
            torch = sys.modules.get("torch")
            if torch is not None and isinstance(obj, torch.Tensor):
                idx = len(oob_arrays)
                oob_arrays.append(obj)
                return (
                    _TensorPlaceholder,
                    (str(obj.dtype).removeprefix("torch."), tuple(obj.shape),
                     idx, obj.device.type),
                )
            return NotImplemented

        pickler = _Pickler(
            buffers.append, reducer_override, protocol=5
        )
        header = pickler.dumps(value)
        # Tensors: append host views after the in-band buffers so
        # buffer_index in the placeholder is len(inband)+idx — we instead
        # record absolute indices by appending now and patching placeholders
        # at unpickle time via the recorded order (placeholders store their
        # position in oob_arrays; absolute index = n_inband + position).
        n_inband = len(buffers)
        for t in oob_arrays:
            buffers.append(pickle.PickleBuffer(_tensor_bytes(t)))
        return SerializedObject(
            header=_prefix_oob_base(header, n_inband), buffers=buffers,
            contained_refs=contained,
        )

    # -- deserialize ----------------------------------------------------------
    def deserialize(self, serialized: SerializedObject) -> Any:
        oob_base, header = _strip_oob_base(serialized.header)
        value = pickle.loads(header, buffers=serialized.buffers)
        return _restore_tensors(value, serialized.buffers, oob_base)


class _Pickler(cloudpickle.CloudPickler):
    def __init__(self, buffer_callback, reducer_override_fn, protocol=5):
        import io

        self._file = io.BytesIO()
        super().__init__(self._file, protocol=protocol, buffer_callback=buffer_callback)
        self._reducer_override_fn = reducer_override_fn

    def reducer_override(self, obj):
        reduced = self._reducer_override_fn(obj)
        if reduced is not NotImplemented:
            return reduced
        # Fall back to cloudpickle's own reducers (functions, classes, ...).
        return super().reducer_override(obj)

    def dumps(self, value) -> bytes:
        self.dump(value)
        return self._file.getvalue()


def _tensor_bytes(t: "torch.Tensor") -> np.ndarray:
    """The tensor's raw bytes as a flat uint8 host array: one
    device-to-host copy for a CUDA tensor, none for a contiguous CPU one."""
    import torch

    host = t.detach().cpu().contiguous()
    return host.reshape(-1).view(torch.uint8).numpy()


def _tensor_from(buf, placeholder: "_TensorPlaceholder") -> "torch.Tensor":
    import torch

    dtype = getattr(torch, placeholder.dtype)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {placeholder.dtype!r}")
    raw = np.frombuffer(buf, dtype=np.uint8)
    if raw.size == 0:  # an empty array has no element stride to view
        host = torch.empty(placeholder.shape, dtype=dtype)
    else:
        if not raw.flags.writeable:  # a tensor must not alias read-only bytes
            raw = raw.copy()
        host = torch.from_numpy(raw).view(dtype).reshape(placeholder.shape)
    if placeholder.device_type == "cpu":
        return host
    return host.to(default_device(placeholder.device_type))


def _apply_deserializer(de, payload):
    return de(payload)


_OOB_MAGIC = b"RTOB"


def _prefix_oob_base(header: bytes, n_inband: int) -> bytes:
    return _OOB_MAGIC + n_inband.to_bytes(4, "little") + header


def _strip_oob_base(header: bytes) -> Tuple[int, bytes]:
    assert header[:4] == _OOB_MAGIC
    return int.from_bytes(header[4:8], "little"), header[8:]


def _restore_tensors(value, buffers, oob_base):
    """Walk the object graph replacing _TensorPlaceholder with tensors."""
    placeholder_found = _contains_placeholder(value)
    if not placeholder_found:
        return value

    def restore(obj, seen):
        if isinstance(obj, _TensorPlaceholder):
            return _tensor_from(buffers[oob_base + obj.buffer_index], obj)
        oid = id(obj)
        if oid in seen:
            return obj
        seen.add(oid)
        if isinstance(obj, list):
            for i, v in enumerate(obj):
                obj[i] = restore(v, seen)
            return obj
        if isinstance(obj, dict):
            for k in list(obj):
                obj[k] = restore(obj[k], seen)
            return obj
        if isinstance(obj, tuple):
            return tuple(restore(v, seen) for v in obj)
        if hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                setattr(obj, k, restore(v, seen))
            return obj
        return obj

    return restore(value, set())


def _contains_placeholder(value, depth=0) -> bool:
    if isinstance(value, _TensorPlaceholder):
        return True
    if depth > 6:
        return True  # deep graph: be conservative, walk it
    if isinstance(value, (list, tuple)):
        return any(_contains_placeholder(v, depth + 1) for v in value)
    if isinstance(value, dict):
        return any(_contains_placeholder(v, depth + 1) for v in value.values())
    if hasattr(value, "__dict__"):
        return any(_contains_placeholder(v, depth + 1) for v in vars(value).values())
    return False


_global_context: Optional[SerializationContext] = None


def get_context() -> SerializationContext:
    global _global_context
    if _global_context is None:
        _global_context = SerializationContext()
    return _global_context
