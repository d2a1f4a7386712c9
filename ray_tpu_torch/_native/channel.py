"""ctypes wrapper for the native SPSC streaming channel (channel.cc).

Reference counterpart: streaming/python's DataWriter/DataReader over the
C++ channel layer. One writer process, one reader process per channel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from .build import load_native_library


class ChannelClosed(Exception):
    """Writer closed and the ring is drained."""


class ChannelTimeout(Exception):
    pass


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_native_library("channel")
        if lib is None:
            raise ImportError("native channel library unavailable")
        lib.tch_create.restype = ctypes.c_void_p
        lib.tch_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tch_open.restype = ctypes.c_void_p
        lib.tch_open.argtypes = [ctypes.c_char_p]
        lib.tch_write.restype = ctypes.c_int
        lib.tch_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64]
        lib.tch_read.restype = ctypes.c_int64
        lib.tch_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.tch_pending_bytes.restype = ctypes.c_uint64
        lib.tch_pending_bytes.argtypes = [ctypes.c_void_p]
        lib.tch_mark_reader_dead.argtypes = [ctypes.c_void_p]
        lib.tch_reader_dead.restype = ctypes.c_int
        lib.tch_reader_dead.argtypes = [ctypes.c_void_p]
        lib.tch_total_messages.restype = ctypes.c_uint64
        lib.tch_total_messages.argtypes = [ctypes.c_void_p]
        lib.tch_close_write.argtypes = [ctypes.c_void_p]
        lib.tch_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
    return _lib


class ChannelWriter:
    def __init__(self, name: str, capacity: int = 8 * 1024 * 1024):
        lib = _load()
        self._lib = lib
        self._h = lib.tch_create(name.encode(), capacity)
        if not self._h:
            raise OSError(f"channel create failed: {name}")
        self.name = name

    def write(self, payload: bytes, timeout: Optional[float] = 30.0) -> None:
        if not self._h:
            raise ChannelClosed(self.name)  # guard: NULL into C segfaults
        rc = self._lib.tch_write(
            self._h, payload, len(payload),
            0 if timeout is None else int(timeout * 1000))
        if rc == 0:
            return
        if rc == -1:
            raise ChannelTimeout(f"ring full for {timeout}s: {self.name}")
        if rc == -2:
            raise ChannelClosed(self.name)
        raise ValueError(f"message larger than channel capacity: {self.name}")

    def pending_bytes(self) -> int:
        if not self._h:
            raise ChannelClosed(self.name)
        return self._lib.tch_pending_bytes(self._h)

    def reader_dead(self) -> bool:
        """Did the consumer declare it will never drain again?"""
        if not self._h:
            raise ChannelClosed(self.name)
        return bool(self._lib.tch_reader_dead(self._h))

    def close(self, unlink: bool = False) -> None:
        """Reader normally owns the unlink; pass unlink=True when no reader
        ever attached (failed handshake) so the segment doesn't leak."""
        if self._h:
            self._lib.tch_close_write(self._h)
            self._lib.tch_close(self._h, 1 if unlink else 0)
            self._h = None


class ChannelReader:
    def __init__(self, name: str, open_timeout: float = 30.0):
        import time

        lib = _load()
        self._lib = lib
        deadline = time.monotonic() + open_timeout
        self._h = lib.tch_open(name.encode())
        while not self._h and time.monotonic() < deadline:
            time.sleep(0.02)          # writer may not have created it yet
            self._h = lib.tch_open(name.encode())
        if not self._h:
            raise OSError(f"channel open timed out: {name}")
        self.name = name
        self._buf = ctypes.create_string_buffer(1 << 20)

    def read(self, timeout: Optional[float] = 30.0) -> bytes:
        if not self._h:
            raise ChannelClosed(self.name)  # guard a concurrent close()
        needed = ctypes.c_uint64(0)
        while True:
            n = self._lib.tch_read(
                self._h, self._buf, len(self._buf),
                0 if timeout is None else int(timeout * 1000),
                ctypes.byref(needed))
            if n >= 0:
                return self._buf.raw[:n]
            if n == -1:
                raise ChannelTimeout(self.name)
            if n == -2:
                raise ChannelClosed(self.name)
            # -3: grow the read buffer to the reported message size
            self._buf = ctypes.create_string_buffer(int(needed.value))

    def pending_bytes(self) -> int:
        if not self._h:
            raise ChannelClosed(self.name)
        return self._lib.tch_pending_bytes(self._h)

    def mark_dead(self) -> None:
        """Consumer error path: unblock a writer waiting on ring space by
        declaring this reader permanently gone."""
        if self._h:
            self._lib.tch_mark_reader_dead(self._h)

    def total_messages(self) -> int:
        if not self._h:
            raise ChannelClosed(self.name)
        return self._lib.tch_total_messages(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.tch_close(self._h, 1)  # reader owns the unlink
            self._h = None
