"""JobWorker actor + two-transport channel protocol
(reference: streaming/python/runtime/worker.py + streaming/src/channel.h,
data_writer/data_reader, ring_buffer, flow_control).

One actor per operator instance. Each edge negotiates its transport at
wiring time:

  native — co-located pairs stream pickled batches through a C++
    shared-memory SPSC ring (``_native/src/channel.cc``, the reference's
    plasma-queue channel): no per-batch RPC, backpressure = ring capacity,
    EOF ordering by ring close + drain-thread join.
  actor  — cross-host fallback: ``push(channel, seq, items)`` calls with a
    credit budget (max unacked batches); large batches ride the object
    store as refs. A sender with no credits blocks on its oldest ack.

EOF markers propagate when all of an instance's input channels are
exhausted; stateful operators (reduce) flush on EOF.

A batch of CUDA tensors pickles through torch's storage reducer on either
transport: a copy to the host on the sender, and one back to the card where
the batch is unpickled (on the native ring, the consumer's drain thread).
An item whose pickle is larger than the ring raises ValueError.
Keyed routing hashes ``repr(key)``, so keys are Python values (ints,
strings), not tensors, whose ``repr`` carries their device.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch

from .graph import BROADCAST, FORWARD, KEY_HASH, REBALANCE, JobGraph

BATCH_SIZE = 256
CHANNEL_CREDITS = 4  # max unacked batches per channel before sender blocks
# Batches whose payload is (approximately) larger than this travel as object
# store refs instead of pickled actor-call bodies: the blob moves through the
# shm arena / native C++ transfer plane (reference: streaming/src/channel.h
# data plane on plasma queues), and the actor call carries only the ref.
PUSH_INLINE_MAX = 32 * 1024
# Native-ring backpressure probe window: a full ring with zero reader
# progress across two consecutive windows means the consumer is dead.
BACKPRESSURE_WINDOW_S = 60.0


def _approx_nbytes(items: List[Any]) -> int:
    """Cheap payload-size estimate (sampled; no serialization)."""
    n = len(items)
    if n == 0:
        return 0
    sample = items if n <= 32 else items[:: max(1, n // 32)][:32]
    total = 0
    for x in sample:
        nb = getattr(x, "nbytes", None)
        if nb is not None:
            total += int(nb)
        elif isinstance(x, (bytes, bytearray, str)):
            total += len(x)
        elif isinstance(x, tuple) and len(x) == 2:
            v = x[1]
            total += int(getattr(v, "nbytes", 0) or 64)
        else:
            total += 64
    return total * n // len(sample)


def _stable_hash(key: Any) -> int:
    """Process-stable key hash (Python's hash() is salted per process, which
    would break cross-process key routing)."""
    import zlib

    if isinstance(key, bytes):
        data = key
    elif isinstance(key, str):
        data = key.encode()
    else:
        data = repr(key).encode()
    return zlib.crc32(data)


def _chan_shm_name(channel_id: str) -> str:
    import hashlib

    digest = hashlib.blake2b(channel_id.encode(), digest_size=10).hexdigest()
    return f"rttch-{digest}"


class _OutChannel:
    """Sender side of one edge instance pair (reference: ProducerChannel).

    Two transports, negotiated at wiring time:
      native — a shared-memory SPSC ring (``_native/src/channel.cc``, the
        reference's plasma-queue channel): batches are pickled straight
        into the ring; backpressure IS the ring capacity; no per-batch RPC
        at all. Used when producer and consumer share a host (the shm
        open succeeds on the consumer side).
      actor  — pickled push() calls with credit-based acks, large batches
        riding the object store as refs. The cross-host fallback.
    """

    def __init__(self, dst_handle, channel_id: str):
        self.dst = dst_handle
        self.channel_id = channel_id
        self.seq = 0
        self.inflight: deque = deque()  # (ack ref, data ref | None)
        self._writer = None
        # The transport this edge took at wiring time (kept after EOF,
        # when the writer is gone).
        self.native = False
        try:
            from .._native.channel import ChannelWriter

            name = _chan_shm_name(channel_id)
            writer = ChannelWriter(name, capacity=8 * 1024 * 1024)
        except Exception:  # noqa: BLE001 - lib unavailable: actor transport
            return
        try:
            ok = ray_tpu_torch.get(
                self.dst.open_native_channel.remote(channel_id, name))
        except Exception:  # noqa: BLE001 - consumer dead/unreachable
            ok = False
        if ok:
            self._writer = writer
            self.native = True
        else:
            writer.close(unlink=True)  # no reader ever attached

    def _write_with_backpressure(self, payload: bytes) -> None:
        """Block indefinitely under backpressure — a slow consumer (or one
        itself blocked on ITS downstream) is normal operation, exactly like
        the actor path blocking on its oldest ack. The only escape is the
        consumer explicitly declaring itself dead (drain thread's error
        path sets the ring's reader_dead flag) — an explicit signal, not a
        progress heuristic, so cascaded backpressure can never be
        misdiagnosed as death."""
        from .._native.channel import ChannelClosed, ChannelTimeout

        while True:
            try:
                self._writer.write(payload, timeout=BACKPRESSURE_WINDOW_S)
                return
            except ChannelTimeout:
                if self._writer.reader_dead():
                    raise ChannelClosed(
                        f"consumer of {self.channel_id} died")

    def send(self, items: List[Any]) -> None:
        if self._writer is not None:
            import pickle as _pickle

            payload = _pickle.dumps(items, protocol=5)
            try:
                self._write_with_backpressure(payload)
            except ValueError:
                # Batch pickles larger than the ring: split and retry so
                # ordering stays on the ring. A single unsplittable item
                # bigger than the ring is a genuine error.
                if len(items) <= 1:
                    raise
                mid = len(items) // 2
                self.send(items[:mid])
                self.send(items[mid:])
                return
            self.seq += 1
            return
        if len(self.inflight) >= CHANNEL_CREDITS:
            # Out of credits: block on the oldest ack (backpressure).
            self._ack_oldest()
        payload: Any = items
        data_ref = None
        if _approx_nbytes(items) > PUSH_INLINE_MAX:
            # Zero-copy data plane: seal the batch in the object store and
            # push only the ref; the consumer's node stages it via the
            # native transfer plane and the consumer reads it zero-copy.
            data_ref = ray_tpu_torch.put(items)
            payload = data_ref
        self.inflight.append(
            (self.dst.push.remote(self.channel_id, self.seq, payload),
             data_ref))
        self.seq += 1

    def _ack_oldest(self) -> None:
        ack, data_ref = self.inflight.popleft()
        ray_tpu_torch.get(ack)
        if data_ref is not None:
            # The ack is the credit return: the consumer has processed the
            # batch, so the sealed blob can be evicted everywhere.
            ray_tpu_torch.free([data_ref])

    def send_eof(self) -> None:
        self.flush()
        if self._writer is not None:
            # Close the ring first: the consumer's push_eof joins its drain
            # thread, which exits only after consuming the full backlog —
            # so EOF can never overtake in-flight ring data.
            self._writer.close()
            self._writer = None
        ray_tpu_torch.get(self.dst.push_eof.remote(self.channel_id))

    def flush(self) -> None:
        while self.inflight:
            self._ack_oldest()


class JobWorker:
    """One operator instance (reference: runtime/worker.py JobWorker)."""

    def __init__(self, op_kind: str, fn_blob, instance_index: int,
                 num_instances: int):
        import cloudpickle

        self.kind = op_kind
        self.fn: Optional[Callable] = (
            cloudpickle.loads(fn_blob) if fn_blob is not None else None)
        self.index = instance_index
        self.num_instances = num_instances
        self._lock = threading.Lock()
        # input channels
        self._expected_inputs: set = set()
        self._eof_inputs: set = set()
        # output routing: list of (partition, [instance _OutChannel...])
        self._outputs: List[Tuple[str, List[_OutChannel]]] = []
        self._rr = 0
        # operator state
        self._reduce_state: Dict[Any, Any] = {}
        self._sink_results: List[Any] = []
        self._out_buffers: Dict[int, List[Any]] = defaultdict(list)
        self._native_readers: Dict[str, Tuple[Any, Any]] = {}
        self._native_errors: Dict[str, str] = {}  # channel -> cause traceback
        self.records_in = 0
        self.records_out = 0

    # ---- wiring (called by the driver before the run) ----

    def add_output(self, partition: str, dst_handles: List[Any],
                   channel_prefix: str) -> None:
        chans = [
            _OutChannel(h, f"{channel_prefix}:{self.index}->{j}")
            for j, h in enumerate(dst_handles)
        ]
        self._outputs.append((partition, chans))

    def expect_input(self, channel_id: str) -> None:
        self._expected_inputs.add(channel_id)

    # ---- data plane ----

    def open_native_channel(self, channel_id: str, shm_name: str) -> bool:
        """Consumer half of the native-transport handshake: attach to the
        producer's shm ring and drain it on a dedicated thread (the
        reference's DataReader loop). Returns False when the segment is
        unreachable (producer on another host) — sender falls back to
        actor-call pushes."""
        import pickle as _pickle

        try:
            from .._native.channel import (
                ChannelClosed, ChannelReader, ChannelTimeout,
            )

            # The writer created the segment BEFORE this call, so a local
            # open succeeds immediately and ENOENT means cross-host — a
            # long retry here would only stall wiring (0.5s covers fs
            # visibility jitter, nothing more).
            reader = ChannelReader(shm_name, open_timeout=0.5)
        except Exception:  # noqa: BLE001 - cross-host or lib unavailable
            return False

        def drain():
            while True:
                try:
                    items = _pickle.loads(reader.read(timeout=60.0))
                    with self._lock:
                        # Inside the try: a user-fn or downstream-send
                        # failure must be RECORDED, not silently end the
                        # thread (push_eof raises on the flag — the actor
                        # path surfaces the same error via its ack).
                        self._process(items)
                except ChannelTimeout:
                    continue        # idle source; the ring is still live
                except ChannelClosed:
                    return
                except Exception:  # noqa: BLE001 - fn error/corrupt frame
                    import traceback

                    traceback.print_exc()
                    # Keep the formatted cause: push_eof re-raises with it,
                    # so a user-fn bug surfaces as ITS traceback instead of
                    # an opaque "reader failed mid-stream".
                    self._native_errors[channel_id] = traceback.format_exc()
                    reader.mark_dead()  # unblock a backpressured producer
                    return

        t = threading.Thread(target=drain, daemon=True,
                             name=f"chan-{channel_id[-12:]}")
        t.start()
        self._native_readers[channel_id] = (reader, t)
        return True

    def push(self, channel_id: str, seq: int, items: List[Any]) -> int:
        """Receive one batch; process synchronously (the actor's ordered
        queue is the inbound buffer; credits bound its depth)."""
        with self._lock:
            self._process(items)
        return seq  # ack

    def push_eof(self, channel_id: str) -> bool:
        native = self._native_readers.pop(channel_id, None)
        if native is not None:
            # The sender closed the ring before this call; the drain thread
            # exits once the backlog is fully consumed. Joining it here
            # guarantees EOF ordering behind every data batch.
            reader, thread = native
            thread.join(timeout=300.0)
            if thread.is_alive():
                # Join timed out: closing would unmap the ring under the
                # live drain thread (segfault). Leak the mapping instead
                # and surface the stall.
                raise RuntimeError(
                    f"native channel {channel_id} still draining after "
                    f"300s; refusing EOF")
            reader.close()
            cause = self._native_errors.pop(channel_id, None)
            if cause:
                raise RuntimeError(
                    f"native channel {channel_id} reader failed mid-stream; "
                    f"cause:\n{cause}")
        with self._lock:
            self._eof_inputs.add(channel_id)
            if self._eof_inputs >= self._expected_inputs:
                self._on_all_inputs_done()
        return True

    def inject(self, items: List[Any]) -> None:
        """Source path: driver feeds the source instances directly."""
        with self._lock:
            self._process(items)

    def finish(self) -> None:
        """Source EOF from the driver."""
        with self._lock:
            self._on_all_inputs_done()

    # ---- operator semantics ----

    def _process(self, items: List[Any]) -> None:
        self.records_in += len(items)
        kind, fn = self.kind, self.fn
        if kind in ("source", "key_by"):
            out = items if kind == "source" else [(fn(x), x) for x in items]
            self._emit(out)
        elif kind == "map":
            self._emit([fn(x) for x in items])
        elif kind == "flat_map":
            out: List[Any] = []
            for x in items:
                out.extend(fn(x))
            self._emit(out)
        elif kind == "filter":
            self._emit([x for x in items if fn(x)])
        elif kind == "reduce":
            # items arrive as (key, value); state holds the running reduction
            for key, value in items:
                if key in self._reduce_state:
                    self._reduce_state[key] = fn(self._reduce_state[key], value)
                else:
                    self._reduce_state[key] = value
        elif kind == "union":
            # Pass-through merge point: records from every upstream edge
            # land here and continue downstream interleaved
            # (reference: datastream.py union -> UnionStream).
            self._emit(list(items))
        elif kind == "sink":
            for x in items:
                if fn is not None:
                    fn(x)
                self._sink_results.append(x)
        else:
            raise ValueError(f"unknown operator kind {kind!r}")

    def _on_all_inputs_done(self) -> None:
        if self.kind == "reduce":
            # flush final (key, aggregate) pairs downstream
            self._emit(list(self._reduce_state.items()))
            self._reduce_state = {}
        self._flush_buffers()
        for _, chans in self._outputs:
            for ch in chans:
                ch.send_eof()

    def _emit(self, items: List[Any]) -> None:
        if not items:
            return
        self.records_out += len(items)
        for partition, chans in self._outputs:
            n = len(chans)
            if partition == BROADCAST:
                for ch in chans:
                    ch.send(list(items))
                continue
            if partition == KEY_HASH:
                groups: Dict[int, List[Any]] = defaultdict(list)
                for kv in items:
                    groups[_stable_hash(kv[0]) % n].append(kv)
                for j, group in groups.items():
                    chans[j].send(group)
                continue
            # forward/rebalance: round-robin batches
            chans[self._rr % n].send(list(items))
            self._rr += 1

    def _flush_buffers(self) -> None:
        for _, chans in self._outputs:
            for ch in chans:
                ch.flush()

    # ---- results / stats ----

    def sink_results(self) -> List[Any]:
        return list(self._sink_results)

    def stats(self) -> Dict[str, int]:
        return {"records_in": self.records_in, "records_out": self.records_out}

    def transports(self) -> Dict[str, str]:
        """Each output channel's transport, ``"native"`` or ``"actor"``."""
        return {ch.channel_id: "native" if ch.native else "actor"
                for _, chans in self._outputs for ch in chans}

    def ready(self) -> bool:
        return True
