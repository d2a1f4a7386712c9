"""DataStream API (reference: streaming/python/datastream.py).

    ctx = StreamingContext()
    (ctx.from_collection(lines)
        .flat_map(str.split)
        .key_by(lambda w: w)
        .reduce(lambda a, b: a + b)   # pairs are (key, count) after count_by
        .sink())
    results = ctx.submit()

Operators chain into a JobGraph; ``submit()`` materializes JobWorker actors,
wires credit-based channels, streams the source collection through, and
returns the sink's collected output.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional

import cloudpickle

import ray_tpu_torch

from .graph import (
    BROADCAST, FORWARD, KEY_HASH, REBALANCE, Edge, JobGraph, Operator,
)
from .worker import BATCH_SIZE, JobWorker


class DataStream:
    def __init__(self, ctx: "StreamingContext", op_id: int, keyed: bool = False):
        self._ctx = ctx
        self._op_id = op_id
        self._keyed = keyed

    def _chain(self, kind: str, fn: Optional[Callable], parallelism: int,
               partition: str, keyed: bool = False) -> "DataStream":
        # broadcast() overrides the partition of the NEXT edge regardless of
        # which operator follows (map/filter/sink/...).
        partition = getattr(self, "_force_partition", partition)
        op = self._ctx._add_op(kind, fn, parallelism)
        self._ctx.graph.add_edge(self._op_id, op.op_id, partition)
        return DataStream(self._ctx, op.op_id, keyed)

    def _default_partition(self) -> str:
        return KEY_HASH if self._keyed else REBALANCE

    def map(self, fn: Callable, parallelism: int = 1) -> "DataStream":
        return self._chain("map", fn, parallelism, self._default_partition())

    def flat_map(self, fn: Callable, parallelism: int = 1) -> "DataStream":
        return self._chain("flat_map", fn, parallelism,
                           self._default_partition())

    def filter(self, fn: Callable, parallelism: int = 1) -> "DataStream":
        return self._chain("filter", fn, parallelism,
                           self._default_partition())

    def key_by(self, key_fn: Callable, parallelism: int = 1) -> "DataStream":
        """Emit (key, value) pairs; downstream sees hash-partitioned keys."""
        return self._chain("key_by", key_fn, parallelism,
                           self._default_partition(), keyed=True)

    def reduce(self, fn: Callable, parallelism: int = 1) -> "DataStream":
        """Keyed running reduction; flushes (key, aggregate) pairs at EOF."""
        if not self._keyed:
            raise ValueError("reduce requires key_by upstream")
        return self._chain("reduce", fn, parallelism, KEY_HASH, keyed=True)

    def union(self, *streams: "DataStream",
              parallelism: int = 1) -> "DataStream":
        """Merge this stream with others into one interleaved stream
        (reference: datastream.py:197 union). The result is keyed only if
        every input is keyed (so a downstream reduce stays legal)."""
        for s in streams:
            if s._ctx is not self._ctx:
                raise ValueError("union requires streams from one context")
        keyed = self._keyed and all(s._keyed for s in streams)
        op = self._ctx._add_op("union", None, parallelism)
        for s in (self, *streams):
            partition = getattr(s, "_force_partition",
                                s._default_partition())
            self._ctx.graph.add_edge(s._op_id, op.op_id, partition)
        return DataStream(self._ctx, op.op_id, keyed)

    def broadcast(self) -> "DataStream":
        out = DataStream(self._ctx, self._op_id, self._keyed)
        out._force_partition = BROADCAST
        return out

    def sink(self, fn: Optional[Callable] = None,
             parallelism: int = 1) -> "DataStream":
        s = self._chain("sink", fn, parallelism, self._default_partition())
        self._ctx._sinks.append(s._op_id)
        return s


class StreamingContext:
    def __init__(self, batch_size: int = BATCH_SIZE):
        import uuid

        self.graph = JobGraph()
        # Channel ids embed a job-unique component: shm channel names are
        # hashes of the channel id, and two concurrent jobs with colliding
        # ids would unlink/attach each other's live rings.
        self._job_uid = uuid.uuid4().hex[:10]
        self._op_counter = itertools.count()
        self._sources: List[tuple] = []  # (op_id, iterable)
        self._sinks: List[int] = []
        self.batch_size = batch_size
        self._workers: Dict[int, List[Any]] = {}

    def _add_op(self, kind: str, fn: Optional[Callable],
                parallelism: int) -> Operator:
        op = Operator(next(self._op_counter), kind, fn,
                      parallelism=max(parallelism, 1))
        self.graph.add_operator(op)
        return op

    def from_collection(self, items: Iterable[Any],
                        parallelism: int = 1) -> DataStream:
        op = self._add_op("source", None, parallelism)
        self._sources.append((op.op_id, items))
        return DataStream(self, op.op_id)

    # ---- physical deployment ----

    def _deploy(self) -> None:
        worker_cls = ray_tpu_torch.remote(num_cpus=0)(JobWorker)
        for op_id, op in self.graph.operators.items():
            blob = cloudpickle.dumps(op.fn) if op.fn is not None else None
            self._workers[op_id] = [
                worker_cls.remote(op.kind, blob, i, op.parallelism)
                for i in range(op.parallelism)
            ]
        ray_tpu_torch.get([w.ready.remote()
                     for ws in self._workers.values() for w in ws])
        # wire edges: senders learn handles, receivers learn channel ids
        for eidx, edge in enumerate(self.graph.edges):
            src_ws = self._workers[edge.src_id]
            dst_ws = self._workers[edge.dst_id]
            # The edge index keeps channel ids unique even for duplicate
            # (src, dst) pairs — e.g. s.union(s) — where a shared prefix
            # would collide shm ring names and dedupe expected inputs.
            prefix = f"{self._job_uid}:e{eidx}:{edge.src_id}-{edge.dst_id}"
            calls = []
            for i, sw in enumerate(src_ws):
                calls.append(sw.add_output.remote(
                    edge.partition, list(dst_ws), prefix))
                for j in range(len(dst_ws)):
                    calls.append(
                        dst_ws[j].expect_input.remote(f"{prefix}:{i}->{j}"))
            ray_tpu_torch.get(calls)

    def submit(self) -> List[Any]:
        """Run the (finite) stream to completion; returns sink results
        concatenated across sink instances."""
        if not self._sources:
            raise ValueError("no sources")
        self._deploy()
        for op_id, items in self._sources:
            instances = self._workers[op_id]
            batch: List[Any] = []
            rr = 0
            for item in items:
                batch.append(item)
                if len(batch) >= self.batch_size:
                    ray_tpu_torch.get(
                        instances[rr % len(instances)].inject.remote(batch))
                    rr += 1
                    batch = []
            if batch:
                ray_tpu_torch.get(
                    instances[rr % len(instances)].inject.remote(batch))
            ray_tpu_torch.get([w.finish.remote() for w in instances])

        results: List[Any] = []
        for sink_id in self._sinks:
            for w in self._workers[sink_id]:
                results.extend(ray_tpu_torch.get(w.sink_results.remote()))
        return results

    def stats(self) -> Dict[str, Dict[str, int]]:
        out = {}
        for op_id, ws in self._workers.items():
            op = self.graph.operators[op_id]
            per = ray_tpu_torch.get([w.stats.remote() for w in ws])
            out[op.name] = {
                "records_in": sum(s["records_in"] for s in per),
                "records_out": sum(s["records_out"] for s in per),
            }
        return out

    def shutdown(self) -> None:
        for ws in self._workers.values():
            for w in ws:
                ray_tpu_torch.kill(w)
        self._workers = {}
