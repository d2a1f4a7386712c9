"""Parallel iterators: the dataflow substrate for the RL layer.

Reference behavior: ``python/ray/util/iter.py`` — a ParallelIterator is a set
of actor-held shards; transformations (``for_each``/``filter``/``batch``/...)
are recorded lazily and executed inside the shard actors; ``gather_sync`` /
``gather_async`` pull items back to the driver as a LocalIterator.

Design notes: shards hold *iterators of batches*; the per-item transform
chain runs in the worker that holds the shard, so a transform's tensors stay
on the device that owns them (a CUDA tensor passes between the local
runtime's threads without a copy). Only gathered items cross process
boundaries.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch

# Sentinel returned by shard actors when their iterator is exhausted; remote
# calls cannot raise StopIteration across the wire.
_STOP = "__parallel_iterator_stop__"


def from_items(items: List[Any], num_shards: int = 2, repeat: bool = False) -> "ParallelIterator":
    """Create a ParallelIterator from an existing list, split into shards."""
    shards: List[List[Any]] = [[] for _ in range(num_shards)]
    for i, item in enumerate(items):
        shards[i % num_shards].append(item)
    name = f"from_items[{len(items)}, shards={num_shards}]"
    return from_iterators(shards, repeat=repeat, name=name)


def from_range(n: int, num_shards: int = 2, repeat: bool = False) -> "ParallelIterator":
    """Create a ParallelIterator over ``range(n)``, split into shards."""
    generators = []
    for i in range(num_shards):
        start = i * (n // num_shards)
        end = (i + 1) * (n // num_shards) if i < num_shards - 1 else n
        generators.append(range(start, end))
    return from_iterators(generators, repeat=repeat,
                          name=f"from_range[{n}, shards={num_shards}]")


def from_iterators(generators: List[Iterable[Any]], repeat: bool = False,
                   name: Optional[str] = None) -> "ParallelIterator":
    """One shard actor per input iterable (or callable returning one)."""
    worker_cls = ray_tpu_torch.remote(num_cpus=0)(ParallelIteratorWorker)
    actors = [worker_cls.remote(g, repeat) for g in generators]
    return from_actors(actors, name=name or f"from_iterators[shards={len(generators)}]")


def from_actors(actors: List[Any], name: Optional[str] = None) -> "ParallelIterator":
    """Wrap existing actors that implement the ParallelIteratorWorker API."""
    return ParallelIterator([_ActorSet(actors, [])],
                            name or f"from_actors[shards={len(actors)}]")


class _ActorSet:
    """A group of shard actors plus the transform chain to apply on them."""

    def __init__(self, actors: List[Any], transforms: List[Callable]):
        self.actors = actors
        self.transforms = transforms

    def with_transform(self, fn: Callable) -> "_ActorSet":
        return _ActorSet(self.actors, self.transforms + [fn])

    def init_actors(self) -> None:
        refs = [a.par_iter_init.remote(self.transforms) for a in self.actors]
        ray_tpu_torch.get(refs)


class ParallelIteratorWorker:
    """Actor mixin holding one shard (reference iter.py ParallelIteratorWorker).

    Any actor class may subclass this to become usable with ``from_actors``.
    """

    def __init__(self, item_generator: Any, repeat: bool = False):
        self.item_generator = item_generator
        self.repeat = repeat
        self.local_it: Optional[Iterator] = None
        self._slice_lock = threading.Lock()

    def _base_iterator(self) -> Iterator:
        while True:
            gen = self.item_generator
            if callable(gen):
                gen = gen()
            yield from gen
            if not self.repeat:
                return

    def par_iter_init(self, transforms: List[Callable]) -> None:
        it: Iterable = self._base_iterator()
        for t in transforms:
            it = t(it)
        self.local_it = iter(it)
        self._slice_index = 0

    def par_iter_init_once(self, transforms: List[Callable]) -> None:
        """Idempotent init — used when several consumers (repartition shards)
        share one parent iterator and must not reset each other."""
        if self.local_it is None:
            self.par_iter_init(transforms)

    def par_iter_next(self):
        assert self.local_it is not None, "par_iter_init() was not called"
        try:
            return next(self.local_it)
        except StopIteration:
            return _STOP

    def par_iter_next_batch(self, n: int):
        """Pull up to n items in one RPC (amortizes per-call overhead)."""
        assert self.local_it is not None, "par_iter_init() was not called"
        out = []
        for _ in range(n):
            try:
                out.append(next(self.local_it))
            except StopIteration:
                out.append(_STOP)
                break
        return out

    def par_iter_slice(self, step: int, start: int):
        """Return the next element at index ≡ start (mod step); used by
        repartition so k new shards each drain a disjoint residue class.
        Items scanned past for other residues are buffered, not dropped."""
        with self._slice_lock:
            assert self.local_it is not None, "par_iter_init() was not called"
            if not hasattr(self, "_slice_index"):
                self._slice_index = 0
            if not hasattr(self, "_slice_buffers"):
                self._slice_buffers = {}
            buf = self._slice_buffers.setdefault(start, collections.deque())
            if buf:
                return buf.popleft()
            while True:
                try:
                    item = next(self.local_it)
                except StopIteration:
                    return _STOP
                residue = self._slice_index % step
                self._slice_index += 1
                if residue == start:
                    return item
                self._slice_buffers.setdefault(
                    residue, collections.deque()).append(item)


class ParallelIterator:
    """A parallel iterator over sharded actors (reference iter.py:118)."""

    def __init__(self, actor_sets: List[_ActorSet], name: str):
        self.actor_sets = actor_sets
        self.name = name

    def __repr__(self):
        return f"ParallelIterator[{self.name}]"

    def _with_transform(self, fn: Callable, name: str) -> "ParallelIterator":
        return ParallelIterator(
            [s.with_transform(fn) for s in self.actor_sets],
            f"{self.name}.{name}",
        )

    # -- lazy per-shard transformations ------------------------------------

    def transform(self, fn: Callable[[Iterable], Iterable]) -> "ParallelIterator":
        return self._with_transform(fn, "transform()")

    def for_each(self, fn: Callable[[Any], Any]) -> "ParallelIterator":
        def apply(it):
            for x in it:
                yield fn(x)
        return self._with_transform(apply, f"for_each({_fn_name(fn)})")

    def filter(self, fn: Callable[[Any], bool]) -> "ParallelIterator":
        def apply(it):
            for x in it:
                if fn(x):
                    yield x
        return self._with_transform(apply, f"filter({_fn_name(fn)})")

    def batch(self, n: int) -> "ParallelIterator":
        def apply(it):
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) == n:
                    yield buf
                    buf = []
            if buf:
                yield buf
        return self._with_transform(apply, f"batch({n})")

    def flatten(self) -> "ParallelIterator":
        def apply(it):
            for x in it:
                yield from x
        return self._with_transform(apply, "flatten()")

    def combine(self, fn: Callable[[Any], List[Any]]) -> "ParallelIterator":
        return self.for_each(fn).flatten()

    def local_shuffle(self, shuffle_buffer_size: int,
                      seed: Optional[int] = None) -> "ParallelIterator":
        def apply(it):
            rng = random.Random(seed)
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) >= shuffle_buffer_size:
                    yield buf.pop(rng.randrange(len(buf)))
            while buf:
                yield buf.pop(rng.randrange(len(buf)))
        return self._with_transform(
            apply, f"local_shuffle(buffer={shuffle_buffer_size})")

    # -- shard restructuring ------------------------------------------------

    def repartition(self, num_partitions: int) -> "ParallelIterator":
        """Re-shard across ``num_partitions`` new actors; each new shard
        drains a residue class (mod num_partitions) of every parent shard."""
        parent = self

        def make_gen(partition_index: int):
            def gen():
                for s in parent.actor_sets:
                    ray_tpu_torch.get([a.par_iter_init_once.remote(s.transforms)
                                 for a in s.actors])
                actors = [a for s in parent.actor_sets for a in s.actors]
                pending = {
                    a.par_iter_slice.remote(num_partitions, partition_index): a
                    for a in actors
                }
                while pending:
                    ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
                    ref = ready[0]
                    actor = pending.pop(ref)
                    item = ray_tpu_torch.get(ref)
                    if item is _STOP or item == _STOP:
                        continue
                    pending[actor.par_iter_slice.remote(
                        num_partitions, partition_index)] = actor
                    yield item
            return gen

        worker_cls = ray_tpu_torch.remote(num_cpus=0)(ParallelIteratorWorker)
        actors = [worker_cls.remote(make_gen(i), False)
                  for i in range(num_partitions)]
        return from_actors(actors,
                           name=f"{self.name}.repartition({num_partitions})")

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(self.actor_sets + other.actor_sets,
                                f"{self.name}.union({other.name})")

    def select_shards(self, shards_to_keep: List[int]) -> "ParallelIterator":
        assert len(self.actor_sets) == 1, "select_shards requires one actor set"
        s = self.actor_sets[0]
        kept = [a for i, a in enumerate(s.actors) if i in shards_to_keep]
        return ParallelIterator([_ActorSet(kept, list(s.transforms))],
                                f"{self.name}.select_shards({shards_to_keep})")

    def num_shards(self) -> int:
        return sum(len(s.actors) for s in self.actor_sets)

    # -- gathering ----------------------------------------------------------

    def gather_sync(self) -> "LocalIterator":
        """Round-robin pull, one item per shard per cycle, in order."""
        parent = self

        def base():
            for s in parent.actor_sets:
                s.init_actors()
            actors = [a for s in parent.actor_sets for a in s.actors]
            active = list(actors)
            while active:
                refs = [a.par_iter_next.remote() for a in active]
                results = ray_tpu_torch.get(refs)
                still = []
                for a, item in zip(active, results):
                    if item is _STOP or (isinstance(item, str) and item == _STOP):
                        continue
                    still.append(a)
                    yield item
                active = still
        return LocalIterator(base, name=f"{self.name}.gather_sync()")

    def gather_async(self, num_async: int = 1) -> "LocalIterator":
        """Pull with ``num_async`` requests in flight per shard; yields items
        in completion order (reference iter.py:494)."""
        parent = self

        def base():
            for s in parent.actor_sets:
                s.init_actors()
            actors = [a for s in parent.actor_sets for a in s.actors]
            pending = {}
            for a in actors:
                for _ in range(num_async):
                    pending[a.par_iter_next.remote()] = a
            while pending:
                ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
                ref = ready[0]
                actor = pending.pop(ref)
                item = ray_tpu_torch.get(ref)
                if item is _STOP or (isinstance(item, str) and item == _STOP):
                    continue
                pending[actor.par_iter_next.remote()] = actor
                yield item
        return LocalIterator(base, name=f"{self.name}.gather_async()")

    def batch_across_shards(self) -> "LocalIterator":
        """Yield lists with exactly one item from every shard per step."""
        parent = self

        def base():
            for s in parent.actor_sets:
                s.init_actors()
            actors = [a for s in parent.actor_sets for a in s.actors]
            while actors:
                results = ray_tpu_torch.get([a.par_iter_next.remote() for a in actors])
                if any(r is _STOP or (isinstance(r, str) and r == _STOP)
                       for r in results):
                    return
                yield results
        return LocalIterator(base, name=f"{self.name}.batch_across_shards()")

    def shards(self) -> List["LocalIterator"]:
        return [self.get_shard(i) for i in range(self.num_shards())]

    def get_shard(self, shard_index: int) -> "LocalIterator":
        flat = []
        for s in self.actor_sets:
            for a in s.actors:
                flat.append((a, s))
        actor, actor_set = flat[shard_index]

        def base():
            ray_tpu_torch.get(actor.par_iter_init.remote(actor_set.transforms))
            while True:
                item = ray_tpu_torch.get(actor.par_iter_next.remote())
                if item is _STOP or (isinstance(item, str) and item == _STOP):
                    return
                yield item
        return LocalIterator(base, name=f"{self.name}.get_shard({shard_index})")

    def take(self, n: int) -> List[Any]:
        return self.gather_sync().take(n)

    def show(self, n: int = 20) -> None:
        self.gather_sync().show(n)

    def __iter__(self):
        return iter(self.gather_sync())


class LocalIterator:
    """A serializable single-process iterator with chained transforms
    (reference iter.py:681). ``base`` is a zero-arg callable returning an
    iterator; transforms are applied lazily on first iteration."""

    # Thread-local metrics context shared by for_each fns (reference
    # iter.py:731 get_metrics) — the RL layer records counters through this.
    _metrics = threading.local()

    def __init__(self, base: Callable[[], Iterator],
                 transforms: Optional[List[Callable]] = None,
                 name: str = "LocalIterator"):
        self.base = base
        self.transforms = list(transforms or [])
        self.name = name
        self._built: Optional[Iterator] = None
        self.shared_metrics = MetricsContext()

    @staticmethod
    def get_metrics() -> "MetricsContext":
        ctx = getattr(LocalIterator._metrics, "ctx", None)
        if ctx is None:
            ctx = MetricsContext()
            LocalIterator._metrics.ctx = ctx
        return ctx

    def _build(self) -> Iterator:
        if self._built is None:
            LocalIterator._metrics.ctx = self.shared_metrics
            it: Iterable = self.base()
            for t in self.transforms:
                it = t(it)
            self._built = iter(it)
        return self._built

    def __iter__(self):
        self._build()
        return self

    def __next__(self):
        it = self._build()
        LocalIterator._metrics.ctx = self.shared_metrics
        return next(it)

    def __repr__(self):
        return f"LocalIterator[{self.name}]"

    def _with(self, fn: Callable, name: str) -> "LocalIterator":
        out = LocalIterator(self.base, self.transforms + [fn],
                            f"{self.name}.{name}")
        out.shared_metrics = self.shared_metrics
        return out

    def transform(self, fn):
        return self._with(fn, "transform()")

    def for_each(self, fn):
        def apply(it):
            for x in it:
                yield fn(x)
        return self._with(apply, f"for_each({_fn_name(fn)})")

    def filter(self, fn):
        def apply(it):
            for x in it:
                if fn(x):
                    yield x
        return self._with(apply, f"filter({_fn_name(fn)})")

    def batch(self, n):
        def apply(it):
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) == n:
                    yield buf
                    buf = []
            if buf:
                yield buf
        return self._with(apply, f"batch({n})")

    def flatten(self):
        def apply(it):
            for x in it:
                yield from x
        return self._with(apply, "flatten()")

    def combine(self, fn):
        return self.for_each(fn).flatten()

    def shuffle(self, shuffle_buffer_size: int, seed: Optional[int] = None):
        def apply(it):
            rng = random.Random(seed)
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) >= shuffle_buffer_size:
                    yield buf.pop(rng.randrange(len(buf)))
            while buf:
                yield buf.pop(rng.randrange(len(buf)))
        return self._with(apply, f"shuffle({shuffle_buffer_size})")

    def zip_with_source_actor(self):
        raise NotImplementedError(
            "zip_with_source_actor applies only to gathered parallel iterators")

    def take(self, n: int) -> List[Any]:
        out = []
        for x in self:
            out.append(x)
            if len(out) >= n:
                break
        return out

    def show(self, n: int = 20) -> None:
        i = 0
        for x in self:
            print(x)
            i += 1
            if i >= n:
                break

    def union(self, other: "LocalIterator",
              deterministic: bool = False) -> "LocalIterator":
        """Interleave two local iterators (round-robin)."""
        a, b = self, other

        def base():
            its = [iter(a), iter(b)]
            alive = [True, True]
            while any(alive):
                for i, it in enumerate(its):
                    if not alive[i]:
                        continue
                    try:
                        yield next(it)
                    except StopIteration:
                        alive[i] = False
        return LocalIterator(base, name=f"{self.name}.union({other.name})")

    def duplicate(self, n: int) -> List["LocalIterator"]:
        """Fan out into n copies sharing one upstream pull (buffered)."""
        queues: List[collections.deque] = [collections.deque() for _ in range(n)]
        src = iter(self)
        lock = threading.Lock()

        def make(i):
            def base():
                while True:
                    with lock:
                        if not queues[i]:
                            try:
                                item = next(src)
                            except StopIteration:
                                return
                            for q in queues:
                                q.append(item)
                    yield queues[i].popleft()
            out = LocalIterator(base, name=f"{self.name}.duplicate[{i}]")
            out.shared_metrics = self.shared_metrics
            return out
        return [make(i) for i in range(n)]


class MetricsContext:
    """Counters shared across the transform chain (reference iter.py
    MetricsContext): ``info`` free-form dict plus common counters."""

    def __init__(self):
        self.counters: collections.defaultdict = collections.defaultdict(int)
        self.info: dict = {}
        self.timers: collections.defaultdict = collections.defaultdict(float)
        self.current_actor = None


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", repr(fn))
