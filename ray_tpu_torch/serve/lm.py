"""LM serving backend: continuous-batching generation behind serve
(counterpart: ``ray_tpu/serve/lm.py``; the glue between serve's router
batching and ``ray_tpu_torch.models.engine.GenerationEngine``).

Serve's router collects concurrent requests into one batch and delivers
them together; the backend submits them all to the engine, which decodes
every request in lockstep on shared batch slots. The engine (caches,
weights on the card) persists across batches.

Streaming is push-shaped: a dedicated PUMP THREAD owns the engine and
decodes continuously whenever any request is active, buffering each
stream's tokens as they are produced. ``stream_poll`` is a LONG-POLL: it
blocks (up to ``wait_s``) until tokens exist, then drains the whole buffer
in one reply. ``close()`` stops the pump and drops the engine, so its
caches go back to the allocator; a runtime actor hosting the backend calls
it through ``__ray_shutdown__`` when it is killed or restarted.

    backend = LMBackend(params, cfg, max_slots=8, max_seq=2048)
    tokens, = backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 16})])
    tok = backend.stream_start([1, 2, 3], max_new_tokens=16)
    backend.stream_poll(tok, wait_s=1.0)   # {"tokens": [...], "done": ...}

``paged=True`` serves through ``models.paged_engine.PagedGenerationEngine``
instead: the KV cache is a pool of ``num_pages`` pages of ``page_size``
rows with prefix caching, and admission queues FIFO on the page budget;
outputs are the same.

``speculative_k > 0`` turns on n-gram speculative decoding in either
engine (``models/speculative.py``; ``speculative_ngram`` is the n-gram
order), exact for greedy requests; ``stats()["speculative"]`` reports its
ticks, drafted, accepted and emitted tokens, and the acceptance rate.

``tp > 1`` serves over tensor parallelism: the JAX package's one
controller over tp devices becomes a ``parallel.World`` of tp rank
processes on ``device`` (they share the card when there is one), each
holding an engine of either kind over ``make_mesh({"tp": tp})`` with its
block of the weights and KH/tp heads of the cache. ``_TpEngine`` gives
the backend the engine interface it uses: submits and cancels are
forwarded to every rank in the order the backend makes them, each
``step()`` steps every rank's engine once, and every rank's reply (its
events, finished outputs, queue, slots and speculation counters) must
equal every other's, or the step raises and the backend is poisoned, as by
any step failure. ``close()`` stops the world.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .. import Device
from .._tree import tree_map
from ..exceptions import ReplicaUnavailableError
from ..models.engine import GenerationEngine
from ..models.paged_engine import PagedGenerationEngine
from ..parallel.mesh import World, make_mesh, rank_state
from .api import accept_batch
from .config import ServeRequest


def _rank_build(key: str, params: Any, cfg: Any, tp: int, paged: bool,
                kw: dict) -> None:
    """In each rank: the engine over a ("tp",) mesh of the world, kept in
    the rank's ``rank_state()`` under ``key``."""
    cls = PagedGenerationEngine if paged else GenerationEngine
    rank_state()[key] = cls(params, cfg, mesh=make_mesh({"tp": tp}), **kw)


def _rank_step(key: str, ops: list) -> dict:
    """In each rank: the forwarded submits and cancels in order, then one
    engine step. Finished outputs leave the engine's ``done`` here, so a
    rank's memory does not grow with traffic."""
    eng = rank_state()[key]
    for op, rid, args in ops:
        if op == "cancel":
            eng.cancel(rid)
        elif eng.submit(*args) != rid:
            raise RuntimeError(f"request {rid} got another id on this rank")
    events = eng.step()
    return {"events": events,
            "done": {rid: eng.done.pop(rid) for rid in list(eng.done)},
            "queue": [r.req_id for r in eng.queue],
            "active": [None if r is None else r.req_id for r in eng.active],
            "spec_stats": dict(eng.spec_stats)}


class _Held:
    """A request as the backend sees it in ``queue`` and ``active``."""
    __slots__ = ("req_id",)

    def __init__(self, req_id: int):
        self.req_id = req_id


class _TpEngine:
    """The engine interface ``LMBackend`` uses (``validate``, ``submit``,
    ``step``, ``cancel``, ``queue``, ``active``, ``done``, ``slots``,
    ``spec_stats``) over one engine a rank of a world of ``tp`` ranks,
    stepped in lockstep. The parameters travel to the ranks on the host,
    and each rank moves only its block to its device."""

    def __init__(self, params: Any, cfg: Any, tp: int, paged: bool,
                 kw: dict, device: Device):
        self.world = World(tp, device=device)   # raises without a card
        self.key = uuid.uuid4().hex
        self.slots = kw["max_slots"]
        self.max_seq = kw["max_seq"] or cfg.max_seq_len
        self.queue: List[_Held] = []
        self.active: List[Optional[_Held]] = [None] * self.slots
        self.done: Dict[int, List[int]] = {}
        self.spec_stats = {"ticks": 0, "drafted": 0, "accepted": 0,
                           "emitted": 0}
        self._ops: list = []
        self._next_id = 0
        host = tree_map(lambda t: t.detach().cpu(), params)
        try:
            self.world.run(_rank_build, self.key, host, cfg, tp, paged, kw)
        except BaseException:
            self.world.close()
            raise

    # Validation reads only max_seq: the engine's own rules, on the host.
    validate = GenerationEngine.validate

    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: float = 0.0, seed: Optional[int] = None,
               stop: Optional[List[List[int]]] = None) -> int:
        self.validate(prompt, max_new_tokens, temperature, seed, stop)
        rid = self._next_id
        self._next_id += 1
        self._ops.append(("submit", rid, (list(prompt), max_new_tokens,
                                          temperature, seed, stop)))
        self.queue.append(_Held(rid))
        return rid

    def cancel(self, req_id: int) -> bool:
        self._ops.append(("cancel", req_id, None))
        for i, r in enumerate(self.queue):
            if r.req_id == req_id:
                del self.queue[i]
                return True
        for slot, r in enumerate(self.active):
            if r is not None and r.req_id == req_id:
                self.active[slot] = None
                return True
        return self.done.pop(req_id, None) is not None

    def step(self) -> list:
        ops, self._ops = self._ops, []
        replies = self.world.run(_rank_step, self.key, ops)
        reply = replies[0]
        for rank, other in enumerate(replies[1:], 1):
            if other != reply:
                raise RuntimeError(
                    f"tp serving: rank {rank} diverged from rank 0 in a "
                    f"step: events {other['events']} against "
                    f"{reply['events']}")
        self.done.update(reply["done"])
        self.queue = [_Held(rid) for rid in reply["queue"]]
        self.active = [None if rid is None else _Held(rid)
                       for rid in reply["active"]]
        self.spec_stats = reply["spec_stats"]
        return reply["events"]

    def close(self) -> None:
        self.world.close()


class LMBackend:
    """Class backend for serve: generation with cross-request continuous
    batching and push-style streaming.

    All engine access is serialized under one condition variable; the pump
    thread is the only caller of ``engine.step()``. Whole-response calls
    submit and wait; streams submit and drain their token buffers as the
    pump fills them.
    """

    def __init__(self, params: Any, cfg: Any, *, max_slots: int = 8,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 32,
                 max_seq: Optional[int] = None,
                 stream_idle_timeout_s: float = 120.0,
                 paged: bool = False, page_size: int = 128,
                 num_pages: Optional[int] = None, speculative_k: int = 0,
                 speculative_ngram: int = 2, tp: int = 1,
                 prefill_chunk: int = 0,
                 device: Device = None):
        kw = dict(max_slots=max_slots, eos_id=eos_id, max_seq=max_seq,
                  speculative_k=speculative_k,
                  speculative_ngram=speculative_ngram,
                  prefill_chunk=prefill_chunk)
        if paged:
            # Paged KV: cache memory bounded by num_pages instead of
            # max_slots * max_seq; admission queues FIFO on page budget.
            kw.update(page_size=page_size, num_pages=num_pages)
        if tp > 1:
            self.engine = _TpEngine(params, cfg, tp, paged, kw, device)
        else:
            cls = PagedGenerationEngine if paged else GenerationEngine
            self.engine = cls(params, cfg, device=device, **kw)
        self.default_max_new_tokens = default_max_new_tokens
        self.stream_idle_timeout_s = stream_idle_timeout_s
        # RLock: stream_poll -> _expire_idle_streams -> stream_cancel
        # re-enters the lock.
        self._cond = threading.Condition(threading.RLock())
        self._pump_thread: Optional[threading.Thread] = None
        self._streams: dict = {}        # token -> engine req_id
        self._stream_bufs: dict = {}    # req_id -> [undelivered tokens]
        self._stream_done: set = set()  # req_ids whose last token is buffered
        self._stream_seen: dict = {}    # token -> last poll/start time
        self._failed: dict = {}         # req_id -> exception from the pump
        # Set by _poison(): the engine step failed. The replica keeps
        # answering but reports unhealthy (check_health) and refuses new
        # work with ReplicaUnavailableError so a router fails over.
        self._poisoned: Optional[BaseException] = None
        self._closed = False

    def _parse(self, r: ServeRequest):
        if len(r.args) > 2:
            raise ValueError(
                "LMBackend takes (prompt, max_new_tokens); "
                f"got {len(r.args)} positional args")
        prompt = list(r.args[0])
        if len(r.args) == 2:
            if "max_new_tokens" in r.kwargs:
                raise ValueError("max_new_tokens given twice")
            n = int(r.args[1])
        else:
            n = int(r.kwargs.get("max_new_tokens",
                                 self.default_max_new_tokens))
        temperature = float(r.kwargs.get("temperature", 0.0))
        seed = r.kwargs.get("seed")
        stop = r.kwargs.get("stop")
        return prompt, n, temperature, seed, stop

    # -------------------------------------------------------------- pump
    def _ensure_pump(self) -> None:
        """Start the decode thread lazily (under self._cond)."""
        if self._pump_thread is None or not self._pump_thread.is_alive():
            self._pump_thread = threading.Thread(
                target=self._pump_loop, name="lm-engine-pump", daemon=True)
            self._pump_thread.start()

    def _engine_has_work(self) -> bool:
        return bool(self.engine.queue
                    or any(r is not None for r in self.engine.active))

    def _pump_loop(self) -> None:
        """The ONLY caller of engine.step(): decodes continuously while any
        request is live, sleeps on the condition otherwise. Each tick's
        stream events land in their buffers and every waiter is woken."""
        while True:
            with self._cond:
                while not self._closed and not self._engine_has_work():
                    self._cond.wait()
                if self._closed:
                    return
                try:
                    events = self.engine.step()
                except BaseException as e:  # noqa: BLE001
                    # The pump dying silently would hang every waiter
                    # forever (and leave the replica reporting healthy):
                    # fail every live request with the error, whatever its
                    # class, and drain the engine so a poisoned step can't
                    # rerun.
                    self._poison(e)
                    continue
                for rid, tok, done in events:
                    buf = self._stream_bufs.get(rid)
                    if buf is not None:
                        buf.append(tok)
                        if done:
                            self._stream_done.add(rid)
                            # A stream's tokens live in its buffer; drop
                            # the engine-side duplicate kept in done.
                            self.engine.done.pop(rid, None)
                self._cond.notify_all()

    def _poison(self, err: BaseException) -> None:
        """Fail every queued/active request with ``err`` (under _cond) and
        clear the engine's slots and queue."""
        self._poisoned = err
        rids = [r.req_id for r in self.engine.queue]
        rids += [r.req_id for r in self.engine.active if r is not None]
        for rid in rids:
            self._failed[rid] = err
            self.engine.cancel(rid)
        self._cond.notify_all()

    def close(self) -> None:
        """Fail every live request, stop the pump thread and drop the
        engine: its KV cache and workspace are freed once nothing else
        holds them (under tp, its world of ranks stops). Later calls raise
        ReplicaUnavailableError. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._poison(ReplicaUnavailableError(None, "LM backend closed"))
            self._closed = True
            for token, rid in list(self._streams.items()):
                self._drop_stream(token, rid)
            self._cond.notify_all()
            pump = self._pump_thread
        if pump is not None and pump is not threading.current_thread():
            pump.join()
        with self._cond:
            engine, self.engine = self.engine, None
            self._pump_thread = None
        if isinstance(engine, _TpEngine):
            engine.close()

    # The runtime's actor-teardown hook (LocalActor.kill).
    __ray_shutdown__ = close

    def _check_poisoned(self) -> None:
        """Under self._cond: refuse new work once the engine is poisoned
        or the backend is closed."""
        if self._closed:
            raise ReplicaUnavailableError(None, "LM backend closed")
        if self._poisoned is not None:
            raise ReplicaUnavailableError(
                None, "LM engine poisoned by step failure: "
                      f"{type(self._poisoned).__name__}: {self._poisoned}")

    def check_health(self) -> dict:
        # Without the lock: the pump holds it through each step and takes
        # it straight back for the next, so a probe that waited for it
        # could time out while the backend decodes (a tp step, a round
        # trip through the ranks, holds it longest). Two attribute reads.
        poisoned = self._poisoned
        if self._closed:
            return {"healthy": False, "reason": "closed"}
        if poisoned is None:
            return {"healthy": True}
        return {"healthy": False,
                "reason": f"engine poisoned: {type(poisoned).__name__}: "
                          f"{poisoned}"}

    @accept_batch
    def __call__(self, requests: List[ServeRequest]) -> List[List[int]]:
        parsed = [self._parse(r) for r in requests]
        with self._cond:
            self._check_poisoned()
            # Validate every request BEFORE submitting any: a bad one must
            # not leave its batch-mates orphaned inside the engine.
            for prompt, n, t, sd, stp in parsed:
                self.engine.validate(prompt, n, t, sd, stp)
            ids = [self.engine.submit(p, n, temperature=t, seed=s, stop=stp)
                   for p, n, t, s, stp in parsed]
            self._ensure_pump()
            self._cond.notify_all()
            while not all(rid in self.engine.done or rid in self._failed
                          for rid in ids):
                self._cond.wait(0.5)
                if self._closed:  # close() failed them and dropped the engine
                    raise ReplicaUnavailableError(None, "LM backend closed")
            errs = [self._failed.pop(rid) for rid in ids
                    if rid in self._failed]
            if errs:
                for rid in ids:
                    self.engine.done.pop(rid, None)
                raise errs[0]
            return [self.engine.done.pop(rid) for rid in ids]

    # ------------------------------------------------------------- streaming
    def _expire_idle_streams(self) -> None:
        """A poller that vanished without cancel must not occupy one of
        max_slots forever."""
        cutoff = time.monotonic() - self.stream_idle_timeout_s
        for token, seen in list(self._stream_seen.items()):
            if seen < cutoff:
                self.stream_cancel(token)

    def stream_start(self, prompt, max_new_tokens: Optional[int] = None,
                     temperature: float = 0.0, seed=None,
                     stop=None) -> str:
        import uuid

        prompt = list(prompt)
        n = int(max_new_tokens if max_new_tokens is not None
                else self.default_max_new_tokens)
        with self._cond:
            self._check_poisoned()
            self._expire_idle_streams()
            self.engine.validate(prompt, n, float(temperature), seed, stop)
            rid = self.engine.submit(prompt, n,
                                     temperature=float(temperature),
                                     seed=seed, stop=stop)
            token = uuid.uuid4().hex
            self._streams[token] = rid
            self._stream_bufs[rid] = []
            self._stream_seen[token] = time.monotonic()
            self._ensure_pump()
            self._cond.notify_all()
        return token

    def stream_poll(self, token: str, wait_s: float = 0.0) -> dict:
        """Long-poll: block until this stream has tokens (or is done), up
        to ``wait_s``, then return EVERYTHING buffered —
        {"tokens": [...], "done": bool}."""
        deadline = time.monotonic() + max(0.0, float(wait_s))
        with self._cond:
            rid = self._streams.get(token)
            if rid is None:
                raise KeyError(f"unknown or finished stream {token!r}")
            self._expire_idle_streams()
            while True:
                if self._closed:
                    raise ReplicaUnavailableError(None, "LM backend closed")
                # Cancelled under us? Re-check BEFORE touching
                # _stream_seen: a refresh for a dropped token would
                # resurrect a seen-entry nothing ever removes.
                if self._streams.get(token) != rid:
                    raise KeyError(f"unknown or finished stream {token!r}")
                self._stream_seen[token] = time.monotonic()
                if rid in self._failed:
                    err = self._failed.pop(rid)
                    self._drop_stream(token, rid)
                    raise err
                out = self._stream_bufs.get(rid, [])
                done = rid in self._stream_done
                remaining = deadline - time.monotonic()
                if out or done or remaining <= 0:
                    break
                self._cond.wait(min(0.5, remaining))
            self._stream_bufs[rid] = []
            if done:
                self._drop_stream(token, rid)
            return {"tokens": out, "done": done}

    def stats(self) -> dict:
        """Engine and speculation telemetry for dashboards and canarying.
        ``"speculative"`` is there at every ``speculative_k`` (all zero
        when it is 0); ``acceptance_rate`` appears once a draft was
        made."""
        with self._cond:
            if self._closed:
                raise ReplicaUnavailableError(None, "LM backend closed")
            eng = self.engine
            st = dict(eng.spec_stats)
            if st["drafted"]:
                st["acceptance_rate"] = round(
                    st["accepted"] / st["drafted"], 3)
            return {
                "slots": eng.slots,
                "active": sum(r is not None for r in eng.active),
                "queued": len(eng.queue),
                "streams": len(self._streams),
                "poisoned": self._poisoned is not None,
                "speculative": st,
            }

    def stream_cancel(self, token: str) -> bool:
        with self._cond:
            rid = self._streams.get(token)
            if rid is None:
                return False
            self.engine.cancel(rid)
            self._drop_stream(token, rid)
            return True

    def _drop_stream(self, token: str, rid: int) -> None:
        self._streams.pop(token, None)
        self._stream_bufs.pop(rid, None)
        self._stream_done.discard(rid)
        self._stream_seen.pop(token, None)
        self._failed.pop(rid, None)
