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
in one reply.

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

Left for a later slice, and refused here with NotImplementedError: tensor
parallelism (``tp > 1``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from .. import Device
from ..exceptions import ReplicaUnavailableError
from ..models.engine import GenerationEngine
from ..models.paged_engine import PagedGenerationEngine
from .api import accept_batch
from .config import ServeRequest


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
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) is not ported yet; it "
                "comes with the parallelism slice of ROADMAP.md")
        if paged:
            # Paged KV: cache memory bounded by num_pages instead of
            # max_slots * max_seq; admission queues FIFO on page budget.
            self.engine = PagedGenerationEngine(
                params, cfg, max_slots=max_slots, eos_id=eos_id,
                max_seq=max_seq, page_size=page_size, num_pages=num_pages,
                speculative_k=speculative_k,
                speculative_ngram=speculative_ngram,
                prefill_chunk=prefill_chunk, device=device)
        else:
            self.engine = GenerationEngine(
                params, cfg, max_slots=max_slots, eos_id=eos_id,
                max_seq=max_seq, speculative_k=speculative_k,
                speculative_ngram=speculative_ngram,
                prefill_chunk=prefill_chunk, device=device)
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
                while not self._engine_has_work():
                    self._cond.wait()
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

    def _check_poisoned(self) -> None:
        """Under self._cond: refuse new work once the engine is poisoned."""
        if self._poisoned is not None:
            raise ReplicaUnavailableError(
                None, "LM engine poisoned by step failure: "
                      f"{type(self._poisoned).__name__}: {self._poisoned}")

    def check_health(self) -> dict:
        with self._cond:
            if self._poisoned is None:
                return {"healthy": True}
            return {"healthy": False,
                    "reason": f"engine poisoned: "
                              f"{type(self._poisoned).__name__}: "
                              f"{self._poisoned}"}

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
