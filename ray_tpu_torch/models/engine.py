"""Continuous-batching generation engine (counterpart:
``ray_tpu/models/engine.py``): many concurrent requests over a FIXED pool
of batch slots and preallocated caches [L, slots, S, KH, Dh].

Requests claim a free slot (prefill writes that slot's cache rows), every
``step()`` decodes ALL slots in one lockstep batched pass with per-slot
positions and lengths (idle slots compute garbage that is ignored), and
finished slots are immediately reusable by queued requests. Prompts
right-pad to a power-of-2 bucket; the pad rows' cache entries are garbage
that decode overwrites before it ever attends them, and the first-token
logits are read at the real last position.

The JAX package donates the cache pools to jitted programs so XLA aliases
them; here the layer loop is a Python ``for`` and every cache write is an
in-place update of the pool tensors. On the card the decode pass runs the
hand-written RMSNorm (2L+1 launches) and flash-decode (L launches) kernels.

With ``speculative_k > 0`` every tick runs n-gram speculative decoding
(``models/speculative.py``): prompt-lookup drafts of up to K tokens per
slot are verified in one (K+1)-position forward (width 1 when nothing
drafts), and each slot emits its longest verified prefix plus one token.
That forward runs K1 (2L+1 launches) and the plain masked attention, as
the JAX package's runs XLA; K6 does not run while speculation is on.

Subclass hooks (the paged engine, ``models/paged_engine.py``, overrides
them): ``_alloc_cache``, ``_decode_all``, ``_verify_all``,
``_prefill_slot``, ``_release_slot`` and ``_can_admit``.

Left for a later slice, and refused here with NotImplementedError: a
tensor-parallel ``mesh``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import Device, default_device
from ..ops.attention import decode_attention, masked_gqa_attention
from .speculative import NgramIndex, _batched_verify, longest_accept
from .transformer import (
    Params, TransformerConfig, _decoder, _layers, _rope, to_compute,
)


def _rope_at(x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """x [B, 1, H, D] rotated at per-slot positions [B]: treat the slot
    axis as _rope's T axis, so the shared helper stays the single source
    of the rotation math."""
    return _rope(x.transpose(0, 1), positions, theta).transpose(0, 1)


def _batched_decode(params: Params, tokens: torch.Tensor,
                    lengths: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor,
                    cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B] at per-slot positions ``lengths`` [B] int32 -> logits
    [B, V]. Writes each slot's new K/V at row ``lengths[b]`` of cache_[kv]
    [L, B, S, KH, Dh] IN PLACE (idle slots write garbage at their row 0,
    as in the JAX engine). Callers ignore logits of inactive slots."""
    B = tokens.shape[0]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slots = torch.arange(B, device=tokens.device)
    x = params["embed"][tokens][:, None, :]                     # [B, 1, E]

    def attend(i, layer, h):
        q = _rope_at((h @ layer["wq"]).reshape(B, 1, H, Dh), lengths,
                     cfg.rope_theta)
        k = _rope_at((h @ layer["wk"]).reshape(B, 1, KH, Dh), lengths,
                     cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(B, 1, KH, Dh)
        cache_k[i, slots, lengths] = k[:, 0]
        cache_v[i, slots, lengths] = v[:, 0]
        attn = decode_attention(q[:, 0].contiguous(), cache_k[i], cache_v[i],
                                lengths).reshape(B, 1, H * Dh)
        return attn @ layer["wo"]

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend)
    return x[:, 0] @ params["embed"].T


def _prefill_into_slot(params: Params, tokens: torch.Tensor, real_len: int,
                       slot: int, cache_k: torch.Tensor, cache_v: torch.Tensor,
                       cfg: TransformerConfig) -> torch.Tensor:
    """Prompt [1, Tb] (right-padded to a power-of-2 bucket) -> logits [V]
    at position real_len-1, with the slot's cache rows [0:Tb) written IN
    PLACE. Pad rows hold garbage K/V beyond real_len — safe: prompt
    positions only attend causally at <= their own index, and decode
    overwrites row ``length`` before each attend reaches it."""
    _, Tb = tokens.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = tokens.device
    x = params["embed"][tokens]                                 # [1, Tb, E]
    positions = torch.arange(Tb, device=dev)
    causal = positions[None, :] <= positions[:, None]           # [Tb, Tb]

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(1, Tb, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(1, Tb, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(1, Tb, KH, Dh)
        cache_k[i, slot, :Tb] = k[0]
        cache_v[i, slot, :Tb] = v[0]
        attn = masked_gqa_attention(q, k, v, causal).reshape(1, Tb, H * Dh)
        return attn @ layer["wo"]

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend)
    return x[0, real_len - 1] @ params["embed"].T               # [V]


def _prefill_chunk(params: Params, tokens: torch.Tensor, start: int,
                   slot: int, last_idx: int, cache_k: torch.Tensor,
                   cache_v: torch.Tensor,
                   cfg: TransformerConfig) -> torch.Tensor:
    """One CHUNK of a long prompt: tokens [1, C] at positions
    start..start+C-1 of ``slot`` -> logits [V] at in-chunk row ``last_idx``
    (meaningful on the final chunk), chunk K/V written into the slot's
    cache rows IN PLACE. Position i attends cache rows 0..start+i, so a
    T-token prompt costs O(T*S) attention instead of the bucketed path's
    [T, T] mask. Pad rows in the final chunk hold garbage beyond the real
    length, covered by the same overwrite-before-attend invariant.

    Its attention block is the third copy (with _prefill_into_slot's and
    _batched_decode's) around the layer loop they share
    (transformer._decoder); the engine tests pin all three to generate():
    touch the attention math in one, touch it in all."""
    _, C = tokens.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = cache_k.shape[2]
    dev = tokens.device
    x = params["embed"][tokens]                                 # [1, C, E]
    positions = start + torch.arange(C, device=dev)
    mask = torch.arange(S, device=dev)[None, :] <= positions[:, None]

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(1, C, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(1, C, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(1, C, KH, Dh)
        cache_k[i, slot, start:start + C] = k[0]
        cache_v[i, slot, start:start + C] = v[0]
        attn = masked_gqa_attention(
            q, cache_k[i, slot:slot + 1], cache_v[i, slot:slot + 1],
            mask).reshape(1, C, H * Dh)
        return attn @ layer["wo"]

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend)
    return x[0, last_idx] @ params["embed"].T                   # [V]


class _Request:
    __slots__ = ("req_id", "prompt", "max_new_tokens", "out", "temperature",
                 "rng", "ng", "stop")

    def __init__(self, req_id: int, prompt: List[int], max_new_tokens: int,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 stop: Optional[List[List[int]]] = None):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.out: List[int] = []
        self.stop = [list(sq) for sq in stop] if stop else []
        self.temperature = float(temperature)
        # Per-request stream: an explicit seed -> same sampled continuation
        # regardless of batch composition; no seed -> fresh OS entropy.
        self.rng = np.random.default_rng(seed)
        self.ng = None   # lazy NgramIndex (speculative decoding)

    def hit_stop(self, extra: Optional[List[int]] = None) -> bool:
        """True when the output (plus tentative ``extra`` tokens) ends
        with any stop sequence — stop tokens stay IN the output, like
        EOS. Only the tail is inspected: copying the whole output per
        emitted token would be O(n^2) over a generation."""
        if not self.stop:
            return False
        longest = max(len(sq) for sq in self.stop)
        out = self.out[-longest:] + extra if extra else self.out
        n_real = len(self.out) + len(extra or [])
        return any(n_real >= len(sq) and out[-len(sq):] == sq
                   for sq in self.stop)

    def pick(self, logits_row: np.ndarray) -> int:
        """Greedy at temperature 0; softmax-sample otherwise (host-side,
        per-request PRNG — the decode pass stays sampling-free)."""
        if self.temperature == 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))


class GenerationEngine:
    """Continuous-batching decode over a fixed slot pool.

    ``submit()`` queues a request; ``step()`` admits queued requests into
    free slots (bucketed in-place prefill) and advances every active slot
    by one token (by up to ``speculative_k + 1`` with speculation on);
    ``run_until_done()`` drains everything. Greedy results
    equal single-request ``generate()``; sampled requests (temperature > 0)
    are seed-reproducible through a host-side per-request numpy PRNG, the
    same stream as the JAX engine's.
    """

    # Run draft-less speculative ticks through _decode_all (the
    # flash-decode kernel) instead of a width-1 verify chunk; the paged
    # engine does.
    _spec_plain_when_draftless = False

    def __init__(self, params: Params, cfg: TransformerConfig, *,
                 max_slots: int = 4, max_seq: Optional[int] = None,
                 eos_id: Optional[int] = None, speculative_k: int = 0,
                 speculative_ngram: int = 2, mesh=None,
                 prefill_chunk: int = 0, device: Device = None):
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel mesh is not ported yet; it comes with the "
                "parallelism slice of ROADMAP.md")
        self.device = default_device(device)
        self.cfg = cfg
        self.slots = max_slots
        # N-gram speculative decoding (models/speculative.py): verify K
        # prompt-lookup drafts per tick in one (K+1)-position forward; 0
        # disables it, and the n-gram order is then inert.
        self.speculative_k = int(speculative_k)
        self.speculative_ngram = int(speculative_ngram)
        self.max_seq = max_seq or cfg.max_seq_len
        self.eos_id = eos_id
        # Weights in the compute dtype on the device, cast once.
        self.params = to_compute(params, cfg, self.device)
        # Long-context prefill: prompts longer than this process in fixed
        # chunks (O(T*S) attention) instead of one power-of-2 bucket
        # (O(T^2) mask memory). 0 = bucketed only.
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.prefill_chunk and self.max_seq % self.prefill_chunk:
            # A final chunk crossing max_seq would write past the cache.
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must divide "
                f"max_seq ({self.max_seq})")
        self._alloc_cache()
        self.lengths = np.zeros(max_slots, np.int32)
        self.tokens = np.zeros(max_slots, np.int32)   # last token per slot
        self.active: List[Optional[_Request]] = [None] * max_slots
        self.queue: List[_Request] = []
        self.done: Dict[int, List[int]] = {}
        self._next_id = 0
        # Speculation telemetry: acceptance rate = accepted / drafted.
        self.spec_stats = {"ticks": 0, "drafted": 0, "accepted": 0,
                           "emitted": 0}

    def _alloc_cache(self) -> None:
        """Allocate the contiguous KV cache [L, slots, max_seq, KH, Dh]. A
        hook so the paged engine never allocates it, not even for a moment:
        at the small page budgets it exists for, that spike alone could
        exhaust the card's memory."""
        cfg = self.cfg
        shape = (cfg.n_layers, self.slots, self.max_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        self.cache_k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.cache_v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)

    # ---- public API ----

    def validate(self, prompt: List[int], max_new_tokens: int,
                 temperature: float = 0.0, seed=None, stop=None) -> None:
        """Raise ValueError if this request can never be served — callers
        submitting several requests atomically validate ALL first."""
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) "
                f"exceeds max_seq {self.max_seq}")
        t = float(temperature)
        if not (math.isfinite(t) and t >= 0):
            raise ValueError(f"temperature must be finite and >= 0, got {t}")
        if seed is not None and (
                not isinstance(seed, (int, np.integer)) or seed < 0):
            raise ValueError(
                f"seed must be a non-negative int, got {seed!r}")
        for sq in (stop or []):
            # isinstance list/tuple FIRST: a flat token list (stop=[220])
            # must raise the documented ValueError, not a TypeError.
            if (not isinstance(sq, (list, tuple)) or not sq
                    or not all(isinstance(t, (int, np.integer))
                               for t in sq)):
                raise ValueError(
                    f"stop sequences must be non-empty token-id lists "
                    f"(e.g. stop=[[220]]), got {sq!r}")

    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: float = 0.0, seed: Optional[int] = None,
               stop: Optional[List[List[int]]] = None) -> int:
        """temperature 0 = greedy (equal to generate()); > 0 samples
        host-side from the same logits with a per-request PRNG. ``stop``:
        token-id sequences that end generation the moment the output ends
        with one (stop tokens included, like EOS)."""
        self.validate(prompt, max_new_tokens, temperature, seed, stop)
        req = _Request(self._next_id, prompt, max_new_tokens,
                       temperature=temperature, seed=seed, stop=stop)
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    @torch.inference_mode()
    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit queued requests, decode one token on every active slot.
        Returns [(req_id, token, done)] for EVERY token produced this tick,
        including the prefill-produced first token of newly admitted
        requests."""
        events = self._admit()
        if not any(r is not None for r in self.active):
            return events
        if self.speculative_k > 0:
            return self._spec_step(events)
        return self._emit_single(self._decode_all(), events)

    def _emit_single(self, logits: torch.Tensor,
                     events: List[Tuple[int, int, bool]]
                     ) -> List[Tuple[int, int, bool]]:
        """Emit one token per active slot from decode logits [B, V]. Greedy
        slots take the device argmax as one [B] int copy; only the sampling
        slots' logits ROWS come to the host."""
        sampling_slots = [s for s, r in enumerate(self.active)
                          if r is not None and r.temperature > 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        rows = (logits[sampling_slots].float().cpu().numpy()
                if sampling_slots else None)
        row_of = {s: i for i, s in enumerate(sampling_slots)}
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            token = (req.pick(rows[row_of[slot]]) if slot in row_of
                     else int(nxt[slot]))
            req.out.append(token)
            if req.ng is not None:
                req.ng.extend([token])
            self.lengths[slot] += 1
            self.tokens[slot] = token
            finished = (len(req.out) >= req.max_new_tokens
                        or (self.eos_id is not None and token == self.eos_id)
                        or req.hit_stop())
            events.append((req.req_id, token, finished))
            if finished:
                self.done[req.req_id] = req.out
                self._release_slot(slot)
        return events

    def cancel(self, req_id: int) -> bool:
        """Abandon a request: queued ones never run, active ones free their
        slot this tick, finished ones drop their buffered output. Returns
        True if anything was cancelled."""
        for i, r in enumerate(self.queue):
            if r.req_id == req_id:
                del self.queue[i]
                return True
        for slot, r in enumerate(self.active):
            if r is not None and r.req_id == req_id:
                self._release_slot(slot)
                return True
        return self.done.pop(req_id, None) is not None

    def run_until_done(self) -> Dict[int, List[int]]:
        while self.queue or any(r is not None for r in self.active):
            self.step()
        out, self.done = self.done, {}
        return out

    # ---- speculative decoding ----

    def _spec_possible(self) -> bool:
        """The (K+1)-wide verify chunk writes cache rows lengths..lengths+K
        for EVERY slot; a slot within K+1 rows of max_seq would write past
        the end (clamped onto valid rows), so such ticks run a width-1
        chunk — only the last few tokens of a nearly full slot."""
        K = self.speculative_k
        for slot, req in enumerate(self.active):
            if req is not None \
                    and self.lengths[slot] + K + 1 > self.max_seq:
                return False
        return True

    def _spec_step(self, events: List[Tuple[int, int, bool]]
                   ) -> List[Tuple[int, int, bool]]:
        """One speculative tick: propose prompt-lookup drafts per slot
        (incremental NgramIndex, O(1) a token), verify them all in a single
        (K+1)-position forward, emit the longest verified prefix + one
        bonus token per slot. Draft-less ticks (no n-gram hit anywhere,
        cache-boundary slots, all-sampling batches) run the SAME verify
        forward at width 1, so with speculation on every logit comes from
        one forward and greedy acceptance is exact by construction.
        Sampling slots accept no drafts; their next token samples from
        chunk position 0. Greedy slots take the device argmax as one
        [B, K+1] int copy; only the sampling slots' position-0 logits rows
        come to the host."""
        B, K = self.slots, self.speculative_k
        drafts = np.zeros((B, K), np.int32)
        dlen = np.zeros(B, np.int32)
        if self._spec_possible():
            for slot, req in enumerate(self.active):
                if req is None or req.temperature > 0:
                    continue
                if req.ng is None:
                    req.ng = NgramIndex(self.speculative_ngram,
                                        req.prompt + req.out)
                room = min(K, self.max_seq - len(req.ng.ctx) - 1,
                           req.max_new_tokens - len(req.out) - 1)
                if room <= 0:
                    continue
                d = req.ng.propose(room)
                dlen[slot] = len(d)
                drafts[slot, :len(d)] = d
        self.spec_stats["ticks"] += 1
        width = K + 1 if dlen.any() else 1
        if width == 1 and self._spec_plain_when_draftless:
            # Paged engine: a width-1 verify would gather the whole page
            # pool per layer, the sweep the paged-decode kernel K7 exists
            # to skip; draft-less ticks take it instead (the near-tie
            # caveat of models/speculative.py applies).
            return self._emit_single(self._decode_all(), events)
        chunk = np.concatenate(
            [self.tokens[:, None], drafts[:, :width - 1]], axis=1)
        logits = self._verify_all(chunk)                        # [B, S, V]
        greedy = torch.argmax(logits, dim=-1).to(
            torch.int32).cpu().numpy()                          # [B, S]
        sampling_slots = [s for s, r in enumerate(self.active)
                          if r is not None and r.temperature > 0]
        rows = (logits[sampling_slots, 0].float().cpu().numpy()
                if sampling_slots else None)
        row_of = {s: i for i, s in enumerate(sampling_slots)}
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            greedy_slot = slot not in row_of
            if greedy_slot:
                a = longest_accept(drafts[slot], int(dlen[slot]),
                                   greedy[slot])
                emitted = [int(t) for t in greedy[slot, :a + 1]]
            else:
                emitted = [req.pick(rows[row_of[slot]])]
            # Truncate at max_new_tokens / EOS / a stop sequence (each
            # finishes the slot).
            out_tokens: List[int] = []
            finished = False
            for t in emitted:
                out_tokens.append(t)
                if (len(req.out) + len(out_tokens) >= req.max_new_tokens
                        or (self.eos_id is not None and t == self.eos_id)
                        or req.hit_stop(out_tokens)):
                    finished = True
                    break
            if greedy_slot:
                # Counted AFTER truncation: tokens cut at EOS or
                # max_new_tokens must not inflate the acceptance rate.
                st = self.spec_stats
                st["drafted"] += int(dlen[slot])
                st["accepted"] += min(a, len(out_tokens) - 1)
                st["emitted"] += len(out_tokens)
            req.out.extend(out_tokens)
            if req.ng is not None:
                req.ng.extend(out_tokens)
            self.lengths[slot] += len(out_tokens)
            self.tokens[slot] = out_tokens[-1]
            for i, t in enumerate(out_tokens):
                events.append((req.req_id, t,
                               finished and i == len(out_tokens) - 1))
            if finished:
                self.done[req.req_id] = req.out
                self._release_slot(slot)
        return events

    def _verify_all(self, chunk: np.ndarray) -> torch.Tensor:
        """Speculative verify over every slot (chunk [B, S]); returns
        logits [B, S, V]. Subclass hook: the paged engine routes the
        chunk's cache writes through its page tables."""
        return _batched_verify(
            self.params, self._device_ints(chunk),
            self._device_ints(self.lengths), self.cache_k, self.cache_v,
            self.cfg)

    # ---- internals ----

    def _device_ints(self, arr: np.ndarray) -> torch.Tensor:
        # A copy: the host arrays change after the call.
        return torch.tensor(arr, dtype=torch.int32, device=self.device)

    def _decode_all(self) -> torch.Tensor:
        """One lockstep decode over every slot; returns logits [B, V]."""
        return _batched_decode(
            self.params, self._device_ints(self.tokens),
            self._device_ints(self.lengths), self.cache_k, self.cache_v,
            self.cfg)

    def _release_slot(self, slot: int) -> None:
        self.active[slot] = None
        self.lengths[slot] = 0

    def _can_admit(self, req: _Request) -> bool:
        """Capacity gate beyond free slots (paged engine: page budget)."""
        return True

    def _admit(self) -> List[Tuple[int, int, bool]]:
        """Fill free slots from the queue; a request that finishes at
        prefill frees its slot immediately, so the same slot can admit
        several one-token requests within one tick. Returns the
        prefill-produced (req_id, first_token, done) events. FIFO: if the
        queue head can't be admitted (capacity gate), nothing behind it
        jumps ahead."""
        events: List[Tuple[int, int, bool]] = []
        for slot in range(self.slots):
            while self.queue and self.active[slot] is None:
                if not self._can_admit(self.queue[0]):
                    return events
                req = self.queue.pop(0)
                done = self._prefill_slot(slot, req)
                events.append((req.req_id, req.out[0], done))
                if not done:
                    self.active[slot] = req  # decode continues next
        return events

    def _prefill_slot(self, slot: int, req: _Request) -> bool:
        """In-place prefill of this slot's cache region; the first
        generated token comes from the real-last-position logits. Returns
        True if the request finished at prefill (one token or EOS).
        Prompts longer than ``prefill_chunk`` (when set) stream through
        the chunked path; shorter ones take the pow-2 bucket path."""
        T0 = len(req.prompt)
        C = self.prefill_chunk
        if C and T0 > C:
            logits = None
            for s0 in range(0, T0, C):
                chunk = req.prompt[s0:s0 + C]
                chunk = chunk + [0] * (C - len(chunk))
                logits = _prefill_chunk(
                    self.params, self._device_ints(np.asarray([chunk])), s0,
                    slot, (T0 - 1) % C, self.cache_k, self.cache_v, self.cfg)
        else:
            bucket = min(1 << (T0 - 1).bit_length(), self.max_seq)
            padded = req.prompt + [0] * (bucket - T0)
            logits = _prefill_into_slot(
                self.params, self._device_ints(np.asarray([padded])), T0,
                slot, self.cache_k, self.cache_v, self.cfg)
        first = req.pick(logits.float().cpu().numpy())
        req.out.append(first)
        # Next decode for this slot attends from `first` at position T0.
        self.lengths[slot] = T0
        self.tokens[slot] = first
        if (len(req.out) >= req.max_new_tokens
                or (self.eos_id is not None and first == self.eos_id)
                or req.hit_stop()):
            self.done[req.req_id] = req.out
            self.lengths[slot] = 0
            return True
        return False
