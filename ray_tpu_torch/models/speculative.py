"""N-gram (prompt-lookup) speculative decoding for the generation engine
(counterpart: ``ray_tpu/models/speculative.py``).

A decode tick normally advances every slot by ONE token. Decode at serving
batch sizes is bound by reading the weights, which costs about the same
whatever the number of positions riding along, so verifying K draft tokens
in one (K+1)-position forward costs little more than a one-token tick and
may emit up to K+1 tokens.

Drafts come from PROMPT LOOKUP (no draft model): the most recent earlier
occurrence of the slot's trailing n-gram in its own context proposes the
tokens that followed it, which hits on repetitive or quoting text (code,
extraction, summaries that quote the source). Verification is exact for
greedy requests: with speculation on, every logit of the contiguous engine
(draft-less ticks included, which run this forward at width 1) comes from
this one chunk forward, so an accepted token is by construction the argmax
the same forward would have produced one position at a time. On the CPU
every path runs the plain versions and spec-on greedy tokens equal
spec-off ones. On the card this forward (dense ``masked_gqa_attention``)
and the flash-decode kernels K6/K7 round differently, so a near-tie logit
pair can make spec-on and spec-off greedy tokens differ: the caveat of any
speculative scheme whose verify differs from its decode. SAMPLING slots
(temperature > 0) draw from the chunk's position-0 logits; a seeded
sampled stream is reproducible across runs of the same workload, but not
bit-matched to the spec-off engine where the kernels' low bits differ.

``propose_ngram``, ``NgramIndex`` and ``longest_accept`` are host-side
Python, the JAX package's copied whole.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.attention import masked_gqa_attention
from ..parallel.mesh import Mesh
from .transformer import (Params, TransformerConfig, _attn_out, _decoder,
                          _embed, _heads, _layers, _logits, _mlp_tp, _rope)


def _batched_verify(params: Params, tokens: torch.Tensor,
                    lengths: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, cfg: TransformerConfig,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Verify forward: tokens [B, S] (current token + S-1 drafts) at
    positions lengths..lengths+S-1 -> logits [B, S, V].

    Every chunk position's K/V is written IN PLACE into the slot's rows of
    cache_[kv] [L, B, S_max, KH, Dh]; position i attends cache rows
    0..lengths+i (its own row included). The write starts at
    min(lengths, S_max - S), the clamp of the JAX package's
    ``dynamic_update_slice``: the engine never asks for a chunk past
    S_max (``_spec_possible``; idle slots sit at length 0), and the clamp
    keeps an index write from ever leaving the cache. Rows written for
    REJECTED drafts hold garbage afterwards, which the next decode or
    verify overwrites before any attend reaches it. Under a mesh, the
    engine's tp rules: the rank's weights and KH/tp heads, partials summed
    and logits gathered over tp; the attention stays plain."""
    B, S = tokens.shape
    (H, KH), Dh = _heads(cfg, mesh), cfg.head_dim
    S_max = cache_k.shape[2]
    dev = tokens.device
    x = _embed(params["embed"], tokens, mesh)                   # [B, S, E]
    offsets = torch.arange(S, device=dev)
    positions = lengths[:, None].long() + offsets[None, :]      # [B, S]
    rows = lengths.long().clamp(0, S_max - S)[:, None] + offsets[None, :]
    slots = torch.arange(B, device=dev)[:, None]
    # mask [B, S, S_max]: position i sees cache rows <= lengths+i.
    mask = (torch.arange(S_max, device=dev)[None, None, :]
            <= positions[:, :, None])

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(B, S, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(B, S, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(B, S, KH, Dh)
        cache_k[i, slots, rows] = k
        cache_v[i, slots, rows] = v
        attn = masked_gqa_attention(q, cache_k[i], cache_v[i],
                                    mask).reshape(B, S, H * Dh)
        return _attn_out(attn, layer["wo"], mesh)

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend, _mlp_tp(mesh))
    return _logits(x, params["embed"], mesh)                    # [B, S, V]


def propose_ngram(context: Sequence[int], k: int,
                  ngram: int = 2) -> List[int]:
    """Prompt-lookup draft: find the most recent EARLIER occurrence of the
    trailing ``ngram`` tokens in ``context`` and propose the k tokens that
    followed it. Returns [] when there is no match (or not enough
    context). O(context) scan — the engine uses the incremental
    NgramIndex instead; this form remains as the executable spec."""
    n = len(context)
    if n <= ngram:
        return []
    tail = tuple(context[-ngram:])
    # Search right-to-left for the previous occurrence (excluding the
    # trailing position itself).
    for start in range(n - ngram - 1, -1, -1):
        if tuple(context[start:start + ngram]) == tail:
            follow = context[start + ngram:start + ngram + k]
            return list(follow)
    return []


class NgramIndex:
    """Incremental last-occurrence index of n-grams over one request's
    context: O(1) per appended token, O(k) per proposal — a per-tick
    O(context) rescan would dominate the host side of long-context
    serving. Tracks the last TWO start positions per gram so the lookup
    can skip the trailing gram itself. Proposals match propose_ngram
    exactly (asserted in tests)."""

    __slots__ = ("n", "ctx", "map")

    def __init__(self, n: int, context: Sequence[int] = ()):
        self.n = n
        self.ctx: List[int] = []
        self.map: dict = {}      # gram -> (last_start, previous_start)
        self.extend(context)

    def extend(self, tokens: Sequence[int]) -> None:
        for t in tokens:
            self.ctx.append(int(t))
            m = len(self.ctx)
            if m >= self.n:
                g = tuple(self.ctx[m - self.n:])
                self.map[g] = (m - self.n, self.map.get(g, (None,))[0])

    def propose(self, k: int) -> List[int]:
        m = len(self.ctx)
        if m <= self.n or k <= 0:
            return []
        tail = tuple(self.ctx[m - self.n:])
        last, prev = self.map.get(tail, (None, None))
        pos = prev if last == m - self.n else last
        if pos is None:
            return []
        return self.ctx[pos + self.n:pos + self.n + k]


def longest_accept(drafts: np.ndarray, draft_len: int,
                   greedy: np.ndarray) -> int:
    """Number of leading drafts verified: draft i is accepted iff it
    equals the greedy continuation after consuming drafts 0..i-1
    (greedy[i] is the argmax at chunk position i)."""
    a = 0
    while a < draft_len and int(drafts[a]) == int(greedy[a]):
        a += 1
    return a
