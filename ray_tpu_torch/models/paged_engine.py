"""Paged-KV continuous-batching engine (counterpart:
``ray_tpu/models/paged_engine.py``; vLLM-style memory management on the
engine of ``models/engine.py``).

The contiguous engine preallocates ``slots * max_seq`` cache rows per
layer; most requests use a fraction of max_seq, so most of that memory is
dead. Here every layer's KV cache is a shared pool of fixed-size pages
(``[L, num_pages, page_size, KH, Dh]``) and each active request owns just
``ceil((prompt+max_new)/page_size)`` pages, handed out by
``ops.paged_attention.PagePool`` and returned the moment the request
finishes. Admission is gated on page budget (FIFO), so a smaller pool
degrades to queueing instead of running out of memory.

Decode attends through ``paged_decode_attention`` (kernel K7 on the card:
the flash-decode loop reading rows through the page table); prefill runs
the normal causal forward over the prompt (which needs no pool) and
scatters the resulting K/V rows through the page indirection. Page 0 is a
reserved scratch page: pad positions and idle slots write there, so
clamped indices can never corrupt a live sequence. Every pool write is in
place (the JAX package donates the pools to its jitted programs).

Greedy outputs equal the contiguous engine's and single-request
``generate()``'s (same math, different storage; on the card K7 walks K6's
tiles with K6's arithmetic).

Prefix caching: finished prompts leave their IMMUTABLE full page-aligned
blocks resident in the pool, keyed by a chained content hash; a later
prompt with the same head joins those pages read-only (refcounted) instead
of re-storing them, so same-prefix fan-out admits ~pool/incremental-pages
concurrent requests instead of pool/total-pages. Cache-pinned pages evict
LRU under pool pressure. Shared pages are never re-written (prefill routes
their scatter rows to the scratch page): another live sequence may be
attending to them, and a re-computed row can differ in low bits when the
original prefill ran at a different bucket length.

Speculative decoding (``speculative_k > 0``) verifies through the page
tables (``_paged_verify``): the chunk's rows scatter through each slot's
table, out-of-range positions and -1 entries to the scratch page, and
attention runs over the gathered pool, plain PyTorch as the JAX package's
is XLA. A tick with no drafts anywhere takes ``_decode_all`` and so K7.

With a tp ``mesh`` the page pools are allocated at KH/tp heads on the
rank's device and every forward takes the base engine's tp rules (the
rank's block of the weights, its heads, partial sums and logits gathered
over tp); page tables and the prefix cache stay host state, which every
rank computes alike because every rank admits the same requests in the
same order. K7 runs over the rank's heads.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import Device
from ..ops.attention import masked_gqa_attention
from ..ops.paged_attention import (
    PagePool, paged_decode_attention, paged_gather, write_paged,
)
from ..parallel.mesh import Mesh
from .engine import GenerationEngine, _Request, _rope_at
from .transformer import (Params, TransformerConfig, _attn_out, _decoder,
                          _embed, _heads, _layers, _logits, _mlp_tp, _rope)


def _paged_decode(params: Params, tokens: torch.Tensor,
                  lengths: torch.Tensor, tables: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: TransformerConfig,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """tokens [B] at positions ``lengths`` [B] -> logits [B, V].

    k_pages/v_pages: [L, num_pages, ps, KH, Dh], written IN PLACE; tables
    [B, P] int32 (-1 padded — clamped writes land on the reserved scratch
    page 0). Under a mesh: the rank's weights and KH/tp heads."""
    B = tokens.shape[0]
    (H, KH), Dh = _heads(cfg, mesh), cfg.head_dim
    ps = k_pages.shape[2]
    x = _embed(params["embed"], tokens, mesh)[:, None, :]       # [B, 1, E]
    # Global pool row for each slot's current position, through its table.
    page = tables.gather(1, (lengths // ps).long()[:, None])[:, 0]   # [B]
    rows = page.clamp_min(0) * ps + lengths % ps                  # [B]

    def attend(i, layer, h):
        q = _rope_at((h @ layer["wq"]).reshape(B, 1, H, Dh), lengths,
                     cfg.rope_theta)
        k = _rope_at((h @ layer["wk"]).reshape(B, 1, KH, Dh), lengths,
                     cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(B, 1, KH, Dh)
        write_paged(k_pages[i], rows, k[:, 0])
        write_paged(v_pages[i], rows, v[:, 0])
        attn = paged_decode_attention(
            q[:, 0].contiguous(), k_pages[i], v_pages[i], tables,
            lengths).reshape(B, 1, H * Dh)
        return _attn_out(attn, layer["wo"], mesh)

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend, _mlp_tp(mesh))
    return _logits(x[:, 0], params["embed"], mesh)


def _paged_verify(params: Params, tokens: torch.Tensor,
                  lengths: torch.Tensor, tables: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: TransformerConfig,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Speculative verify through page indirection: tokens [B, S]
    (current + S-1 drafts) at positions lengths..lengths+S-1 -> logits
    [B, S, V]. Chunk K/V rows scatter IN PLACE through each slot's page
    table; positions past the table and -1 entries go to the scratch page
    0, so a draft position past a request's reserved pages can never
    corrupt a live page. Shared prefix pages lie strictly before the
    prompt's end and so before every chunk position: the verify never
    writes them. Several slots' scratch rows may collide on page 0 (which
    of the values lands is unspecified); that is harmless because page 0
    is never attended by a position whose logits are used: those positions
    lie inside their slot's reserved pages. Attention gathers the pool to
    the logical layout and masks col <= lengths+i (plain PyTorch, as the
    JAX package's is XLA; chunk widths are small)."""
    B, S = tokens.shape
    (H, KH), Dh = _heads(cfg, mesh), cfg.head_dim
    ps = k_pages.shape[2]
    P = tables.shape[1]
    dev = tokens.device
    x = _embed(params["embed"], tokens, mesh)                   # [B, S, E]
    positions = (lengths[:, None].long()
                 + torch.arange(S, device=dev)[None, :])        # [B, S]
    page_idx = positions // ps
    page = torch.where(page_idx < P,
                       tables.long().gather(1, page_idx.clamp_max(P - 1)),
                       -1)
    rows = (page.clamp_min(0) * ps + positions % ps).reshape(-1)  # [B*S]
    mask = (torch.arange(P * ps, device=dev)[None, None, :]
            <= positions[:, :, None])                           # [B, S, P*ps]

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(B, S, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(B, S, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(B, S, KH, Dh)
        write_paged(k_pages[i], rows, k.reshape(-1, KH, Dh))
        write_paged(v_pages[i], rows, v.reshape(-1, KH, Dh))
        buf_k = paged_gather(k_pages[i], tables)            # [B, P*ps, ...]
        buf_v = paged_gather(v_pages[i], tables)
        attn = masked_gqa_attention(q, buf_k, buf_v, mask).reshape(
            B, S, H * Dh)
        return _attn_out(attn, layer["wo"], mesh)

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend, _mlp_tp(mesh))
    return _logits(x, params["embed"], mesh)                    # [B, S, V]


def _paged_prefill_chunk(params: Params, tokens: torch.Tensor, start: int,
                         last_idx: int, rows: torch.Tensor,
                         table_row: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, cfg: TransformerConfig,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One CHUNK of a long prompt through page indirection: tokens [1, C]
    at positions start..start+C-1 -> logits [V] at in-chunk row
    ``last_idx``. Chunk K/V scatter to pool rows ``rows`` [C]
    (shared-prefix and pad positions route to the scratch page — their
    valid K/V already live in shared pages / are never attended); each
    position attends the slot's gathered pool at cols 0..start+i, which
    covers previous chunks AND shared prefix pages — so fully-shared chunks
    can be SKIPPED entirely by the caller (prefix-cache compute reuse, not
    just memory reuse)."""
    _, C = tokens.shape
    (H, KH), Dh = _heads(cfg, mesh), cfg.head_dim
    ps = k_pages.shape[2]
    P = table_row.shape[0]
    dev = tokens.device
    x = _embed(params["embed"], tokens, mesh)                   # [1, C, E]
    positions = start + torch.arange(C, device=dev)
    mask = (torch.arange(P * ps, device=dev)[None, :]
            <= positions[:, None])                              # [C, P*ps]

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(1, C, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(1, C, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(1, C, KH, Dh)
        write_paged(k_pages[i], rows, k[0])
        write_paged(v_pages[i], rows, v[0])
        buf_k = paged_gather(k_pages[i], table_row[None])   # [1, P*ps, ...]
        buf_v = paged_gather(v_pages[i], table_row[None])
        attn = masked_gqa_attention(q, buf_k, buf_v, mask).reshape(
            1, C, H * Dh)
        return _attn_out(attn, layer["wo"], mesh)

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend, _mlp_tp(mesh))
    return _logits(x[0, last_idx], params["embed"], mesh)       # [V]


def _paged_prefill(params: Params, tokens: torch.Tensor, real_len: int,
                   rows: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, cfg: TransformerConfig,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Prompt [1, Tb] (bucket-padded) -> logits [V] at real_len-1; each
    layer's prompt K/V rows scatter into the pool at global rows ``rows``
    [Tb] (pad positions point at the scratch page). The forward itself is
    the standard causal attention over the prompt — prefill never reads the
    pool."""
    _, Tb = tokens.shape
    (H, KH), Dh = _heads(cfg, mesh), cfg.head_dim
    dev = tokens.device
    x = _embed(params["embed"], tokens, mesh)                   # [1, Tb, E]
    positions = torch.arange(Tb, device=dev)
    causal = positions[None, :] <= positions[:, None]

    def attend(i, layer, h):
        q = _rope((h @ layer["wq"]).reshape(1, Tb, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope((h @ layer["wk"]).reshape(1, Tb, KH, Dh), positions,
                  cfg.rope_theta)
        v = (h @ layer["wv"]).reshape(1, Tb, KH, Dh)
        write_paged(k_pages[i], rows, k[0])
        write_paged(v_pages[i], rows, v[0])
        attn = masked_gqa_attention(q, k, v, causal).reshape(1, Tb, H * Dh)
        return _attn_out(attn, layer["wo"], mesh)

    x = _decoder(x, _layers(params, cfg), params["final_norm"],
                 cfg.norm_eps, attend, _mlp_tp(mesh))
    return _logits(x[0, real_len - 1], params["embed"], mesh)   # [V]


class PagedGenerationEngine(GenerationEngine):
    """GenerationEngine with paged KV memory.

    ``num_pages`` bounds TOTAL cache memory independently of
    slots * max_seq: requests reserve ceil((prompt+max_new)/page_size)
    pages at admission (no mid-decode exhaustion) and queue FIFO when the
    pool is exhausted. Page 0 is reserved as the scratch target for
    pad/idle writes.
    """

    # Draft-less speculative ticks take K7 (_decode_all): a width-1 verify
    # would gather the whole page pool per layer.
    _spec_plain_when_draftless = True

    def __init__(self, params: Params, cfg: TransformerConfig, *,
                 max_slots: int = 4, max_seq: Optional[int] = None,
                 eos_id: Optional[int] = None, page_size: int = 128,
                 num_pages: Optional[int] = None, speculative_k: int = 0,
                 speculative_ngram: int = 2, prefill_chunk: int = 0,
                 mesh: Optional[Mesh] = None, device: Device = None):
        super().__init__(params, cfg, max_slots=max_slots, max_seq=max_seq,
                         eos_id=eos_id, speculative_k=speculative_k,
                         speculative_ngram=speculative_ngram, mesh=mesh,
                         prefill_chunk=prefill_chunk, device=device)
        # The pools at the rank's KH/tp heads under a mesh.
        L, KH, Dh = cfg.n_layers, _heads(cfg, mesh)[1], cfg.head_dim
        self.page_size = ps = page_size
        self.pages_per_slot = -(-self.max_seq // ps)
        if num_pages is None:
            num_pages = max_slots * self.pages_per_slot + 1  # +1 scratch
        if num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages={num_pages} cannot fit one max_seq sequence "
                f"({self.pages_per_slot} pages) plus the scratch page")
        self.num_pages = num_pages
        shape = (L, num_pages, ps, KH, Dh)
        self.k_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.pool = PagePool(num_pages, ps)
        self.pool.alloc(seq=-1, tokens=1)       # pin page 0 as scratch
        if self.pool.pages_for(-1) != [0]:
            raise RuntimeError("page 0 must be the scratch page")
        # Page tables, one row per slot (-1 padded), rebuilt on
        # admit/release; the shape is fixed.
        self._tables = np.full((max_slots, self.pages_per_slot), -1,
                               np.int32)
        self._prompt_keys: dict = {}  # req_id -> prefix block keys (memo)

    # ------------------------------------------------------------ hooks
    def _alloc_cache(self) -> None:
        """Pages are allocated in __init__ (they need page_size/num_pages,
        known only after super().__init__ returns); the base class's
        contiguous [L, slots, max_seq, KH, Dh] cache is NEVER allocated."""

    def _prefix_keys(self, prompt: List[int]):
        """(chained hash, block tokens) for the prompt's IMMUTABLE full
        blocks — those strictly before the decode boundary (decode writes
        start at position len(prompt), so block j is immutable iff
        (j+1)*page_size <= len(prompt)). The tokens travel with the key so
        every cache probe verifies content, not just the 64-bit hash."""
        ps = self.page_size
        keys, h = [], 0
        for j in range(len(prompt) // ps):
            blk = tuple(prompt[j * ps:(j + 1) * ps])
            h = PagePool.chain_hash(h, blk)
            keys.append((h, blk))
        return keys

    def _keys_for(self, req: _Request):
        """Memoized per request: _can_admit runs every engine tick while a
        request waits at the queue head, and rehashing the whole prompt per
        tick would be O(prompt) host work per generated token. Entries for
        departed requests are pruned against the live queue."""
        keys = self._prompt_keys.get(req.req_id)
        if keys is None:
            live = {r.req_id for r in self.queue}
            self._prompt_keys = {rid: k for rid, k
                                 in self._prompt_keys.items() if rid in live}
            keys = self._prompt_keys[req.req_id] = \
                self._prefix_keys(req.prompt)
        return keys

    def _cached_prefix(self, keys, *, promote: bool) -> List[int]:
        """Pages of the longest run of consecutive cached blocks from the
        start. ``promote`` refreshes LRU (use only when actually taking the
        pages); admission probes peek."""
        fetch = self.pool.cache_get if promote else self.pool.cache_peek
        pages: List[int] = []
        for key, blk in keys:
            page = fetch(key, blk)
            if page is None:
                break
            pages.append(page)
        return pages

    def _prefix_hits(self, prompt: List[int]) -> int:
        return len(self._cached_prefix(self._prefix_keys(prompt),
                                       promote=False))

    def _can_admit(self, req: _Request) -> bool:
        total = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        hits = len(self._cached_prefix(self._keys_for(req), promote=False))
        # Cache-pinned pages no live sequence reads are reclaimable on
        # demand (alloc evicts LRU) — but the request's own hit pages are
        # among them and will be share()d, not evicted, so they must not be
        # double-counted as reclaimable headroom.
        reclaimable = max(0, self.pool.evictable_pages - hits)
        return self.pool.free_pages + reclaimable >= total - hits

    def _release_slot(self, slot: int) -> None:
        super()._release_slot(slot)
        self.pool.free(slot)
        self._tables[slot] = -1

    def _decode_all(self) -> torch.Tensor:
        return _paged_decode(
            self.params, self._device_ints(self.tokens),
            self._device_ints(self.lengths), self._device_ints(self._tables),
            self.k_pages, self.v_pages, self.cfg, self.mesh)

    def _verify_all(self, chunk: np.ndarray) -> torch.Tensor:
        return _paged_verify(
            self.params, self._device_ints(chunk),
            self._device_ints(self.lengths), self._device_ints(self._tables),
            self.k_pages, self.v_pages, self.cfg, self.mesh)

    def _prefill_slot(self, slot: int, req: _Request) -> bool:
        T0 = len(req.prompt)
        C = self.prefill_chunk
        chunked = bool(C and T0 > C)
        self.pool.free(slot)  # defensive: slot ids are reused as seq ids
        # Prefix reuse: join the longest cached run of immutable prompt
        # blocks (their K/V is already resident — same tokens at the same
        # absolute positions), then reserve the REST of the page budget up
        # front (admission checked it fits): growth during decode can't
        # exhaust the pool mid-flight.
        keys = self._prompt_keys.pop(req.req_id, None) \
            or self._prefix_keys(req.prompt)
        shared = self._cached_prefix(keys, promote=True)
        self.pool.share(slot, shared)
        self.pool.alloc(slot, T0 + req.max_new_tokens)
        pages = np.asarray(self.pool.pages_for(slot), np.int32)
        self._tables[slot] = -1
        self._tables[slot, :len(pages)] = pages
        ps = self.page_size
        # Layout width: pow-2 bucket, or the chunk SPAN ceil(T0/C)*C —
        # which can exceed the bucket when T0 is itself a power of two.
        bucket = min(1 << (T0 - 1).bit_length(), self.max_seq)
        width = -(-T0 // C) * C if chunked else bucket
        # Global pool rows for every layout position; pad positions beyond
        # the owned range AND shared-prefix positions land on scratch page
        # 0: a shared page is immutable (another live sequence may be
        # attending to it mid-decode), and this prefill's recomputed rows
        # could differ in low bits when the original ran at a different
        # bucket length. ONE copy of this routing — it is the
        # shared-page-immutability safety logic.
        logical = np.arange(width)
        page_idx = logical // ps
        writable = (page_idx < len(pages)) & (page_idx >= len(shared))
        rows = np.where(writable,
                        pages[np.minimum(page_idx, len(pages) - 1)] * ps
                        + logical % ps,
                        logical % ps)  # scratch page 0
        if chunked:
            # Chunked long-context prefill. Chunks lying entirely inside
            # the shared-prefix region are SKIPPED: their K/V already live
            # in shared pages, and no later computation reads their hidden
            # states — prefix-cache compute reuse.
            shared_rows = len(shared) * ps
            table_row = self._device_ints(self._tables[slot])
            logits = None
            for s0 in range(0, T0, C):
                is_final = s0 + C >= T0
                if not is_final and s0 + C <= shared_rows:
                    continue
                chunk = req.prompt[s0:s0 + C]
                chunk = chunk + [0] * (C - len(chunk))
                logits = _paged_prefill_chunk(
                    self.params, self._device_ints(np.asarray([chunk])), s0,
                    (T0 - 1) % C, self._device_ints(rows[s0:s0 + C]),
                    table_row, self.k_pages, self.v_pages, self.cfg,
                    self.mesh)
        else:
            padded = req.prompt + [0] * (bucket - T0)
            logits = _paged_prefill(
                self.params, self._device_ints(np.asarray([padded])), T0,
                self._device_ints(rows), self.k_pages, self.v_pages,
                self.cfg, self.mesh)
        # The blocks this prefill just wrote are now resident + immutable:
        # publish them so later prompts with the same head reuse the pages.
        for j in range(len(shared), len(keys)):
            key, blk = keys[j]
            self.pool.cache_put(key, int(pages[j]), blk)
        first = req.pick(logits.float().cpu().numpy())
        req.out.append(first)
        self.lengths[slot] = T0
        self.tokens[slot] = first
        if (len(req.out) >= req.max_new_tokens
                or (self.eos_id is not None and first == self.eos_id)
                or req.hit_stop()):
            self.done[req.req_id] = req.out
            self._release_slot(slot)
            return True
        return False
