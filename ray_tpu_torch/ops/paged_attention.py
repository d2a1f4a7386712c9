"""Paged-KV decode attention and the page pool (counterpart:
``ray_tpu/ops/paged_attention.py``).

Layout: one shared pool of fixed-size pages, ``k_pages/v_pages:
[num_pages, page_size, KH, D]``; each sequence owns a list of page ids
(``page_table: [B, max_pages]`` int32, -1 padded). Memory is allocated in
page granules on demand, so N concurrent sequences cost
sum(ceil(len_i/page_size)) pages instead of N * max_seq rows.

``paged_decode_attention`` is the wrapper of kernel K7
(``csrc/paged_decode_attention.cu``): K6's split flash-decode blocks, with
K6's split plan, reading each logical row through the page table. CUDA
tensors go through the kernel (``paged_decode_attention.launches`` counts
its launches), CPU tensors through the plain version, which gathers the
pages into the contiguous layout and delegates to
``masked_gqa_attention``, as the JAX package's XLA path does. It never
falls back from the one to the other.

``PagePool`` is host-side bookkeeping, the JAX package's copied whole.
``write_paged`` updates the pool IN PLACE (JAX returns a new array).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from .attention import (_DTYPES, _SMEM_LIMIT, _decode_split,
                        masked_gqa_attention)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "paged_decode_attention_forward": (
        [_P] * 8 + [_I] * 8 + [_L] * 5 + [ctypes.c_float, _I, _P], _I),
    "paged_decode_attention_smem_bytes": ([_I, _I, _I], _L),
}


def paged_gather(k_pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """[num_pages, ps, KH, D] gathered to [B, max_pages*ps, KH, D] (the
    plain layout). -1 page ids are clamped to page 0; callers mask by
    length so those rows are never attended."""
    safe = page_table.clamp_min(0).long()                  # [B, P]
    gathered = k_pages[safe]                               # [B, P, ps, KH, D]
    B, P, ps, KH, D = gathered.shape
    return gathered.reshape(B, P * ps, KH, D)


def write_paged(pages: torch.Tensor, pool_positions: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Scatter new KV rows into the paged pool, IN PLACE.

    pages [num_pages, ps, KH, D] (contiguous); pool_positions [N] (global
    row = page_id * ps + offset, computed by the caller from its page
    table); values [N, KH, D]. Returns ``pages``. Where positions repeat
    (idle slots all writing the scratch row) the row ends up holding one of
    the values, unspecified which."""
    num_pages, ps, KH, D = pages.shape
    flat = pages.view(num_pages * ps, KH, D)
    flat.index_copy_(0, pool_positions.long(), values.to(pages.dtype))
    return pages


def _paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_table: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Plain paged decode attention: gather, then attend rows 0..lengths[b]
    inclusive (the JAX package's XLA path)."""
    buf_k = paged_gather(k_pages, page_table)
    buf_v = paged_gather(v_pages, page_table)
    S = buf_k.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= lengths[:, None])[:, None, :]
    return masked_gqa_attention(q[:, None], buf_k, buf_v, mask)[:, 0]


def _check_paged_args(q, k_pages, v_pages, page_table, lengths) -> None:
    """Refuse what K7 does not take: dtypes and shapes first, then
    devices, then layout."""
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise TypeError(
            "paged_decode_attention kernel takes float32 or bfloat16 q and "
            f"pages of one dtype, got {q.dtype}, {k_pages.dtype}, "
            f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(
            f"page_table and lengths must be int32, got {page_table.dtype}, "
            f"{lengths.dtype}")
    if (q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or page_table.dim() != 2):
        raise ValueError(
            f"want q [B, H, D], pages [num_pages, ps, KH, D] and page_table "
            f"[B, P], got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}, {tuple(page_table.shape)}")
    B, H, D = q.shape
    num_pages, ps, KH, Dk = k_pages.shape
    if (Dk != D or page_table.shape[0] != B or lengths.shape != (B,)
            or min(B, num_pages, ps, KH, page_table.shape[1]) == 0):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, page_table {tuple(page_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if D not in (64, 128):
        raise ValueError(f"paged_decode_attention kernel takes D in "
                         f"(64, 128), got {D}")
    if H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of kv heads {KH}")
    ts = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_cuda for t in ts):
        raise ValueError(
            "paged_decode_attention kernel takes CUDA tensors, got "
            f"{[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError(
            "paged_decode_attention operands lie on different devices")
    if not (q.is_contiguous() and lengths.is_contiguous()
            and page_table.stride(1) == 1):
        raise ValueError("q, lengths and each page_table row must be "
                         "contiguous")
    vec = 16 // q.element_size()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name}'s last two dims must be contiguous")
        if t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned per row")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths):
    from .._kernels.build import load

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        # The kernel's output would carry no grad_fn; JAX cannot
        # differentiate its _paged_flash_decode either.
        raise RuntimeError(
            "paged_decode_attention has no backward; call it under "
            "torch.no_grad() or torch.inference_mode()")
    _check_paged_args(q, k_pages, v_pages, page_table, lengths)
    B, H, D = q.shape
    num_pages, ps, KH, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // KH
    lib = load("paged_decode_attention", _SIGNATURES)
    smem = lib.paged_decode_attention_smem_bytes(G, D, _DTYPES[q.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"paged_decode_attention: G={G}, D={D} needs {smem} bytes of "
            f"shared memory per block, above the card's {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        # K6's number of splits, so K6's plan and bits.
        n_split, partials, tickets = _decode_split(q, B * KH, G, D)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_forward(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), B, P, ps, num_pages, KH,
            G, D, n_split, page_table.stride(0),
            k_pages.stride(0), k_pages.stride(1), v_pages.stride(0),
            v_pages.stride(1), float(D ** -0.5), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Single-position cached attention over a paged KV pool.

    q [B, H, D]; k_pages/v_pages [num_pages, page_size, KH, D];
    page_table [B, max_pages] int32 (-1 padded); lengths [B] int32
    (inclusive attend bound, like ``decode_attention``) -> [B, H, D].
    CUDA tensors go through the hand-written kernel K7; CPU tensors through
    ``_paged_decode_ref``. It has no backward: on the card it raises when
    grad mode is on and an input requires grad."""
    if q.device.type == "cpu":
        return _paged_decode_ref(q, k_pages, v_pages, page_table, lengths)
    return _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths)


paged_decode_attention.launches = 0


class PagePool:
    """Host-side page allocator for a paged KV cache (the bookkeeping half
    of vLLM's block manager; device tensors live with the caller).

    Free pages are a LIFO; sequences append pages as they grow and return
    them on free. Raises when the pool is exhausted — admission control
    (e.g. an engine's slot queue) decides what to do about it.

    Pages are REFCOUNTED so immutable prompt blocks can be shared between
    sequences (prefix caching): ``share`` joins an existing page to another
    sequence; the prefix CACHE maps a chained content hash of page-aligned
    prompt blocks to the resident page holding its K/V, pinning it (one
    cache ref) until pool pressure evicts it LRU via ``evict``.
    """

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owned: dict = {}  # seq id -> [page ids]
        self._refs: List[int] = [0] * num_pages
        # Chained-hash prefix cache: key -> (page id, block tokens),
        # insertion-ordered = LRU, refreshed on hit. Each entry holds one
        # pinning ref.
        self._prefix_cache: dict = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Cached pages pinned ONLY by the cache (refcount 1): reclaimable
        on demand, so admission may count them as free."""
        return sum(1 for p, _ in self._prefix_cache.values()
                   if self._refs[p] == 1)

    def pages_for(self, seq: int) -> List[int]:
        return list(self._owned.get(seq, ()))

    def alloc(self, seq: int, tokens: int) -> List[int]:
        """Ensure ``seq`` owns enough pages for ``tokens`` total tokens;
        returns newly allocated page ids (may be empty). Evicts unpinned
        prefix-cache pages LRU when the free list alone cannot satisfy."""
        owned = self._owned.setdefault(seq, [])
        need = -(-tokens // self.page_size) - len(owned)
        if need <= 0:
            return []
        if need > len(self._free):
            self.evict(need - len(self._free))
        if need > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {need}, free {len(self._free)}")
        new = [self._free.pop() for _ in range(need)]
        for p in new:
            self._refs[p] = 1
        owned.extend(new)
        return new

    def share(self, seq: int, page_ids: List[int]) -> None:
        """Join existing (immutable) pages to ``seq``'s owned list,
        bumping their refcounts — the capacity win of prefix reuse."""
        owned = self._owned.setdefault(seq, [])
        for p in page_ids:
            self._refs[p] += 1
            owned.append(p)

    def free(self, seq: int) -> int:
        """Drop all of ``seq``'s page refs; pages whose refcount reaches 0
        return to the free list (shared/cached pages survive). Returns how
        many pages were actually freed."""
        pages = self._owned.pop(seq, [])
        freed = 0
        for p in reversed(pages):
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    # ------------------------------------------------------- prefix cache
    @staticmethod
    def chain_hash(prev: int, block_tokens) -> int:
        """Key for one page-aligned prompt block: hashing the previous
        block's key into this one encodes the absolute position, so equal
        token blocks at different depths never collide (RoPE makes K/V
        position-dependent). Python's hash of an int tuple is the same in
        every process and equals the JAX package's key."""
        return hash((prev, tuple(block_tokens)))

    def cache_get(self, key: int, tokens=None) -> Optional[int]:
        """Resident page for a block key, refreshing its LRU position.
        ``tokens``: the block's actual token ids — verified against the
        entry, because trusting the 64-bit hash alone would let a
        collision silently serve another prompt's K/V; a mismatch is a
        miss."""
        ent = self._prefix_cache.get(key)
        if ent is None:
            return None
        page, blk = ent
        if tokens is not None and blk is not None and tuple(tokens) != blk:
            return None
        del self._prefix_cache[key]              # re-insert = most recent
        self._prefix_cache[key] = ent
        return page

    def cache_peek(self, key: int, tokens=None) -> Optional[int]:
        """cache_get without the LRU refresh: admission probes run every
        engine tick and must not promote blocks they aren't (yet) using."""
        ent = self._prefix_cache.get(key)
        if ent is None:
            return None
        page, blk = ent
        if tokens is not None and blk is not None and tuple(tokens) != blk:
            return None
        return page

    def cache_put(self, key: int, page_id: int, tokens=None) -> None:
        """Pin ``page_id`` under ``key``. First writer wins — a duplicate
        key keeps the already-cached page."""
        if key in self._prefix_cache:
            return
        self._refs[page_id] += 1
        self._prefix_cache[key] = (
            page_id, tuple(tokens) if tokens is not None else None)

    def evict(self, n: int) -> int:
        """Drop up to ``n`` LRU cache entries whose pages are pinned only
        by the cache; returns how many pages were reclaimed."""
        got = 0
        for key in list(self._prefix_cache):
            if got >= n:
                break
            page = self._prefix_cache[key][0]
            if self._refs[page] != 1:
                continue                     # a live sequence still reads it
            del self._prefix_cache[key]
            self._refs[page] = 0
            self._free.append(page)
            got += 1
        return got

    def table(self, seqs: List[int], max_pages: Optional[int] = None
              ) -> np.ndarray:
        """Dense [len(seqs), max_pages] int32 page table (-1 padded) for
        the given sequences, in order."""
        width = max_pages or max(
            (len(self._owned.get(s, ())) for s in seqs), default=1) or 1
        out = np.full((len(seqs), width), -1, np.int32)
        for i, s in enumerate(seqs):
            pages = self._owned.get(s, ())
            if len(pages) > width:
                raise ValueError(
                    f"seq {s} owns {len(pages)} pages but the table is "
                    f"only {width} wide — it outgrew the configured "
                    f"max_pages")
            out[i, :len(pages)] = pages
        return out
