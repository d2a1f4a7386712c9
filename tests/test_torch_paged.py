"""The port's paged serving path (ray_tpu_torch.ops.paged_attention,
ray_tpu_torch.models.paged_engine, LMBackend(paged=True)) against the JAX
package's, on the CPU, in f32: twins of tests/test_paged_attention.py with
the same inputs, made with numpy, through both.

On the CPU the K7 wrapper takes its plain version; it is held against the
JAX package's XLA path and against its Pallas kernel in interpret mode. The
kernel itself is checked on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JCfg
from ray_tpu.models import init_params as j_init
from ray_tpu.models import paged_engine as jpe
from ray_tpu.ops import attention as jatt
from ray_tpu.ops import paged_attention as jpa
from ray_tpu.serve.config import ServeRequest as JServeRequest
from ray_tpu.serve.lm import LMBackend as JLMBackend
from ray_tpu_torch.models import TransformerConfig as TCfg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models import paged_engine as tpe
from ray_tpu_torch.models.generate import generate as t_generate
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops.paged_attention import PagePool
from ray_tpu_torch.serve import LMBackend, ServeRequest

CPU = "cpu"
# tests/test_paged_attention.py's engine config, and its chunked one.
_KW = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)
_CHUNK_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=256)


def _pair(kw):
    jcfg = JCfg(dtype=jnp.float32, **kw)
    tcfg = TCfg(dtype=torch.float32, **kw)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device=CPU)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def model():
    return _pair(_KW)


@pytest.fixture(scope="module")
def chunk_model():
    return _pair(_CHUNK_KW)


@pytest.fixture
def interpret():
    """Run the JAX package's Pallas kernels in interpret mode off the TPU,
    restoring the module flag whatever happens."""
    prev = jatt._INTERPRET
    jatt._INTERPRET = jax.default_backend() != "tpu"
    try:
        yield
    finally:
        jatt._INTERPRET = prev


def _setup(B, H, KH, D, ps, pages_per_seq, lengths, seed=0):
    """numpy inputs: a pool with shuffled page assignment (physical order
    != logical order) and -1 padding past each sequence's pages."""
    rng = np.random.default_rng(seed)
    num_pages = B * pages_per_seq + 2      # a couple of never-used spares
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, KH, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, KH, D)).astype(np.float32)
    ids = rng.permutation(B * pages_per_seq)
    table = np.full((B, pages_per_seq), -1, np.int32)
    for b in range(B):
        used = -(-(lengths[b] + 1) // ps)
        table[b, :used] = ids[b * pages_per_seq:b * pages_per_seq + used]
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _port(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------- K7 (plain)


def test_plain_k7_matches_jax_xla_path():
    arrays = _setup(B=3, H=4, KH=2, D=16, ps=8, pages_per_seq=4,
                    lengths=[0, 13, 30])
    want = jpa.paged_decode_attention(*_jax(arrays))
    got = tpa.paged_decode_attention(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("D", [8, 16, 32])
def test_plain_k7_matches_jax_xla_path_small_head_dims(D):
    """The small models' head dims, which the card's K7 takes too (the
    soak's paged engine at D 8), at the soak's page size 16: GQA, a page
    edge and a partly used last page; atol 2e-5 as at D 64."""
    arrays = _setup(B=3, H=4, KH=2, D=D, ps=16, pages_per_seq=3,
                    lengths=[0, 15, 40], seed=D)
    want = jpa.paged_decode_attention(*_jax(arrays))
    got = tpa.paged_decode_attention(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,H,KH,lengths,pages", [
    (4, 8, 1, [0, 127, 200, 383], 3),      # shuffled pages, page edges
    (2, 16, 2, [45, 255], 2),              # GQA, G = 8
], ids=["mqa", "gqa"])
def test_plain_k7_matches_pallas_k7_interpret(interpret, B, H, KH, lengths,
                                              pages):
    arrays = _setup(B=B, H=H, KH=KH, D=128, ps=128, pages_per_seq=pages,
                    lengths=lengths, seed=3)
    want = jpa._paged_flash_decode(*_jax(arrays))
    got = tpa.paged_decode_attention(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_idle_row_with_minus_one_table_matches_jax(interpret):
    """An idle slot (length 0, a table of -1) attends scratch row 0 of page
    0, as the JAX package's XLA path and Pallas index map both do."""
    q, kp, vp, table, lens = _setup(B=3, H=4, KH=2, D=128, ps=128,
                                    pages_per_seq=2, lengths=[200, 5, 0],
                                    seed=4)
    table[2] = -1
    arrays = (q, kp, vp, table, lens)
    got = tpa.paged_decode_attention(*_port(arrays)).numpy()
    for want in (jpa.paged_decode_attention(*_jax(arrays)),
                 jpa._paged_flash_decode(*_jax(arrays))):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
    # Row 0 alone: the idle row's output is page 0's first V row.
    np.testing.assert_allclose(got[2].reshape(2, 2, 128),
                               np.repeat(vp[0, 0][:, None], 2, axis=1),
                               atol=1e-6)


def test_write_paged_and_gather_roundtrip_match_jax():
    """Scatter rows through page indirection (crossing a page boundary);
    the gathered layout sees them at the right logical positions, as in the
    JAX package."""
    num_pages, ps, KH, D = 4, 8, 2, 16
    page_ids = np.array([2, 0])
    logical = np.arange(6, 10)
    positions = (page_ids[logical // ps] * ps + logical % ps).astype(np.int32)
    values = np.arange(4 * KH * D, dtype=np.float32).reshape(4, KH, D)
    table = np.asarray([[2, 0]], np.int32)
    jpool = jpa.write_paged(jnp.zeros((num_pages, ps, KH, D)),
                            jnp.asarray(positions), jnp.asarray(values))
    tpool = torch.zeros(num_pages, ps, KH, D)
    assert tpa.write_paged(tpool, torch.from_numpy(positions),
                           torch.from_numpy(values)) is tpool   # in place
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    gathered = tpa.paged_gather(tpool, torch.from_numpy(table))[0]
    np.testing.assert_array_equal(
        gathered.numpy(), np.asarray(jpa.paged_gather(jpool, table))[0])
    np.testing.assert_array_equal(gathered[6:10].numpy(), values)
    assert float(gathered[:6].abs().sum()) == 0.0
    assert float(gathered[10:].abs().sum()) == 0.0


# --------------------------------------------------------------- PagePool


class TestPagePool:
    def test_alloc_grow_and_free(self):
        pool = PagePool(num_pages=8, page_size=16)
        first = pool.alloc(seq=1, tokens=20)     # ceil(20/16) = 2 pages
        assert len(first) == 2 and pool.free_pages == 6
        assert pool.alloc(seq=1, tokens=30) == []   # still fits in 2
        more = pool.alloc(seq=1, tokens=40)      # grows to 3
        assert len(more) == 1
        assert pool.pages_for(1) == first + more
        assert pool.free(1) == 3
        assert pool.free_pages == 8

    def test_exhaustion_raises_and_leaves_state_clean(self):
        pool = PagePool(num_pages=2, page_size=16)
        pool.alloc(seq=1, tokens=32)
        with pytest.raises(MemoryError):
            pool.alloc(seq=2, tokens=17)
        assert pool.free_pages == 0
        assert pool.pages_for(2) == []

    def test_table_padding(self):
        pool = PagePool(num_pages=6, page_size=16)
        pool.alloc(seq=7, tokens=33)   # 3 pages
        pool.alloc(seq=9, tokens=10)   # 1 page
        t = pool.table([7, 9])
        assert t.shape == (2, 3)
        assert (t[0] >= 0).all()
        assert t[1, 0] >= 0 and (t[1, 1:] == -1).all()

    def test_pages_are_isolated_between_sequences(self):
        pool = PagePool(num_pages=4, page_size=16)
        a = pool.alloc(seq=1, tokens=32)
        b = pool.alloc(seq=2, tokens=32)
        assert not set(a) & set(b)


class TestPrefixCache:
    def test_share_refcounts_and_free(self):
        pool = PagePool(num_pages=6, page_size=8)
        a = pool.alloc(seq=1, tokens=16)          # 2 pages
        pool.share(seq=2, page_ids=a)             # seq 2 joins both
        assert pool.free(1) == 0                  # still referenced by 2
        assert pool.free(2) == 2                  # last ref returns them
        assert pool.free_pages == 6

    def test_cache_pin_and_evict_lru(self):
        pool = PagePool(num_pages=4, page_size=8)
        pages = pool.alloc(seq=1, tokens=32)      # all 4 pages
        k1 = PagePool.chain_hash(0, (1,) * 8)
        k2 = PagePool.chain_hash(k1, (2,) * 8)
        assert k2 == jpa.PagePool.chain_hash(
            jpa.PagePool.chain_hash(0, (1,) * 8), (2,) * 8)
        pool.cache_put(k1, pages[0])
        pool.cache_put(k2, pages[1])
        pool.free(1)
        assert pool.free_pages == 2               # 2 stay cache-pinned
        assert pool.evictable_pages == 2
        # Touch k1 so k2 becomes LRU, then evict one: k2 goes first.
        assert pool.cache_get(k1) == pages[0]
        assert pool.evict(1) == 1
        assert pool.cache_get(k2) is None
        assert pool.cache_get(k1) == pages[0]
        # alloc auto-evicts the rest under pressure
        assert len(pool.alloc(seq=3, tokens=32)) == 4
        assert pool.cache_get(k1) is None

    def test_cached_page_in_use_not_evicted(self):
        pool = PagePool(num_pages=3, page_size=8)
        pages = pool.alloc(seq=1, tokens=8)
        key = PagePool.chain_hash(0, (5,) * 8)
        pool.cache_put(key, pages[0])             # refs: seq1 + cache = 2
        assert pool.evictable_pages == 0
        assert pool.evict(1) == 0                 # still read by seq 1
        assert pool.cache_get(key) == pages[0]


def _pool_state(pool):
    return (list(pool._free), dict(pool._owned), list(pool._refs),
            list(pool._prefix_cache.items()), pool.evictable_pages)


def test_seeded_pool_op_sequence_matches_jax_pool():
    """One seeded sequence of alloc/share/free/cache/evict on both pools:
    equal free lists, owners, refcounts, cache order and tables after every
    operation (numpy ints as tokens hash as the JAX package's keys)."""
    rng = np.random.default_rng(11)
    ours, theirs = PagePool(24, 8), jpa.PagePool(24, 8)
    keys = []
    for _ in range(400):
        op = rng.integers(0, 6)
        seq = int(rng.integers(0, 5))
        if op == 0:
            tokens = int(rng.integers(1, 60))
            res = []
            for pool in (ours, theirs):
                try:
                    res.append(pool.alloc(seq, tokens))
                except MemoryError:
                    res.append("exhausted")
            assert res[0] == res[1]
        elif op == 1:
            donor = int(rng.integers(0, 5))
            pages = ours.pages_for(donor)[:2] if donor != seq else []
            for pool in (ours, theirs):
                pool.share(seq, pages)
        elif op == 2:
            assert ours.free(seq) == theirs.free(seq)
        elif op == 3:
            owned = ours.pages_for(seq)
            if owned:
                blk = rng.integers(0, 4, 8)
                key = PagePool.chain_hash(keys[-1][0] if keys else 0, blk)
                assert key == jpa.PagePool.chain_hash(
                    keys[-1][0] if keys else 0, blk)
                page = owned[int(rng.integers(0, len(owned)))]
                for pool in (ours, theirs):
                    pool.cache_put(key, page, blk)
                keys.append((key, blk))
        elif op == 4 and keys:
            key, blk = keys[int(rng.integers(0, len(keys)))]
            if rng.integers(0, 2):
                assert ours.cache_get(key, blk) == theirs.cache_get(key, blk)
            else:
                assert ours.cache_peek(key, blk) == \
                    theirs.cache_peek(key, blk)
        else:
            n = int(rng.integers(1, 4))
            assert ours.evict(n) == theirs.evict(n)
        assert _pool_state(ours) == _pool_state(theirs)
        seqs = list(range(5))
        np.testing.assert_array_equal(ours.table(seqs, 24),
                                      theirs.table(seqs, 24))


# ------------------------------------------------------ the paged engine


def _j_engine(jcfg, jparams, **kw):
    return jpe.PagedGenerationEngine(jparams, jcfg, **kw)


def _t_engine(tcfg, tparams, **kw):
    return tpe.PagedGenerationEngine(tparams, tcfg, device=CPU, **kw)


def _drain(eng, submits):
    ids = [eng.submit(*a, **k) for a, k in submits]
    res = eng.run_until_done()
    return [res[i] for i in ids]


def _t_ref(tcfg, tparams, prompt, n):
    return t_generate(tparams, [prompt], tcfg, n, device=CPU)[0].tolist()


def test_paged_prefill_and_decode_logits_match_jax(model):
    """The paged programs on the same pool, tables and tokens: prefill
    logits, four lockstep decode ticks (one slot idle, its table -1) and
    the pools after them, within 1e-5."""
    jcfg, jparams, tcfg, tparams = model
    L, KH, Dh, ps, num_pages = 2, 2, 16, 8, 12
    jk = jnp.zeros((L, num_pages, ps, KH, Dh), jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros(L, num_pages, ps, KH, Dh)
    tv = torch.zeros_like(tk)
    tp = tparams                      # f32 on the CPU: the compute form
    tables = np.full((3, 4), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [7, 1]
    lengths = np.zeros(3, np.int32)
    tokens = np.zeros(3, np.int32)
    rng = np.random.default_rng(0)
    for slot, T0 in ((0, 11), (1, 5)):
        prompt = rng.integers(0, 128, T0)
        Tb = 1 << (T0 - 1).bit_length()
        padded = np.zeros((1, Tb), np.int32)
        padded[0, :T0] = prompt
        logical = np.arange(Tb)
        pages = tables[slot][tables[slot] >= 0]
        rows = np.where(logical // ps < len(pages),
                        pages[np.minimum(logical // ps, len(pages) - 1)] * ps
                        + logical % ps, logical % ps).astype(np.int32)
        jl, jk, jv = jpe._paged_prefill(
            jparams, jnp.asarray(padded), jnp.asarray(T0, jnp.int32),
            jnp.asarray(rows), jk, jv, jcfg)
        tl = tpe._paged_prefill(tp, torch.from_numpy(padded), T0,
                                torch.from_numpy(rows), tk, tv, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        lengths[slot], tokens[slot] = T0, int(np.argmax(np.asarray(jl)))
    for _ in range(4):
        jl, jk, jv = jpe._paged_decode(
            jparams, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(tables), jk, jv, jcfg)
        tl = tpe._paged_decode(tp, torch.from_numpy(tokens),
                               torch.from_numpy(lengths),
                               torch.from_numpy(tables), tk, tv, tcfg)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=1e-5)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths[:2] += 1
    # Every row but the scratch page's (idle slots race on its row 0).
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               atol=1e-5)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               atol=1e-5)


def test_paged_engine_matches_generate_and_jax(model):
    jcfg, jparams, tcfg, tparams = model
    prompts = [[1, 2, 3], [7, 8], [9, 10, 11, 12, 13]]
    submits = [((p, 6), {}) for p in prompts]
    eng = _t_engine(tcfg, tparams, max_slots=3, page_size=16)
    assert not hasattr(eng, "cache_k")   # no contiguous cache, ever
    ours = _drain(eng, submits)
    assert ours == _drain(_j_engine(jcfg, jparams, max_slots=3,
                                    page_size=16), submits)
    for p, out in zip(prompts, ours):
        assert out == _t_ref(tcfg, tparams, p, 6)
    # every page returned (only the scratch page stays pinned)
    assert eng.pool.free_pages == eng.num_pages - 1


def test_paged_engine_page_budget_queues_fifo(model):
    """A pool too small for all requests at once admits FIFO and still
    completes everything exactly: 1 scratch + 4 usable pages of 16 rows,
    each request needs ceil((3+14)/16) = 2, so only 2 of 3 run at once."""
    jcfg, jparams, tcfg, tparams = model
    eng = _t_engine(tcfg, tparams, max_slots=3, page_size=16, num_pages=5)
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    ids = [eng.submit(p, 14) for p in prompts]
    eng.step()
    assert sum(r is not None for r in eng.active) == 2  # third queued
    assert len(eng.queue) == 1 and eng.queue[0].req_id == ids[2]
    out = eng.run_until_done()
    want = _drain(_j_engine(jcfg, jparams, max_slots=3, page_size=16,
                            num_pages=5), [((p, 14), {}) for p in prompts])
    assert [out[i] for i in ids] == want
    for p, rid in zip(prompts, ids):
        assert out[rid] == _t_ref(tcfg, tparams, p, 14)
    assert eng.pool.free_pages == 4


def test_paged_engine_memory_footprint_smaller(model):
    """8 short requests served from 80 pool rows per layer, where the
    contiguous engine at 8 slots would hold 8 * 64 = 512."""
    _, _, tcfg, tparams = model
    eng = _t_engine(tcfg, tparams, max_slots=8, page_size=16, num_pages=5)
    assert eng.k_pages.shape[1] * eng.k_pages.shape[2] == 80
    ids = [eng.submit([i + 1, i + 2], 4) for i in range(8)]
    out = eng.run_until_done()
    for i, rid in enumerate(ids):
        assert out[rid] == _t_ref(tcfg, tparams, [i + 1, i + 2], 4)


def test_paged_engine_cancel_frees_pages(model):
    _, _, tcfg, tparams = model
    eng = _t_engine(tcfg, tparams, max_slots=2, page_size=16)
    rid = eng.submit([1, 2], 30)
    eng.step()
    assert eng.pool.free_pages < eng.num_pages - 1
    assert eng.cancel(rid)
    assert eng.pool.free_pages == eng.num_pages - 1
    assert (eng._tables == -1).all()


def test_paged_engine_seeded_sampling_matches_jax(model):
    """Host-side numpy sampling: the same seed gives the JAX paged engine's
    continuation, and again on a fresh engine."""
    jcfg, jparams, tcfg, tparams = model
    submits = [(([4, 5], 6), dict(temperature=0.9, seed=11)),
               (([1, 2, 3], 5), {})]
    ours = _drain(_t_engine(tcfg, tparams, max_slots=2, page_size=16),
                  submits)
    assert ours == _drain(_j_engine(jcfg, jparams, max_slots=2,
                                    page_size=16), submits)
    assert ours == _drain(_t_engine(tcfg, tparams, max_slots=2,
                                    page_size=16), submits)


def test_paged_engine_prefix_reuse_tables_match_jax(model):
    """A second request with the same prompt head reuses the cached prefix
    pages and still produces the exact continuation; after each request
    the page tables, pool and cache equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = model
    ours = _t_engine(tcfg, tparams, max_slots=2, page_size=8)
    theirs = _j_engine(jcfg, jparams, max_slots=2, page_size=8)
    prompt = [(i % 50) + 1 for i in range(20)]    # 2 immutable full blocks
    other = [60 + (i % 5) for i in range(20)]
    ref = _t_ref(tcfg, tparams, prompt, 6)
    for step, p in enumerate((prompt, prompt, other)):
        for eng in (ours, theirs):
            eng.submit(p, 6)
        # One tick: prefill (sharing any cached prefix) and one decode.
        ours.step()
        theirs.step()
        np.testing.assert_array_equal(ours._tables, theirs._tables)
        assert _pool_state(ours.pool) == _pool_state(theirs.pool)
        if step == 1:
            # The shared blocks are read by the live request and pinned by
            # the cache.
            shared = ours._tables[0, :2]
            assert all(ours.pool._refs[int(pg)] == 2 for pg in shared)
        out = ours.run_until_done()
        assert out == theirs.run_until_done()
        if p is prompt:
            assert list(out.values()) == [ref]
        assert _pool_state(ours.pool) == _pool_state(theirs.pool)
    assert ours._prefix_hits(prompt) == 2
    assert ours._prefix_hits(other) == 2
    assert ours._prefix_hits([99] * 20) == 0
    # The 2 + 2 immutable blocks stayed resident, pinned by the cache.
    assert ours.num_pages - 1 - ours.pool.free_pages == 4


def test_paged_engine_prefix_reuse_admission_capacity(model):
    """Same-prefix requests admit concurrently where private copies could
    not: each spans 3 pages privately but 1 beyond the shared prefix, and
    the pool has 6 usable pages (3 + 1 + 1 + 1)."""
    _, _, tcfg, tparams = model
    prompt = [(i % 50) + 1 for i in range(16)]    # 2 full blocks of 8
    eng = _t_engine(tcfg, tparams, max_slots=4, page_size=8, max_seq=24,
                    num_pages=7)
    ids = [eng.submit(prompt, 8) for _ in range(4)]
    eng.step()
    assert sum(r is not None for r in eng.active) == 4
    out = eng.run_until_done()
    ref = _t_ref(tcfg, tparams, prompt, 8)
    for rid in ids:
        assert out[rid] == ref


def test_paged_engine_own_prefix_hits_not_counted_as_evictable(model):
    """Admission must not count the request's OWN cached prefix pages as
    reclaimable headroom: they will be shared, not evicted."""
    _, _, tcfg, tparams = model
    prompt16 = [(i % 50) + 1 for i in range(16)]   # 2 full blocks of 8
    eng = _t_engine(tcfg, tparams, max_slots=2, page_size=8, max_seq=40,
                    num_pages=7)                     # 6 usable
    eng.submit(prompt16, 1)
    eng.run_until_done()
    assert eng.pool.evictable_pages == 2
    eng.submit([3, 4, 5, 6, 7, 8, 9, 10, 11], 7)     # holds 2 pages
    eng.step()
    assert any(r is not None for r in eng.active)
    # free=2, evictable=2 (both are rb's own prefix hits), rb needs 3 NEW
    # pages (total ceil((16+24)/8) = 5, hits 2): it must queue, not crash.
    rb = eng.submit(prompt16, 24)
    eng.step()
    assert not any(r is not None and r.req_id == rb for r in eng.active)
    out = eng.run_until_done()
    assert out[rb] == _t_ref(tcfg, tparams, prompt16, 24)


def test_paged_chunked_prefill_exact_and_prefix_skip(chunk_model,
                                                     monkeypatch):
    """Chunked prefill through page tables: exact vs generate() and the JAX
    engine for crossing/exact/straddling lengths, and a same-prefix
    follow-up SKIPS its fully-shared chunks while still producing the exact
    continuation."""
    jcfg, jparams, tcfg, tparams = chunk_model
    rng = np.random.default_rng(5)
    submits = [((rng.integers(1, 60, size=T0).tolist(), 6), {})
               for T0 in (65, 128, 180)]
    kw = dict(max_slots=2, page_size=16, prefill_chunk=64)
    ours = _drain(_t_engine(tcfg, tparams, **kw), submits)
    assert ours == _drain(_j_engine(jcfg, jparams, **kw), submits)
    for (args, _), out in zip(submits, ours):
        assert out == _t_ref(tcfg, tparams, *args)

    prompt = (list(range(1, 17)) * 12)[:160]   # 160 tokens, 10 pages of 16
    ref = _t_ref(tcfg, tparams, prompt, 6)
    eng = _t_engine(tcfg, tparams, **kw)
    calls = []
    orig = tpe._paged_prefill_chunk

    def counting(*a, **k):
        calls.append(a[2])                     # the chunk's start
        return orig(*a, **k)

    monkeypatch.setattr(tpe, "_paged_prefill_chunk", counting)
    assert _drain(eng, [((prompt, 6), {})]) == [ref]
    assert calls == [0, 64, 128]               # ceil(160/64) chunks
    calls.clear()
    # Blocks 0..9 are immutable and cached; chunks 0-1 (rows 0..127) are
    # fully shared, so only the final chunk runs.
    assert _drain(eng, [((prompt, 6), {})]) == [ref]
    assert calls == [128]


def test_paged_lm_backend_batch_and_stream_match_jax(model):
    """LMBackend(paged=True): one batched call (more requests than slots,
    a pool below slots * max_seq) and a stream equal the JAX package's
    paged backend."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(max_slots=2, paged=True, page_size=16, num_pages=9)
    ours = LMBackend(tparams, tcfg, device=CPU, **kw)
    theirs = JLMBackend(jparams, jcfg, **kw)
    assert isinstance(ours.engine, tpe.PagedGenerationEngine)
    prompts = [[i + 1, i + 2] for i in range(5)]
    got = ours([ServeRequest((p,), {"max_new_tokens": 5}) for p in prompts])
    assert got == theirs([JServeRequest((p,), {"max_new_tokens": 5})
                          for p in prompts])
    for p, out in zip(prompts, got):
        assert out == _t_ref(tcfg, tparams, p, 5)
    tok = ours.stream_start([2, 3, 4], max_new_tokens=4)
    streamed, done = [], False
    for _ in range(200):
        r = ours.stream_poll(tok, wait_s=2.0)
        streamed += r["tokens"]
        if r["done"]:
            done = True
            break
    assert done and streamed == _t_ref(tcfg, tparams, [2, 3, 4], 4)
    assert ours.stats()["active"] == 0
