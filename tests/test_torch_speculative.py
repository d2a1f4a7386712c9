"""The port's n-gram speculative decoding (ray_tpu_torch.models.speculative,
the engines' speculative tick, the paged verify, LMBackend with
speculative_k > 0 and its stats()) against the JAX package's, on the CPU,
in f32: the same numpy-seeded inputs and the same weights through both.

The verify forwards reach no Pallas kernel in either package (JAX runs
them through XLA, the port through plain PyTorch on the CPU), so nothing
here switches the JAX package to interpret mode. The card runs the same
code with kernel K1 in it (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JCfg
from ray_tpu.models import engine as jeng
from ray_tpu.models import init_params as j_init
from ray_tpu.models import paged_engine as jpe
from ray_tpu.models import speculative as jspec
from ray_tpu.serve.config import ServeRequest as JServeRequest
from ray_tpu.serve.lm import LMBackend as JLMBackend
from ray_tpu_torch.models import TransformerConfig as TCfg
from ray_tpu_torch.models import engine as teng
from ray_tpu_torch.models import paged_engine as tpe
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models import speculative as tspec
from ray_tpu_torch.models.generate import generate as t_generate
from ray_tpu_torch.models.transformer import _rope
from ray_tpu_torch.serve import LMBackend, ServeRequest

CPU = "cpu"
# tests/test_engine.py's _cfg() (the config of TestSpeculativeDecoding),
# and the long-context config of its chunked-prefill test.
_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq_len=64)
_LONG_KW = dict(_KW, max_seq_len=256)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test files that run beside this one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


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
def long_model():
    return _pair(_LONG_KW)


def _t_ref(tcfg, tparams, prompt, n):
    return t_generate(tparams, [prompt], tcfg, n, device=CPU)[0].tolist()


def _t_np(t):
    return t.detach().cpu().numpy()


# ----------------------------------------------------------- the rotation


def test_rope_at_per_slot_positions_matches_jax_and_per_slot_calls(model):
    """_rope with positions [B, T] (the verify chunk's) equals the JAX
    package's vmapped _rope_positions, and each slot's row equals the
    shared-positions form of the same function on that slot alone."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [17, 18, 19, 20, 21],
                      [60, 61, 62, 63, 64]], np.int32)
    got = _rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    want = jspec._rope_positions(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(_t_np(got), np.asarray(want), **TOL)
    for b in range(3):
        one = _rope(torch.from_numpy(x[b:b + 1]), torch.from_numpy(pos[b]),
                    10_000.0)
        assert torch.equal(got[b:b + 1], one)


# ------------------------------------------------------ the verify forwards


@pytest.mark.parametrize("lengths", [[5, 17, 0], [30, 3, 0], [28, 0, 12]],
                         ids=["inside", "clamped_past_end", "ends_at_s_max"])
def test_batched_verify_matches_jax(model, lengths):
    """Logits [B, S, V] and the written cache rows equal JAX's within f32
    1e-5, including a chunk that would run past S_max (JAX's
    dynamic_update_slice clamps its start; the port reproduces the clamp)
    and one whose last row is S_max - 1."""
    jcfg, jparams, tcfg, tparams = model
    B, S, S_max = 3, 4, 32
    L, KH, Dh = _KW["n_layers"], _KW["n_kv_heads"], 8
    rng = np.random.default_rng(sum(lengths))
    tokens = rng.integers(0, _KW["vocab_size"], (B, S)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    ck = rng.standard_normal((L, B, S_max, KH, Dh)).astype(np.float32)
    cv = rng.standard_normal((L, B, S_max, KH, Dh)).astype(np.float32)
    want, jk, jv = jspec._batched_verify(
        jparams, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(ck),
        jnp.asarray(cv), jcfg)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tspec._batched_verify(tparams, torch.from_numpy(tokens),
                                torch.from_numpy(lens), tk, tv, tcfg)
    assert got.shape == (B, S, _KW["vocab_size"])
    np.testing.assert_allclose(_t_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_t_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_t_np(tv), np.asarray(jv), **TOL)
    # Only the chunk's rows changed, at the (clamped) start.
    for b, n in enumerate(lengths):
        start = min(n, S_max - S)
        keep = np.ones(S_max, bool)
        keep[start:start + S] = False
        np.testing.assert_array_equal(_t_np(tk)[:, b, keep], ck[:, b, keep])


def test_paged_verify_matches_jax(model):
    """The paged verify against JAX's: logits and the whole pool within
    f32 1e-5. Slot 0's last two positions run past its table and slot 1's
    fall on -1 entries (both to the scratch page 0, on rows no other slot
    writes, so the result does not depend on which of two colliding writes
    lands); slot 2 shares slot 0's first page, which must be left as it
    was."""
    jcfg, jparams, tcfg, tparams = model
    B, S, ps, P, n_pages = 3, 4, 8, 3, 10
    L, KH, Dh = _KW["n_layers"], _KW["n_kv_heads"], 8
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, _KW["vocab_size"], (B, S)).astype(np.int32)
    tables = np.asarray([[3, 5, 7], [4, -1, -1], [3, 6, -1]], np.int32)
    lens = np.asarray([22, 10, 9], np.int32)
    kp = rng.standard_normal((L, n_pages, ps, KH, Dh)).astype(np.float32)
    vp = rng.standard_normal((L, n_pages, ps, KH, Dh)).astype(np.float32)
    want, jk, jv = jpe._paged_verify(
        jparams, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(tables),
        jnp.asarray(kp), jnp.asarray(vp), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = tpe._paged_verify(tparams, torch.from_numpy(tokens),
                            torch.from_numpy(lens), torch.from_numpy(tables),
                            tk, tv, tcfg)
    np.testing.assert_allclose(_t_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_t_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_allclose(_t_np(tv), np.asarray(jv), **TOL)
    assert np.array_equal(_t_np(tk)[:, 3], kp[:, 3])        # shared page
    assert np.array_equal(_t_np(tv)[:, 3], vp[:, 3])
    written = {0, 6, 7}                  # scratch, slot 2's, slot 0's last
    for pg in set(range(n_pages)) - written:
        assert np.array_equal(_t_np(tk)[:, pg], kp[:, pg]), pg
    assert not np.array_equal(_t_np(tk)[:, 0, :2], kp[:, 0, :2])


# ------------------------------------------------------------ host side


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_index_matches_scan_spec_of_both_packages(n):
    """Twin of test_ngram_index_matches_scan_spec: the port's incremental
    NgramIndex proposes what both packages' O(context) scans propose, and
    what JAX's index proposes, over seeded random streams."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        ctx = rng.integers(0, 6, size=40).tolist()
        ours, theirs = tspec.NgramIndex(n, ctx[:10]), jspec.NgramIndex(
            n, ctx[:10])
        for i in range(10, len(ctx)):
            got = ours.propose(4)
            assert got == tspec.propose_ngram(ctx[:i], 4, n), (trial, i)
            assert got == jspec.propose_ngram(ctx[:i], 4, n), (trial, i)
            assert got == theirs.propose(4), (trial, i)
            ours.extend([ctx[i]])
            theirs.extend([ctx[i]])


def test_longest_accept_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        k = int(rng.integers(0, 5))
        greedy = rng.integers(0, 3, 5)
        drafts = np.where(rng.random(4) < 0.7, greedy[:4], 9)
        assert tspec.longest_accept(drafts, k, greedy) == \
            jspec.longest_accept(drafts, k, greedy)


@pytest.mark.parametrize("stop,out,extra", [
    ([], [1, 2], None), ([[2]], [1, 2], None), ([[2, 3]], [1, 2], [3]),
    ([[3, 4]], [1], [3, 4]), ([[1, 3]], [1], [3, 5]),
    ([[5, 1, 2, 3]], [1, 2], [3]), ([[9], [2, 3]], [7, 1, 2], [3]),
    ([[1, 2]], [], [1, 2]), ([[4]], [4], []),
], ids=lambda v: repr(v))
def test_hit_stop_with_tentative_tokens_matches_jax(stop, out, extra):
    """_Request.hit_stop(extra) — the output plus the tokens a speculative
    tick is about to emit — answers as the JAX package's."""
    ours = teng._Request(0, [1], 8, stop=stop)
    theirs = jeng._Request(0, [1], 8, stop=stop)
    ours.out, theirs.out = list(out), list(out)
    extra2 = None if extra is None else list(extra)
    assert ours.hit_stop(extra) == theirs.hit_stop(extra2)
    assert ours.hit_stop() == theirs.hit_stop()


# ------------------------------------------- the engines (TestSpeculative-
# Decoding's twins): tokens AND spec_stats equal the JAX engine's


def _engines(m, paged, **kw):
    jcfg, jparams, tcfg, tparams = m
    if paged:
        return (jpe.PagedGenerationEngine(jparams, jcfg, **kw),
                tpe.PagedGenerationEngine(tparams, tcfg, device=CPU, **kw))
    return (jeng.GenerationEngine(jparams, jcfg, **kw),
            teng.GenerationEngine(tparams, tcfg, device=CPU, **kw))


def _drive(eng, submits):
    """Submit, step to the end; (outputs in submit order, steps taken)."""
    ids = [eng.submit(*a, **k) for a, k in submits]
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        steps += 1
    return [eng.done.pop(i) for i in ids], steps


def _both(m, submits, *, paged=False, **kw):
    """Both engines on the same submits: the port's outputs, steps and
    spec_stats, each asserted equal to the JAX engine's."""
    j, t = _engines(m, paged, **kw)
    (jo, js), (to, ts) = _drive(j, submits), _drive(t, submits)
    assert to == jo
    assert ts == js
    assert t.spec_stats == j.spec_stats
    return to, ts, t


_PAGED = [pytest.param(False, id="contiguous"), pytest.param(True,
                                                            id="paged")]


@pytest.mark.parametrize("paged", _PAGED)
def test_greedy_exact_and_fewer_steps(model, paged):
    _, _, tcfg, tparams = model
    prompt, n = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], 20
    kw = dict(page_size=8) if paged else {}
    (out,), steps, eng = _both(model, [((prompt, n), {})], paged=paged,
                               max_slots=2, speculative_k=4, **kw)
    assert out == _t_ref(tcfg, tparams, prompt, n)
    assert steps < n, f"speculation accepted nothing ({steps} steps)"
    assert eng.spec_stats["accepted"] > 0


@pytest.mark.parametrize("paged", _PAGED)
def test_multi_slot_mixed_prompts_exact(model, paged):
    _, _, tcfg, tparams = model
    prompts = [[1, 2, 1, 2, 1, 2, 1], [9, 9, 9, 9, 9], [4, 8, 15, 16, 23, 42]]
    ns = [12, 10, 8]
    kw = dict(page_size=8) if paged else {}
    outs, _, _ = _both(model, [((p, n), {}) for p, n in zip(prompts, ns)],
                       paged=paged, max_slots=3, speculative_k=3, **kw)
    for p, n, out in zip(prompts, ns, outs):
        assert out == _t_ref(tcfg, tparams, p, n), p


@pytest.mark.parametrize("paged", _PAGED)
def test_sampling_slot_safe_beside_greedy(model, paged):
    """A sampling slot draws from the verify's position-0 logits with its
    seeded PRNG: the JAX engine's tokens, the same again on a second run,
    and the greedy batch-mate exact."""
    _, _, tcfg, tparams = model
    submits = [(([3, 4, 3, 4, 3, 4], 10), {}),
               (([7, 8, 9], 10), dict(temperature=0.8, seed=5))]
    kw = dict(page_size=8) if paged else {}
    first, _, _ = _both(model, submits, paged=paged, max_slots=2,
                        speculative_k=3, **kw)
    again, _, _ = _both(model, submits, paged=paged, max_slots=2,
                        speculative_k=3, **kw)
    assert first == again and len(first[1]) == 10
    assert first[0] == _t_ref(tcfg, tparams, [3, 4, 3, 4, 3, 4], 10)


@pytest.mark.parametrize("paged", _PAGED)
def test_cache_boundary_falls_back(model, paged):
    """A request that ends exactly at max_seq: near the end the chunk would
    run past the cache, so those ticks verify at width 1; the output stays
    exact."""
    _, _, tcfg, tparams = model
    prompt = [2, 3, 2, 3, 2, 3]
    kw = dict(page_size=8) if paged else {}
    (out,), _, eng = _both(model, [((prompt, 10), {})], paged=paged,
                           max_slots=1, max_seq=16, speculative_k=4, **kw)
    assert out == _t_ref(tcfg, tparams, prompt, 10)
    assert len(prompt) + len(out) == eng.max_seq


@pytest.mark.parametrize("paged", _PAGED)
def test_eos_inside_accepted_run_truncates(model, paged):
    _, _, tcfg, tparams = model
    prompt = [11, 12, 11, 12, 11, 12, 11]
    ref = _t_ref(tcfg, tparams, prompt, 20)
    eos = ref[2]
    kw = dict(page_size=8) if paged else {}
    (out,), _, _ = _both(model, [((prompt, 20), {})], paged=paged,
                         max_slots=2, eos_id=eos, speculative_k=4, **kw)
    assert out == ref[:ref.index(eos) + 1]


@pytest.mark.parametrize("paged", _PAGED)
def test_draftless_ticks(model, paged):
    """No repeated bigram in the prompt: the first ticks draft nothing.
    On such a tick the contiguous engine verifies at width 1 (its decode
    pass never runs with speculation on) and the paged engine takes its
    decode pass (K7 on the card); ticks with drafts verify at width K+1.
    Both stay exact."""
    _, _, tcfg, tparams = model
    prompt = [4, 8, 15, 16, 23, 42, 37]
    kw = dict(page_size=8) if paged else {}
    j, t = _engines(model, paged, max_slots=2, speculative_k=4, **kw)
    widths, decodes = [], []
    verify, decode = t._verify_all, t._decode_all

    def spy_verify(chunk):
        widths.append(chunk.shape[1])
        return verify(chunk)

    def spy_decode():
        decodes.append(1)
        return decode()

    t._verify_all, t._decode_all = spy_verify, spy_decode
    (jo, js), (to, ts) = (_drive(j, [((prompt, 8), {})]),
                          _drive(t, [((prompt, 8), {})]))
    assert to == jo and ts == js and t.spec_stats == j.spec_stats
    assert to[0] == _t_ref(tcfg, tparams, prompt, 8)
    ticks = t.spec_stats["ticks"]
    if paged:
        assert set(widths) <= {5} and len(decodes) >= 1
        assert len(widths) + len(decodes) == ticks
    else:
        assert set(widths) <= {1, 5} and widths.count(1) >= 1
        assert decodes == [] and len(widths) == ticks


def test_paged_engine_speculative_exact_with_live_prefix_hit(model):
    """Speculation through page tables with prefix caching live: the
    second same-prompt request joins the first's cached pages and still
    equals generate() and the JAX engine; the verify never writes those
    shared pages."""
    _, _, tcfg, tparams = model
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
    ref = _t_ref(tcfg, tparams, prompt, 16)
    j, t = _engines(model, True, max_slots=2, page_size=8, speculative_k=4)
    (jo, js), (to, ts) = (_drive(j, [((prompt, 16), {})]),
                          _drive(t, [((prompt, 16), {})]))
    assert to == jo == [ref] and ts == js and ts < 16
    assert t._prefix_hits(prompt) > 0 and j._prefix_hits(prompt) > 0
    shared = t._cached_prefix(t._prefix_keys(prompt), promote=False)
    before = t.k_pages[:, shared].clone()
    (jo, _), (to, _) = (_drive(j, [((prompt, 16), {})]),
                        _drive(t, [((prompt, 16), {})]))
    assert to == jo == [ref]
    assert t.spec_stats == j.spec_stats
    assert torch.equal(t.k_pages[:, shared], before)


@pytest.mark.parametrize("paged", _PAGED)
def test_chunked_prefill_and_speculation_compose(long_model, paged):
    """Twin of the chunked + speculative case of
    test_chunked_prefill_exact_long_prompt (and of the paged matrix test,
    without the mesh): a 150-token repetitive prompt in 64-token chunks,
    then speculative decode."""
    _, _, tcfg, tparams = long_model
    prompt = ([7, 8, 9, 7, 8, 9] * 30)[:150]
    kw = dict(page_size=64) if paged else {}
    (out,), _, _ = _both(long_model, [((prompt, 10), {})], paged=paged,
                         max_slots=2, prefill_chunk=64, speculative_k=3, **kw)
    assert out == _t_ref(tcfg, tparams, prompt, 10)


def test_stop_sequence_inside_accepted_run(model):
    """Twin of test_stop_sequences' speculative case: a two-token stop
    sequence ends generation in the middle of an accepted run."""
    _, _, tcfg, tparams = model
    prompt = [5, 6, 7, 5, 6, 7, 5]
    full = _t_ref(tcfg, tparams, prompt, 12)
    two = full[3:5]
    (out,), _, _ = _both(model, [((prompt, 12), dict(stop=[two]))],
                         max_slots=2, speculative_k=4)
    want = next(full[:i] for i in range(1, 13)
                if len(full[:i]) >= 2 and full[:i][-2:] == two)
    assert out == want


# -------------------------------------------------------------- LMBackend


def _call(b, serve_request, prompts, n):
    return b([serve_request((p,), {"max_new_tokens": n}) for p in prompts])


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("paged", _PAGED)
def test_lm_backend_stats_match_jax(model, paged, k):
    """stats() equals the JAX backend's key for key and value for value
    after the same requests, "speculative" included, at speculative_k 0
    and 3."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(max_slots=2, paged=paged, page_size=16, speculative_k=k)
    ours = LMBackend(tparams, tcfg, device=CPU, **kw)
    theirs = JLMBackend(jparams, jcfg, **kw)
    assert ours.stats() == theirs.stats()
    prompts = [[1, 2, 1, 2, 1, 2], [9, 9, 9, 9], [4, 8, 15]]
    assert _call(ours, ServeRequest, prompts, 8) == \
        _call(theirs, JServeRequest, prompts, 8)
    st = ours.stats()
    assert st == theirs.stats()
    assert set(st["speculative"]) >= {"ticks", "drafted", "accepted",
                                      "emitted"}
    assert (st["speculative"]["ticks"] > 0) == (k > 0)
    assert ("acceptance_rate" in st["speculative"]) == (k > 0)


@pytest.mark.parametrize("paged", _PAGED)
def test_lm_backend_speculative_batch_and_stream_match_jax(model, paged):
    """LMBackend(speculative_k=3, speculative_ngram=3): one batched call
    with more requests than slots equals the JAX backend's and generate();
    a stream equals the whole response."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(max_slots=2, paged=paged, page_size=16, speculative_k=3,
              speculative_ngram=3)
    ours = LMBackend(tparams, tcfg, device=CPU, **kw)
    theirs = JLMBackend(jparams, jcfg, **kw)
    assert ours.engine.speculative_k == 3
    assert ours.engine.speculative_ngram == 3
    prompts = [[i + 1, i + 2, i + 3] * 3 for i in range(5)]
    got = _call(ours, ServeRequest, prompts, 9)
    assert got == _call(theirs, JServeRequest, prompts, 9)
    for p, out in zip(prompts, got):
        assert out == _t_ref(tcfg, tparams, p, 9)
    tok = ours.stream_start(prompts[0], max_new_tokens=9)
    streamed = []
    for _ in range(200):
        r = ours.stream_poll(tok, wait_s=2.0)
        streamed += r["tokens"]
        if r["done"]:
            break
    assert streamed == got[0]
    assert ours.stats()["speculative"]["accepted"] > 0
