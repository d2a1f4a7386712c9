"""The port's serving path (ray_tpu_torch.models / ray_tpu_torch.serve)
against the JAX package's, on the CPU, at the examples/lm_serving.py smoke
config in f32 with the JAX weights carried across by params_from_numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import TransformerConfig as JCfg
from ray_tpu.models import init_params as j_init
from ray_tpu.models import engine as jeng
from ray_tpu.models.generate import generate as j_generate
from ray_tpu_torch.models import TransformerConfig as TCfg
from ray_tpu_torch.models import engine as teng
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models.generate import generate as t_generate
from ray_tpu_torch.models.paged_engine import PagedGenerationEngine
from ray_tpu_torch.serve import LMBackend, ServeRequest

CPU = "cpu"
_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=128)


@pytest.fixture(scope="module")
def model():
    jcfg = JCfg(dtype=jnp.float32, **_KW)
    tcfg = TCfg(dtype=torch.float32, **_KW)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device=CPU)
    return jcfg, jparams, tcfg, tparams


def _j_run(jcfg, jparams, submits, **kw):
    eng = jeng.GenerationEngine(jparams, jcfg, **kw)
    ids = [eng.submit(*a, **k) for a, k in submits]
    res = eng.run_until_done()
    return [res[i] for i in ids]


def _t_run(tcfg, tparams, submits, **kw):
    eng = teng.GenerationEngine(tparams, tcfg, device=CPU, **kw)
    ids = [eng.submit(*a, **k) for a, k in submits]
    res = eng.run_until_done()
    return [res[i] for i in ids]


def _t_ref(tcfg, tparams, prompt, n):
    return t_generate(tparams, [prompt], tcfg, n, device=CPU)[0].tolist()


def _j_ref(jcfg, jparams, prompt, n):
    out = j_generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg,
                     max_new_tokens=n)
    return np.asarray(out)[0].tolist()


def test_params_from_numpy_keeps_layout(model):
    jcfg, jparams, tcfg, tparams = model
    assert tparams["layers"]["wq"].shape == (2, 64, 64)
    assert tparams["layers"]["wk"].shape == (2, 64, 32)
    assert tparams["embed"].dtype == torch.float32
    np.testing.assert_array_equal(tparams["layers"]["w_down"].numpy(),
                                  np.asarray(jparams["layers"]["w_down"]))


def test_prefill_and_decode_logits_match_jax(model):
    """Bucketed prefill into two slots, then lockstep decode ticks: logits
    (atol 1e-4) and cache rows match the JAX engine's programs."""
    jcfg, jparams, tcfg, tparams = model
    L, slots, S, KH, Dh = 2, 3, 64, 2, 16
    jk = jnp.zeros((L, slots, S, KH, Dh), jnp.float32)
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((L, slots, S, KH, Dh))
    tv = torch.zeros_like(tk)
    tp = teng.to_compute(tparams, tcfg)
    lengths = np.zeros(slots, np.int32)
    tokens = np.zeros(slots, np.int32)
    rng = np.random.default_rng(0)
    for slot, T0 in ((0, 5), (2, 11)):
        prompt = rng.integers(0, 256, T0)
        Tb = 1 << (T0 - 1).bit_length()
        padded = np.zeros((1, Tb), np.int32)
        padded[0, :T0] = prompt
        jl, jk, jv = jeng._prefill_into_slot(
            jparams, jnp.asarray(padded), jnp.asarray(T0, jnp.int32),
            jnp.asarray(slot, jnp.int32), jk, jv, jcfg)
        tl = teng._prefill_into_slot(tp, torch.from_numpy(padded), T0, slot,
                                     tk, tv, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        lengths[slot], tokens[slot] = T0, int(np.argmax(np.asarray(jl)))
    for _ in range(4):
        jl, jk, jv = jeng._batched_decode(
            jparams, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv, jcfg)
        tl = teng._batched_decode(tp, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths), tk, tv, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths = lengths + 1
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_greedy_engine_matches_jax_engine_and_generate(model):
    """Different prompt lengths decoding in lockstep, oversubscribed (4
    requests, 3 slots): each equals the JAX engine's output and the
    port's single-request generate()."""
    jcfg, jparams, tcfg, tparams = model
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4], [20, 21, 22, 23]]
    ns = [6, 4, 8, 5]
    submits = [((p, n), {}) for p, n in zip(prompts, ns)]
    ours = _t_run(tcfg, tparams, submits, max_slots=3)
    assert ours == _j_run(jcfg, jparams, submits, max_slots=3)
    for p, n, out in zip(prompts, ns, ours):
        assert out == _t_ref(tcfg, tparams, p, n)


def test_generate_matches_jax_generate(model):
    jcfg, jparams, tcfg, tparams = model
    assert _t_ref(tcfg, tparams, [9, 8, 7, 6], 7) == \
        _j_ref(jcfg, jparams, [9, 8, 7, 6], 7)


def test_slot_reuse_oversubscribed_with_streaming_events(model):
    """8 requests through 2 slots: slots are reused as they free, and the
    step() event stream carries every token, first tokens included."""
    jcfg, jparams, tcfg, tparams = model
    eng = teng.GenerationEngine(tparams, tcfg, max_slots=2, device=CPU)
    prompts = [[i + 1, i + 2] for i in range(8)]
    ids = [eng.submit(p, 3) for p in prompts]
    streamed = {rid: [] for rid in ids}
    while eng.queue or any(r is not None for r in eng.active):
        for rid, token, done in eng.step():
            streamed[rid].append(token)
    ref = _j_run(jcfg, jparams, [((p, 3), {}) for p in prompts],
                 max_slots=2)
    for rid, exp in zip(ids, ref):
        assert eng.done[rid] == exp
        assert streamed[rid] == eng.done[rid]


def test_eos_frees_slot_and_single_token_finishes_at_prefill(model):
    _, _, tcfg, tparams = model
    first = _t_ref(tcfg, tparams, [5, 6], 1)[0]
    eng = teng.GenerationEngine(tparams, tcfg, max_slots=1, eos_id=first,
                                device=CPU)
    rid = eng.submit([5, 6], 10)
    assert eng.run_until_done()[rid] == [first]     # EOS, not 10 tokens
    eng = teng.GenerationEngine(tparams, tcfg, max_slots=2, device=CPU)
    rid = eng.submit([3, 4, 5], 1)
    assert eng.run_until_done()[rid] == _t_ref(tcfg, tparams, [3, 4, 5], 1)
    assert all(r is None for r in eng.active)


def test_chunked_prefill_matches_bucketed_and_jax(model):
    """Prompts longer than the chunk stream through fixed chunks and match
    the JAX chunked engine and the port's generate()."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    submits = [((rng.integers(1, 250, size=T0).tolist(), 4), {})
               for T0 in (33, 64, 70)]
    ours = _t_run(tcfg, tparams, submits, max_slots=2, prefill_chunk=32)
    assert ours == _j_run(jcfg, jparams, submits, max_slots=2,
                          prefill_chunk=32)
    for (args, _), out in zip(submits, ours):
        assert out == _t_ref(tcfg, tparams, *args)


def test_seeded_sampling_matches_jax_engine(model):
    """Host-side numpy sampling: the same seed gives the JAX engine's
    sampled continuation, whatever the batch-mates; greedy stays exact."""
    jcfg, jparams, tcfg, tparams = model
    submits = [(([1, 2, 3], 6), {}),
               (([4, 5], 6), dict(temperature=0.9, seed=7))]
    ours = _t_run(tcfg, tparams, submits, max_slots=4)
    assert ours == _j_run(jcfg, jparams, submits, max_slots=4)
    alone = _t_run(tcfg, tparams, [submits[1]], max_slots=4)
    assert alone == [ours[1]]
    other = _t_run(tcfg, tparams, [(([4, 5], 6), dict(temperature=0.9,
                                                      seed=8))])
    assert other != alone


def test_stop_sequences_and_cancel(model):
    _, _, tcfg, tparams = model
    prompt = [5, 6, 7, 5, 6, 7, 5]
    full = _t_ref(tcfg, tparams, prompt, 12)
    eng = teng.GenerationEngine(tparams, tcfg, max_slots=2, device=CPU)
    rid = eng.submit(prompt, 12, stop=[[full[2]]])
    assert eng.run_until_done()[rid] == full[:full.index(full[2]) + 1]
    with pytest.raises(ValueError, match="stop"):
        eng.submit(prompt, 4, stop=[220])
    r1, r2 = eng.submit(prompt, 8), eng.submit([1, 2], 8)
    eng.step()
    assert eng.cancel(r1) and eng.cancel(r2) is True
    assert eng.run_until_done() == {}


def test_unported_features_raise_naming_the_slice(model):
    _, _, tcfg, tparams = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.GenerationEngine(tparams, tcfg, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedGenerationEngine(tparams, tcfg, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMBackend(tparams, tcfg, paged=True, tp=2, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LMBackend(tparams, tcfg, tp=2, device=CPU)


# ------------------------------------------------------------ LMBackend


def test_lm_backend_batch_call_matches_jax(model):
    """One batched __call__, as serve delivers it, more requests than
    slots: each caller gets the JAX engine's greedy continuation."""
    jcfg, jparams, tcfg, tparams = model
    b = LMBackend(tparams, tcfg, max_slots=2, device=CPU)
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    outs = b([ServeRequest((p,), {"max_new_tokens": 4}) for p in prompts])
    assert outs == _j_run(jcfg, jparams, [((p, 4), {}) for p in prompts],
                          max_slots=2)
    assert b([ServeRequest(([4, 5], 6), {})]) == \
        [_t_ref(tcfg, tparams, [4, 5], 6)]
    st = b.stats()
    assert st["slots"] == 2 and st["active"] == 0 and not st["poisoned"]


@pytest.mark.parametrize("paged", [False, True])
def test_lm_backend_speculative_ngram_serves_jax_tokens(model, paged):
    """speculative_ngram is taken as the JAX LMBackend takes it and, with
    speculative_k 0, is inert: the same greedy tokens as JAX's backend
    given the same arguments."""
    from ray_tpu.serve.config import ServeRequest as JServeRequest
    from ray_tpu.serve.lm import LMBackend as JLMBackend

    jcfg, jparams, tcfg, tparams = model
    kw = dict(max_slots=2, paged=paged, page_size=16, speculative_k=0,
              speculative_ngram=3)
    b = LMBackend(tparams, tcfg, device=CPU, **kw)
    assert b.engine.speculative_ngram == 3 and b.engine.speculative_k == 0
    prompts = [[i + 1, i + 2, i + 1, i + 2] for i in range(3)]
    got = b([ServeRequest((p,), {"max_new_tokens": 5}) for p in prompts])
    want = JLMBackend(jparams, jcfg, **kw)(
        [JServeRequest((p,), {"max_new_tokens": 5}) for p in prompts])
    assert got == want


def test_lm_backend_token_streaming(model):
    """stream_start/stream_poll deliver the whole-response greedy
    continuation; cancel frees the slot."""
    _, _, tcfg, tparams = model
    b = LMBackend(tparams, tcfg, max_slots=2, device=CPU)
    tok = b.stream_start([1, 2, 3], max_new_tokens=5)
    got, done = [], False
    for _ in range(200):
        r = b.stream_poll(tok, wait_s=2.0)
        got += r["tokens"]
        if r["done"]:
            done = True
            break
    assert done
    assert got == b([ServeRequest(([1, 2, 3],), {"max_new_tokens": 5})])[0]
    with pytest.raises(KeyError):
        b.stream_poll(tok)
    tok = b.stream_start([1, 2], max_new_tokens=30)
    assert b.stream_cancel(tok) and not b.stream_cancel(tok)
    assert b([ServeRequest(([3, 4],), {"max_new_tokens": 3})]) == \
        [_t_ref(tcfg, tparams, [3, 4], 3)]


def test_lm_backend_pump_error_propagates(model):
    """A failing engine step surfaces on the waiting calls, drains the
    engine, then the backend refuses new work with
    ReplicaUnavailableError and reports unhealthy."""
    from ray_tpu_torch.exceptions import ReplicaUnavailableError

    _, _, tcfg, tparams = model

    def boom():
        raise RuntimeError("device exploded")

    b = LMBackend(tparams, tcfg, max_slots=2, device=CPU)
    b.engine.step = boom
    with pytest.raises(RuntimeError, match="device exploded"):
        b([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
    assert not b.engine.queue and not any(
        r is not None for r in b.engine.active)
    with pytest.raises(ReplicaUnavailableError, match="device exploded"):
        b.stream_start([1, 2], max_new_tokens=4)
    with pytest.raises(ReplicaUnavailableError, match="device exploded"):
        b([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
    health = b.check_health()
    assert not health["healthy"] and "device exploded" in health["reason"]
    assert not b._streams and not b._stream_seen and not b._failed

    b2 = LMBackend(tparams, tcfg, max_slots=2, device=CPU)
    with b2._cond:  # the pump can't step until we release the lock
        token = b2.stream_start([1, 2], max_new_tokens=4)
        b2.engine.step = boom
    with pytest.raises(RuntimeError, match="device exploded"):
        for _ in range(100):
            b2.stream_poll(token, wait_s=5.0)
    assert not b2._streams and not b2._stream_seen and not b2._failed


class _PumpStop(BaseException):
    """Not an Exception: what a bare ``except Exception`` lets through."""


@pytest.mark.parametrize("paged", [False, True])
def test_lm_backend_pump_base_exception_poisons(model, paged):
    """A BaseException that escapes engine.step() fails the waiting call
    with that exception and marks the replica unhealthy, as the reference
    pump does; the pump never dies with the caller left blocked."""
    import threading

    _, _, tcfg, tparams = model

    def stop():
        raise _PumpStop("pump stopped")

    b = LMBackend(tparams, tcfg, max_slots=2, paged=paged, device=CPU)
    b.engine.step = stop
    raised = []

    def call():
        try:
            b([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
        except BaseException as e:  # noqa: BLE001
            raised.append(e)

    caller = threading.Thread(target=call, daemon=True)
    caller.start()
    caller.join(timeout=30)
    assert not caller.is_alive(), "the caller is still blocked"
    assert len(raised) == 1 and isinstance(raised[0], _PumpStop)
    health = b.check_health()
    assert not health["healthy"]
    assert "_PumpStop: pump stopped" in health["reason"]
