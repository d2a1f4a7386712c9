"""Serving under tensor parallelism, the port against the JAX package on the
CPU: twins of tests/test_engine.py's five tp tests, plus
``decode_shardings``, ``unsharded_operands`` and the tp backend's failure
paths. JAX runs its engines over a ("tp",) mesh of 2 virtual CPU devices
with JAX's weights; the port runs one engine a rank in a 2-rank gloo world
of processes (``parallel.World``, one torch thread a rank) with the same
weights carried by ``params_from_numpy``, every rank over its block of
them. Each rank's tokens must equal JAX's unsharded and tp engines', and
each rank's KV cache or page pool holds KH/tp heads, the shape of one of
JAX's shards. The rank bodies travel by value and name nothing of JAX."""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import TransformerConfig as JCfg
from ray_tpu.models import init_params as j_init
from ray_tpu.models.engine import GenerationEngine as JEngine
from ray_tpu.models.generate import generate as j_generate
from ray_tpu.models.paged_engine import PagedGenerationEngine as JPaged
from ray_tpu.models.transformer import decode_shardings as j_decode_shardings
from ray_tpu.ops.attention import unsharded_operands as j_unsharded
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.exceptions import ReplicaUnavailableError
from ray_tpu_torch.models import TransformerConfig as TCfg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.models.engine import GenerationEngine
from ray_tpu_torch.ops.attention import unsharded_operands
from ray_tpu_torch.parallel import World
from ray_tpu_torch.serve import LMBackend, ServeRequest

cloudpickle.register_pickle_by_value(sys.modules[__name__])

# tests/test_engine.py's _cfg() and its long-context config.
_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq_len=64)
_LONG = dict(_KW, max_seq_len=256)
PROMPT = [5, 6, 7, 5, 6, 7, 5]


@pytest.fixture(scope="module")
def world():
    with World(2, device="cpu", threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:2]).reshape(2), ("tp",))


def _model(kw):
    jcfg = JCfg(dtype=jnp.float32, **kw)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _model(_KW)


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Rank processes that a backend starts run one torch thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _j_ref(jcfg, jparams, prompt, n):
    out = j_generate(jparams, jnp.asarray(prompt, jnp.int32)[None], jcfg,
                     max_new_tokens=n)
    return np.asarray(out)[0].tolist()


def _j_run(eng, batches, probe=None):
    """Each batch of (prompt, n) submitted, then run to the end; the prefix
    hits of ``probe`` before each batch."""
    outs, hits = [], []
    for batch in batches:
        if probe is not None:
            hits.append(eng._prefix_hits(probe))
        ids = [eng.submit(p, n) for p, n in batch]
        res = eng.run_until_done()
        outs.append([res[i] for i in ids])
    return outs, hits


def _j_shard(arr):
    """The shape of one device's shard of a JAX array."""
    return tuple(arr.sharding.shard_shape(arr.shape))


# ------------------------------------------------ rank bodies (by value)


def _rank_engines(params, cfg_kw, runs):
    """In each rank: for each (paged, engine kwargs, batches, probe), an
    engine over the ("tp",) mesh run as ``_j_run`` runs JAX's; with each
    run's outputs and prefix hits, its KV store's shape and its weights'
    local shapes."""
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.engine import GenerationEngine
    from ray_tpu_torch.models.paged_engine import PagedGenerationEngine
    from ray_tpu_torch.parallel import make_mesh

    assert "jax" not in sys.modules
    cfg = TransformerConfig(dtype=torch.float32, **cfg_kw)
    mesh = make_mesh({"tp": 2})
    got = []
    for paged, kw, batches, probe in runs:
        cls = PagedGenerationEngine if paged else GenerationEngine
        eng = cls(params, cfg, mesh=mesh, **kw)
        outs, hits = [], []
        for batch in batches:
            if probe is not None:
                hits.append(eng._prefix_hits(probe))
            ids = [eng.submit(p, n) for p, n in batch]
            res = eng.run_until_done()
            outs.append([res[i] for i in ids])
        store = eng.k_pages if paged else eng.cache_k
        got.append({"outs": outs, "hits": hits, "kv": tuple(store.shape),
                    "params": {k: tuple(eng.params["layers"][k].shape)
                               for k in ("wq", "wk", "wo", "w_down")},
                    "embed": tuple(eng.params["embed"].shape)})
    return got


def _rank_shardings(cfg_kw, bad_kw):
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import decode_shardings
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"tp": 2})
    specs = decode_shardings(TransformerConfig(**cfg_kw), mesh)
    try:
        decode_shardings(TransformerConfig(**bad_kw), mesh)
    except ValueError as e:
        return specs, str(e)
    return specs, None


def _rank_refusals(params, cfg_kw):
    """A DTensor split over the 2 ranks: unsharded_operands is False for it
    and both decode wrappers refuse it; an engine given another device
    than the mesh's refuses it."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.engine import GenerationEngine
    from ray_tpu_torch.ops.attention import (decode_attention,
                                             unsharded_operands)
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"tp": 2})
    q = torch.zeros(2, 4, 16)
    dq = distribute_tensor(q, mesh.device_mesh, [Shard(1)])
    k = torch.zeros(2, 8, 2, 16)
    pages = torch.zeros(3, 8, 2, 16)
    lengths = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros(2, 1, dtype=torch.int32)
    out = {"plain": unsharded_operands(q, k, k),
           "dtensor": unsharded_operands(q, dq)}
    errs = []
    for call in (lambda: decode_attention(dq, k, k, lengths),
                 lambda: paged_decode_attention(dq, pages, pages, table,
                                                lengths),
                 lambda: GenerationEngine(
                     params, TransformerConfig(**cfg_kw), mesh=mesh,
                     device="cuda:0")):
        try:
            call()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    out["launches"] = (decode_attention.launches,
                       paged_decode_attention.launches)
    return out


def _rank_skew(key, how):
    """Rank 1 of a tp backend's world: its engine cuts every request by one
    token ("diverge"), or its next step raises ("raise")."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import rank_state

    if dist.get_rank() != 1:
        return None
    eng = rank_state()[key]
    if how == "diverge":
        submit = eng.submit
        eng.submit = lambda prompt, n, *rest: submit(prompt, n - 1, *rest)
    else:
        def step():
            raise RuntimeError("rank 1 fails its step")
        eng.step = step
    return None


# ----------------------------------------------------------------- twins


def test_tp_sharded_engine_matches_unsharded(world, jmesh, model):
    """The contiguous engine on a tp mesh, with and without speculation:
    every rank's tokens equal JAX's unsharded and tp engines', every rank
    holds KH/tp heads of the cache, JAX's shard shape."""
    jcfg, jparams, tparams = model
    batches = [[(PROMPT, 8)]]
    plain = JEngine(jparams, jcfg, max_slots=2)
    ref, _ = _j_run(plain, batches)
    jtp = JEngine(jparams, jcfg, max_slots=2, mesh=jmesh)
    jtp_outs, _ = _j_run(jtp, batches)
    jspec = JEngine(jparams, jcfg, max_slots=2, mesh=jmesh, speculative_k=3)
    jspec_outs, _ = _j_run(jspec, batches)
    assert jtp_outs == ref and jspec_outs == ref

    ranks = world.run(_rank_engines, tparams, _KW, [
        (False, dict(max_slots=2), batches, None),
        (False, dict(max_slots=2, speculative_k=3), batches, None)])
    for got in ranks:
        assert [g["outs"] for g in got] == [ref, ref]
        assert got[0]["kv"] == _j_shard(jtp.cache_k) == (2, 2, 64, 1, 8)
        assert got[0]["params"] == {"wq": (2, 32, 16), "wk": (2, 32, 8),
                                    "wo": (2, 16, 32), "w_down": (2, 32, 32)}
        assert got[0]["embed"] == (32, 32)


def test_tp_sharded_paged_engine_matches_unsharded(world, jmesh, model):
    """The paged engine on a tp mesh (pool split on the kv-head axis, tables
    host state): the unsharded paged engine's tokens, with speculation and
    with prefix caching on the split pool."""
    jcfg, jparams, tparams = model
    batches = [[(PROMPT, 8)]]
    ref, _ = _j_run(JPaged(jparams, jcfg, max_slots=2, page_size=8),
                    batches)
    jtp = JPaged(jparams, jcfg, max_slots=2, page_size=8, mesh=jmesh)
    assert _j_run(jtp, batches)[0] == ref
    jspec = JPaged(jparams, jcfg, max_slots=2, page_size=8, mesh=jmesh,
                   speculative_k=3)
    assert _j_run(jspec, batches)[0] == ref
    long_prompt = ([3, 1, 4, 1, 5, 9, 2, 6] * 3)[:18]
    twice = [[(long_prompt, 8)], [(long_prompt, 8)]]
    jlong, jhits = _j_run(JPaged(jparams, jcfg, max_slots=2, page_size=8,
                                 mesh=jmesh), twice, probe=long_prompt)
    assert jlong[0] == jlong[1] and jhits[1] > 0

    kw = dict(max_slots=2, page_size=8)
    ranks = world.run(_rank_engines, tparams, _KW, [
        (True, kw, batches, None),
        (True, dict(kw, speculative_k=3), batches, None),
        (True, kw, twice, long_prompt)])
    for got in ranks:
        assert [g["outs"] for g in got[:2]] == [ref, ref]
        assert got[2]["outs"] == jlong and got[2]["hits"] == jhits
        assert got[0]["kv"] == _j_shard(jtp.k_pages) == (2, 17, 8, 1, 8)


def test_chunked_prefill_paged_tp_compose(world, jmesh):
    """Paged KV + tp mesh + chunked prefill + speculation + prefix caching
    in one engine: generate()'s tokens, twice, the second prompt's shared
    prefix chunks skipped on the split pool."""
    jcfg, jparams, tparams = _model(_LONG)
    prompt = ([7, 8, 9, 7, 8, 9] * 30)[:150]
    ref = _j_ref(jcfg, jparams, prompt, 10)
    kw = dict(max_slots=2, page_size=64, prefill_chunk=64, speculative_k=3)
    twice = [[(prompt, 10)], [(prompt, 10)]]
    jeng = JPaged(jparams, jcfg, mesh=jmesh, **kw)
    jouts, jhits = _j_run(jeng, twice, probe=prompt)
    assert jouts == [[ref], [ref]] and jhits[1] > 0

    for got in world.run(_rank_engines, tparams, _LONG,
                         [(True, kw, twice, prompt)]):
        assert got[0]["outs"] == jouts and got[0]["hits"] == jhits
        assert got[0]["kv"] == _j_shard(jeng.k_pages) == (2, 9, 64, 1, 8)


def _serve_tokens(rt, sv, params, cfg, kw, name):
    """One request through a tp=2 backend behind serve; its tokens and the
    backend's stats() through the handle."""
    sv.create_backend(f"lm:{name}", sv.LMBackend, params, cfg, tp=2, **kw,
                      config=sv.BackendConfig(max_concurrent_queries=8))
    sv.create_endpoint(f"gen_{name}", backend=f"lm:{name}")
    h = sv.get_handle(f"gen_{name}")
    out = rt.get(h.remote(PROMPT, max_new_tokens=6), timeout=300)
    st = rt.get(h.options(method="stats").remote(), timeout=60)
    return out, st


def _tp_behind_serve(model, paged):
    """LMBackend(tp=2) with speculation behind serve: generate()'s tokens
    from JAX's backend and from the port's, whose replica drives a world
    of 2 ranks; stats() through the handle, speculation counted."""
    jcfg, jparams, tparams = model
    kw = dict(speculative_k=3, **(dict(paged=True, page_size=8)
                                   if paged else {}))
    outs = []
    for rt, sv, params, cfg, extra in (
            (ray_tpu, jserve, jparams, jcfg, {}),
            (ray_tpu_torch, tserve, tparams,
             TCfg(dtype=torch.float32, **_KW), {"device": "cpu"})):
        rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
        try:
            sv.init()
            outs.append(_serve_tokens(rt, sv, params, cfg, dict(kw, **extra),
                                      "ptp" if paged else "tp"))
        finally:
            sv.shutdown()
            rt.shutdown()
    (jout, jst), (tout, tst) = outs
    assert jout == tout == _j_ref(jcfg, jparams, PROMPT, 6)
    assert tst["slots"] == jst["slots"] == 8
    assert tst["speculative"] == jst["speculative"]
    assert tst["speculative"]["ticks"] > 0


def test_lm_backend_paged_tp_behind_serve(model, one_thread_ranks):
    """Paged KV + tp=2 + speculation behind serve."""
    _tp_behind_serve(model, paged=True)


def test_lm_backend_tp_behind_serve(model, one_thread_ranks):
    """The contiguous engine at tp=2 behind serve, with speculation."""
    _tp_behind_serve(model, paged=False)


# ------------------------------------------- the port's own tp surfaces


def test_decode_shardings_match_jax(world, jmesh):
    """The specs of JAX's decode_shardings, and its ValueError's words."""
    bad = dict(_KW, n_kv_heads=3, n_heads=3)
    jspecs = jax.tree_util.tree_map(
        lambda ns: tuple(ns.spec),
        j_decode_shardings(JCfg(**_KW), jmesh),
        is_leaf=lambda x: hasattr(x, "spec"))
    with pytest.raises(ValueError) as err:
        j_decode_shardings(JCfg(**bad), jmesh)
    for specs, msg in world.run(_rank_shardings, _KW, bad):
        got = {"embed": tuple(specs["embed"]),
               "layers": {k: tuple(v) for k, v in specs["layers"].items()},
               "final_norm": tuple(specs["final_norm"])}
        assert got == jspecs
        assert got["layers"]["wo"] == (None, "tp", None)
        assert msg == str(err.value)


def test_unsharded_operands_and_the_decode_refusals(world, jmesh, model):
    """Plain tensors (every rank's own shard) are unsharded, as JAX's
    single-device arrays are; a DTensor over 2 ranks is not, as JAX's
    array over 2 devices is not, and the decode wrappers refuse it rather
    than take a plain version. A mesh that is not the port's is a
    TypeError; a device other than the mesh's a ValueError."""
    _, _, tparams = model
    x = jnp.zeros((2, 4))
    split = jax.device_put(x, jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(None, "tp")))
    assert j_unsharded(x) and not j_unsharded(split)
    assert unsharded_operands(torch.zeros(2, 4), torch.zeros(3))
    with pytest.raises(TypeError, match="parallel Mesh"):
        GenerationEngine(tparams, TCfg(dtype=torch.float32, **_KW),
                         mesh=jmesh, device="cpu")
    for got in world.run(_rank_refusals, tparams, _KW):
        assert got["plain"] is True and got["dtensor"] is False
        dec, paged, dev = got["errors"]
        assert "decode_attention takes each rank's own tensors" in dec
        assert "paged_decode_attention takes each rank's own" in paged
        assert "is not the mesh's device cpu" in dev
        assert got["launches"] == (0, 0)


@pytest.mark.parametrize("how", ["diverge", "raise"])
def test_a_rank_out_of_step_poisons_the_tp_backend(model, how,
                                                   one_thread_ranks):
    """Nothing is served from one rank while another disagrees: when rank
    1's events leave rank 0's (its engine cuts each request by a token) or
    its step raises, the call fails with that error, the backend reports
    unhealthy and refuses new work, and close() stops its world."""
    jcfg, jparams, tparams = model
    b = LMBackend(tparams, TCfg(dtype=torch.float32, **_KW), tp=2,
                  max_slots=2, device="cpu")
    try:
        req = [ServeRequest((PROMPT,), {"max_new_tokens": 6})]
        assert b(req) == [_j_ref(jcfg, jparams, PROMPT, 6)]
        eng = b.engine
        eng.world.run(_rank_skew, eng.key, how)
        with pytest.raises(Exception, match="diverged from rank 0"
                           if how == "diverge" else "rank 1 fails"):
            b(req)
        assert b.check_health()["healthy"] is False
        with pytest.raises(ReplicaUnavailableError):
            b(req)
    finally:
        b.close()
    assert b.engine is None and eng.world._procs == []
