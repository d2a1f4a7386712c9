"""The port's examples against the JAX package's, on the CPU: twins of the
tests of tests/test_examples.py (the 8-rank pipelined transformer's is in
test_torch_examples_pipeline.py) and of test_placement_group.py's
gang-rendezvous test.

Each twin runs the reference's example (``examples/``) on a fresh
``ray_tpu`` runtime and the port's (``ray_tpu_torch.examples``) with
``device="cpu"`` on a fresh ``ray_tpu_torch`` runtime, and holds each to
the reference test's own assertion. Where the result is deterministic the
two are held equal: the word counts, the micro-batches' rows (and their
``mean_abs`` within 1e-6), the parameter server's sync loss (within 1e-5
relative of the reference's sync rounds run without its runtime, whose
server aliases its weights: ``_jax_sync_loss``). Where the JAX example
draws weights from ``jax.random``, the port's example is handed JAX's
draws by monkeypatching its draw
(``draw_params``): ``lm_serving``'s greedy, streamed and speculative
outputs must then equal JAX's token for token, and both searches must pick
lr 0.1."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import TransformerConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu_torch.models import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples import (cartpole_ppo as j_cartpole,  # noqa: E402
                      hyperparameter_search as j_search,
                      lm_serving as j_lm,
                      mapreduce_wordcount as j_wordcount,
                      parameter_server as j_ps, serve_model as j_serve,
                      streaming_microbatch as j_micro)
from ray_tpu_torch.examples import (cartpole_ppo as t_cartpole,  # noqa: E402
                                    hyperparameter_search as t_search,
                                    lm_serving as t_lm,
                                    mapreduce_wordcount as t_wordcount,
                                    parameter_server as t_ps,
                                    serve_model as t_serve,
                                    streaming_microbatch as t_micro)

STORE = 256 * 1024 * 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()


def both(jax_program, port_program):
    """Each program on a fresh local runtime of its package (the
    reference's ``local_ray``): (JAX's result, the port's)."""
    outs = []
    for rt, program in ((ray_tpu, jax_program),
                        (ray_tpu_torch, port_program)):
        rt.init(num_cpus=8, object_store_memory=STORE)
        try:
            outs.append(program())
        finally:
            rt.shutdown()
    return outs


def _jax_sync_loss(workers=4, rounds=5, lr=0.1):
    """The reference's sync rounds without its runtime: each round's
    gradients by its jitted ``grad_fn`` at the round's weights, applied in
    order. Its example on a runtime can differ under load: its server
    returns the array it updates in place, so a round's later gradient
    tasks may read the round's first updates."""
    w = np.zeros(8, np.float32)
    for _ in range(rounds):
        grads = [np.asarray(j_ps.grad_fn(jnp.asarray(w), *j_ps.make_data(
            seed=s)[:2])) for s in range(workers)]
        for g in grads:
            w -= lr * g
    return j_ps.final_loss(w)


def test_parameter_server_sync():
    j, t = both(lambda: j_ps.main(use_async=False, smoke=True),
                lambda: t_ps.main(use_async=False, smoke=True,
                                  device="cpu"))
    assert j < 1.0 and t < 1.0
    want = _jax_sync_loss()
    assert abs(t - want) <= 1e-5 * abs(want), (t, want, j)


def test_parameter_server_async():
    # Gradients apply in arrival order: the loss is the reference's bound.
    j, t = both(lambda: j_ps.main(use_async=True, smoke=True),
                lambda: t_ps.main(use_async=True, smoke=True, device="cpu"))
    assert j < 1.0 and t < 1.0


def test_mapreduce_wordcount():
    j, t = both(lambda: j_wordcount.main(smoke=True),
                lambda: t_wordcount.main(smoke=True))
    assert t["the"] > 0
    assert t == j


def test_hyperparameter_search(monkeypatch):
    """The port's MLP starts from JAX's draw (PRNGKey(0) split in two, as
    the reference's train_mlp draws it)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    drawn = {"w1": np.asarray(jax.random.normal(k1, (2, 16)) * 0.5),
             "b1": np.zeros(16, np.float32),
             "w2": np.asarray(jax.random.normal(k2, (16, 2)) * 0.5),
             "b2": np.zeros(2, np.float32)}
    monkeypatch.setattr(t_search, "draw_params", lambda: {
        k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
    j, t = both(lambda: j_search.main(smoke=True),
                lambda: t_search.main(smoke=True, device="cpu"))
    assert j["lr"] == 0.1 and t["lr"] == 0.1


def test_cartpole_ppo():
    j, t = both(lambda: j_cartpole.main(smoke=True),
                lambda: t_cartpole.main(smoke=True, device="cpu"))
    assert j["timesteps_total"] > 0 and t["timesteps_total"] > 0
    assert t["timesteps_total"] == j["timesteps_total"]


def test_serve_model():
    both(lambda: j_serve.main(smoke=True),
         lambda: t_serve.main(smoke=True, device="cpu"))


def _recorded(module, to_list):
    """Wrap ``module.generate`` (the example's reference decode): every
    call's prompt and output, in call order."""
    calls = []
    inner = module.generate

    def generate(params, prompt, cfg, max_new_tokens, **kw):
        out = inner(params, prompt, cfg, max_new_tokens=max_new_tokens, **kw)
        calls.append((np.asarray(prompt).tolist(), max_new_tokens,
                      to_list(out)))
        return out

    return calls, generate


def test_lm_serving(monkeypatch):
    """The port's model carries JAX's weights (PRNGKey(0)). Each example
    asserts that its 6 greedy requests, its stream and its speculative
    request equal its own ``generate``; both examples' ``generate`` calls
    (those prompts and outputs) must be equal, and so are the served
    outputs."""
    jcfg = JConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=128,
                   dtype=jnp.float32)
    drawn = jax.tree_util.tree_map(np.asarray,
                                   jinit(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(t_lm, "draw_params", lambda cfg, device:
                        params_from_numpy(drawn, device=device))
    j_calls, j_gen = _recorded(j_lm, lambda o: np.asarray(o).tolist())
    t_calls, t_gen = _recorded(t_lm, lambda o: o.tolist())
    monkeypatch.setattr(j_lm, "generate", j_gen)
    monkeypatch.setattr(t_lm, "generate", t_gen)
    j, t = both(lambda: j_lm.main(smoke=True),
                lambda: t_lm.main(smoke=True, device="cpu"))
    assert len(j) == 6 and len(t) == 6
    assert t == j
    assert len(t_calls) == 8          # 6 greedy, the stream, speculation
    assert t_calls == j_calls


def test_streaming_microbatch():
    j, t = both(lambda: j_micro.main(smoke=True),
                lambda: t_micro.main(smoke=True))
    assert t["batches"] == 8 and t["rows"] == 8 * 256
    assert (t["batches"], t["rows"]) == (j["batches"], j["rows"])
    assert abs(t["mean_abs"] - j["mean_abs"]) <= 1e-6


@pytest.mark.slow
@pytest.mark.cluster
def test_gang_rendezvous_example_completes():
    """The reference's test (test_placement_group.py), in each package: a
    2-node cluster, the example run as a driver against it."""
    from ray_tpu.cluster.testing import Cluster as JCluster
    from ray_tpu.cluster.testing import _subprocess_env as j_env
    from ray_tpu_torch.cluster.testing import Cluster as TCluster
    from ray_tpu_torch.cluster.testing import _subprocess_env as t_env

    runs = (
        (lambda: JCluster(head_resources={"CPU": 2}, num_workers=2), j_env,
         "RAY_TPU_ADDRESS",
         [os.path.join(ROOT, "examples", "gang_rendezvous.py")]),
        (lambda: TCluster(head_resources={"CPU": 2}, num_workers=2,
                          device="cpu"), t_env, "RAY_TPU_TORCH_ADDRESS",
         ["-m", "ray_tpu_torch.examples.gang_rendezvous"]))
    for make, env_of, var, cmd in runs:
        with make() as cluster:
            cluster.add_node(resources={"CPU": 2}, num_workers=2)
            cluster.wait_for_nodes(2)
            env = env_of()
            env[var] = cluster.address
            out = subprocess.run(
                [sys.executable, *cmd, "--world-size", "4", "--strategy",
                 "SPREAD"], capture_output=True, text=True, timeout=180,
                env=env, cwd=ROOT)
            assert out.returncode == 0, out.stdout + out.stderr
            assert "rendezvous complete" in out.stdout, out.stdout
