"""The port's 8-rank pipelined transformer example against the JAX
package's, on the CPU: the twin of tests/test_examples.py::
test_pipelined_transformer (in a file of its own: its 8 rank processes are
the heaviest of the example twins).

JAX's example runs dp2 x pp2 x sp1 x tp2 on the 8 virtual CPU devices of
tests/conftest.py; the port's on 8 gloo rank processes with
``device="cpu"``, handed JAX's weights (PRNGKey(0)) and tokens
(PRNGKey(1)) by monkeypatching its draw. The final losses, after 1 + 3
AdamW steps, agree within atol = rtol = 2e-5 (f32: the sharded sums'
order, and torch's and optax's Adam rounding), the pipeline twins'
tolerance in test_torch_pipeline_model.py; every rank reports the same
losses, and they fall."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.models import TransformerConfig as JConfig
from ray_tpu.models import init_params as jinit
from ray_tpu_torch.models import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples import pipelined_transformer as j_pt  # noqa: E402
from ray_tpu_torch.examples import pipelined_transformer as t_pt  # noqa: E402


def test_pipelined_transformer(monkeypatch):
    jcfg = JConfig(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=64,
                   dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jinit(jax.random.PRNGKey(0), jcfg))
    tokens = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (4, jcfg.max_seq_len + 1), 0,
        jcfg.vocab_size, jnp.int32))
    monkeypatch.setattr(t_pt, "draw", lambda cfg: (
        params_from_numpy(params, device="cpu"), torch.from_numpy(tokens)))

    runs, inner = [], t_pt.run
    monkeypatch.setattr(t_pt, "run", lambda *a, **kw: runs.append(
        inner(*a, **kw)) or runs[-1])

    j_loss = j_pt.main(smoke=True)
    t_loss = t_pt.main(smoke=True, device="cpu")
    losses = [r["losses"] for r in runs[0]["ranks"]]
    assert len(losses) == 8 and all(ls == losses[0] for ls in losses)
    assert j_loss > 0 and t_loss > 0
    assert t_loss == losses[0][-1]
    np.testing.assert_allclose(t_loss, j_loss, atol=2e-5, rtol=2e-5)
    assert losses[0][-1] < losses[0][0], "loss should decrease"
