"""Serve a language model with continuous batching
(counterpart: ``examples/lm_serving.py``; net-new over the reference — Ray
0.9 predates LLM serving; this is the flagship serving path: router batches
-> GenerationEngine slots).

Concurrent callers' requests decode in lockstep on shared batch slots
(``ray_tpu_torch/models/engine.py``); greedy requests reproduce
single-request ``generate()`` exactly, sampled requests are
seed-reproducible. The model runs on ``device``: the card unless
``--device cpu`` is given.

Run:  python -m ray_tpu_torch.examples.lm_serving [--smoke] [--device cpu]
"""

import argparse

import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.serve import BackendConfig, LMBackend


def config(smoke: bool) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256, d_model=64 if smoke else 256,
        n_layers=2 if smoke else 4, n_heads=4, n_kv_heads=2,
        d_ff=128 if smoke else 512, max_seq_len=128,
        dtype=torch.float32)


def draw_params(cfg: TransformerConfig, device):
    """The model's random weights, from seed 0."""
    return init_params(torch.Generator().manual_seed(0), cfg, device=device)


def main(smoke: bool = False, device=None):
    dev = ray_tpu_torch.default_device(device)
    cfg = config(smoke)
    params = draw_params(cfg, dev)

    def reference(prompt, n):
        return generate(params, torch.tensor([prompt], dtype=torch.int32),
                        cfg, max_new_tokens=n, device=dev)[0].tolist()

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    serve.init()
    serve.create_backend(
        "lm:v1", LMBackend, params, cfg, device=dev,
        config=BackendConfig(max_batch_size=4, batch_wait_timeout_s=0.05,
                             max_concurrent_queries=8))
    serve.create_endpoint("generate", backend="lm:v1")
    h = serve.get_handle("generate")

    # Fire concurrent requests: the router batches them, the engine
    # decodes them together.
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    refs = [h.remote(p, max_new_tokens=8) for p in prompts]
    outs = ray_tpu_torch.get(refs, timeout=600)
    for p, out in zip(prompts, outs):
        exp = reference(p, 8)
        assert out == exp, (p, out, exp)
    print(f"{len(prompts)} concurrent greedy requests, all exact; "
          f"e.g. {prompts[0]} -> {outs[0]}")

    # Sampled request: reproducible under an explicit seed.
    a = ray_tpu_torch.get(h.remote([5, 6], max_new_tokens=8,
                                   temperature=0.8, seed=42), timeout=600)
    b = ray_tpu_torch.get(h.remote([5, 6], max_new_tokens=8,
                                   temperature=0.8, seed=42), timeout=600)
    assert a == b
    print(f"sampled (T=0.8, seed=42): {a}")

    # Token streaming: tokens arrive as the engine produces them (the
    # HTTP ingress exposes the same stream as chunked NDJSON with
    # {"stream": true} in the request kwargs).
    streamed = []
    for tok in h.stream([7, 8, 9], max_new_tokens=8):
        streamed.append(tok)
    exp = reference([7, 8, 9], 8)
    assert streamed == exp, (streamed, exp)
    print(f"streamed token-by-token: {streamed}")
    stats = serve.stat()
    print("endpoint metrics:", stats["metrics"]["endpoints"]["generate"])

    # Speculative decoding (n-gram prompt lookup): a second backend with
    # speculative_k — repetitive prompts accept drafts, outputs stay
    # exactly equal to plain greedy decode; acceptance telemetry via the
    # backend's stats method.
    serve.create_backend("lm:spec", LMBackend, params, cfg,
                         speculative_k=4, device=dev,
                         config=BackendConfig(max_concurrent_queries=8))
    serve.create_endpoint("generate_spec", backend="lm:spec")
    hs = serve.get_handle("generate_spec")
    rep = [3, 4, 5, 3, 4, 5, 3, 4]
    spec_out = ray_tpu_torch.get(hs.remote(rep, max_new_tokens=10),
                                 timeout=600)
    exp = reference(rep, 10)
    assert spec_out == exp, (spec_out, exp)
    st = ray_tpu_torch.get(hs.options(method="stats").remote(), timeout=60)
    print(f"speculative: {spec_out}  telemetry: {st['speculative']}")
    serve.shutdown()
    return outs


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args()
    try:
        main(a.smoke, a.device)
    finally:
        ray_tpu_torch.shutdown()
