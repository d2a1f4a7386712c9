"""Model serving over HTTP (counterpart: ``examples/serve_model.py``;
reference: python/ray/serve/examples/echo*.py).

A tensor model behind a replicated backend: two replicas, traffic split
between two model versions (canary), reachable by Python handle and HTTP.
Each call is one tensor op on ``device``: the card unless ``--device cpu``
is given.

Run:  python -m ray_tpu_torch.examples.serve_model [--smoke] [--device cpu]
"""

import argparse
import json
import urllib.request

import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import BackendConfig


class LinearModel:
    """y = scale * x, one tensor op on the model's device a call."""

    def __init__(self, scale: float, device: str):
        self.device = torch.device(device)
        self.scale = torch.tensor(scale, dtype=torch.float32,
                                  device=self.device)

    def __call__(self, x=None):
        x = torch.tensor(float(x or 0.0), dtype=torch.float32,
                         device=self.device)
        return float((x * self.scale).item())


def main(smoke: bool = False, device=None):
    dev = str(ray_tpu_torch.default_device(device))
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    serve.init(http_port=0)
    serve.create_backend("model:v1", LinearModel, 2.0, dev,
                         config=BackendConfig(num_replicas=2))
    serve.create_endpoint("predict", backend="model:v1", route="/predict",
                          methods=["GET", "POST"])

    h = serve.get_handle("predict")
    out = ray_tpu_torch.get([h.remote(float(i)) for i in range(8)])
    assert out == [2.0 * i for i in range(8)]
    print("handle path ok:", out[:4], "...")

    # Canary: 20% of traffic to v2 (y = 10x).
    serve.create_backend("model:v2", LinearModel, 10.0, dev)
    serve.set_traffic("predict", {"model:v1": 0.8, "model:v2": 0.2})
    versions = {ray_tpu_torch.get(h.remote(1.0)) for _ in range(40)}
    assert versions <= {2.0, 10.0}
    print("traffic split serves versions:", sorted(versions))

    addr = serve.http_address()
    if addr:
        req = urllib.request.Request(
            f"{addr}/predict", data=json.dumps(3.0).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            print("http path ok:", json.loads(resp.read()))
    serve.shutdown()


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
