"""Streaming micro-batch pipeline riding the data plane
(counterpart: ``examples/streaming_microbatch.py``).

A three-stage pipeline — produce -> featurize -> sink — where each stage
is a task and micro-batches flow between stages as object refs. Stages
never meet in one process: when run with ``--cluster``, producers and
featurizers land on different nodes and every batch crosses the wire via
the chunked pull-based transfer manager. The driver keeps a bounded window
of batches in flight (``ray_tpu_torch.wait``-based backpressure) so the
pipeline streams instead of materializing the whole dataset.

Host-only: the batches are numpy arrays. With ``--cluster`` the head's
placement passes run on ``--device`` (the card unless ``cpu`` is given).

Run:  python -m ray_tpu_torch.examples.streaming_microbatch [--smoke]
          [--cluster [--device cpu]]
"""

import argparse

import numpy as np

import ray_tpu_torch


def build_stages():
    @ray_tpu_torch.remote
    def produce(seed: int, rows: int):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((rows, 16), dtype=np.float32)

    @ray_tpu_torch.remote
    def featurize(batch):
        # Per-feature standardization — a stand-in for real preprocessing.
        mu = batch.mean(axis=0, keepdims=True)
        sd = batch.std(axis=0, keepdims=True) + 1e-6
        return (batch - mu) / sd

    @ray_tpu_torch.remote
    def sink(batch):
        return {"rows": int(batch.shape[0]),
                "mean_abs": float(np.abs(batch).mean())}

    return produce, featurize, sink


def main(smoke: bool = False, cluster=None) -> dict:
    if cluster is not None:
        ray_tpu_torch.init(address=cluster.address, ignore_reinit_error=True)
    elif not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    produce, featurize, sink = build_stages()

    n_batches = 8 if smoke else 64
    rows = 256 if smoke else 8192
    window = 4  # micro-batches in flight at once

    inflight, done = [], []
    for i in range(n_batches):
        # Chain the stages: each ref feeds the next stage without the
        # driver ever holding the batch bytes.
        batch = produce.remote(i, rows)
        inflight.append(sink.remote(featurize.remote(batch)))
        if len(inflight) >= window:
            ready, inflight = ray_tpu_torch.wait(inflight, num_returns=1,
                                                 timeout=120)
            done.extend(ray_tpu_torch.get(ready, timeout=120))
    done.extend(ray_tpu_torch.get(inflight, timeout=120))

    total_rows = sum(d["rows"] for d in done)
    assert len(done) == n_batches
    assert total_rows == n_batches * rows
    # Standardized features: mean |x| of a unit normal is ~0.8
    mean_abs = sum(d["mean_abs"] for d in done) / len(done)
    assert 0.5 < mean_abs < 1.1, mean_abs
    print(f"streamed {n_batches} micro-batches ({total_rows} rows), "
          f"mean|x| after featurize = {mean_abs:.3f}")
    return {"batches": len(done), "rows": total_rows, "mean_abs": mean_abs}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--cluster", action="store_true",
                   help="run over a 3-node cluster so batches cross the "
                        "chunked transfer path")
    p.add_argument("--device", default=None,
                   help="the cluster head's placement device: cuda (the "
                        "default) or cpu")
    a = p.parse_args()
    if a.cluster:
        from ray_tpu_torch.cluster import Cluster

        c = Cluster(head_resources={"CPU": 2}, num_workers=1,
                    device=a.device)
        try:
            for _ in range(2):
                c.add_node(resources={"CPU": 2}, num_workers=1)
            c.wait_for_nodes(3)
            main(a.smoke, cluster=c)
        finally:
            ray_tpu_torch.shutdown()
            c.shutdown()
    else:
        try:
            main(a.smoke)
        finally:
            ray_tpu_torch.shutdown()
