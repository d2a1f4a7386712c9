"""Streaming MapReduce word count
(counterpart: ``examples/mapreduce_wordcount.py``; reference:
doc/examples/streaming/streaming.py — the article word-count).

flat_map → key_by → reduce over the streaming dataflow: records cross
operator instances through shm rings when co-located, credit-based actor
pushes otherwise.

Host-only: no tensor and no card.

Run:  python -m ray_tpu_torch.examples.mapreduce_wordcount [--smoke]
"""

import argparse
from collections import Counter

import ray_tpu_torch
from ray_tpu_torch.streaming import StreamingContext

ARTICLE = """the quick brown fox jumps over the lazy dog
a distributed system is a system whose components communicate
the fox and the dog become friends in the distributed system"""


def main(smoke: bool = False):
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4)
    lines = ARTICLE.splitlines() * (3 if smoke else 300)
    ctx = StreamingContext(batch_size=64)
    (ctx.from_collection(lines)
        .flat_map(lambda line: [(w, 1) for w in line.split()])
        .key_by(lambda kv: kv[0], parallelism=2)
        .reduce(lambda a, b: (a[0], a[1] + b[1]), parallelism=2)
        .sink())
    results = ctx.submit()
    counts = {k: v[1] for k, v in results}
    ctx.shutdown()
    expected = Counter(w for line in lines for w in line.split())
    assert counts == dict(expected)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
    print("word count top-5:", top)
    return counts


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true")
    try:
        main(p.parse_args().smoke)
    finally:
        ray_tpu_torch.shutdown()
