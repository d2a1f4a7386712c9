"""Long-running soak workloads
(counterpart: ``scripts/soak.py``; reference: ci/long_running_tests/
workloads/ — many_tasks.py, actor_deaths.py, node_failures.py,
serve_failure.py, pbt.py run for hours against a cluster).

Each workload loops until --duration expires and must hold two invariants:
no error escapes, and per-iteration progress never stalls (an iteration
taking > 20x the trailing median fails the run — the reference's soak
failures are almost always hangs, not crashes).

The workloads, their invariants, the stall rule and the defaults are the
reference's. ``lm_serve`` serves its model on ``--device`` (the card unless
``cpu`` is given), and the workloads that start a cluster put its head's
placement passes there too; the rest are host-only. Two knobs that
``hostile_workload`` sets, ``RAY_TPU_TORCH_CHAOS_KILL_WORKER_EVERY_S`` and
``RAY_TPU_TORCH_OOM_GRACE_S``, are not read by the port's controller yet
(ROADMAP A6c, part 3): its worker killer does not fire, and the OOM guard
keeps its 2 s grace.

Run:  python -m ray_tpu_torch.scripts.soak --workload many_tasks --duration 60
      python -m ray_tpu_torch.scripts.soak --workload lm_serve --duration 60
      python -m ray_tpu_torch.scripts.soak --all --duration 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np


# name -> each iteration's seconds in the workload's last run (read by
# chip_smoke.py for its median).
LAST_TIMES = {}


def _loop(name: str, duration_s: float, body, setup=None, teardown=None):
    """Drive one workload; returns iterations completed."""
    state = setup() if setup else None
    iters = 0
    times = LAST_TIMES[name] = []
    deadline = time.time() + duration_s
    try:
        while time.time() < deadline:
            t0 = time.time()
            body(state, iters)
            dt = time.time() - t0
            times.append(dt)
            iters += 1
            if len(times) >= 8:
                med = statistics.median(times[-50:])
                # Absolute floor 15s: the shared 1-vCPU host exhibits
                # multi-second co-tenant freezes (observed 5-7s with the
                # SAME iteration fast on re-run); a genuine hang trips the
                # body's own 60s get-timeouts or this cap, while scheduler
                # noise doesn't fail the run.
                if dt > max(20 * med, 15.0):
                    raise RuntimeError(
                        f"{name}: iteration {iters} took {dt:.1f}s "
                        f"(median {med:.2f}s) — stall")
    finally:
        if teardown:
            teardown(state)
    rate = iters / max(duration_s, 1e-9)
    print(f"[soak] {name}: {iters} iterations ({rate:.1f}/s), "
          f"median {statistics.median(times):.3f}s" if times else
          f"[soak] {name}: 0 iterations")
    return iters


# --------------------------------------------------------------- workloads

def many_tasks(duration_s: float) -> int:
    """Waves of dependent fan-out (reference workloads/many_tasks.py)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def child(i):
        return i

    @ray_tpu_torch.remote
    def merge(*xs):
        return sum(xs)

    def body(_, i):
        kids = [child.remote(j) for j in range(100)]
        total = ray_tpu_torch.get(merge.remote(*kids), timeout=60)
        assert total == sum(range(100))

    return _loop("many_tasks", duration_s, body)


def actor_deaths(duration_s: float) -> int:
    """Constant actor churn with kills (reference workloads/actor_deaths.py)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class Worker:
        def __init__(self, idx):
            self.idx = idx

        def work(self, x):
            return x + self.idx

    rng = np.random.RandomState(0)

    def setup():
        return {"actors": [Worker.remote(i) for i in range(8)]}

    def body(state, i):
        actors = state["actors"]
        victim = int(rng.randint(len(actors)))
        ray_tpu_torch.kill(actors[victim])
        actors[victim] = Worker.remote(victim)
        # all (incl. the fresh replacement) must answer
        out = ray_tpu_torch.get(
            [a.work.remote(100) for a in actors], timeout=60)
        assert sorted(out) == [100 + j for j in range(len(actors))]

    return _loop("actor_deaths", duration_s, body, setup=setup)


def node_failures(duration_s: float, device=None) -> int:
    """Kill and re-add worker nodes while tasks flow
    (reference workloads/node_failures.py)."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster.testing import Cluster

    @ray_tpu_torch.remote
    def work(i):
        return i * i

    def setup():
        c = Cluster(head_resources={"CPU": 2}, num_workers=1,
                    device=device)
        c.add_node(resources={"CPU": 1}, num_workers=1)
        ray_tpu_torch.init(address=c.address, ignore_reinit_error=True)
        return {"cluster": c}

    def body(state, i):
        c = state["cluster"]
        out = ray_tpu_torch.get([work.remote(j) for j in range(50)], timeout=120)
        assert out == [j * j for j in range(50)]
        if i % 3 == 2:
            # Cycle the non-head node (nodes[0] is the head: killing it
            # would take the GCS down with it).
            c.remove_node(c.nodes[-1])
            c.add_node(resources={"CPU": 1}, num_workers=1)
            c.wait_for_nodes(2, timeout=60)

    def teardown(state):
        ray_tpu_torch.shutdown()
        state["cluster"].shutdown()

    return _loop("node_failures", duration_s, body,
                 setup=setup, teardown=teardown)


def head_failover(duration_s: float, device=None) -> int:
    """Kill the GCS leader mid-workload; a warm standby must take over
    with no lost or doubled work (the head-HA drill). The
    failover happens once, a few iterations in; the remaining duration
    soaks the promoted standby as the new leader."""
    import shutil
    import socket
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.cluster.testing import Cluster

    @ray_tpu_torch.remote
    def work(i):
        return i * i

    def setup():
        # Pre-pick the standby's port so every process in the cluster can
        # be born knowing the fallback address.
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        sport = s.getsockname()[1]
        s.close()
        tmp = tempfile.mkdtemp(prefix="soak_ha_")
        persist = os.path.join(tmp, "gcs_state.bin")
        os.environ["RAY_TPU_TORCH_GCS_ADDRS"] = f"127.0.0.1:{sport}"
        os.environ.setdefault("RAY_TPU_TORCH_GCS_LEASE_TTL_S", "1.5")
        from ray_tpu_torch._private.config import reset_config

        reset_config()  # this driver must also learn the fallback address
        c = Cluster(head_resources={"CPU": 2}, num_workers=1,
                    persist_path=persist, head_with_node=False,
                    device=device)
        c.add_node(resources={"CPU": 2}, num_workers=2)
        c.start_standby(port=sport)
        ray_tpu_torch.init(address=c.address, ignore_reinit_error=True)
        return {"cluster": c, "sport": sport, "tmp": tmp, "failed_over": False}

    def body(state, i):
        out = ray_tpu_torch.get([work.remote(j) for j in range(50)], timeout=120)
        assert out == [j * j for j in range(50)]
        if i == 2 and not state["failed_over"]:
            c = state["cluster"]
            c.kill_head()
            c.wait_for_leader(state["sport"], timeout=30)
            state["failed_over"] = True

    def teardown(state):
        ray_tpu_torch.shutdown()
        state["cluster"].shutdown()
        shutil.rmtree(state["tmp"], ignore_errors=True)
        os.environ.pop("RAY_TPU_TORCH_GCS_ADDRS", None)
        from ray_tpu_torch._private.config import reset_config

        reset_config()

    iters = _loop("head_failover", duration_s, body,
                  setup=setup, teardown=teardown)
    return iters


def hostile_workload(duration_s: float, device=None) -> int:
    """~2% hostile task mix under steady load (the blast-radius drill):
    hangers shot by the deadline killer, crash-loopers quarantined after
    three strikes, allocator bombs shot by the OOM guard, and a random
    worker SIGKILLed every 10s (once the port's controller reads the
    chaos knob; see the module's docstring) — while the healthy majority
    completes with zero loss and the consistency auditor stays clean."""
    import ray_tpu_torch
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.cluster.testing import Cluster
    from ray_tpu_torch.exceptions import (
        TaskPoisonedError, TaskTimeoutError, WorkerCrashedError)

    MB = 1 << 20

    @ray_tpu_torch.remote
    def work(i):
        return i * i

    hang = ray_tpu_torch.remote(chaos.hostile_hang)
    segv = ray_tpu_torch.remote(chaos.hostile_segfault)
    oom = ray_tpu_torch.remote(chaos.hostile_oom)

    def setup():
        c = Cluster(
            head_resources={"CPU": 2, "memory": 2048 * MB}, num_workers=2,
            extra_env={
                # Injected kills: blamed tasks retry but never count a
                # poison strike (cause="chaos"); 10s cadence keeps the
                # odds of 4 consecutive hits on one task negligible.
                "RAY_TPU_TORCH_CHAOS_KILL_WORKER_EVERY_S": "10",
                "RAY_TPU_TORCH_OOM_GRACE_S": "1.0",
            }, device=device)
        ray_tpu_torch.init(address=c.address, ignore_reinit_error=True)
        return {"cluster": c, "poisoned": False, "iters": 0}

    def body(state, i):
        state["iters"] = i + 1
        healthy = [work.remote(j) for j in range(96)]
        h_ref = hang.options(timeout_s=1.5).remote(600.0)
        s_ref = segv.options(max_retries=0).remote()
        o_refs = []
        if i % 3 == 0:
            o_refs.append(oom.options(
                max_retries=0, resources={"memory": 48 * MB}).remote(
                    target_bytes=256 * MB, hold_s=30.0))
        # zero healthy loss, exact results, despite sharing workers with
        # every hostile task above (collateral deaths re-drive for free)
        out = ray_tpu_torch.get(healthy, timeout=120)
        assert out == [j * j for j in range(96)]
        try:
            ray_tpu_torch.get(h_ref, timeout=60)
            raise RuntimeError("hostile hang escaped its deadline")
        except TaskTimeoutError:
            pass
        try:
            ray_tpu_torch.get(s_ref, timeout=60)
            raise RuntimeError("segfaulting task returned a value")
        except (WorkerCrashedError, TaskPoisonedError) as e:
            state["poisoned"] |= isinstance(e, TaskPoisonedError)
        for r in o_refs:
            try:
                ray_tpu_torch.get(r, timeout=90)
                raise RuntimeError("oom bomb escaped the guard")
            except (WorkerCrashedError, TaskPoisonedError):
                pass

    def teardown(state):
        try:
            # Three strikes land within the first three iterations, so any
            # run long enough must have flipped to fail-fast poisoning.
            if state["iters"] >= 5 and not state["poisoned"]:
                raise RuntimeError(
                    "crash-looper was never quarantined "
                    f"({state['iters']} iterations)")
            if state["iters"] >= 2:
                from ray_tpu_torch.cluster.protocol import RpcClient

                time.sleep(2.0)  # let the reaper settle the last kills
                resp = RpcClient(
                    "127.0.0.1", state["cluster"].gcs_port).call(
                        {"type": "run_audit", "verify": True}, timeout=180.0)
                findings = resp.get("findings", [])
                if findings:
                    raise RuntimeError(
                        f"doctor found {len(findings)} inconsistencies "
                        f"after the hostile soak: {findings[:5]}")
        finally:
            ray_tpu_torch.shutdown()
            state["cluster"].shutdown()

    return _loop("hostile_workload", duration_s, body,
                 setup=setup, teardown=teardown)


_DRIVER_SCRIPT = """
import sys
import ray_tpu_torch
ray_tpu_torch.init(address=sys.argv[1])
@ray_tpu_torch.remote
def sq(x):
    return x * x
out = ray_tpu_torch.get([sq.remote(i) for i in range(20)], timeout=60)
assert out == [i * i for i in range(20)], out
ray_tpu_torch.shutdown()
"""


def many_drivers(duration_s: float, device=None) -> int:
    """Short-lived driver processes connect, run work, disconnect — over
    and over against one cluster (reference workloads/many_drivers.py).
    Exercises per-driver state cleanup: leaked refs/exports from dead
    drivers would eventually wedge the GCS."""
    import subprocess
    import sys as _sys

    from ray_tpu_torch.cluster.testing import Cluster, _subprocess_env

    def setup():
        return {"cluster": Cluster(head_resources={"CPU": 2},
                                   num_workers=2, device=device)}

    def body(state, i):
        proc = subprocess.run(
            [_sys.executable, "-c", _DRIVER_SCRIPT,
             state["cluster"].address],
            env=_subprocess_env(), capture_output=True, text=True,
            timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"driver {i} failed rc={proc.returncode}:\n"
                f"{proc.stderr[-2000:]}")

    def teardown(state):
        state["cluster"].shutdown()

    return _loop("many_drivers", duration_s, body,
                 setup=setup, teardown=teardown)


def serve_failure(duration_s: float) -> int:
    """Random replica/master kills under steady query load
    (reference workloads/serve_failure.py)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    rng = np.random.RandomState(0)

    def setup():
        serve.init()
        serve.create_backend("soak:v1", lambda x=None: {"v": x})
        serve.create_endpoint("soak", backend="soak:v1")
        return {"handle": serve.get_handle("soak")}

    def body(state, i):
        h = state["handle"]
        out = ray_tpu_torch.get([h.remote(j) for j in range(20)], timeout=60)
        assert [o["v"] for o in out] == list(range(20))
        if i % 5 == 4:
            # Kill the control plane; max_restarts=-1 + checkpoint restore
            # must bring it back without dropping the endpoint.
            try:
                from ray_tpu_torch.serve.master import MASTER_NAME
                master = ray_tpu_torch.get_actor(MASTER_NAME)
                ray_tpu_torch.kill(master, no_restart=False)
                time.sleep(0.5)
            except Exception:
                pass

    def teardown(state):
        serve.shutdown()

    return _loop("serve_failure", duration_s, body,
                 setup=setup, teardown=teardown)


def lm_params(cfg, device):
    """``lm_serve``'s model weights, random from seed 0."""
    import torch

    from ray_tpu_torch.models import init_params

    return init_params(torch.Generator().manual_seed(0), cfg, device=device)


def lm_serve(duration_s: float, device=None) -> int:
    """The full LM serving stack under sustained mixed load: whole-
    response + streamed + sampled requests against a speculative paged
    engine with prefix caching and chunked prefill — every serving
    feature in one loop, outputs pinned exact each iteration — on
    ``device`` (the card unless "cpu" is given)."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.generate import generate
    from ray_tpu_torch.serve import BackendConfig, LMBackend

    dev = ray_tpu_torch.default_device(device)
    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=64, max_seq_len=128, dtype=torch.float32)
    params = lm_params(cfg, dev)

    def ref(prompt, n):
        return generate(params, torch.tensor([prompt], dtype=torch.int32),
                        cfg, max_new_tokens=n, device=dev)[0].tolist()

    def setup():
        serve.init()
        serve.create_backend(
            "soak:lm", LMBackend, params, cfg,
            paged=True, page_size=16, speculative_k=3, prefill_chunk=32,
            device=dev, config=BackendConfig(max_concurrent_queries=16,
                                 replica_concurrency=4))
        serve.create_endpoint("soak_lm", backend="soak:lm")
        h = serve.get_handle("soak_lm")
        shared = [(i % 50) + 1 for i in range(48)]   # prefix-cache fodder
        return {"handle": h, "shared": shared,
                "refs": {}, "expected": {}}

    def body(state, i):
        h, shared = state["handle"], state["shared"]
        # whole-response batch over a shared prefix (prefix cache +
        # chunked prefill + speculation all engage)
        prompts = [shared + [(i + j) % 50 + 1] for j in range(3)]
        outs = ray_tpu_torch.get(
            [h.remote(p, max_new_tokens=6) for p in prompts], timeout=120)
        for p, out in zip(prompts, outs):
            exp = state["expected"].setdefault(tuple(p), ref(p, 6))
            assert out == exp, (p, out, exp)
        # one streamed request, pinned vs whole-response
        sp = [7, 8, 9, (i % 40) + 1]
        streamed = list(h.stream(sp, max_new_tokens=5))
        exp = state["expected"].setdefault(tuple(sp) + ("s",), ref(sp, 5))
        assert streamed == exp, (sp, streamed, exp)
        # one seeded sampled request, reproducible across iterations
        samp = ray_tpu_torch.get(h.remote([5, 6], max_new_tokens=5,
                                    temperature=0.8, seed=11), timeout=120)
        prev = state["expected"].setdefault("samp", samp)
        assert samp == prev

    def teardown(state):
        serve.shutdown()

    return _loop("lm_serve", duration_s, body,
                 setup=setup, teardown=teardown)


def pbt(duration_s: float) -> int:
    """Repeated short PBT runs (reference workloads/pbt.py)."""
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

    def objective(config):
        x = 0.0
        for i in range(5):
            x += config["lr"]
            tune.report(score=x, training_iteration=i + 1)

    def body(_, i):
        analysis = tune.run(
            objective,
            config={"lr": tune.sample_from(
                lambda _: float(np.random.uniform(0.1, 1.0)))},
            num_samples=4,
            scheduler=PopulationBasedTraining(
                metric="score", mode="max", time_attr="training_iteration",
                perturbation_interval=2,
                hyperparam_mutations={"lr": tune.sample_from(
                    lambda _: float(np.random.uniform(0.1, 1.0)))}),
            local_dir=tempfile.mkdtemp(prefix="soak_pbt_"),
            verbose=0,
        )
        assert len(analysis.trials) == 4

    return _loop("pbt", duration_s, body)


WORKLOADS = {
    "many_tasks": many_tasks,
    "many_drivers": many_drivers,
    "actor_deaths": actor_deaths,
    "node_failures": node_failures,
    "head_failover": head_failover,
    "hostile_workload": hostile_workload,
    "serve_failure": serve_failure,
    "lm_serve": lm_serve,
    "pbt": pbt,
}
# Workloads that own their cluster; a leftover local-mode runtime would
# make their cluster connect a silent no-op.
_STANDALONE = {"node_failures", "head_failover", "many_drivers",
               "hostile_workload"}
# Workloads that take the device: lm_serve's model, and the head's
# placement passes of the clusters the standalone ones start.
_ON_DEVICE = _STANDALONE | {"lm_serve"}


def main(argv=None):
    import ray_tpu_torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", choices=sorted(WORKLOADS))
    p.add_argument("--all", action="store_true")
    p.add_argument("--duration", type=float, default=60.0,
                   help="seconds per workload")
    p.add_argument("--device", default=None,
                   help="lm_serve's model and the clusters' placement: "
                        "cuda (the default) or cpu")
    a = p.parse_args(argv)
    names = sorted(WORKLOADS) if a.all else [a.workload]
    if names == [None]:
        p.error("pass --workload NAME or --all")

    dev = str(ray_tpu_torch.default_device(a.device))
    results = {}
    for name in names:
        if name in _STANDALONE:
            if ray_tpu_torch.is_initialized():
                ray_tpu_torch.shutdown()
        elif not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(num_cpus=4)
        kw = {"device": dev} if name in _ON_DEVICE else {}
        results[name] = WORKLOADS[name](a.duration, **kw)
    print("[soak] all workloads completed:", results)
    return results


if __name__ == "__main__":
    try:
        ok = bool(main())
    finally:
        import ray_tpu_torch

        ray_tpu_torch.shutdown()
    sys.exit(0 if ok else 1)
