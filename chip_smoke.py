#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); imports
nothing of JAX. Phases, each of which makes the script exit non-zero when
it fails:

1. start-up: the card's name and power limit (nvidia-smi), then nvcc builds
   every kernel of the path from ray_tpu_torch/csrc into
   ray_tpu_torch/_build (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, in f32 and bf16;
3. the main path at the flagship config's full width (vocab 32000,
   d_model 1024, 8 layers, 16 heads, bf16, 8 slots, max_seq 2048, random
   weights from a seed): one batched LMBackend call of 12 greedy requests,
   one seeded sampled request twice, one streamed request; every launch
   counter is set to 0 just before and read just after, and must show the
   path went through each kernel as often as its structure says;
4. the same weights in f32 on the card and on the CPU, teacher-forced
   through 3 prompts for 16 decode steps: logits within atol 1e-3;
5. timings (CUDA events) of each kernel, its plain version and the
   PyTorch library call that computes the same function, beside the
   kernel's least possible time on the card.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch._kernels import build
from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.models import engine as engine_mod
from ray_tpu_torch.ops import attention, fused
from ray_tpu_torch.serve import LMBackend, ServeRequest

# Flagship config (scripts/model_bench.py's decode benchmark) and engine.
FLAGSHIP = dict(vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16,
                n_kv_heads=16, d_ff=4096, max_seq_len=2048)
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 2048, 32
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), for the least-time bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
EPS = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                atol: float, rtol: float) -> float:
    err = max_err(got, want)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{name}: {m}")
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}) ok")
    return err


# ------------------------------------------------------------- timing


def device_ms(what: str, fn, arg_sets, iters: int,
              sleep_cycles: int = 1_000_000_000) -> float:
    """Device time per call of fn(*args), args cycling through arg_sets
    (copies that together exceed the 50 MB L2, so each call finds its
    inputs cold, as the serving path does). A sleep kernel first holds
    the stream while the host queues every call, so CUDA events time the
    calls back to back and not the host's launch overhead; if the sleep
    ended before the host finished queueing, the figure is host-bound and
    a line naming ``what`` says so."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    if start.query():
        log(f"  ({what}: the sleep ended before the host queued every "
            "call, so this time is an upper bound set by the host)")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: int, dtype) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the peak
    rate for the inputs' type, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def n_copies(bytes_per_call: int) -> int:
    return max(1, min(64, math.ceil(128e6 / max(bytes_per_call, 1))))


# ------------------------------------------------- phase 2: kernel checks


def rms_inputs(rows: int, dtype, seed: int):
    g = cuda_gen(seed)
    x = torch.randn(rows, FLAGSHIP["d_model"], generator=g, device="cuda")
    w = 1.0 + 0.1 * torch.randn(FLAGSHIP["d_model"], generator=g,
                                device="cuda")
    return x.to(dtype), w.to(dtype)


def decode_inputs(B, H, KH, D, S, lengths, dtype, seed: int):
    g = cuda_gen(seed)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def check_kernels() -> dict:
    """Each kernel against its plain version on the same CUDA tensors.
    f32: RMSNorm rtol 1e-5 (atol 1e-6 near zero), decode atol 2e-5 — the
    two differ only in summation order. bf16: atol = rtol = 2e-2, since the
    plain versions round intermediates (x*inv; scores and probabilities)
    to bf16 and the kernels do not."""
    errs = {}
    log("phase 2: kernels vs plain PyTorch on the card")
    for rows in (8, 64, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_inputs(rows, dtype, seed=rows)
            tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                f"rms_norm [{rows}, 1024] {str(dtype)[6:]}",
                fused.rms_norm(x, w, EPS),
                fused._rms_norm_ref(x, w, EPS), **tol)
            if rows == 8 and dtype == torch.bfloat16:
                errs["rms_norm"] = err
    # Flagship decode shape (G=1, D=64) with lengths at 0, mid-tile, a tile
    # edge and S-1; a GQA shape (G=8, D=128).
    flag_lens = [0, 31, 63, 64, 100, 1000, 2046, 2047]
    for (B, H, KH, D, S, lens), tag in (
            ((8, 16, 16, 64, 2048, flag_lens), "flagship"),
            ((4, 32, 4, 128, 1024, [0, 511, 64, 1023]), "gqa")):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ln = decode_inputs(B, H, KH, D, S, lens, dtype, seed=D)
            tol = (dict(atol=2e-5, rtol=0.0) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                f"decode_attention {tag} B={B} H={H} KH={KH} D={D} S={S} "
                f"{str(dtype)[6:]}",
                attention.decode_attention(q, k, v, ln),
                attention._decode_attention_ref(q, k, v, ln), **tol)
            if tag == "flagship" and dtype == torch.bfloat16:
                errs["decode_attention"] = err
    torch.cuda.synchronize()
    return errs


# ----------------------------------------------- phase 3: the main path


class PathProbe:
    """Counts and times the engine's prefills and decode ticks (host clock
    around work that ends in a synchronize), and keeps each tick's slot
    lengths so the kernels can be timed on this run's data."""

    def __init__(self, eng):
        self.prefills, self.ticks = [], []
        self.tick_lengths = []
        self._prefill, self._decode = eng._prefill_slot, eng._decode_all
        eng._prefill_slot, eng._decode_all = self.prefill, self.decode
        self.eng = eng

    def prefill(self, slot, req):
        T0 = len(req.prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = self._prefill(slot, req)
        torch.cuda.synchronize()
        bucket = min(1 << (T0 - 1).bit_length(), self.eng.max_seq)
        self.prefills.append((bucket, (time.perf_counter() - t0) * 1e3))
        return done

    def decode(self):
        active = sum(r is not None for r in self.eng.active)
        self.tick_lengths.append((active, self.eng.lengths.copy()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = self._decode()
        torch.cuda.synchronize()
        self.ticks.append((active, (time.perf_counter() - t0) * 1e3))
        return logits


def stream_all(backend, prompt, n):
    tok = backend.stream_start(prompt, max_new_tokens=n)
    got = []
    for _ in range(10_000):
        r = backend.stream_poll(tok, wait_s=5.0)
        got += r["tokens"]
        if r["done"]:
            return got
    raise AssertionError("stream did not finish")


def main_path(params, cfg) -> dict:
    log("phase 3: LMBackend at the flagship config, bf16, 8 slots, "
        "max_seq 2048")
    backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        device="cuda")
    V = cfg.vocab_size
    # Warm-up outside the counted run (cuBLAS handles, first launches).
    backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
    probe = PathProbe(backend.engine)

    rng = np.random.default_rng(SEED)
    lens = [17, 20, 24, 29, 32, 33, 40, 47, 52, 58, 61, 64]   # buckets 32, 64
    prompts = [rng.integers(0, V, T0).tolist() for T0 in lens]
    fused.rms_norm.launches = 0
    attention.decode_attention.launches = 0

    t0 = time.perf_counter()
    outs = backend([ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
                    for p in prompts])
    batch_s = time.perf_counter() - t0
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    s2 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    streamed = stream_all(backend, prompts[0], NEW_TOKENS)

    launches = {"rms_norm": fused.rms_norm.launches,
                "decode_attention": attention.decode_attention.launches}
    n_pre, n_tick = len(probe.prefills), len(probe.ticks)
    log(f"  12 greedy requests x {NEW_TOKENS} tokens in {batch_s:.3f} s; "
        f"{n_pre} prefills, {n_tick} decode ticks on the whole path")
    for i, out in enumerate(outs):
        if len(out) != NEW_TOKENS or not all(0 <= t < V for t in out):
            raise AssertionError(f"request {i}: bad output {out}")
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"seeded sampling not reproducible: {s1} {s2}")
    log(f"  sampled (T=0.8, seed=42) twice, equal: {s1[:8]}...")
    if streamed != outs[0]:
        raise AssertionError(
            f"stream {streamed} != whole response {outs[0]}")
    log(f"  streamed request equals its whole response: {streamed[:8]}...")

    L = cfg.n_layers
    want = {"rms_norm": (2 * L + 1) * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    log(f"  launches {launches}, expected {want} "
        f"(rms_norm {2 * L + 1} per prefill and per tick, "
        f"decode_attention {L} per tick)")
    for name in want:
        if launches[name] == 0 or launches[name] != want[name]:
            raise AssertionError(
                f"{name}: {launches[name]} launches on the main path, "
                f"expected {want[name]}")
    return {"launches": launches, "probe": probe, "backend": backend}


# ------------------------------------- phase 4: card vs CPU, f32, full width


def card_vs_cpu(params) -> float:
    log("phase 4: f32 at full width, card vs CPU, teacher-forced 3 prompts "
        "x 16 steps (atol 1e-3)")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    engines = [engine_mod.GenerationEngine(params, cfg, max_slots=SLOTS,
                                           max_seq=MAX_SEQ, device="cuda"),
               engine_mod.GenerationEngine(cpu_params, cfg, max_slots=SLOTS,
                                           max_seq=MAX_SEQ, device="cpu")]
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, T0).tolist()
               for T0 in (17, 40, 64)]
    worst, flips, checked = 0.0, 0, 0

    def compare(gpu_logits, cpu_logits, what):
        nonlocal worst, flips, checked
        g = gpu_logits.float().cpu()
        c = cpu_logits.float()
        err = max_err(g, c)
        worst = max(worst, err)
        if not torch.isfinite(g).all() or err > 1e-3:
            raise AssertionError(f"{what}: card vs CPU max_abs_err {err}")
        top2 = torch.topk(c, 2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 1e-3
        agree = g.argmax(-1) == c.argmax(-1)
        checked += int(decisive.sum())
        if not bool(agree[decisive].all()):
            raise AssertionError(f"{what}: greedy token differs where the "
                                 f"CPU's top-2 margin exceeds 1e-3")
        flips += int((~agree).sum())
        return c.argmax(-1)

    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            T0 = len(p)
            bucket = 1 << (T0 - 1).bit_length()
            padded = np.asarray([p + [0] * (bucket - T0)])
            logits = [engine_mod._prefill_into_slot(
                e.params, e._device_ints(padded), T0, slot, e.cache_k,
                e.cache_v, cfg) for e in engines]
            tok = int(compare(logits[0], logits[1], f"prefill {slot}"))
            for e in engines:
                e.lengths[slot], e.tokens[slot] = T0, tok
        for step in range(16):
            logits = [e._decode_all() for e in engines]
            nxt = compare(logits[0][:3], logits[1][:3], f"decode {step}")
            for e in engines:   # both follow the CPU run's tokens
                e.tokens[:3] = nxt.numpy()
                e.lengths[:3] += 1
    log(f"  max_abs_err {worst:.3e} over 3 prefills + 16 steps; argmax "
        f"agrees on all {checked} decisive rows ({flips} near-ties differ)")
    return worst


# ----------------------------------------------------- phase 5: timings


def timings(main: dict, card: str) -> dict:
    log(f"phase 5: timings on {card}")
    probe = main["probe"]
    out = {}
    by_bucket = {}
    for bucket, ms in probe.prefills:
        by_bucket.setdefault(bucket, []).append(ms)
    for bucket in sorted(by_bucket):
        log(f"  prefill bucket {bucket}: median "
            f"{np.median(by_bucket[bucket]):.3f} ms over "
            f"{len(by_bucket[bucket])} prefills [{card}]")
    full = [ms for active, ms in probe.ticks if active == SLOTS]
    tick_ms = float(np.median(full))
    log(f"  decode tick at {SLOTS} active slots: median {tick_ms:.3f} ms "
        f"over {len(full)} ticks, {SLOTS / tick_ms * 1e3:.1f} tokens/s "
        f"[{card}]")
    # The same tick's device time, its ~400 launches queued back to back
    # behind a ~1 s sleep: the gap to the wall time is the card's idle
    # share, time the host spends issuing eager PyTorch ops.
    eng = main["backend"].engine
    mid = [lens for active, lens in probe.tick_lengths if active == SLOTS]
    args = (eng.params, eng._device_ints(eng.tokens),
            eng._device_ints(mid[len(mid) // 2]), eng.cache_k, eng.cache_v,
            eng.cfg)
    with torch.inference_mode():
        dev_ms = min(device_ms("decode tick", engine_mod._batched_decode,
                               [args], 2, sleep_cycles=2_000_000_000)
                     for _ in range(3))
    log(f"  decode tick device time {dev_ms:.3f} ms back to back vs "
        f"{tick_ms:.3f} ms wall: card busy {dev_ms / tick_ms:.1%}, idle "
        f"{1 - dev_ms / tick_ms:.1%} of the tick [{card}]")

    E = FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    # K1 at the decode shape: 8 rows of d_model, bf16 (the path's most
    # frequent launch).
    rows = SLOTS
    sets = [rms_inputs(rows, bf16, seed=100 + i)
            for i in range(n_copies(2 * rows * E * 2))]
    k1_bytes = (2 * rows * E + E) * 2
    k1_ops = 4 * rows * E
    lib_rms = getattr(torch.nn.functional, "rms_norm", None)
    out["rms_norm"] = dict(
        ms=device_ms("rms_norm kernel",
                     lambda x, w: fused.rms_norm(x, w, EPS), sets, 200),
        plain_ms=device_ms("rms_norm plain",
                           lambda x, w: fused._rms_norm_ref(x, w, EPS), sets,
                           100),
        library_ms=(device_ms("F.rms_norm",
                              lambda x, w: lib_rms(x, (E,), w, EPS), sets,
                              200) if lib_rms is not None else None),
        **bound(k1_bytes, k1_ops, bf16),
        shape=f"[{rows}, {E}] bf16")

    # K6 at the flagship decode shape with the lengths of a median
    # full-slot tick of this run.
    full_lens = [lens for active, lens in probe.tick_lengths
                 if active == SLOTS]
    lens = full_lens[len(full_lens) // 2]
    B, H, KH, D, S = SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"], \
        E // FLAGSHIP["n_heads"], MAX_SEQ
    live = int((lens.astype(np.int64) + 1).sum())
    k6_bytes = 2 * live * KH * D * 2 + 2 * B * H * D * 2 + 4 * B
    k6_ops = 4 * live * H * D
    sets = []
    for i in range(n_copies(2 * live * KH * D * 2)):
        q, k, v, ln = decode_inputs(B, H, KH, D, S, lens.tolist(), bf16,
                                    seed=200 + i)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= ln[:, None].long())[:, None, None, :]
        sets.append((q, k, v, ln, mask))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["decode_attention"] = dict(
        ms=device_ms("decode_attention kernel", lambda q, k, v, ln, m:
                     attention.decode_attention(q, k, v, ln), sets,
                     200),
        # Fewer calls: each is ~20 launches, and every launch has to fit in
        # the queue behind the sleep for the time to be the device's.
        plain_ms=device_ms("decode_attention plain", lambda q, k, v, ln, m:
                           attention._decode_attention_ref(q, k, v, ln),
                           sets, 40),
        library_ms=device_ms("SDPA", lambda q, k, v, ln, m: sdpa(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m), sets, 100),
        **bound(k6_bytes, k6_ops, bf16),
        shape=f"B={B} H={H} KH={KH} D={D} S={S} bf16, lengths "
              f"{lens.tolist()}")
    for name, t in out.items():
        lib = ("n/a" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us")
        log(f"  {name} at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    # The prefill shape of K1, for the record.
    sets = [rms_inputs(64, bf16, seed=300 + i)
            for i in range(n_copies(2 * 64 * E * 2))]
    prefill_ms = device_ms("rms_norm kernel [64]",
                           lambda x, w: fused.rms_norm(x, w, EPS), sets, 200)
    log(f"  rms_norm at [64, {E}] bf16: kernel {prefill_ms * 1e3:.2f} us "
        f"[{card}]")
    return out


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this script "
                 "drives the port on an NVIDIA card")
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 1: built {len(built)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(ptxas))

    errs = check_kernels()

    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = init_params(cuda_gen(SEED), cfg, device="cuda")
    main = main_path(params, cfg)
    card_vs_cpu(params)
    times = timings(main, card)

    replaces = {"rms_norm": "ray_tpu/ops/fused.py:40",
                "decode_attention": "ray_tpu/ops/attention.py:544"}
    kernels = []
    for name in ("rms_norm", "decode_attention"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": main["launches"][name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
