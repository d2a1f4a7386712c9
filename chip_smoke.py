#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); imports
nothing of JAX. Phases, each of which makes the script exit non-zero when
it fails:

1. start-up: the card's name and power limit (nvidia-smi), then nvcc builds
   every kernel of both paths from ray_tpu_torch/csrc into
   ray_tpu_torch/_build (one nvcc per source, all at once); ptxas's
   registers and spills of the bf16 flash kernels K3-K5 (tensor cores) at
   D 64 and D 128, where any spill, a missing instantiation or a bf16
   instantiation of the f32 FMA kernels fails the run;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (and GQA, ragged,
   tile-edge, split-edge, long-cache and small-page shapes), in f32 and
   bf16; the bf16 flash gradients against a bound derived from the
   numerics; the split decode kernels K6 and K7 twice on the same inputs
   (the same bits), and K7 against K6 on the same rows (the same bits);
   K1's residual form against PyTorch's add and the plain K1 launch (the
   same bits), and K1's backward against the plain backward and against
   itself on a second launch (the same bits);
3. the serving path at the flagship config's full width (vocab 32000,
   d_model 1024, 8 layers, 16 heads, bf16, 8 slots, max_seq 2048, random
   weights from a seed): one batched LMBackend call of 12 greedy requests,
   one seeded sampled request twice, one streamed request; every launch
   counter is set to 0 just before and read just after, and must show the
   path went through each kernel as often as its structure says (K1 once
   plain and 2L times in its residual form per prefill and per tick);
3b. the paged serving path, LMBackend(paged=True) at the same config (page
   size 128), counters set to 0 before and read after: 16 greedy requests
   sharing a 512-token prefix, on the default pool and on a tight one that
   queues admission, one 1,536-token prompt through chunked prefill, one
   seeded sampled request twice and one streamed request; greedy outputs
   must equal the contiguous engine's, and every decode tick must launch
   exactly 8 paged-decode, 0 decode and 17 RMSNorm kernels (1 plain, 16 in
   the residual form);
3c. speculative serving, LMBackend(speculative_k=4, speculative_ngram=2)
   over each engine at the same config, counters set to 0 before and read
   after: (a) 8 quoting requests (a 96-token passage and its first 32
   tokens again, 64 new tokens), (b) phase 3's 12 greedy requests, (c) a
   seeded sampled request beside 3 greedy ones, the batch twice (equal),
   (d) a stream equal to the same request's whole response, (e) a request
   that ends at exactly max_seq; the paged one also the 16 shared-prefix
   requests, whose prefix pages must keep their bits through every verify
   pass. Every verify pass must launch 17 RMSNorm kernels and no decode
   kernel, every paged tick with no drafts 17 RMSNorm and 8 paged-decode
   kernels. Greedy outputs against the same engines with speculation off:
   each request that differs must differ first where the plain path's
   top-2 logits lie within FLIP_ULPS bf16 ulps;
4. the same weights in f32 on the card and on the CPU, teacher-forced
   through 3 prompts for 16 decode steps and one 5-wide verify chunk,
   through the contiguous and the paged engine: logits within atol 1e-3;
   and in f32 on the card, each engine's greedy tokens with speculation on
   equal to its tokens with it off on phase 3c's traffic (a) and (b);
5. the training path at the same config (bf16 compute, f32 params, AdamW):
   5 train steps at batch 8, seq 2048 on one seeded batch; the counters are
   set to 0 just before and read after every step, which must show 1 plain
   and 2L residual RMSNorm forwards, 2L+1 RMSNorm backwards, 1
   cross-entropy, and L each of the flash forward, dq and dk/dv launches;
   the loss starts within 1.0 of ln(32000) and falls;
6. one f32 train step at full width and depth (batch 1, seq 256) on the
   card and on the CPU from the same weights: the loss, every gradient,
   and the loss after a second step, within stated tolerances;
7. timings (CUDA events) of each kernel, its plain version and the
   PyTorch library call that computes the same function, beside the
   kernel's least possible time on the card (the paged kernel also beside
   the contiguous one and SDPA on the same rows, at a median tick's short
   lengths, ~600 and ~2000 rows, with the number of splits; the flash
   kernels also in f32, at
   a GQA shape, and as TFLOP/s beside SDPA's forward and backward); the
   paged decode tick against the contiguous one; K1's residual form at
   the decode and train rows against x + a then F.rms_norm, K1's backward
   against the plain one and autograd through F.rms_norm, and the host µs
   per K1 call at the decode shape; the train step's device time against
   its wall, and its kernels by name (torch.profiler), K1 and K3-K5 each;
   on phase 3c's traffic (a), speculation on against off for each engine:
   decode tokens/s, tokens per tick, the acceptance rate, and one full
   verify tick's device time and wall beside the plain tick's at the same
   lengths.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch._kernels import build
from ray_tpu_torch.models import (
    TransformerConfig, init_params, make_train_step, named_leaves,
    to_compute,
)
from ray_tpu_torch.models import engine as engine_mod
from ray_tpu_torch.models import paged_engine as paged_mod
from ray_tpu_torch.models import speculative
from ray_tpu_torch.ops import attention, fused, paged_attention
from ray_tpu_torch.serve import LMBackend, ServeRequest

# Flagship config (scripts/model_bench.py's decode benchmark) and engine.
FLAGSHIP = dict(vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16,
                n_kv_heads=16, d_ff=4096, max_seq_len=2048)
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 2048, 32
# The paged engine: the JAX package's default page size; a 512-token shared
# prefix (4 full pages); a pool of 17 pages (the scratch page and one
# max_seq sequence), on which that traffic queues for pages; the chunked
# prefill of one long prompt.
PAGE, PREFIX, TIGHT_PAGES, CHUNK, LONG_PROMPT = 128, 512, 17, 256, 1536
# Speculative serving: 4 drafts from bigram prompt lookup; quoting prompts of
# a 96-token passage and its first 32 tokens again, 64 new tokens.
SPEC_K, SPEC_NGRAM = 4, 2
QUOTE_PASSAGE, QUOTE_REPEAT, QUOTE_NEW = 96, 32, 64
# The train step of scripts/model_bench.py's bench_config: batch 8, seq 2048.
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 2048, 5
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), for the least-time bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
EPS = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


# Every kernel wrapper's launch counter (the wrapper and the attribute it
# counts in), by the kernel's name in the {"kernels": [...]} line. K1 has
# three: its plain forward, its residual form and its backward.
COUNTED = {
    "rms_norm": (fused.rms_norm, "launches"),
    "add_rms_norm": (fused.add_rms_norm, "launches"),
    "rms_norm_backward": (fused.rms_norm, "backward_launches"),
    "decode_attention": (attention.decode_attention, "launches"),
    "softmax_xent": (fused.softmax_cross_entropy, "launches"),
    "flash_forward": (attention.flash_forward, "launches"),
    "flash_backward_dq": (attention.flash_backward_dq, "launches"),
    "flash_backward_dkv": (attention.flash_backward_dkv, "launches"),
    "paged_decode_attention": (paged_attention.paged_decode_attention,
                               "launches"),
}


def reset_counts() -> None:
    for fn, attr in COUNTED.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTED.items()}


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
    # The least atol that would pass beside this rtol: the margin left.
    need = ((got.float() - want.float()).abs()
            - rtol * want.float().abs()).clamp_min(0).max().item()
    log(f"  {name}: max_abs_err {err:.3e}, needs atol {need:.3e} at rtol "
        f"{rtol} (atol {atol}) ok")
    return err


def check_bound(name: str, got: torch.Tensor, want: torch.Tensor,
                bnd: torch.Tensor) -> float:
    """|got - want| <= bnd everywhere, else fail. Prints the largest error,
    the largest ratio of error to bound, and the one-ulp check's reading
    (atol 1e-5, rtol 2^-7): the elements it fails and the most any
    exceeds it by."""
    d = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    ratio = torch.where(d > 0, d / bnd, 0.0).max().item()
    over = d - (1e-5 + 2 ** -7 * want.float().abs())
    n_old = int((over > 0).sum())
    log(f"  {name}: max_abs_err {d.max().item():.3e}, at most "
        f"{ratio:.3f} of the bound; one-ulp check fails {n_old} of "
        f"{d.numel()} by up to {max(over.max().item(), 0.0):.3e}")
    if ratio > 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f} times its bound")
    return d.max().item()


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


def ptxas_report(log_text: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc -Xptxas=-v output."""
    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


TC_KERNELS = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
              "flash_dkv_tc_kernel")   # K3, K4, K5 in bf16


def check_tc_ptxas(log_text: str) -> None:
    """The bf16 K3, K4 and K5 (tensor cores) at D 64 and D 128: registers
    and spills as ptxas reports them; any spill, a missing instantiation,
    or a bf16 instantiation of the FMA kernels fails the run."""
    seen = {kern: set() for kern in TC_KERNELS}
    for name, r in sorted(ptxas_report(log_text).items()):
        if re.search(r"flash_(fwd|dq|dkv)_kernelI13__nv_bfloat16", name):
            raise AssertionError(f"a bf16 FMA flash kernel is built: {name}")
        m = re.search(r"(flash_(?:fwd|dq|dkv)_tc_kernel)ILi(\d+)ELb([01])E",
                      name)
        if not m:
            continue
        D, causal = int(m.group(2)), m.group(3) == "1"
        what = f"{m.group(1)}<D={D}, causal={causal}>"
        log(f"  {what}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads, "
            f"{r.get('stack')} bytes stack")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            raise AssertionError(f"{what} spills: {r}")
        seen[m.group(1)].add(D)
    for kern, ds in seen.items():
        if ds != {64, 128}:
            raise AssertionError(f"ptxas reported no {kern} at D "
                                 f"{sorted({64, 128} - ds)}")


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


def split_edges(B, KH, S, count):
    """count lengths below S at the split edges of the decode kernels' plan
    at B*KH (attention.decode_splits): a length whose last row is the first
    row of a split (a split of one row) or the row before it (the last row
    of the split before), spread over the ones there are."""
    n_split = attention.decode_splits(B * KH)
    edges = set()
    for L in range(1, S):
        plan = attention.split_plan(L, n_split)
        if len(plan) > 1 and plan[-1][0] == L:
            edges |= {L - 1, L}
    edges = sorted(edges)
    return [edges[round(i * (len(edges) - 1) / (count - 1))]
            for i in range(count)]


def check_kernels() -> dict:
    """Each kernel against its plain version on the same CUDA tensors.
    f32: RMSNorm rtol 1e-5 (atol 1e-6 near zero), decode atol 2e-5 — the
    two differ only in summation order. bf16: atol = rtol = 2e-2, since the
    plain versions round intermediates (x*inv; scores and probabilities)
    to bf16 and the kernels do not."""
    errs = {"rms_norm": 0.0}
    log("phase 2: kernels vs plain PyTorch on the card")
    # RMSNorm at the serving rows (a decode tick's 8, the prefill buckets
    # 64 and 2048), the train step's B*T rows, and the [B, T, E] input the
    # train forward passes it, requiring grad; its recorded error is the
    # largest over these shapes in bf16.
    E = FLAGSHIP["d_model"]
    for shape in ((8, E), (64, E), (2048, E), (TRAIN_B * TRAIN_T, E),
                  (TRAIN_B, TRAIN_T, E)):
        rows = math.prod(shape[:-1])
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_inputs(rows, dtype, seed=rows + len(shape) - 2)
            x = x.reshape(shape).requires_grad_(len(shape) == 3)
            tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                f"rms_norm {list(shape)} {str(dtype)[6:]}",
                fused.rms_norm(x, w, EPS).detach(),
                fused._rms_norm_ref(x, w, EPS).detach(), **tol)
            if dtype == torch.bfloat16:
                errs["rms_norm"] = max(errs["rms_norm"], err)
            del x, w
    check_k1_residual_and_backward(errs)
    # Flagship decode shape (G=1, D=64) with lengths at 0, mid-tile, a tile
    # edge and S-1, and at the edges of its splits; a GQA shape (G=8,
    # D=128); a long cache, where many splits are live. Each split launch
    # must give the same bits twice.
    flag_lens = [0, 31, 63, 64, 100, 1000, 2046, 2047]
    for (B, H, KH, D, S, lens), tag in (
            ((8, 16, 16, 64, 2048, flag_lens), "flagship"),
            ((8, 16, 16, 64, 2048, split_edges(8, 16, 2048, 8)),
             "split edges"),
            ((4, 32, 4, 128, 1024, [0, 511, 64, 1023]), "gqa"),
            ((2, 16, 16, 64, 8192, [8191, 5000]), "long cache")):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ln = decode_inputs(B, H, KH, D, S, lens, dtype, seed=D)
            tol = (dict(atol=2e-5, rtol=0.0) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            what = (f"decode_attention {tag} B={B} H={H} KH={KH} D={D} "
                    f"S={S} {str(dtype)[6:]}, "
                    f"{attention.decode_splits(B * KH)} splits")
            got = attention.decode_attention(q, k, v, ln)
            err = check_close(
                what, got, attention._decode_attention_ref(q, k, v, ln),
                **tol)
            if not torch.equal(attention.decode_attention(q, k, v, ln), got):
                raise AssertionError(f"{what}: a second launch differs")
            if tag == "flagship" and dtype == torch.bfloat16:
                errs["decode_attention"] = err
            del q, k, v
    torch.cuda.synchronize()
    return errs


def check_k1_residual_and_backward(errs: dict) -> None:
    """K1's residual form at the shapes of check_kernels: h must be
    PyTorch's x + a and y the plain K1 launch's y on that h, bit for bit
    (y is also held to the plain version as K1 is). K1's backward at a
    decode tick's 8 rows and the train step's B*T, with and without the
    residual's gradient g_h: the same bits on a second launch; against
    the plain backward plus g_h (as autograd added it), dx within f32
    atol = rtol = 1e-5 and, without g_h, bf16 atol = rtol = 2^-7; with
    g_h the bf16 dx within fused._rms_norm_dx_bound (the plain version
    rounds the norm's dx before adding g_h, the kernel rounds once); dw in
    bf16 within 2^-7 and in f32 within fused._rms_norm_dw_bound (over
    16384 rows the plain column sum is itself further than 1e-5 from the
    exact sum). The bounds' derivations are beside the helpers; check_bound
    prints the one-ulp check's reading (atol 1e-5, rtol 2^-7) beside."""
    E = FLAGSHIP["d_model"]
    errs.update(add_rms_norm=0.0, rms_norm_backward=0.0)
    for shape in ((8, E), (64, E), (2048, E), (TRAIN_B * TRAIN_T, E),
                  (TRAIN_B, TRAIN_T, E)):
        rows = math.prod(shape[:-1])
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_inputs(rows, dtype, seed=rows + 7)
            a, _ = rms_inputs(rows, dtype, seed=rows + 8)
            x, a = x.reshape(shape), a.reshape(shape)
            what = f"add_rms_norm {list(shape)} {str(dtype)[6:]}"
            h, y = fused.add_rms_norm(x, a, w, EPS)
            if not torch.equal(h, x + a):
                raise AssertionError(f"{what}: h differs from x + a")
            plain_k1 = fused.rms_norm(h, w, EPS)
            if not torch.equal(y, plain_k1):
                raise AssertionError(f"{what}: y differs from rms_norm(h) "
                                     f"by {max_err(y, plain_k1)}")
            tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(f"{what} y", y, fused._rms_norm_ref(h, w, EPS),
                              **tol)
            if dtype == torch.bfloat16:
                errs["add_rms_norm"] = max(errs["add_rms_norm"], err)
            del x, a, h, y, plain_k1
    log("  add_rms_norm: h == x + a and y == rms_norm(h), bit for bit, at "
        "every shape")
    blocks_of = fused._rms_fn("rms_norm_backward_blocks")
    for rows in (SLOTS, TRAIN_B * TRAIN_T):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            h, w = rms_inputs(rows, dtype, seed=rows + 9)
            gy, _ = rms_inputs(rows, dtype, seed=rows + 10)
            gh, _ = rms_inputs(rows, dtype, seed=rows + 11)
            for g_h in (gh, None):
                what = (f"rms_norm_backward [{rows}, {E}] {str(dtype)[6:]}, "
                        f"{'with' if g_h is not None else 'no'} g_h")
                dx, dw = fused._rms_norm_bwd_cuda(h, w, gy, g_h, EPS)
                dx2, dw2 = fused._rms_norm_bwd_cuda(h, w, gy, g_h, EPS)
                if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                    raise AssertionError(f"{what}: a second launch differs")
                dx_norm, want_dw = fused._rms_norm_bwd(h, w, gy, EPS)
                want_dx = dx_norm if g_h is None else dx_norm + g_h
                tol = (dict(atol=1e-5, rtol=1e-5) if f32
                       else dict(atol=2 ** -7, rtol=2 ** -7))
                if f32 or g_h is None:
                    e_dx = check_close(f"{what} dx", dx, want_dx, **tol)
                else:
                    e_dx = check_bound(f"{what} dx", dx, want_dx,
                                       fused._rms_norm_dx_bound(
                                           dx, want_dx, dx_norm))
                if f32:
                    bnd = fused._rms_norm_dw_bound(h, gy, EPS, want_dw,
                                                   blocks_of(rows))
                    d = (dw - want_dw).abs()
                    ratio = (d / bnd).max().item()
                    over = int((d > 1e-5 + 1e-5 * want_dw.abs()).sum())
                    log(f"  {what} dw: max_abs_err {d.max().item():.3e}, at "
                        f"most {ratio:.3f} of the bound; atol = rtol = 1e-5 "
                        f"fails {over} of {E}")
                    if ratio > 1.0:
                        raise AssertionError(f"{what} dw: error {ratio:.3f} "
                                             f"times its bound")
                else:
                    e_dw = check_close(f"{what} dw", dw, want_dw, **tol)
                    if rows > SLOTS and g_h is not None:
                        errs["rms_norm_backward"] = max(e_dx, e_dw)
            del h, w, gy, gh
    log("  rms_norm_backward: every second launch gives the first's bits")


def paged_inputs(B, H, KH, D, ps, P, lengths, dtype, seed: int):
    """A pool of B * P pages past the scratch page 0, handed to the
    sequences in shuffled order; tables -1 padded past each sequence's
    pages. The last sequence is idle (length 0, a table of -1)."""
    g = cuda_gen(seed)
    num_pages = B * P + 1
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(num_pages, ps, KH, D, generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn(num_pages, ps, KH, D, generator=g,
                     device="cuda").to(dtype)
    ids = np.random.default_rng(seed).permutation(B * P) + 1
    table = np.full((B, P), -1, np.int32)
    for b, L in enumerate(lengths[:-1]):
        used = -(-(L + 1) // ps)
        table[b, :used] = ids[b * P:b * P + used]
    lens = list(lengths[:-1]) + [0]
    return (q, kp, vp, torch.tensor(table, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


PAGED_SHAPES = (   # (tag, B, H, KH, D, page size, P, lengths; last idle)
    ("flagship", SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"],
     FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], PAGE, MAX_SEQ // PAGE,
     [0, 127, 128, 600, 2047, 1000, 64, 0]),
    ("split edges", SLOTS, 16, 16, 64, PAGE, MAX_SEQ // PAGE,
     split_edges(SLOTS, 16, MAX_SEQ, SLOTS - 1) + [0]),
    ("gqa", 5, 32, 4, 128, 64, 16, [0, 63, 500, 1023, 0]),
    ("small page", 4, 8, 2, 64, 16, 16, [80, 127, 250, 0]),
    ("long cache", 3, 16, 16, 64, PAGE, 64, [8191, 5000, 0]),
)


def check_paged_kernel() -> dict:
    """K7 against its plain version on the same CUDA tensors, with shuffled
    physical pages, -1 padded tables and an idle row: f32 atol 2e-5 (the
    two differ only in summation order), bf16 atol = rtol = 2e-2 (the
    plain version rounds scores and probabilities to bf16). And K7 against
    K6 on the same rows gathered into a contiguous cache: equal bit for
    bit, since both split a sequence by K6's plan and walk K6's tiles with
    K6's arithmetic; and to itself on a second launch."""
    errs = {}
    log("phase 2: paged decode kernel vs plain PyTorch on the card")
    for tag, B, H, KH, D, ps, P, lens in PAGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ln = paged_inputs(B, H, KH, D, ps, P, lens,
                                                dtype, seed=D + ps)
            what = (f"paged_decode_attention {tag} B={B} H={H} KH={KH} "
                    f"D={D} ps={ps} P={P} {str(dtype)[6:]}, "
                    f"{attention.decode_splits(B * KH)} splits")
            got = paged_attention.paged_decode_attention(q, kp, vp, table,
                                                         ln)
            if not torch.equal(paged_attention.paged_decode_attention(
                    q, kp, vp, table, ln), got):
                raise AssertionError(f"{what}: a second launch differs")
            tol = (dict(atol=2e-5, rtol=0.0) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                what, got, paged_attention._paged_decode_ref(
                    q, kp, vp, table, ln), **tol)
            k6 = attention.decode_attention(
                q, paged_attention.paged_gather(kp, table).contiguous(),
                paged_attention.paged_gather(vp, table).contiguous(), ln)
            if not torch.equal(got, k6):
                raise AssertionError(
                    f"{what}: differs from K6 on the same rows by "
                    f"{max_err(got, k6):.3e}")
            if tag == "flagship" and dtype == torch.bfloat16:
                errs["paged_decode_attention"] = err
    log("  every paged check equals K6 on the same rows, bit for bit")
    torch.cuda.synchronize()
    return errs


def flash_inputs(B, T, H, KH, D, dtype, seed: int):
    g = cuda_gen(seed)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, T, KH, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, T, KH, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def xent_inputs(N, V, dtype, seed: int):
    g = cuda_gen(seed)
    logits = 3 * torch.randn(N, V, generator=g, device="cuda")
    labels = torch.randint(0, V, (N,), generator=g, device="cuda")
    return logits.to(dtype), labels


FLASH_SHAPES = (   # (tag, B, T = S, H, KH, D, causal)
    ("train", TRAIN_B, TRAIN_T, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"],
     FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], True),
    ("gqa", 2, 1024, 32, 4, 128, True),
    ("ragged", 2, 1000, 8, 2, 64, False),
    ("tile edge", 2, 129, 8, 2, 128, True),
)


def check_train_kernels() -> dict:
    """K2-K5 against their plain versions on the same CUDA tensors.
    K2 (f32 losses of 10-40): atol 1e-4, rtol 1e-5, the two differ in
    summation order and the kernel's online rescaling of the sum. K3-K5 in
    f32: out within atol 1e-5, rtol 1e-5 and lse within 1e-5 (summation
    order; the kernel's softmax is online, the plain one takes the final
    max); dq, dk, dv within atol 1e-4, rtol 1e-4 (sums of up to 2048 x G
    terms in another order). In bf16: lse as in f32 (it is an f32 sum of
    unrounded exponentials in both); out within atol = rtol = 2e-2, since
    the kernel rounds p to bf16 against a running max and the plain version
    against the final one (on an H100 80GB HBM3 at 700 W the largest error
    read 3.9e-3 on |out| up to 3.9, and needed atol 1.2e-3 beside rtol
    2e-2); dq, dk, dv within the bound that
    attention._flash_grad_bounds derives from the numerics (one bf16 ulp of
    the plain result, the f32 sum reordered, the f32 error of p and ds
    before their bf16 rounding, and 16 flipped roundings of p or ds, each
    worth 2^-7 of the row's largest p or ds times the column's largest
    operand; the derivation is beside the helper). The kernels form s and
    dp on the tensor cores in another order than the plain version, so
    roundings of p and ds to bf16 flip and the one-ulp check that held the
    FMA kernels (atol 1e-5, rtol 2^-7) no longer applies; its reading is
    printed for information."""
    errs = {}
    log("phase 2: training kernels vs plain PyTorch on the card")
    for N, V in ((TRAIN_B * TRAIN_T, FLAGSHIP["vocab_size"]), (1000, 32001)):
        logits, labels = xent_inputs(N, V, torch.float32, seed=N)
        err = check_close(f"softmax_xent [{N}, {V}] f32",
                          fused.softmax_cross_entropy(logits, labels),
                          fused._xent_ref(logits, labels), atol=1e-4,
                          rtol=1e-5)
        errs.setdefault("softmax_xent", err)
        del logits, labels
    for tag, B, T, H, KH, D, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            q, k, v, do = flash_inputs(B, T, H, KH, D, dtype, seed=T + D)
            what = (f"{tag} B={B} T=S={T} H={H} KH={KH} D={D} "
                    f"{'causal' if causal else 'full'} {str(dtype)[6:]}")
            out, lse = attention.flash_forward(q, k, v, causal)
            ref_out, ref_lse = attention._flash_forward_ref(q, k, v, causal)
            e_out = check_close(f"flash_forward out {what}", out, ref_out,
                                **(dict(atol=1e-5, rtol=1e-5) if f32
                                   else dict(atol=2e-2, rtol=2e-2)))
            check_close(f"flash_forward lse {what}", lse, ref_lse,
                        atol=1e-5, rtol=1e-6)
            dsum = attention._flash_dsum(ref_out, do)
            args = (q, k, v, do, ref_lse, dsum, causal)
            got = (attention.flash_backward_dq(*args),
                   *attention.flash_backward_dkv(*args))
            want = (attention._flash_backward_dq_ref(*args),
                    *attention._flash_backward_dkv_ref(*args))
            names = [f"flash_backward_dq {what}",
                     f"flash_backward_dkv dk {what}",
                     f"flash_backward_dkv dv {what}"]
            if f32:
                e = [check_close(n, x, w, atol=1e-4, rtol=1e-4)
                     for n, x, w in zip(names, got, want)]
            else:
                bounds = attention._flash_grad_bounds(*args[:6], *want,
                                                      causal=causal)
                e = [check_bound(n, x, w, bd)
                     for n, x, w, bd in zip(names, got, want, bounds)]
                del bounds
            e_dq, e_dkv = e[0], max(e[1:])
            if tag == "train" and not f32:
                errs.update(flash_forward=e_out, flash_backward_dq=e_dq,
                            flash_backward_dkv=e_dkv)
            del q, k, v, do, out, lse, ref_out, ref_lse, dsum, got, want
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


# -------------------------------------------- phase 3: the serving path


def count_delta(before: dict) -> dict:
    return {n: c - before[n] for n, c in read_counts().items()}


class PathProbe:
    """Counts and times the engine's prefills and decode ticks (host clock
    around work that ends in a synchronize), keeps each tick's slot lengths
    so the kernels can be timed on this run's data, and the kernel launches
    of each prefill and each tick."""

    def __init__(self, eng):
        self.prefills, self.ticks = [], []
        self.tick_lengths = []
        self.prefill_launches, self.tick_launches = [], []
        self._prefill, self._decode = eng._prefill_slot, eng._decode_all
        eng._prefill_slot, eng._decode_all = self.prefill, self.decode
        self.eng = eng

    def prefill(self, slot, req):
        T0 = len(req.prompt)
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        done = self._prefill(slot, req)
        torch.cuda.synchronize()
        bucket = min(1 << (T0 - 1).bit_length(), self.eng.max_seq)
        self.prefills.append((bucket, (time.perf_counter() - t0) * 1e3))
        self.prefill_launches.append(count_delta(before))
        return done

    def decode(self):
        active = sum(r is not None for r in self.eng.active)
        self.tick_lengths.append((active, self.eng.lengths.copy()))
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        logits = self._decode()
        torch.cuda.synchronize()
        self.ticks.append((active, (time.perf_counter() - t0) * 1e3))
        self.tick_launches.append(count_delta(before))
        return logits


class PagedProbe(PathProbe):
    """PathProbe for the paged engine: also keeps each tick's page tables,
    the pages two or more active slots read, the pages each active slot
    reads through K7, and how often the page budget refused the queue head
    while a slot was free."""

    def __init__(self, eng):
        super().__init__(eng)
        self.tables, self.shared, self.pages_read = [], [], []
        self.refusals = 0
        self._can_admit = eng._can_admit
        eng._can_admit = self.can_admit

    def can_admit(self, req) -> bool:
        ok = self._can_admit(req)
        if not ok and any(r is None for r in self.eng.active):
            self.refusals += 1
        return ok

    def decode(self):
        eng = self.eng
        self.tables.append(eng._tables.copy())
        live = [s for s, r in enumerate(eng.active) if r is not None]
        pages = [int(pg) for s in live for pg in eng._tables[s] if pg >= 0]
        self.shared.append(len({pg for pg in pages if pages.count(pg) > 1}))
        self.pages_read.append([int(eng.lengths[s]) // eng.page_size + 1
                                for s in live])
        return super().decode()


def stream_all(backend, prompt, n):
    tok = backend.stream_start(prompt, max_new_tokens=n)
    got = []
    for _ in range(10_000):
        r = backend.stream_poll(tok, wait_s=5.0)
        got += r["tokens"]
        if r["done"]:
            return got
    raise AssertionError("stream did not finish")


def serving_prompts(V: int) -> list:
    """Phase 3's 12 greedy prompts, 17-64 tokens (buckets 32 and 64)."""
    rng = np.random.default_rng(SEED)
    lens = [17, 20, 24, 29, 32, 33, 40, 47, 52, 58, 61, 64]
    return [rng.integers(0, V, T0).tolist() for T0 in lens]


def main_path(params, cfg) -> dict:
    log("phase 3: serving path, LMBackend at the flagship config, bf16, "
        "8 slots, max_seq 2048")
    backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        device="cuda")
    V = cfg.vocab_size
    # Warm-up outside the counted run (cuBLAS handles, first launches).
    backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
    probe = PathProbe(backend.engine)

    prompts = serving_prompts(V)
    reset_counts()

    t0 = time.perf_counter()
    outs = backend([ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
                    for p in prompts])
    batch_s = time.perf_counter() - t0
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    s2 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    streamed = stream_all(backend, prompts[0], NEW_TOKENS)

    launches = read_counts()
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
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    log(f"  launches {launches}, expected {want} "
        f"(K1 {2 * L + 1} per prefill and per tick: rms_norm 1, "
        f"add_rms_norm {2 * L}; decode_attention {L} per tick)")
    for name in want:
        if launches[name] == 0 or launches[name] != want[name]:
            raise AssertionError(
                f"{name}: {launches[name]} launches on the main path, "
                f"expected {want[name]}")
    stray = {n: c for n, c in launches.items() if n not in want and c}
    if stray:
        raise AssertionError(f"training kernels ran while serving: {stray}")
    check_launches_each(probe.prefill_launches + probe.tick_launches, L,
                        "prefill or tick")
    return {"launches": launches, "probe": probe, "backend": backend,
            "outs": outs}


def check_launches_each(per_run, L: int, what: str) -> None:
    """Every forward (a prefill, a prefill chunk, a decode tick) launches
    K1 2L + 1 times: once plain, 2L times in its residual form."""
    for i, got in enumerate(per_run):
        n = got["rms_norm"]
        if n == 0 or got["add_rms_norm"] != 2 * L * n:
            raise AssertionError(
                f"{what} {i}: {n} plain and {got['add_rms_norm']} residual "
                f"K1 launches, expected 1 and {2 * L} per forward")


# --------------------------------- phase 3b: the paged serving path


def check_paged_launches(probes, L: int) -> dict:
    """Every paged decode tick launches exactly L paged-decode, 0 decode
    and 2L+1 RMSNorm kernels (1 plain, 2L in the residual form) and
    nothing else; every prefill launches K1 so per forward (once, or once
    per chunk run) and no attention kernel. Returns the totals they add
    up to."""
    per_tick = {n: 0 for n in COUNTED}
    per_tick.update(rms_norm=1, add_rms_norm=2 * L,
                    paged_decode_attention=L)
    total = {n: 0 for n in COUNTED}
    for probe in probes:
        for i, got in enumerate(probe.tick_launches):
            if got != per_tick:
                raise AssertionError(f"paged tick {i}: launches {got}, "
                                     f"expected {per_tick}")
        check_launches_each(probe.prefill_launches, L, "paged prefill")
        for i, got in enumerate(probe.prefill_launches):
            if any(c for n, c in got.items()
                   if n not in ("rms_norm", "add_rms_norm")):
                raise AssertionError(f"paged prefill {i}: launches {got}")
        for got in probe.tick_launches + probe.prefill_launches:
            for n, c in got.items():
                total[n] += c
    return total


def paged_traffic(V: int):
    """Phase 3b's requests: a 512-token prefix, 16 suffix lengths, the 16
    shared-prefix prompts and one long prompt."""
    rng = np.random.default_rng(SEED + 5)
    prefix = rng.integers(0, V, PREFIX).tolist()
    suffixes = rng.permutation(np.arange(8, 201))[:16]
    shared = [prefix + rng.integers(0, V, int(n)).tolist() for n in suffixes]
    long_prompt = rng.integers(0, V, LONG_PROMPT).tolist()
    return prefix, suffixes, shared, long_prompt


def paged_path(params, cfg) -> dict:
    """LMBackend(paged=True) at the flagship config, against LMBackend
    over the contiguous engine on the same requests. The contiguous runs
    come first, outside the counted window."""
    log(f"phase 3b: paged serving path, LMBackend(paged=True) at the "
        f"flagship config, bf16, {SLOTS} slots, max_seq {MAX_SEQ}, page "
        f"size {PAGE}")
    V, L = cfg.vocab_size, cfg.n_layers
    prefix, suffixes, shared, long_prompt = paged_traffic(V)

    def served(backend, prompts, n):
        return backend([ServeRequest((p,), {"max_new_tokens": n})
                        for p in prompts])

    contig = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                       device="cuda")
    contig_probe = PathProbe(contig.engine)
    want_shared = served(contig, shared, NEW_TOKENS)
    want_long = served(LMBackend(params, cfg, max_slots=SLOTS,
                                 max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                 device="cuda"), [long_prompt], 64)[0]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    # (a) 16 greedy requests sharing a 4-page prefix, on the default pool.
    backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        paged=True, page_size=PAGE, device="cuda")
    probe_a = PagedProbe(backend.engine)
    outs = served(backend, shared, NEW_TOKENS)
    # (d) one seeded sampled request twice, one streamed request.
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = backend([ServeRequest((shared[0],), sample_kw)])[0]
    s2 = backend([ServeRequest((shared[0],), sample_kw)])[0]
    streamed = stream_all(backend, shared[1], NEW_TOKENS)
    # (b) the same traffic on a pool that queues admission for pages.
    tight = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                      paged=True, page_size=PAGE, num_pages=TIGHT_PAGES,
                      device="cuda")
    probe_b = PagedProbe(tight.engine)
    outs_tight = served(tight, shared, NEW_TOKENS)
    # (c) one long prompt through chunked prefill.
    chunked = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        paged=True, page_size=PAGE, prefill_chunk=CHUNK,
                        device="cuda")
    probe_c = PagedProbe(chunked.engine)
    out_long = served(chunked, [long_prompt], 64)[0]
    torch.cuda.synchronize()
    launches = read_counts()
    wall_s = time.perf_counter() - t0

    probes = (probe_a, probe_b, probe_c)
    n_tick = sum(len(p.ticks) for p in probes)
    n_pre = sum(len(p.prefills) for p in probes)
    log(f"  (a)-(d) in {wall_s:.3f} s: {n_pre} prefills, {n_tick} paged "
        f"decode ticks")
    if outs != want_shared:
        bad = [i for i, (a, b) in enumerate(zip(outs, want_shared)) if a != b]
        raise AssertionError(f"(a) paged outputs differ from the contiguous "
                             f"engine's for requests {bad}")
    most = max(probe_a.shared)
    if most < PREFIX // PAGE:
        raise AssertionError(f"(a) at most {most} pages were shared between "
                             f"live requests, expected {PREFIX // PAGE}")
    log(f"  (a) 16 greedy requests (prefix {PREFIX} + suffixes "
        f"{int(suffixes.min())}-{int(suffixes.max())} tokens) equal the "
        f"contiguous engine's; up to {most} pages shared by live requests; "
        f"pool {backend.engine.num_pages} pages")
    if outs_tight != want_shared:
        raise AssertionError("(b) tight-pool outputs differ from the "
                             "contiguous engine's")
    if probe_b.refusals == 0:
        raise AssertionError("(b) the page budget never held the queue")
    log(f"  (b) pool of {TIGHT_PAGES} pages: the page budget held the queue "
        f"head {probe_b.refusals} times while a slot was free; at most "
        f"{max(a for a, _ in probe_b.ticks)} requests ran at once; every "
        f"output equals the contiguous engine's")
    if out_long != want_long:
        raise AssertionError("(c) chunked paged prefill output differs from "
                             "the contiguous engine's")
    reads = sorted({n for r in probe_c.pages_read for n in r})
    log(f"  (c) {LONG_PROMPT}-token prompt, prefill_chunk {CHUNK}, 64 new "
        f"tokens: equal to the contiguous engine's; {len(probe_c.prefills)} "
        f"prefill ({probe_c.prefill_launches[0]['rms_norm']} chunks), "
        f"decode ticks read {reads[0]}-{reads[-1]} pages through K7")
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"seeded sampling not reproducible: {s1} {s2}")
    if streamed != outs[1]:
        raise AssertionError(f"stream {streamed} != whole response "
                             f"{outs[1]}")
    log(f"  (d) sampled (T=0.8, seed=42) twice, equal: {s1[:8]}...; "
        f"streamed request equals its whole response")
    total = check_paged_launches(probes, L)
    if total != launches:
        raise AssertionError(f"launches {launches} != the prefills' and "
                             f"ticks' {total}")
    log(f"  launches {launches}: every tick exactly {L} paged_decode, 0 "
        f"decode_attention, 1 rms_norm and {2 * L} add_rms_norm")
    return {"launches": launches, "probe": probe_a, "backend": backend,
            "contig": contig.engine, "contig_probe": contig_probe,
            "want_shared": want_shared}


# ------------------------------ phase 3c: speculative serving, both engines


def ulp_bf16(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


# A greedy token of the speculative path may differ from the plain path's
# only where the plain path's top-2 logits lie within this many bf16 ulps
# of its top logit: one ulp for the two paths' roundings of each logit to
# bf16 (half an ulp each), and one for each bf16 rounding the plain verify
# attention makes and K6 does not (its scores, its probabilities, its
# output), each taken to reach the logit as at most one ulp. A fault in the
# verify (a wrong position, row or mask) moves logits by far more.
FLIP_ULPS = 4


def spec_traffic(V: int) -> dict:
    """Phase 3c's requests: (a) 8 quoting prompts, each a seeded 96-token
    passage followed by its first 32 tokens again (prompt lookup's own
    traffic: extraction and summaries that quote the source); (b) phase
    3's 12 greedy prompts; (e) one prompt whose QUOTE_NEW new tokens end at
    exactly max_seq (the passage of (a)'s first prompt repeated)."""
    rng = np.random.default_rng(SEED + 9)
    quoting = []
    for _ in range(SLOTS):
        passage = rng.integers(0, V, QUOTE_PASSAGE).tolist()
        quoting.append(passage + passage[:QUOTE_REPEAT])
    passage = quoting[0][:QUOTE_PASSAGE]
    boundary = (passage * (MAX_SEQ // QUOTE_PASSAGE + 1))[
        :MAX_SEQ - QUOTE_NEW]
    return {"quoting": quoting, "greedy": serving_prompts(V),
            "boundary": boundary}


class SpecProbe(PathProbe):
    """PathProbe for speculative serving: also wraps the verify pass and
    step(). Per pass (verify or decode): its kind and width, launches,
    chunk, lengths and page tables (for replay). Per tick: the slots
    active, its wall (step() less the prefills inside it), the tokens it
    emitted and its pass. With ``gaps`` it also keeps, for every greedy
    token a decode pass picks, the top-2 gap and top logit of its row,
    by (prompt, index in the output), read after the tick's wall is
    taken."""

    def __init__(self, eng, gaps: bool = False):
        super().__init__(eng)
        self.passes, self.chunks, self.tables, self.steps = [], [], [], []
        self.gaps = {} if gaps else None
        self._pending = None
        self._verify, self._step = eng._verify_all, eng.step
        eng._verify_all, eng.step = self.verify, self.step

    def _tables(self):
        t = getattr(self.eng, "_tables", None)
        return None if t is None else t.copy()

    def verify(self, chunk):
        eng = self.eng
        active = sum(r is not None for r in eng.active)
        self.tick_lengths.append((active, eng.lengths.copy()))
        self.chunks.append(chunk.copy())
        self.tables.append(self._tables())
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        logits = self._verify(chunk)
        torch.cuda.synchronize()
        self.ticks.append((active, (time.perf_counter() - t0) * 1e3))
        self.tick_launches.append(count_delta(before))
        self.passes.append(("verify", chunk.shape[1]))
        return logits

    def decode(self):
        eng = self.eng
        self.chunks.append(eng.tokens[:, None].copy())
        self.tables.append(self._tables())
        logits = super().decode()
        self.passes.append(("decode", 1))
        if self.gaps is not None:
            self._pending = (logits, [
                (s, tuple(r.prompt), len(r.out))
                for s, r in enumerate(eng.active)
                if r is not None and r.temperature == 0])
        return logits

    def step(self):
        n_pre, n_pass = len(self.prefills), len(self.passes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = self._step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if len(self.passes) > n_pass:
            ms -= sum(m for _, m in self.prefills[n_pre:])
            self.steps.append((self.ticks[-1][0], ms,
                               len(events) - (len(self.prefills) - n_pre),
                               len(self.passes) - 1))
        if self._pending is not None:
            logits, rows = self._pending
            self._pending = None
            top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
            for s, key, idx in rows:
                self.gaps[key, idx] = (float(top[s, 0] - top[s, 1]),
                                       float(top[s, 0]))
        return events

    def mark(self) -> int:
        return len(self.steps)


def served(backend, prompts, n, **kw):
    return backend([ServeRequest((p,), dict(max_new_tokens=n, **kw))
                    for p in prompts])


def check_spec_launches(probe, L: int, paged: bool) -> dict:
    """Every verify pass launches K1 2L+1 times (1 plain, 2L residual) and
    no decode kernel; the contiguous engine runs no decode pass; a paged
    pass with no drafts launches K1 2L+1 times and K7 L times; prefills
    launch K1 per forward and no attention kernel. Returns the totals."""
    verify = {n: 0 for n in COUNTED}
    verify.update(rms_norm=1, add_rms_norm=2 * L)
    decode = dict(verify, paged_decode_attention=L)
    total = {n: 0 for n in COUNTED}
    for i, ((kind, width), got) in enumerate(zip(probe.passes,
                                                 probe.tick_launches)):
        if kind == "decode" and not paged:
            raise AssertionError(f"pass {i}: the contiguous engine ran its "
                                 "decode pass with speculation on")
        want = verify if kind == "verify" else decode
        if got != want:
            raise AssertionError(f"{kind} pass {i} (width {width}): "
                                 f"launches {got}, expected {want}")
    check_launches_each(probe.prefill_launches, L, "prefill")
    for got in probe.prefill_launches:
        if any(c for n, c in got.items()
               if n not in ("rms_norm", "add_rms_norm")):
            raise AssertionError(f"speculative prefill launches {got}")
    for got in probe.tick_launches + probe.prefill_launches:
        for n, c in got.items():
            total[n] += c
    return total


def greedy_flips(name, got, want, prompts, gaps) -> list:
    """Greedy requests whose speculative output differs from the plain
    path's; at each first difference the plain path's top-2 gap must be
    under FLIP_ULPS bf16 ulps of its top logit, else the run fails."""
    flips = []
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap, top = gaps.get((tuple(p), j), (math.inf, 0.0))
        bnd = FLIP_ULPS * ulp_bf16(top)
        log(f"  {name}: greedy request (prompt {len(p)}) differs from the "
            f"plain path at token {j}: plain top-2 gap {gap:.6g} at top "
            f"logit {top:.6g}, bound {bnd:.6g} ({FLIP_ULPS} bf16 ulps)")
        if not gap < bnd:
            raise AssertionError(f"{name}: a greedy token differs where the "
                                 f"plain path's top-2 gap {gap} is not under "
                                 f"{bnd}")
        flips.append((len(p), j, gap, bnd))
    return flips


def speculative_path(params, cfg, main: dict, paged: dict) -> dict:
    """Both engines with speculative_k=4 through LMBackend at the flagship
    config, against the same engines with speculation off on the same
    requests. The plain runs come first, outside the counted window."""
    log(f"phase 3c: speculative serving, LMBackend(speculative_k={SPEC_K}, "
        f"speculative_ngram={SPEC_NGRAM}) and LMBackend(paged=True, ...) at "
        f"the flagship config, bf16, {SLOTS} slots, max_seq {MAX_SEQ}, page "
        f"size {PAGE}")
    V, L = cfg.vocab_size, cfg.n_layers
    tr = spec_traffic(V)
    quoting, greedy, boundary = tr["quoting"], tr["greedy"], tr["boundary"]
    prefix, _, shared, _ = paged_traffic(V)
    common = dict(max_slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    spec = dict(speculative_k=SPEC_K, speculative_ngram=SPEC_NGRAM)
    paged_kw = dict(paged=True, page_size=PAGE)

    # The plain paths: every greedy reference, and traffic (a)'s ticks.
    plain = {}
    for name, kw in (("contiguous", {}), ("paged", paged_kw)):
        b = LMBackend(params, cfg, **common, **kw)
        served(b, [[1, 2, 3]], 4)
        pr = SpecProbe(b.engine, gaps=True)
        ref = {"a": served(b, quoting, QUOTE_NEW)}
        seg_a = (0, pr.mark())
        ref["b"] = served(b, greedy, NEW_TOKENS)
        ref["e"] = served(b, [boundary], QUOTE_NEW)
        if kw:
            ref["shared"] = served(b, shared, NEW_TOKENS)
        plain[name] = {"ref": ref, "probe": pr, "seg_a": seg_a,
                       "backend": b}
    for k in ("a", "b", "e"):
        if plain["paged"]["ref"][k] != plain["contiguous"]["ref"][k]:
            raise AssertionError(f"({k}) the plain paged engine's greedy "
                                 "outputs differ from the contiguous one's")
    if plain["paged"]["ref"]["shared"] != paged["want_shared"]:
        raise AssertionError("the plain paged engine's shared-prefix outputs "
                             "differ from phase 3b's")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runs = {}
    for name, kw in (("contiguous", {}), ("paged", paged_kw)):
        b = LMBackend(params, cfg, **common, **spec, **kw)
        pr = SpecProbe(b.engine)
        out = {"a": served(b, quoting, QUOTE_NEW)}
        seg_a = (0, pr.mark())
        stats_a = b.stats()["speculative"]
        out["b"] = served(b, greedy, NEW_TOKENS)
        # (c) a sampled request beside 3 greedy ones, the batch twice.
        mix = [ServeRequest((quoting[0],), {"max_new_tokens": NEW_TOKENS,
                                            "temperature": 0.8,
                                            "seed": 42})] + [
            ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
            for p in quoting[1:4]]
        out["c"] = [b(mix), b(mix)]
        # (d) a whole response alone, then the same request streamed.
        out["d"] = [served(b, [quoting[4]], QUOTE_NEW)[0],
                    stream_all(b, quoting[4], QUOTE_NEW)]
        # (e) a request that ends at exactly max_seq.
        seg_e = pr.mark()
        out["e"] = served(b, [boundary], QUOTE_NEW)
        seg_e = (seg_e, pr.mark())
        if kw:
            # The shared-prefix traffic: its prefix pages (published by the
            # first request's prefill) must hold the same K/V bits after
            # every verify pass of the 16.
            out["shared_first"] = served(b, shared[:1], NEW_TOKENS)
            eng = b.engine
            pages = eng._cached_prefix(eng._prefix_keys(prefix),
                                       promote=False)
            if len(pages) != PREFIX // PAGE:
                raise AssertionError(f"{len(pages)} prefix pages cached, "
                                     f"expected {PREFIX // PAGE}")
            keep = (eng.k_pages[:, pages].clone(),
                    eng.v_pages[:, pages].clone())
            n_pass = len(pr.passes)
            out["shared"] = served(b, shared, NEW_TOKENS)
            same = (torch.equal(eng.k_pages[:, pages], keep[0])
                    and torch.equal(eng.v_pages[:, pages], keep[1]))
            sums = [float(t.float().abs().sum()) for t in keep]
            hit = sum(1 for i in range(n_pass, len(pr.passes))
                      if pr.passes[i][0] == "verify"
                      and sum(int(pg) in pr.tables[i][s]
                              for s in range(SLOTS)
                              for pg in pages[:1]) >= 2)
            log(f"  (shared) 16 requests on a {PREFIX}-token prefix: its "
                f"{len(pages)} pages (checksums |K| {sums[0]:.6g}, |V| "
                f"{sums[1]:.6g}) read by two or more slots in {hit} verify "
                f"passes; bits after those passes equal: {same}")
            if not same:
                raise AssertionError("a verify pass wrote a shared prefix "
                                     "page")
            if hit == 0:
                raise AssertionError("no verify pass ran with the prefix "
                                     "pages shared")
        runs[name] = {"out": out, "probe": pr, "backend": b,
                      "seg_a": seg_a, "seg_e": seg_e, "stats_a": stats_a}
    torch.cuda.synchronize()
    launches = read_counts()
    wall_s = time.perf_counter() - t0

    total = {n: 0 for n in COUNTED}
    for name, run in runs.items():
        pr, out = run["probe"], run["out"]
        got = check_spec_launches(pr, L, name == "paged")
        for n, c in got.items():
            total[n] += c
        kinds = [k for k, _ in pr.passes]
        widths = sorted({w for k, w in pr.passes if k == "verify"})
        log(f"  {name}: {len(pr.prefills)} prefills, {kinds.count('verify')} "
            f"verify passes (widths {widths}), {kinds.count('decode')} "
            f"decode passes; every verify pass {2 * L + 1} K1 (rms_norm 1, "
            f"add_rms_norm {2 * L}), 0 decode_attention, 0 "
            f"paged_decode_attention" + (
                f"; every draft-less tick {2 * L + 1} K1 and {L} "
                f"paged_decode_attention" if name == "paged" else ""))
        for k, n in (("a", QUOTE_NEW), ("b", NEW_TOKENS), ("e", QUOTE_NEW)):
            for o in out[k]:
                if len(o) != n or not all(0 <= t < V for t in o):
                    raise AssertionError(f"{name} ({k}): bad output {o}")
        if len(boundary) + len(out["e"][0]) != MAX_SEQ:
            raise AssertionError(f"{name} (e) does not end at max_seq")
        lo, hi = run["seg_e"]
        tail = [pr.passes[pr.steps[i][3]] for i in range(lo, hi)][-3:]
        log(f"  {name} (e): a {len(boundary)}-token prompt + {QUOTE_NEW} "
            f"new tokens ends at max_seq {MAX_SEQ}; its last ticks ran "
            f"{tail}")
        c1, c2 = out["c"]
        if c1 != c2 or len(c1[0]) != NEW_TOKENS:
            raise AssertionError(f"{name} (c): the batch with a seeded "
                                 f"sampled request differs between runs")
        log(f"  {name} (c): sampled (T=0.8, seed=42) beside 3 greedy, the "
            f"batch twice, equal: {c1[0][:8]}...")
        if out["d"][0] != out["d"][1]:
            raise AssertionError(f"{name} (d): stream {out['d'][1]} != whole "
                                 f"response {out['d'][0]}")
        log(f"  {name} (d): streamed request equals its whole response")
        ref = plain[name]["ref"]
        gaps = plain[name]["probe"].gaps
        flips, n_req = [], 0
        for k, prompts in (("a", quoting), ("b", greedy), ("e", [boundary]),
                           ("shared", shared)):
            if k in out:
                flips += greedy_flips(f"{name} ({k})", out[k], ref[k],
                                      prompts, gaps)
                n_req += len(prompts)
        all_gaps = np.array([g / (FLIP_ULPS * ulp_bf16(t))
                             for g, t in gaps.values()])
        log(f"  {name}: {len(flips)} of {n_req} greedy requests differ from "
            f"the plain path's (bf16; each at a near-tie within "
            f"{FLIP_ULPS} ulps); over the plain path's {len(all_gaps)} "
            f"decode tokens the top-2 gap is under that bound for "
            f"{(all_gaps < 1).mean():.1%}, median {np.median(all_gaps):.2f} "
            f"times it")
        log(f"  {name} stats()['speculative']: "
            f"{run['backend'].stats()['speculative']}; after (a) alone: "
            f"{run['stats_a']}")
        run["flips"], run["n_greedy"] = flips, n_req
    log(f"  phase 3c in {wall_s:.3f} s; launches {launches}")
    if total != launches:
        raise AssertionError(f"launches {launches} != the prefills' and "
                             f"passes' {total}")
    for n in ("rms_norm", "add_rms_norm", "paged_decode_attention"):
        if launches[n] == 0:
            raise AssertionError(f"{n} never launched in phase 3c")
    return {"launches": launches, "runs": runs, "plain": plain}


# ------------------------------------- phase 4: card vs CPU, f32, full width


class _Recorded(engine_mod._Request):
    """A greedy request that keeps the logits its prefill hands pick(), so
    phase 4 reads them through the engine's own _prefill_slot."""
    __slots__ = ("logits",)

    def pick(self, logits_row):
        self.logits = torch.from_numpy(np.array(logits_row))
        return int(np.argmax(logits_row))


def card_vs_cpu(params, engine_cls, what: str, **kw) -> float:
    log(f"phase 4: f32 at full width, card vs CPU, {what}, teacher-forced 3 "
        "prompts x 16 steps (atol 1e-3)")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    cpu_params = to_compute(params, cfg, "cpu")
    engines = [engine_cls(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cuda", **kw),
               engine_cls(cpu_params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cpu", **kw)]
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
            reqs = [_Recorded(slot, p, 17) for _ in engines]
            for e, req in zip(engines, reqs):
                e._prefill_slot(slot, req)
            tok = int(compare(reqs[0].logits, reqs[1].logits,
                              f"prefill {slot}"))
            for e in engines:   # both follow the CPU run's tokens
                e.tokens[slot] = tok
        for step in range(16):
            logits = [e._decode_all() for e in engines]
            nxt = compare(logits[0][:3], logits[1][:3], f"decode {step}")
            for e in engines:
                e.tokens[:3] = nxt.numpy()
                e.lengths[:3] += 1
        # One speculative verify chunk (the current token and SPEC_K seeded
        # drafts) at the lengths the decode steps reached.
        drafts = rng.integers(0, cfg.vocab_size, (SLOTS, SPEC_K))
        chunk = np.concatenate([engines[1].tokens[:, None],
                                drafts.astype(np.int32)], axis=1)
        logits = [e._verify_all(chunk) for e in engines]
        compare(logits[0][:3], logits[1][:3], "verify chunk")
    log(f"  max_abs_err {worst:.3e} over 3 prefills + 16 steps + one "
        f"{SPEC_K + 1}-wide verify chunk; argmax agrees on all {checked} "
        f"decisive rows ({flips} near-ties differ)")
    return worst


def spec_f32_equal(params) -> None:
    """f32 at full width on the card: each engine's greedy tokens with
    speculation on equal its tokens with speculation off, on phase 3c's
    traffic (a) and (b) together."""
    log(f"phase 4: f32 at full width on the card, greedy tokens with "
        f"speculative_k={SPEC_K} vs 0 on traffic (a) + (b), both engines")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    tr = spec_traffic(cfg.vocab_size)
    for name, cls, kw in (
            ("contiguous", engine_mod.GenerationEngine, {}),
            ("paged", paged_mod.PagedGenerationEngine, dict(page_size=PAGE))):
        outs = []
        for k in (0, SPEC_K):
            eng = cls(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                      speculative_k=k, speculative_ngram=SPEC_NGRAM,
                      device="cuda", **kw)
            ids = ([eng.submit(p, QUOTE_NEW) for p in tr["quoting"]]
                   + [eng.submit(p, NEW_TOKENS) for p in tr["greedy"]])
            res = eng.run_until_done()
            outs.append([res[i] for i in ids])
            stats = dict(eng.spec_stats)
            del eng
            torch.cuda.empty_cache()
        diff = [i for i, (a, b) in enumerate(zip(*outs)) if a != b]
        log(f"  {name}: {len(outs[0])} greedy requests, {len(diff)} differ "
            f"(speculative run: {stats})")
        if diff:
            raise AssertionError(f"{name}: f32 speculative greedy tokens "
                                 f"differ from plain ones for requests "
                                 f"{diff}")


# ------------------------------------------------ phase 5: the train path


def train_setup():
    """The flagship in bf16 with f32 params from the seed, its AdamW state
    and one seeded batch of B x (T + 1) tokens, on the card."""
    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = init_params(cuda_gen(SEED), cfg, device="cuda")
    init_opt, train_step = make_train_step(cfg)
    rng = np.random.default_rng(SEED + 2)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1))).to("cuda")}
    return cfg, params, init_opt(params), train_step, batch


def train_path(card: str) -> dict:
    log(f"phase 5: training path, {TRAIN_STEPS} train steps at the flagship "
        f"config, bf16, batch {TRAIN_B}, seq {TRAIN_T}, AdamW")
    cfg, params, opt, train_step, batch = train_setup()
    V, L = cfg.vocab_size, cfg.n_layers
    per_step = {"rms_norm": 1, "add_rms_norm": 2 * L,
                "rms_norm_backward": 2 * L + 1, "softmax_xent": 1,
                "flash_forward": L, "flash_backward_dq": L,
                "flash_backward_dkv": L}
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    seen = read_counts()
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        now = read_counts()
        got = {n: now[n] - seen[n] for n in now}
        seen = now
        want = {n: per_step.get(n, 0) for n in now}
        if got != want:
            raise AssertionError(f"train step {step}: launches {got}, "
                                 f"expected {want}")
        log(f"  step {step}: loss {losses[-1]:.6f}, {walls[-1]:.3f} ms wall, "
            f"launches {got}")
    launches = read_counts()
    ln_v = math.log(V)
    if not (math.isfinite(losses[0]) and abs(losses[0] - ln_v) < 1.0):
        raise AssertionError(f"step-0 loss {losses[0]} is not within 1.0 "
                             f"of ln({V}) = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    step_ms = float(np.median(walls))
    tokens = TRAIN_B * TRAIN_T
    log(f"  losses {losses} (ln {V} = {ln_v:.4f}); launches over the run "
        f"{launches}")
    log(f"  train step: median {step_ms:.3f} ms wall over {TRAIN_STEPS} "
        f"steps (first {walls[0]:.3f} ms), {tokens / step_ms * 1e3:.1f} "
        f"tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "walls": walls}


# ------------------------------ phase 6: train step, card vs CPU, f32


def train_card_vs_cpu() -> dict:
    """One f32 train step at full width and depth (batch 1, seq 256) from
    the same weights on the card and on the CPU. Tolerances: the loss
    within 1e-4; each gradient within 1e-3 of its own largest magnitude
    (cuBLAS and the CPU's BLAS sum in other orders, as do the kernels and
    their plain versions, and the differences compound through 8 layers
    and back); the loss after the first update within 1e-3 (AdamW divides
    by sqrt(v), so entries whose gradient is near 0 move by a visible
    fraction of the learning rate when it rounds differently)."""
    log("phase 6: one f32 train step at full width, batch 1, seq 256, card "
        "vs CPU")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    cpu = init_params(torch.Generator().manual_seed(SEED + 3), cfg,
                      device="cpu")
    gpu = to_compute(cpu, cfg, "cuda")
    tokens = np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, 257))
    init_opt, train_step = make_train_step(cfg)
    runs = []
    for params in (gpu, cpu):
        opt = init_opt(params)
        batch = {"tokens": torch.from_numpy(tokens)}
        t0 = time.perf_counter()
        _, _, loss0 = train_step(params, opt, batch)
        grads = {name: t.grad.float().cpu()
                 for name, t in named_leaves(params).items()}
        _, _, loss1 = train_step(params, opt, batch)
        runs.append((loss0.item(), grads, loss1.item(),
                     time.perf_counter() - t0))
    (g0, ggrads, g1, gs), (c0, cgrads, c1, cs) = runs
    worst = 0.0
    for name, want in cgrads.items():
        got = ggrads[name]
        scale = want.abs().max().item()
        err = max_err(got, want)
        if not torch.isfinite(got).all() or err > 1e-3 * scale:
            raise AssertionError(f"grad {name}: card vs CPU max_abs_err "
                                 f"{err} above 1e-3 x {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    if abs(g0 - c0) > 1e-4 or not math.isfinite(g0):
        raise AssertionError(f"loss card {g0} vs CPU {c0}")
    if abs(g1 - c1) > 1e-3 or not math.isfinite(g1):
        raise AssertionError(f"loss after a step: card {g1} vs CPU {c1}")
    log(f"  loss card {g0:.7f} CPU {c0:.7f} (diff {abs(g0 - c0):.2e}); "
        f"every gradient within {worst:.2e} of its largest magnitude; "
        f"after one update card {g1:.7f} CPU {c1:.7f} (diff "
        f"{abs(g1 - c1):.2e}); two steps {gs:.1f} s on the card, {cs:.1f} "
        f"s on the CPU")
    return {"loss_diff": abs(g0 - c0), "grad_rel_err": worst,
            "loss1_diff": abs(g1 - c1)}


# ----------------------------------------------------- phase 7: timings


def timings(main: dict, card: str) -> dict:
    log(f"phase 7: timings on {card}")
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

    out.update(k1_residual_timings(card))

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
        **bound(k6_bytes, k6_ops, bf16), lens=lens.tolist(),
        shape=f"B={B} H={H} KH={KH} D={D} S={S} bf16, lengths "
              f"{lens.tolist()}, {attention.decode_splits(B * KH)} splits")
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


def host_us(fns: dict, calls: int = 1000, rounds: int = 5) -> dict:
    """Host µs per call of each fn(): calls queued back to back on the CPU
    clock, with no synchronize between them (the launches run behind), in
    rounds that take the fns in turn; the median over rounds of each, so a
    noisy neighbour on the host's cores does not decide a comparison."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def k1_residual_timings(card: str) -> dict:
    """K1's residual form (add_rms_norm) at a decode tick's 8 rows and the
    train step's B*T, against its plain version and against x + a then
    F.rms_norm (two PyTorch calls: no one call computes it, so the
    {"kernels": [...]} line has no library time for it); then, at the
    decode shape under torch.inference_mode as the engines run, the host
    µs per call of rms_norm, add_rms_norm and that pair. The line takes
    the decode shape."""
    E = FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    lib_rms = torch.nn.functional.rms_norm
    out = {}
    for rows, iters in ((SLOTS, 200), (TRAIN_B * TRAIN_T, 50)):
        sets = [rms_inputs(rows, bf16, seed=110 + i)
                + rms_inputs(rows, bf16, seed=150 + i)[:1]
                for i in range(n_copies(4 * rows * E * 2))]
        t = dict(
            ms=device_ms("add_rms_norm kernel", lambda x, w, a:
                         fused.add_rms_norm(x, a, w, EPS), sets, iters),
            plain_ms=device_ms("add_rms_norm plain", lambda x, w, a:
                               fused._add_rms_norm_ref(x, a, w, EPS), sets,
                               iters // 2),
            pair_ms=device_ms("x + a, F.rms_norm", lambda x, w, a:
                              lib_rms(x + a, (E,), w, EPS), sets, iters),
            unfused_ms=device_ms("x + a, rms_norm kernel", lambda x, w, a:
                                 fused.rms_norm(x + a, w, EPS), sets, iters),
            library_ms=None, **bound((4 * rows * E + E) * 2, 5 * rows * E,
                                     bf16),
            shape=f"[{rows}, {E}] bf16")
        log(f"  add_rms_norm at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, x + a then F.rms_norm "
            f"{t['pair_ms'] * 1e3:.2f} us, x + a then the rms_norm kernel "
            f"{t['unfused_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
        if rows == SLOTS:
            out["add_rms_norm"] = t
            x, w, a = sets[0]
            with torch.inference_mode():
                hosts = host_us({
                    "rms_norm": lambda: fused.rms_norm(x, w, EPS),
                    "F.rms_norm": lambda: lib_rms(x, (E,), w, EPS),
                    "add_rms_norm": lambda: fused.add_rms_norm(x, a, w, EPS),
                    "x + a then F.rms_norm": lambda: lib_rms(x + a, (E,), w,
                                                             EPS),
                })
            log("  host us per call at [8, 1024] bf16, 1000 calls queued, "
                "median of 5 rounds in turn, inference mode: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in hosts.items()) + f" [{card}]")
        del sets
    return out


def paged_timings(paged: dict, short_lens: list, card: str) -> dict:
    """The paged decode tick against the contiguous one (wall and device
    time at 8 active slots, on the same lengths), and K7 and K6 at the
    flagship decode shape, at the short lengths of a median contiguous
    tick (short_lens), at ~600 and at ~2000 rows: each beside its bound,
    its plain version, the number of splits, and the library on the same
    rows (K7: the gather + SDPA; K6: SDPA on the contiguous cache with a
    length mask). The {"kernels": [...]} line takes K7 at ~600 rows."""
    log(f"phase 7: paged timings on {card}")
    probe, contig = paged["probe"], paged["contig"]
    eng = paged["backend"].engine
    walls = {}
    for name, pr in (("paged", probe), ("contiguous", paged["contig_probe"])):
        full = [ms for active, ms in pr.ticks if active == SLOTS]
        walls[name] = float(np.median(full))
        log(f"  {name} decode tick at {SLOTS} active slots, the 16 "
            f"shared-prefix requests: median {walls[name]:.3f} ms wall over "
            f"{len(full)} ticks [{card}]")
    full = [i for i, (active, _) in enumerate(probe.ticks) if active == SLOTS]
    mid = full[len(full) // 2]
    lens = probe.tick_lengths[mid][1]
    tokens = eng._device_ints(eng.tokens)
    lengths = eng._device_ints(lens)
    runs = {
        "paged": (paged_mod._paged_decode, (
            eng.params, tokens, lengths,
            eng._device_ints(probe.tables[mid]), eng.k_pages, eng.v_pages,
            eng.cfg)),
        "contiguous": (engine_mod._batched_decode, (
            contig.params, tokens, lengths, contig.cache_k, contig.cache_v,
            contig.cfg)),
    }
    with torch.inference_mode():
        for name, (fn, args) in runs.items():
            dev = min(device_ms(f"{name} decode tick", fn, [args], 2,
                                sleep_cycles=2_000_000_000)
                      for _ in range(3))
            log(f"  {name} decode tick device time {dev:.3f} ms back to "
                f"back at lengths {lens.tolist()} vs {walls[name]:.3f} ms "
                f"wall: card busy {dev / walls[name]:.1%} [{card}]")

    bf16 = torch.bfloat16
    B, H, KH = SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    D = FLAGSHIP["d_model"] // H
    P = MAX_SEQ // PAGE
    n_split = attention.decode_splits(B * KH)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, lens in (("short", list(short_lens)),
                      ("~600", [600 + i for i in range(B)]),
                      ("~2000", [2000 + i for i in range(B)])):
        live = sum(L + 1 for L in lens)
        pages = sum(-(-(L + 1) // PAGE) for L in lens)
        kv_bytes = 2 * live * KH * D * 2 + 2 * B * H * D * 2 + 4 * B
        sets = []
        for i in range(n_copies(2 * live * KH * D * 2)):
            q, kp, vp, table, ln = paged_inputs(B + 1, H, KH, D, PAGE, P,
                                                lens + [0], bf16,
                                                seed=700 + i)
            q, table, ln = q[:B].contiguous(), table[:B], ln[:B]
            kc = paged_attention.paged_gather(kp, table).contiguous()
            vc = paged_attention.paged_gather(vp, table).contiguous()
            mask = (torch.arange(P * PAGE, device="cuda")[None, :]
                    <= ln[:, None].long())[:, None, None, :]
            sets.append((q, kp, vp, table, ln, kc, vc, mask))

        def library(q, kp, vp, table, ln, kc, vc, mask):
            k = paged_attention.paged_gather(kp, table).transpose(1, 2)
            v = paged_attention.paged_gather(vp, table).transpose(1, 2)
            return sdpa(q[:, :, None], k, v, attn_mask=mask)

        t = dict(
            ms=device_ms("paged_decode_attention kernel", lambda *a:
                         paged_attention.paged_decode_attention(*a[:5]),
                         sets, 200),
            plain_ms=device_ms("paged_decode_attention plain", lambda *a:
                               paged_attention._paged_decode_ref(*a[:5]),
                               sets, 40),
            library_ms=device_ms("paged_gather + SDPA", library, sets, 60),
            k6_ms=device_ms("decode_attention on the same rows", lambda *a:
                            attention.decode_attention(a[0], a[5], a[6],
                                                       a[4]), sets, 200),
            k6_library_ms=device_ms(
                "SDPA on the same rows", lambda q, kp, vp, table, ln, kc, vc,
                mask: sdpa(q[:, :, None], kc.transpose(1, 2),
                           vc.transpose(1, 2), attn_mask=mask), sets, 100),
            k6_bound_ms=bound(kv_bytes, 4 * live * H * D, bf16)["bound_ms"],
            **bound(kv_bytes + 4 * pages, 4 * live * H * D, bf16),
            shape=f"B={B} H={H} KH={KH} D={D} ps={PAGE} P={P} bf16, "
                  f"lengths {lens[0]}-{lens[-1]} ({tag}), {n_split} splits")
        log(f"  paged_decode_attention at {t['shape']}: kernel "
            f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
            f"paged_gather + SDPA {t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
        log(f"  decode_attention on the same rows laid out contiguously "
            f"({tag}): kernel {t['k6_ms'] * 1e3:.2f} us, SDPA with a length "
            f"mask {t['k6_library_ms'] * 1e3:.2f} us, bound "
            f"{t['k6_bound_ms'] * 1e3:.3f} us (bytes) [{card}]")
        if tag == "~600":
            out["paged_decode_attention"] = t
        del sets
        torch.cuda.empty_cache()
    return out


def spec_timings(spec: dict, card: str) -> None:
    """Traffic (a) at 8 slots, speculation on against off, each engine:
    decode tokens/s (tokens the ticks emitted over the ticks' wall, step()
    less its prefills), tokens per tick and per slot-tick, the acceptance
    rate, and the device time of one verify tick of full width at 8 active
    slots (its median-wall one, replayed behind a sleep) beside its wall,
    and the plain tick's at the same lengths."""
    log(f"phase 7: speculative timings on {card}, traffic (a): {SLOTS} "
        f"quoting requests x {QUOTE_NEW} tokens")
    for name in ("contiguous", "paged"):
        run, ref = spec["runs"][name], spec["plain"][name]
        rows = {}
        for label, r in (("plain", ref), ("speculative", run)):
            lo, hi = r["seg_a"]
            steps = r["probe"].steps[lo:hi]
            wall = sum(st[1] for st in steps)
            toks = sum(st[2] for st in steps)
            full = [st[1] for st in steps if st[0] == SLOTS]
            rows[label] = dict(ticks=len(steps), tokens=toks, wall_ms=wall,
                               median_ms=float(np.median(full)))
            log(f"  {name} {label}: {toks} tokens in {len(steps)} ticks, "
                f"{wall:.3f} ms of tick wall: {toks / wall * 1e3:.1f} decode "
                f"tokens/s, {toks / len(steps):.3f} tokens a tick, "
                f"{sum(st[2] / st[0] for st in steps) / len(steps):.3f} a "
                f"slot-tick; median tick at {SLOTS} active "
                f"{rows[label]['median_ms']:.3f} ms [{card}]")
        st = run["stats_a"]
        log(f"  {name}: acceptance rate {st['accepted']} / {st['drafted']} = "
            f"{st['accepted'] / max(st['drafted'], 1):.4f}, {st['emitted']} "
            f"tokens emitted by greedy slots in {st['ticks']} ticks [{card}]")
        pr = run["probe"]
        lo, hi = run["seg_a"]
        cands = sorted((s for s in pr.steps[lo:hi] if s[0] == SLOTS
                        and pr.passes[s[3]] == ("verify", SPEC_K + 1)),
                       key=lambda s: s[1])
        if not cands:
            raise AssertionError(f"{name}: no verify tick of width "
                                 f"{SPEC_K + 1} at {SLOTS} active slots")
        _, v_wall, v_toks, i = cands[len(cands) // 2]
        eng = run["backend"].engine
        chunk, lens = pr.chunks[i], pr.tick_lengths[i][1]
        ints = eng._device_ints
        tokens = ints(np.ascontiguousarray(chunk[:, 0]))
        if name == "contiguous":
            verify = (speculative._batched_verify, (
                eng.params, ints(chunk), ints(lens), eng.cache_k,
                eng.cache_v, eng.cfg))
            plain = (engine_mod._batched_decode, (
                eng.params, tokens, ints(lens), eng.cache_k, eng.cache_v,
                eng.cfg))
        else:
            tables = ints(pr.tables[i])
            verify = (paged_mod._paged_verify, (
                eng.params, ints(chunk), ints(lens), tables, eng.k_pages,
                eng.v_pages, eng.cfg))
            plain = (paged_mod._paged_decode, (
                eng.params, tokens, ints(lens), tables, eng.k_pages,
                eng.v_pages, eng.cfg))
        # One tick queued behind the sleep: a verify tick's ~530 launches
        # twice over do not fit in the launch queue, and the host would
        # then wait for the sleep to end.
        with torch.inference_mode():
            dev = {what: min(device_ms(f"{name} {what} tick", fn, [args], 1,
                                       sleep_cycles=2_000_000_000)
                             for _ in range(3))
                   for what, (fn, args) in (("verify", verify),
                                            ("plain", plain))}
        p_wall = rows["plain"]["median_ms"]
        log(f"  {name} verify tick ({SPEC_K + 1} wide, {SLOTS} slots, "
            f"lengths {lens.min()}-{lens.max()}, {v_toks} tokens): device "
            f"{dev['verify']:.3f} ms back to back vs {v_wall:.3f} ms wall, "
            f"card busy {dev['verify'] / v_wall:.1%}; plain tick at the same "
            f"lengths: device {dev['plain']:.3f} ms vs {p_wall:.3f} ms median "
            f"wall, busy {dev['plain'] / p_wall:.1%} [{card}]")
        for what, (fn, args) in (("verify", verify), ("plain", plain)):
            tick_profile(f"{name} {what} tick", fn, args, card)


def tick_profile(what: str, fn, args, card: str) -> None:
    """One call under torch.profiler: its device events and their summed
    time, the kernels that take the most, and the PyTorch ops whose
    kernels do (an op's device time includes the ops inside it)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in avg
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in kern)
    if total == 0:
        log(f"  {what}: torch.profiler recorded no device time")
        return
    log(f"  {what} under torch.profiler: {total:.3f} ms of device time in "
        f"{sum(r[2] for r in kern)} device events [{card}]")
    for name, ms, count in kern[:4]:
        log(f"    {ms:8.3f} ms x{count:<4d} {name[:72]}")
    ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in avg
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda r: -r[1])
    log("    ops: " + ", ".join(f"{k} {ms:.3f} ms x{c}"
                                for k, ms, c in ops[:6]))


def train_timings(card: str) -> dict:
    """K2-K5 at the training path's shapes: the kernel, its plain version
    and the PyTorch call that computes the same function."""
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    N, V, E = TRAIN_B * TRAIN_T, FLAGSHIP["vocab_size"], FLAGSHIP["d_model"]
    sets = [xent_inputs(N, V, f32, seed=400)]
    out["softmax_xent"] = dict(
        ms=device_ms("softmax_xent kernel", fused.softmax_cross_entropy,
                     sets, 20),
        plain_ms=device_ms("softmax_xent plain", fused._xent_ref, sets, 5),
        library_ms=device_ms("F.cross_entropy", lambda x, y:
                             torch.nn.functional.cross_entropy(
                                 x, y, reduction="none"), sets, 20),
        **bound(N * V * 4 + N * 8 + N * 4, 4 * N * V, f32),
        shape=f"[{N}, {V}] f32 logits, int64 labels")
    del sets

    B, T = TRAIN_B, TRAIN_T
    H, KH = FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    D = E // H
    sdpa = torch.nn.functional.scaled_dot_product_attention
    one = B * T * H * D * 2                  # bytes of one q-shaped tensor
    kv = B * T * KH * D * 2
    stat = B * H * T * 4                     # bytes of lse or dsum
    mm = 2 * B * H * D * (T * (T + 1) // 2)  # one causal product's flops
    fsets = []
    for i in range(n_copies(2 * one + 2 * kv)):
        q, k, v, do = flash_inputs(B, T, H, KH, D, bf16, seed=500 + i)
        o, lse = attention.flash_forward(q, k, v, True)
        dsum = attention._flash_dsum(o, do)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True)
        fsets.append((q, k, v, do, lse, dsum, qt, kt, vt, ot,
                      do.transpose(1, 2)))
    lib_bwd = device_ms("SDPA backward", lambda *a: torch.autograd.grad(
        a[9], (a[6], a[7], a[8]), a[10], retain_graph=True), fsets, 10)
    shape = f"B={B} T=S={T} H={H} KH={KH} D={D} causal bf16"
    out["flash_forward"] = dict(
        ms=device_ms("flash_forward kernel", lambda *a:
                     attention.flash_forward(*a[:3], True), fsets, 10),
        plain_ms=device_ms("flash_forward plain", lambda *a:
                           attention._flash_forward_ref(*a[:3], True),
                           fsets, 3),
        library_ms=device_ms("SDPA forward", lambda *a: sdpa(
            *a[6:9], is_causal=True), fsets, 20),
        **bound(2 * one + 2 * kv + stat, 2 * mm, bf16), shape=shape)
    out["flash_backward_dq"] = dict(
        ms=device_ms("flash_backward_dq kernel", lambda *a:
                     attention.flash_backward_dq(*a[:6], True), fsets, 10),
        plain_ms=device_ms("flash_backward_dq plain", lambda *a:
                           attention._flash_backward_dq_ref(*a[:6], True),
                           fsets, 3),
        library_ms=lib_bwd,
        **bound(3 * one + 2 * kv + 2 * stat, 3 * mm, bf16), shape=shape)
    out["flash_backward_dkv"] = dict(
        ms=device_ms("flash_backward_dkv kernel", lambda *a:
                     attention.flash_backward_dkv(*a[:6], True), fsets, 10),
        plain_ms=device_ms("flash_backward_dkv plain", lambda *a:
                           attention._flash_backward_dkv_ref(*a[:6], True),
                           fsets, 3),
        library_ms=lib_bwd,
        **bound(2 * one + 4 * kv + 2 * stat, 4 * mm, bf16), shape=shape)
    del fsets
    torch.cuda.empty_cache()
    for name in ("softmax_xent", "flash_forward", "flash_backward_dq",
                 "flash_backward_dkv"):
        t = out[name]
        log(f"  {name} at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library "
            f"{t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    log("  (the library time of both backward kernels is one SDPA backward, "
        "which computes dq, dk and dv together)")
    k3 = out["flash_forward"]
    log(f"  flash_forward bf16 (tensor cores) at {shape}: "
        f"{2 * mm / k3['ms'] / 1e9:.1f} TFLOP/s, SDPA's forward "
        f"{2 * mm / k3['library_ms'] / 1e9:.1f} TFLOP/s; kernel / SDPA "
        f"{k3['ms'] / k3['library_ms']:.3f}, kernel / bound "
        f"{k3['ms'] / k3['bound_ms']:.3f} [{card}]")
    k4, k5 = out["flash_backward_dq"], out["flash_backward_dkv"]
    log(f"  flash_backward_dq bf16 (tensor cores) at {shape}: "
        f"{3 * mm / k4['ms'] / 1e9:.1f} TFLOP/s, kernel / bound "
        f"{k4['ms'] / k4['bound_ms']:.3f}; flash_backward_dkv "
        f"{4 * mm / k5['ms'] / 1e9:.1f} TFLOP/s, kernel / bound "
        f"{k5['ms'] / k5['bound_ms']:.3f} [{card}]")
    log(f"  K4 + K5 {(k4['ms'] + k5['ms']) * 1e3:.2f} us (bounds "
        f"{(k4['bound_ms'] + k5['bound_ms']) * 1e3:.3f} us) vs SDPA's "
        f"backward {lib_bwd * 1e3:.2f} us "
        f"({7 * mm / lib_bwd / 1e9:.1f} TFLOP/s for its dq, dk, dv): "
        f"K4 + K5 / SDPA {(k4['ms'] + k5['ms']) / lib_bwd:.3f} [{card}]")
    # The f32 routes (FMA loops, no TF32) of K3-K5 at the same shape, and
    # K3-K5 at a GQA shape beside SDPA on k/v repeated to every query head.
    q, k, v, do = flash_inputs(B, T, H, KH, D, f32, seed=510)
    o, lse = attention.flash_forward(q, k, v, True)
    f32_set = [(q, k, v, do, lse, attention._flash_dsum(o, do))]
    f32_ms = device_ms("flash_forward kernel f32", lambda *a:
                       attention.flash_forward(*a[:3], True), f32_set, 3)
    f32_dq = device_ms("flash_backward_dq kernel f32", lambda *a:
                       attention.flash_backward_dq(*a, True), f32_set, 3)
    f32_dkv = device_ms("flash_backward_dkv kernel f32", lambda *a:
                        attention.flash_backward_dkv(*a, True), f32_set, 3)
    log(f"  f32 (FMA loops) at B={B} T=S={T} H={H} KH={KH} D={D} causal: "
        f"flash_forward {f32_ms * 1e3:.2f} us "
        f"({2 * mm / f32_ms / 1e9:.1f} TFLOP/s), flash_backward_dq "
        f"{f32_dq * 1e3:.2f} us, flash_backward_dkv {f32_dkv * 1e3:.2f} us "
        f"[{card}]")
    del q, k, v, do, o, lse, f32_set
    Bg, Tg, Hg, KHg, Dg = 2, 1024, 32, 4, 128
    mm_g = 2 * Bg * Hg * Dg * (Tg * (Tg + 1) // 2)
    one_g, kv_g = Bg * Tg * Hg * Dg * 2, Bg * Tg * KHg * Dg * 2
    stat_g = Bg * Hg * Tg * 4
    gsets = []
    for i in range(4):
        q, k, v, do = flash_inputs(Bg, Tg, Hg, KHg, Dg, bf16, seed=520 + i)
        o, lse = attention.flash_forward(q, k, v, True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (
            q, attention._repeat_kv(k, Hg), attention._repeat_kv(v, Hg)))
        gsets.append((q, k, v, do, lse, attention._flash_dsum(o, do), qt,
                      kt, vt, sdpa(qt, kt, vt, is_causal=True),
                      do.transpose(1, 2)))
    g_ms = device_ms("flash_forward kernel gqa", lambda *a:
                     attention.flash_forward(*a[:3], True), gsets, 20)
    g_lib = device_ms("SDPA forward gqa", lambda *a: sdpa(
        *a[6:9], is_causal=True), gsets, 20)
    b_fwd = bound(2 * one_g + 2 * kv_g + stat_g, 2 * mm_g, bf16)
    log(f"  flash_forward bf16 at B={Bg} T=S={Tg} H={Hg} KH={KHg} D={Dg} "
        f"causal: kernel {g_ms * 1e3:.2f} us "
        f"({2 * mm_g / g_ms / 1e9:.1f} TFLOP/s), SDPA forward on repeated "
        f"k/v {g_lib * 1e3:.2f} us, bound {b_fwd['bound_ms'] * 1e3:.3f} us "
        f"[{card}]")
    g_dq = device_ms("flash_backward_dq kernel gqa", lambda *a:
                     attention.flash_backward_dq(*a[:6], True), gsets, 20)
    g_dkv = device_ms("flash_backward_dkv kernel gqa", lambda *a:
                      attention.flash_backward_dkv(*a[:6], True), gsets, 20)
    g_bwd = device_ms("SDPA backward gqa", lambda *a: torch.autograd.grad(
        a[9], (a[6], a[7], a[8]), a[10], retain_graph=True), gsets, 10)
    b_dq = bound(3 * one_g + 2 * kv_g + 2 * stat_g, 3 * mm_g, bf16)
    b_dkv = bound(2 * one_g + 4 * kv_g + 2 * stat_g, 4 * mm_g, bf16)
    log(f"  at the same GQA shape: flash_backward_dq {g_dq * 1e3:.2f} us "
        f"({3 * mm_g / g_dq / 1e9:.1f} TFLOP/s, bound "
        f"{b_dq['bound_ms'] * 1e3:.3f} us), flash_backward_dkv "
        f"{g_dkv * 1e3:.2f} us ({4 * mm_g / g_dkv / 1e9:.1f} TFLOP/s, "
        f"bound {b_dkv['bound_ms'] * 1e3:.3f} us); SDPA backward on "
        f"repeated k/v {g_bwd * 1e3:.2f} us: K4 + K5 / SDPA "
        f"{(g_dq + g_dkv) / g_bwd:.3f} [{card}]")
    del gsets
    torch.cuda.empty_cache()
    # K1 at the training shape, for the record.
    sets = [rms_inputs(N, bf16, seed=600)]
    k1_ms = device_ms("rms_norm kernel [train]",
                      lambda x, w: fused.rms_norm(x, w, EPS), sets, 50)
    log(f"  rms_norm at [{N}, {E}] bf16: kernel {k1_ms * 1e3:.2f} us, bound "
        f"{bound((2 * N * E + E) * 2, 4 * N * E, bf16)['bound_ms'] * 1e3:.3f}"
        f" us [{card}]")
    out["rms_norm_backward"] = k1_backward_timings(card)
    return out


def k1_backward_timings(card: str) -> dict:
    """K1's backward at the train step's [B*T, d_model] bf16, with the
    residual's gradient g_h (16 of a step's 17 calls) and without; against
    the plain backward plus the add that autograd did, and against
    torch.autograd.grad through F.rms_norm (no g_h: its graph retained,
    its forward outside the clock)."""
    N, E = TRAIN_B * TRAIN_T, FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    h, w = rms_inputs(N, bf16, seed=610)
    gy, gh = rms_inputs(N, bf16, seed=611)[0], rms_inputs(N, bf16, seed=612)[0]
    hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
    yl = torch.nn.functional.rms_norm(hl, (E,), wl, EPS)
    sets = [(h, w, gy, gh)]

    def plain(h, w, gy, gh):
        dx, dw = fused._rms_norm_bwd(h, w, gy, EPS)
        return dx + gh, dw

    t = dict(
        ms=device_ms("rms_norm_backward kernel", lambda h, w, gy, gh:
                     fused._rms_norm_bwd_cuda(h, w, gy, gh, EPS), sets, 50),
        no_gh_ms=device_ms("rms_norm_backward kernel, no g_h",
                           lambda h, w, gy, gh: fused._rms_norm_bwd_cuda(
                               h, w, gy, None, EPS), sets, 50),
        plain_ms=device_ms("rms_norm_backward plain", plain, sets, 10),
        library_ms=device_ms("autograd.grad through F.rms_norm",
                             lambda h, w, gy, gh: torch.autograd.grad(
                                 yl, (hl, wl), gy, retain_graph=True),
                             sets, 20),
        **bound((4 * N * E + 2 * E) * 2, 10 * N * E, bf16),
        shape=f"[{N}, {E}] bf16, with g_h")
    log(f"  rms_norm_backward at [{N}, {E}] bf16: kernel "
        f"{t['ms'] * 1e3:.2f} us with g_h, {t['no_gh_ms'] * 1e3:.2f} us "
        f"without; plain backward + add {t['plain_ms'] * 1e3:.2f} us; "
        f"autograd.grad through F.rms_norm {t['library_ms'] * 1e3:.2f} us; "
        f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    return t


def train_breakdown(card: str, step_ms: float) -> None:
    """Where a flagship train step's device time goes: one step queued
    behind a sleep (device time back to back, against the median wall of
    phase 5) and one step under torch.profiler, its kernels summed by
    name."""
    from torch.profiler import ProfilerActivity, profile

    _, params, opt, train_step, batch = train_setup()
    dev_ms = device_ms("train step", lambda: train_step(params, opt, batch),
                       [()], 2, sleep_cycles=2_000_000_000)
    log(f"  train step device time {dev_ms:.3f} ms back to back vs "
        f"{step_ms:.3f} ms wall: card busy {dev_ms / step_ms:.1%} "
        f"[{card}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(params, opt, batch)
        torch.cuda.synchronize()
    # Device-side events only: a CPU range (an aten op, an autograd node)
    # also reports the device time of the kernels it launched.
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total == 0:
        log("  torch.profiler recorded no device time: kernel breakdown "
            "not measured")
        return
    groups = {"flash attention K3-K5": ("flash_",),
              "RMSNorm K1 (forward, residual form, backward)": ("rms_norm",),
              "cross-entropy K2": ("xent_kernel",),
              "cuBLAS matmuls": ("nvjet", "gemm", "sm90_", "cutlass"),
              "memcpy, memset": ("Memcpy", "Memset")}
    by_group = dict.fromkeys([*groups, "other PyTorch kernels"], 0.0)
    for name, ms, _ in rows:
        hit = [g for g, keys in groups.items()
               if any(k in name for k in keys)]
        by_group[hit[0] if hit else "other PyTorch kernels"] += ms
    log(f"  torch.profiler, one train step: {total:.3f} ms of device time "
        f"in {sum(r[2] for r in rows)} device events [{card}]")
    for group, ms in by_group.items():
        log(f"    {ms:9.3f} ms {ms / total:6.1%}  {group}")
    for tag, key in (("K3 forward", "flash_fwd"), ("K4 dq", "flash_dq"),
                     ("K5 dk/dv", "flash_dkv")):
        ms = sum(r[1] for r in rows if key in r[0])
        log(f"    {ms:9.3f} ms {ms / total:6.1%}    of which {tag}")
    # The device time under K1's autograd nodes (their forwards and
    # backwards, as torch.profiler records them).
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and "RMSNorm" in e.key and e.device_time_total > 0):
            log(f"    {e.device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                f"under {e.key}")
    log("  largest kernels:")
    for name, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {name[:80]}")


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
    check_tc_ptxas(built["flash_attention"]["log"])

    errs = check_kernels()
    errs.update(check_paged_kernel())
    errs.update(check_train_kernels())

    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = init_params(cuda_gen(SEED), cfg, device="cuda")
    main = main_path(params, cfg)
    paged = paged_path(params, cfg)
    spec = speculative_path(params, cfg, main, paged)
    card_vs_cpu(params, engine_mod.GenerationEngine, "contiguous engine")
    card_vs_cpu(params, paged_mod.PagedGenerationEngine, "paged engine",
                page_size=PAGE)
    spec_f32_equal(params)
    train = train_path(card)
    train_card_vs_cpu()
    times = timings(main, card)
    times.update(paged_timings(paged, times["decode_attention"]["lens"],
                               card))
    spec_timings(spec, card)
    times.update(train_timings(card))
    train_breakdown(card, train["step_ms"])

    # (kernel, its source, the TPU kernel it replaces, the path it runs on)
    table = {
        "rms_norm": ("rms_norm.cu", "ray_tpu/ops/fused.py:40", main),
        "add_rms_norm": ("rms_norm.cu", "ray_tpu/ops/fused.py:40", main),
        "rms_norm_backward": ("rms_norm.cu", "ray_tpu/ops/fused.py:77",
                              train),
        "decode_attention": ("decode_attention.cu",
                             "ray_tpu/ops/attention.py:544", main),
        "softmax_xent": ("softmax_xent.cu", "ray_tpu/ops/fused.py:117",
                         train),
        "flash_forward": ("flash_attention.cu",
                          "ray_tpu/ops/attention.py:185", train),
        "flash_backward_dq": ("flash_attention.cu",
                              "ray_tpu/ops/attention.py:371", train),
        "flash_backward_dkv": ("flash_attention.cu",
                               "ray_tpu/ops/attention.py:393", train),
        "paged_decode_attention": ("paged_decode_attention.cu",
                                   "ray_tpu/ops/paged_attention.py:74",
                                   paged),
    }
    kernels = []
    for name, (source, replaces, path) in table.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": path["launches"][name],
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
