#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernels K3 (forward), K4 (dq)
and K5 (dk/dv) on one NVIDIA card.

    python3 flash_variants.py

Each variant is ray_tpu_torch/csrc/flash_attention.cu with a few lines
replaced (the table VARIANTS below), built by nvcc with the port's flags into
a temporary directory and loaded with ctypes beside the others. The script
prints ptxas's registers and spills of the three tensor-core kernels at
D 64 and 128 (causal) for each, then times the kernel each variant changes
at the flagship train shape (B 8, T = S 2048, H = KH 16, D 64, causal) and
at a GQA shape (B 2, T = S 1024, H 32, KH 4, D 128, causal), in turns: the
list forward, then backward. Every variant's output is checked first:
"same" variants must give the source's bits; "reorder" variants change the
summation order and must stay within attention._flash_grad_bounds of the
plain version; "diagnostic" variants skip part of the work and give wrong
results, and measure what that part costs. A kernel that spills at a
head dim is reported and not timed at that head dim.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from ray_tpu_torch._kernels import build
from ray_tpu_torch.ops import attention

SRC = build.CSRC / "flash_attention.cu"
_K3_BOUNDS = "__launch_bounds__(32 * tc_warps<D>(), TC_MIN_BLOCKS)"
# name -> (kernel it changes, kind, [(text in the source, its replacement)])
VARIANTS = {
    "source": ("all", "same", []),
    # K3
    "K3: 2 stages": ("fwd", "same", [(
        "tc_stages() { return D == 64 ? 3 : 2; }",
        "tc_stages() { return 2; }")]),
    "K3 D 64: 4 warps, 3 blocks/SM": ("fwd", "same", [
        ("tc_warps() { return D == 64 ? 8 : 4; }", "tc_warps() { return 4; }"),
        (_K3_BOUNDS,
         "__launch_bounds__(32 * tc_warps<D>(), D == 64 ? 3 : 2)")]),
    "K3: no masking": ("fwd", "diagnostic", [
        ("if (k0 + BN > sh.S || (CAUSAL && k0 + BN - 1 > rw)) {",
         "if (false) {")]),
    # K4
    "K4: 3 stages": ("dq", "same", [(
        "dq_stages() { return 2; }", "dq_stages() { return 3; }")]),
    "K4 D 64: 64-column chunks": ("dq", "same", [(
        "dq_cols() { return D == 64 ? 32 : 64; }",
        "dq_cols() { return 64; }")]),
    "K4 D 128: 32-column chunks": ("dq", "same", [(
        "dq_cols() { return D == 64 ? 32 : 64; }",
        "dq_cols() { return 32; }")]),
    "K4 D 64: 4 warps, 3 blocks/SM": ("dq", "same", [
        ("dq_warps() { return D == 64 ? 8 : 4; }", "dq_warps() { return 4; }"),
        ("dq_min_blocks() { return 2; }",
         "dq_min_blocks() { return D == 64 ? 3 : 2; }")]),
    "K4: exp by expf": ("dq", "reorder", [(
        "s[j][e] = exp2_approx(fmaf(s[j][e], sl2, -lse2[e >> 1]));",
        "s[j][e] = expf(s[j][e] * sh.scale - lse2[e >> 1] / LOG2E);")]),
    "K4: no masking": ("dq", "diagnostic", [(
        "if (kc + NC > sh.S || (CAUSAL && kc + NC - 1 > rw)) {",
        "if (false) {")]),
    # K5
    "K5: 3 stages": ("dkv", "same", [(
        "dkv_stages() { return 2; }", "dkv_stages() { return 3; }")]),
    "K5: 64-column chunks": ("dkv", "same", [(
        "dkv_cols() { return 32; }", "dkv_cols() { return 64; }")]),
    "K5 D 64: 4 warps, 2 blocks/SM": ("dkv", "same", [(
        "dkv_min_blocks() { return D == 64 ? 3 : 2; }",
        "dkv_min_blocks() { return 2; }")]),
    "K5 D 64: 8 warps, 2 blocks/SM": ("dkv", "same", [
        ("dkv_warps() { return 4; }",
         "dkv_warps() { return D == 64 ? 8 : 4; }"),
        ("dkv_min_blocks() { return D == 64 ? 3 : 2; }",
         "dkv_min_blocks() { return 2; }")]),
    "K5 D 128: 2 warps a block": ("dkv", "same", [(
        "dkv_warps() { return 4; }",
        "dkv_warps() { return D == 64 ? 4 : 2; }")]),
    "K5: no masking": ("dkv", "diagnostic", [(
        "if (qc + NC > sh.T || (CAUSAL && qc < kw + 15)) {",
        "if (false) {")]),
}
SHAPES = {"flagship": (8, 2048, 16, 16, 64), "gqa": (2, 1024, 32, 4, 128)}


def build_all(tmp: Path) -> dict:
    """{name: (ctypes library, {(kernel, D) that spill})}, one nvcc per
    variant, all at once; kernel is "fwd", "dq" or "dkv"."""
    src = SRC.read_text()
    for hdr in build.CSRC.glob("*.cuh"):
        (tmp / hdr.name).write_text(hdr.read_text())
    procs = {}
    for i, (name, (_, _, subs)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {SRC.name}")
            text = text.replace(old, new)
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs, spills = [], set()
        for kern, r in sorted(cs.ptxas_report(log).items()):
            for tc in cs.TC_KERNELS:
                if tc + "ILi" in kern and "ELb1E" in kern:
                    D = int(kern.split(tc + "ILi")[1].split("E")[0])
                    which = tc[6:-10]
                    regs.append(f"{which} D{D} {r.get('registers')} regs/"
                                f"{r.get('spill_stores')} B spilled")
                    if r.get("spill_stores") or r.get("spill_loads"):
                        spills.add((which, D))
        print(f"{name}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in attention._FLASH_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = (lib, spills)
    return libs


def launch(lib, which: str, q, k, v, do, lse, dsum, out) -> None:
    """One bf16 causal launch of K3 (out = (o, lse)), K4 (out = (dq,)) or
    K5 (out = (dk, dv)) from lib."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    strided = (q, k, v) if which == "fwd" else (q, k, v, do)
    st = [x for t in strided for x in t.stride()[:3]]
    st = (ctypes.c_longlong * len(st))(*st)
    ins = [q, k, v] if which == "fwd" else [q, k, v, do, lse, dsum]
    fn = {"fwd": lib.flash_forward, "dq": lib.flash_backward_dq,
          "dkv": lib.flash_backward_dkv}[which]
    err = fn(*[t.data_ptr() for t in ins + list(out)], B, T, S, H, KH, D, st,
             float(D ** -0.5), 1, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{which}: CUDA error {err}")


def outputs(which: str, q, k):
    if which == "fwd":
        B, T, H, _ = q.shape
        return (torch.empty_like(q), torch.empty(B, H, T, device="cuda"))
    return (torch.empty_like(q),) if which == "dq" else (
        torch.empty_like(k), torch.empty_like(k))


def check(name: str, lib, which: str, tag: str, args, want, bounds) -> None:
    kind = VARIANTS[name][1]
    out = outputs(which, args[0], args[1])
    launch(lib, which, *args, out)
    if kind == "same" and not all(torch.equal(g, w)
                                  for g, w in zip(out, want[which])):
        raise AssertionError(f"{name} at {tag}: output differs from the "
                             "source's")
    if kind == "reorder":
        for g, w, b in zip(out, want["ref_" + which], bounds[which]):
            if ((g.float() - w.float()).abs() > b).any():
                raise AssertionError(f"{name} at {tag}: outside the bound")


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("flash_variants: no CUDA device is available")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        src = libs["source"][0]
        for tag, (B, T, H, KH, D) in SHAPES.items():
            sets = []
            for i in range(4):
                q, k, v, do = cs.flash_inputs(B, T, H, KH, D,
                                              torch.bfloat16, seed=800 + i)
                o, lse = attention.flash_forward(q, k, v, True)
                sets.append((q, k, v, do, lse, attention._flash_dsum(o, do)))
            mm = 2 * B * H * D * (T * (T + 1) // 2)
            flops = {"fwd": 2 * mm, "dq": 3 * mm, "dkv": 4 * mm}
            want = {}
            for which in flops:
                out = outputs(which, sets[0][0], sets[0][1])
                launch(src, which, *sets[0], out)
                want[which] = out
            a0 = sets[0][:6] + (True,)
            want["ref_dq"] = (attention._flash_backward_dq_ref(*a0),)
            want["ref_dkv"] = attention._flash_backward_dkv_ref(*a0)
            b = attention._flash_grad_bounds(*a0[:6], want["ref_dq"][0],
                                             *want["ref_dkv"], causal=True)
            bounds = {"dq": b[:1], "dkv": b[1:]}
            del b
            bufs = {w: outputs(w, sets[0][0], sets[0][1]) for w in flops}
            times = {}
            for name in list(libs) + list(libs)[::-1]:
                lib, spills = libs[name]
                kern = VARIANTS[name][0]
                for which in (flops if kern == "all" else [kern]):
                    if (which, D) in spills:
                        continue     # a spilling kernel is not timed
                    if (name, which) not in times:
                        check(name, lib, which, tag, sets[0], want, bounds)
                    times.setdefault((name, which), []).append(cs.device_ms(
                        f"{name} {which} {tag}", lambda *a, lib=lib,
                        w=which: launch(lib, w, *a, bufs[w]), sets, 10))
            print(f"{tag} B={B} T=S={T} H={H} KH={KH} D={D} causal bf16 "
                  f"[{card}]:", flush=True)
            for (name, which), ms in times.items():
                kind = VARIANTS[name][1]
                print(f"  {name} ({kind}) {which}: {ms[0] * 1e3:.2f}, "
                      f"{ms[1] * 1e3:.2f} us; "
                      f"{flops[which] / min(ms) / 1e9:.1f} TFLOP/s",
                      flush=True)
            del sets, want, bounds
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
