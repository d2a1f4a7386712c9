#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention forward (K3) on one NVIDIA card.

    python3 k3_variants.py

Each variant is ray_tpu_torch/csrc/flash_attention.cu with a few lines
replaced (the table VARIANTS below), built by nvcc with the port's flags into
a temporary directory and loaded with ctypes beside the others. The script
prints ptxas's registers and spills of flash_fwd_tc_kernel at D 64 and 128
for each, then times every variant at the flagship train shape (B 8,
T = S 2048, H = KH 16, D 64, causal) and at a GQA shape (B 2, T = S 1024,
H 32, KH 4, D 128, causal), in turns: the list forward, then backward.
Variants marked "diagnostic" skip part of the work and give wrong
results; they measure what that part costs. Every other variant's output
must equal the source's bit for bit, or the script fails.
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
_WARPS = "{ return D == 64 ? 8 : 4; }"
_Q_REGS = "tc_q_in_regs() { return D != 64; }"
_BOUNDS = "__launch_bounds__(32 * tc_warps<D>(), TC_MIN_BLOCKS)"
_STAGES = "tc_stages() { return D == 64 ? 3 : 2; }"
# name -> (diagnostic, [(text in the source, its replacement)])
VARIANTS = {
    "source": (False, []),
    "2 stages": (False, [(_STAGES, "tc_stages() { return 2; }")]),
    "3 stages": (False, [(_STAGES, "tc_stages() { return 3; }")]),
    "D 64: 4 warps, 3 blocks/SM": (False, [
        (_WARPS, "{ return 4; }"),
        (_BOUNDS,
         "__launch_bounds__(32 * tc_warps<D>(), D == 64 ? 3 : 2)")]),
    "D 64: Q in registers, 1 block/SM": (False, [
        (_Q_REGS, "tc_q_in_regs() { return true; }"),
        (_BOUNDS,
         "__launch_bounds__(32 * tc_warps<D>(), D == 64 ? 1 : 2)")]),
    "D 128: Q reloaded every tile": (False, [
        (_Q_REGS, "tc_q_in_regs() { return false; }")]),
    "no masking": (True, [
        ("if (k0 + BN > sh.S || (CAUSAL && k0 + BN - 1 > rw)) {",
         "if (false) {")]),
}
SHAPES = {"flagship": (8, 2048, 16, 16, 64), "gqa": (2, 1024, 32, 4, 128)}


def build_all(tmp: Path) -> dict:
    """{name: ctypes library}, one nvcc per variant, all at once."""
    src = SRC.read_text()
    for hdr in build.CSRC.glob("*.cuh"):
        (tmp / hdr.name).write_text(hdr.read_text())
    procs = {}
    for i, (name, (_, subs)) in enumerate(VARIANTS.items()):
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
        regs = []
        for kern, r in sorted(cs.ptxas_report(log).items()):
            if "flash_fwd_tc_kernel" in kern:
                regs.append(f"{r.get('registers')} regs/"
                            f"{r.get('spill_stores')} B spilled")
        print(f"{name}: flash_fwd_tc_kernel {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in attention._FLASH_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def launch(lib, q, k, v, out, lse) -> None:
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    st = (ctypes.c_longlong * 9)(*[x for t in (q, k, v)
                                   for x in t.stride()[:3]])
    err = lib.flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), B, T, S, H, KH,
                            D, st, float(D ** -0.5), 1, 1,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_forward: CUDA error {err}")


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("k3_variants: no CUDA device is available")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        for tag, (B, T, H, KH, D) in SHAPES.items():
            sets = []
            for i in range(4):
                q, k, v, _ = cs.flash_inputs(B, T, H, KH, D, torch.bfloat16,
                                             seed=800 + i)
                sets.append((q, k, v, torch.empty_like(q),
                             torch.empty(B, H, T, device="cuda")))
            flops = 4 * B * H * D * (T * (T + 1) // 2)
            want = [t.clone() for t in attention.flash_forward(
                *sets[0][:3], True)]
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                launch(libs[name], *sets[0])
                same = (torch.equal(sets[0][3], want[0])
                        and torch.equal(sets[0][4], want[1]))
                if not VARIANTS[name][0] and not same:
                    raise AssertionError(f"{name} at {tag}: output differs "
                                         "from the source's")
                times[name].append(cs.device_ms(
                    f"{name} {tag}", lambda *a, lib=libs[name]:
                    launch(lib, *a), sets, 20))
            print(f"{tag} B={B} T=S={T} H={H} KH={KH} D={D} causal bf16 "
                  f"[{card}]:", flush=True)
            for name, ms in times.items():
                kind = " (diagnostic)" if VARIANTS[name][0] else ""
                print(f"  {name}{kind}: {ms[0] * 1e3:.2f}, "
                      f"{ms[1] * 1e3:.2f} us; "
                      f"{flops / min(ms) / 1e9:.1f} TFLOP/s", flush=True)
            del sets
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
