#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernels K3 (forward), K4 (dq)
and K5 (dk/dv), of the split flash-decode kernels K6 and K7, and of the
RMSNorm kernels K1 (forward, residual form, backward), on one NVIDIA card.

    python3 flash_variants.py        # K1, then K6/K7, then K3-K5
    python3 flash_variants.py rms    # K1 only

K1 first: each RMS_VARIANTS entry is ray_tpu_torch/csrc/rms_norm.cu with a
constant replaced (rows a block or a warp for the forward, whether a row
stays in registers between its two passes; the number of blocks the
backward cuts the rows into; a diagnostic without the dw pass); each is
checked against
the source (the forward's bits; the backward's dx bits and its dw within
bf16 atol = rtol = 2^-7 of the plain version) and timed at 8, 64 and 16384
rows of the flagship's d_model in bf16, in turns.

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

Then the decode kernels: each DECODE_VARIANTS entry is
ray_tpu_torch/csrc/decode_tile.cuh (K6's and K7's shared block body) with
a few lines replaced, built with both kernels' sources; each is launched
with the number of splits the wrappers take (attention.decode_splits) and
the source also with each of DECODE_SPLITS (1 is the sequential walk of
one block per sequence and kv head), at the flagship decode shape (B 8,
H = KH 16, D 64, bf16, page 128) with lengths of a short tick, ~600 and
~2000 rows, and at a GQA shape (B 4, H 32, KH 4, D 128, page 64, ~1000
rows), K6 and K7 in turns. Before it is timed, each variant must give the
source's bits at the same number of splits, each number of splits must
hold the plain version to the bf16 tolerance (atol = rtol = 2e-2), and K7
must give K6's bits.
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
from ray_tpu_torch.ops import attention, fused, paged_attention

SRC = build.CSRC / "flash_attention.cu"
RMS_SRC = build.CSRC / "rms_norm.cu"
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


# ------------------------------------------------- decode kernels K6, K7

DECODE_TILE = build.CSRC / "decode_tile.cuh"
_L2_256 = """namespace decode_tile {
__device__ __forceinline__ void cp_async_16_l2(void* dst, const void* src,
                                               bool) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\\n" ::
               "r"(tc_tile::smem_addr(dst)), "l"(src) : "memory");
}
"""
# name -> (kind, [(text in decode_tile.cuh or a decode source, its
# replacement)]): "same" variants must give the source's bits;
# "diagnostic" ones skip or move work, give wrong results, and measure
# what that work costs.
DECODE_VARIANTS = {
    "source": ("same", []),
    "1 stage (no cp.async prefetch)": ("same", [(
        "constexpr int STAGES = 2;", "constexpr int STAGES = 1;")]),
    "3 stages": ("same", [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")]),
    "L2 prefetch of 256 B a copy": ("same", [
        ("namespace decode_tile {", _L2_256),
        ("tc_tile::cp_async_16(k_s", "cp_async_16_l2(k_s"),
        ("tc_tile::cp_async_16(v_s", "cp_async_16_l2(v_s")]),
    "tile copies only (no score or PV arithmetic)": ("diagnostic", [
        ("for (int e = tid; e < G * TK; e += THREADS) {",
         "for (int e = tid; e < 0; e += THREADS) {"),
        ("for (int j = 0; j < n; ++j) a += ",
         "for (int j = 0; j < 0; ++j) a += ")]),
    # K6 reads the same bytes as if the cache were [B, KH, S, D]: a kv
    # head's rows lie together, not 128-byte pieces 2 KB apart.
    "K6 reads the cache as [B, KH, S, D]": ("diagnostic", [
        ("k + (size_t)b * k_sb + (size_t)kh * D,",
         "k + (size_t)b * k_sb + (size_t)kh * D * S,"),
        ("v + (size_t)b * v_sb + (size_t)kh * D,",
         "v + (size_t)b * v_sb + (size_t)kh * D * S,"),
        ("ContiguousRows{k_ss, v_ss}", "ContiguousRows{D, D}")]),
}
DECODE_SOURCES = ("decode_attention", "paged_decode_attention")
DECODE_SPLITS = (1, 2, 3, 4, 5, 6, 8, 16)
# tag -> (B, H, KH, D, page size, max pages, lengths)
DECODE_SHAPES = {
    "short": (8, 16, 16, 64, 128, 16, [32 + 4 * i for i in range(8)]),
    "~600": (8, 16, 16, 64, 128, 16, [600 + i for i in range(8)]),
    "~2000": (8, 16, 16, 64, 128, 16, [2000 + i for i in range(8)]),
    "gqa ~1000": (4, 32, 4, 128, 64, 16, [1000, 1008, 1016, 1023]),
}


def build_decode(tmp: Path) -> dict:
    """{name: (K6 library, K7 library)}, one nvcc per source and variant,
    all at once."""
    files = [DECODE_TILE.name] + [f"{src}.cu" for src in DECODE_SOURCES]
    procs = {}
    for i, (name, (_, subs)) in enumerate(DECODE_VARIANTS.items()):
        texts = {f: (build.CSRC / f).read_text() for f in files}
        for old, new in subs:
            if not any(old in t for t in texts.values()):
                raise SystemExit(f"{name}: {old!r} is in no decode source")
            texts = {f: t.replace(old, new) for f, t in texts.items()}
        d = tmp / f"decode{i}"
        d.mkdir()
        for hdr in build.CSRC.glob("*.cuh"):
            (d / hdr.name).write_text(texts.get(hdr.name, hdr.read_text()))
        for src in DECODE_SOURCES:
            (d / f"{src}.cu").write_text(texts[f"{src}.cu"])
            procs[name, src] = (subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(d / f"{src}.so"), str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                d / f"{src}.so")
    libs = {}
    sigs = {"decode_attention": attention._SIGNATURES,
            "paged_decode_attention": paged_attention._SIGNATURES}
    for (name, src), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {src}:\n{log}")
        regs = [f"{r.get('registers')} regs/{r.get('spill_stores')} B "
                "spilled" for _, r in sorted(cs.ptxas_report(log).items())]
        print(f"{name} {src}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in sigs[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs.setdefault(name, {})[src] = lib
    return {name: (d["decode_attention"], d["paged_decode_attention"])
            for name, d in libs.items()}


def decode_args(B, H, KH, D, ps, P, lengths, seed):
    """bf16 q, a contiguous cache [B, P * ps, KH, D] and the same rows as
    a pool of pages in order, with its table."""
    q, k, v, ln = cs.decode_inputs(B, H, KH, D, P * ps, lengths,
                                   torch.bfloat16, seed)
    table = torch.arange(B * P, dtype=torch.int32,
                         device="cuda").reshape(B, P)
    return (q, k, v, ln, k.view(B * P, ps, KH, D), v.view(B * P, ps, KH, D),
            table)


def decode_launch(libs, kernel: str, n_split: int, args, out, scratch):
    """One bf16 launch of K6 or K7 from libs = (K6 library, K7 library),
    split n_split ways, into out."""
    q, k, v, ln, kp, vp, table = args
    part, tickets = scratch
    B, H, D = q.shape
    KH = k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "K6":
        err = libs[0].decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(),
            out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B,
            k.shape[1], KH, H // KH, D, n_split, k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(D ** -0.5), 1, stream)
    else:
        err = libs[1].paged_decode_attention_forward(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            ln.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, table.shape[1], kp.shape[1], kp.shape[0],
            KH, H // KH, D, n_split, table.stride(0), kp.stride(0),
            kp.stride(1), vp.stride(0), vp.stride(1), float(D ** -0.5), 1,
            stream)
    if err:
        raise RuntimeError(f"{kernel}: CUDA error {err}")


def decode_main(tmp: Path, card: str) -> None:
    libs = build_decode(tmp)
    tickets = torch.zeros(4096, dtype=torch.int32, device="cuda")
    for tag, (B, H, KH, D, ps, P, lens) in DECODE_SHAPES.items():
        policy = attention.decode_splits(B * KH)
        live = sum(L + 1 for L in lens)
        nbytes = 2 * live * KH * D * 2
        sets = [decode_args(B, H, KH, D, ps, P, lens, seed=900 + i)
                for i in range(cs.n_copies(nbytes))]
        a0 = sets[0]
        want = attention._decode_attention_ref(*a0[:4])
        out = torch.empty_like(a0[0])
        splits = sorted({policy, *DECODE_SPLITS})
        part = torch.empty(B * KH * max(splits) * (H // KH * D + 2 * H // KH),
                           device="cuda")
        runs = [("source", n) for n in splits] + [
            (name, policy) for name in DECODE_VARIANTS if name != "source"]
        bits = {}
        for name, n in runs:   # the checks, before any timing
            if DECODE_VARIANTS[name][0] == "diagnostic":
                continue
            for kernel in ("K6", "K7"):
                decode_launch(libs[name], kernel, n, a0, out, (part, tickets))
                got = out.clone()
                ref = bits.setdefault(n, got)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{name}, {n} splits, {kernel} at {tag}: not the "
                        f"source's K6 bits at {n} splits")
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
        times = {}
        for name, n in runs + runs[::-1]:
            for kernel in ("K6", "K7"):
                times.setdefault((name, n, kernel), []).append(cs.device_ms(
                    f"{name} {n} {kernel} {tag}", lambda *a, lib=libs[name],
                    kern=kernel, n=n: decode_launch(
                        lib, kern, n, a, out, (part, tickets)), sets, 200,
                    sleep_cycles=100_000_000))
        bnd = (nbytes + 2 * B * H * D * 2) / cs.HBM_BYTES_PER_S * 1e6
        print(f"decode {tag}: B={B} H={H} KH={KH} D={D} ps={ps} bf16, "
              f"lengths {lens[0]}-{lens[-1]}, bound {bnd:.3f} us (bytes), "
              f"the wrappers' {policy} splits [{card}]:", flush=True)
        for (name, n, kernel), ms in times.items():
            print(f"  {name} ({DECODE_VARIANTS[name][0]}), {n} splits, "
                  f"{kernel}: {ms[0] * 1e3:.2f}, {ms[1] * 1e3:.2f} us",
                  flush=True)
        del sets
        torch.cuda.empty_cache()


# K1 (csrc/rms_norm.cu): name -> (kind, [(text, replacement)]). Forward
# variants keep each row's reduction and must give the source's bits;
# backward variants change how many blocks (and partial rows of dw) the
# rows are cut into, so dx keeps its bits and dw is summed in another order;
# a diagnostic skips work, gives wrong results and is not checked.
RMS_VARIANTS = {
    "source": ("same", []),
    "fwd: 1 row a block": ("same", [
        ("constexpr int kRows = 2;", "constexpr int kRows = 1;")]),
    "fwd: 4 rows a block": ("same", [
        ("constexpr int kRows = 2;", "constexpr int kRows = 4;")]),
    "fwd: 8 rows a block": ("same", [
        ("constexpr int kRows = 2;", "constexpr int kRows = 8;")]),
    "fwd: 2 rows a warp": ("same", [
        ("constexpr int kRowsPerWarp = 1;",
         "constexpr int kRowsPerWarp = 2;")]),
    "fwd: 4 rows a warp": ("same", [
        ("constexpr int kRowsPerWarp = 1;",
         "constexpr int kRowsPerWarp = 4;")]),
    "fwd: rows read again (no kHoldRow)": ("same", [
        ("constexpr bool kHoldRow = true;",
         "constexpr bool kHoldRow = false;")]),
    "bwd: no dw pass (diagnostic)": ("diagnostic", [
        ("  rms_norm_dw_kernel<T><<<",
         "  if (false) rms_norm_dw_kernel<T><<<")]),
    "bwd: 256 blocks": ("reorder", [
        ("constexpr int kBwdBlocks = 1024;",
         "constexpr int kBwdBlocks = 256;")]),
    "bwd: 512 blocks": ("reorder", [
        ("constexpr int kBwdBlocks = 1024;",
         "constexpr int kBwdBlocks = 512;")]),
    "bwd: 2048 blocks": ("reorder", [
        ("constexpr int kBwdBlocks = 1024;",
         "constexpr int kBwdBlocks = 2048;")]),
}


def build_rms(tmp: Path) -> dict:
    """{name: ctypes library} of RMS_VARIANTS, one nvcc each, all at once."""
    src = RMS_SRC.read_text()
    procs = {}
    for i, (name, (_, subs)) in enumerate(RMS_VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {RMS_SRC.name}")
            text = text.replace(old, new)
        cu, so = tmp / f"rms{i}.cu", tmp / f"rms{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in fused._RMS_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def rms_launch(lib, which: str, x, a, w, h, y, gy, gh, dx, dw) -> None:
    """One bf16 launch of a variant's K1: "fwd" (y from x), "add" (h, y
    from x + a) or "bwd" (dx, dw from h = x, g_y, g_h)."""
    R, E = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    if which == "bwd":
        part = torch.empty(lib.rms_norm_backward_blocks(R), E,
                           device="cuda")
        err = lib.rms_norm_backward(
            x.data_ptr(), w.data_ptr(), gy.data_ptr(), gh.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), part.data_ptr(), R, E, cs.EPS, 1,
            1, stream)
    else:
        add = which == "add"
        err = lib.rms_norm_forward(
            x.data_ptr(), a.data_ptr() if add else None, w.data_ptr(),
            h.data_ptr() if add else None, y.data_ptr(), R, E, cs.EPS, 1, 1,
            stream)
    if err:
        raise RuntimeError(f"K1 {which}: CUDA error {err}")


def rms_main(tmp: Path, card: str) -> None:
    """Every K1 variant at the decode tick's 8 rows, a prefill's 64 and the
    train step's 16384 (bf16, d_model 1024): the plain forward, the
    residual form, and (16384 rows) the backward with g_h, in turns. Each
    is checked against the source first."""
    libs = build_rms(tmp)
    E, bf16 = cs.FLAGSHIP["d_model"], torch.bfloat16
    runs = {8: ("fwd", "add"), 64: ("fwd",),
            cs.TRAIN_B * cs.TRAIN_T: ("fwd", "add", "bwd")}
    for R, whichs in runs.items():
        sets = []
        for i in range(cs.n_copies(4 * R * E * 2)):
            x, w = cs.rms_inputs(R, bf16, seed=950 + i)
            a, gy, gh = (cs.rms_inputs(R, bf16, seed=960 + 3 * i + k)[0]
                         for k in range(3))
            sets.append((x, a, w, torch.empty_like(x), torch.empty_like(x),
                         gy, gh, torch.empty_like(x), torch.empty_like(w)))
        want = {}
        for which in whichs:
            src = [t.clone() for t in sets[0]]
            rms_launch(libs["source"], which, *src)
            want[which] = src
        for name, lib in libs.items():
            for which in whichs:
                got = [t.clone() for t in sets[0]]
                rms_launch(lib, which, *got)
                kind = RMS_VARIANTS[name][0]
                if kind == "diagnostic":
                    continue
                outs = {"fwd": (4,), "add": (3, 4), "bwd": (7, 8)}[which]
                for k in outs:
                    same = torch.equal(got[k], want[which][k])
                    if not same and (kind == "same" or k == 7):
                        raise AssertionError(f"{name} {which} R={R}: not "
                                             f"the source's bits")
                    if not same:
                        _, pdw = fused._rms_norm_bwd(got[0], got[2], got[5],
                                                     cs.EPS)
                        torch.testing.assert_close(
                            got[8].float(), pdw.float(), atol=2 ** -7,
                            rtol=2 ** -7)
        times = {}
        for name in list(libs) + list(libs)[::-1]:
            for which in whichs:
                times.setdefault((name, which), []).append(cs.device_ms(
                    f"{name} {which} R={R}", lambda *t, lib=libs[name],
                    w=which: rms_launch(lib, w, *t), sets,
                    50 if R > 64 else 200, sleep_cycles=200_000_000))
        print(f"K1 at [{R}, {E}] bf16 [{card}]:", flush=True)
        for (name, which), ms in times.items():
            print(f"  {name} ({RMS_VARIANTS[name][0]}) {which}: "
                  f"{ms[0] * 1e3:.2f}, {ms[1] * 1e3:.2f} us", flush=True)
        del sets, want
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("flash_variants: no CUDA device is available")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rms_main(Path(tmp), card)
        if sys.argv[1:] == ["rms"]:
            return 0
        decode_main(Path(tmp), card)
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
