"""Boundaries of the port: ray_tpu_torch, chip_smoke.py and flash_variants.py
import no JAX and nothing of ray_tpu; entry points never run on the CPU
unless asked; the CUDA wrappers never fall back to their plain versions;
``ray_tpu_torch.ops`` and ``ray_tpu_torch.serve`` export what ``ray_tpu.ops``
and ``ray_tpu.serve`` do; the cluster runtime's and the operator tools'
sources read only the port's own variables and name only the port's own
shared-memory segments, spill directories and session, log and report
files, and the library layer (tune, util, projects) its own results
directory, named-actor registry and joblib backend; tune and util export
what the JAX package's do and import no optional package (pandas, pyyaml,
joblib) until a call needs it; no string in the port names a module of the
JAX package."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.ops
from ray_tpu_torch._kernels import build
from ray_tpu_torch.models import TransformerConfig, init_params
from ray_tpu_torch.models import (engine, generate, moe_transformer,
                                  paged_engine, transformer, vision)
from ray_tpu_torch.ops import attention, fused, paged_attention
from ray_tpu_torch.parallel import init_moe_params
from ray_tpu_torch.scheduler import kernel as sched
from ray_tpu_torch.scheduler.dag import random_dag, uniform_cluster
from ray_tpu_torch.serve import LMBackend
from ray_tpu_torch.experimental import array as dist_array
from ray_tpu_torch.train import MeshTrainer, TPUTrainer

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_variants.py"]
_FORBIDDEN = ("jax", "jaxlib", "ray_tpu")

_PROBE = """
import importlib, pkgutil, sys
import ray_tpu_torch
for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke, flash_variants
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
print("BAD", bad)
"""


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)


_CLUSTER_SOURCES = sorted(
    p for d in ("cluster", "_native", "_private", "scripts", "dashboard",
                "autoscaler")
    for p in (ROOT / "ray_tpu_torch" / d).rglob("*")
    if p.suffix in (".py", ".cc", ".c")) + [ROOT / "ray_tpu_torch" /
                                             "monitor.py"]
# The library layer: tune, util and projects.
_LIBRARY_SOURCES = sorted(
    p for d in ("tune", "util") for p in (ROOT / "ray_tpu_torch" / d).rglob(
        "*.py")) + [ROOT / "ray_tpu_torch" / "projects.py"]
# Streaming (its rings are /dev/shm segments) and the experimental APIs.
_STREAMING_SOURCES = sorted(
    p for d in ("streaming", "experimental")
    for p in (ROOT / "ray_tpu_torch" / d).rglob("*.py"))
# The JAX package's knob prefix, arena, completion-ring and streaming-ring
# prefixes, spill
# directory, and the CLI's session, head-log and report paths: a port
# process that named one would read the other package's settings or
# session, or sweep its segments, on a shared machine. The results
# directory, the named-actor registry and the joblib backend of tune and
# util: a port trial that named one would write into the other package's
# results, or find its actors.
_FOREIGN_NAMES = re.compile(
    r"RAY_TPU_(?!TORCH_)|rtps-|rtcr-|rtch-|ray_tpu_spill|ray_tpu_session"
    r"|ray_tpu_head_|ray_tpu_postmortem|ray_tpu_profile_|ray_tpu_timeline"
    r"|ray_tpu_results|__ray_tpu_named_actor_registry__|\"ray_tpu\"")


@pytest.mark.parametrize("path", _CLUSTER_SOURCES + _LIBRARY_SOURCES
                         + _STREAMING_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_cluster_sources_name_only_the_ports_own_resources(path):
    hits = [(i, line.strip()) for i, line in
            enumerate(path.read_text().splitlines(), 1)
            if _FOREIGN_NAMES.search(line)]
    assert hits == [], hits


def _strings(tree):
    """Every string constant of a module, with the literal text at the
    head of each f-string."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value
        elif isinstance(node, ast.JoinedStr) and node.values and \
                isinstance(node.values[0], ast.Constant):
            yield node.lineno, node.values[0].value


_NATIVE_SOURCES = sorted(p for p in (ROOT / "ray_tpu_torch").rglob("*")
                         if p.suffix in (".cc", ".c", ".cu", ".cuh", ".h"))


@pytest.mark.parametrize("path", PORT_FILES + _NATIVE_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_module_of_the_jax_package(path):
    """A string that starts with ``ray_tpu.`` is a module path of the JAX
    package: launched (``python -m ray_tpu.cluster.launch``) or imported
    (``PyImport_ImportModule("ray_tpu._native.c_entry")``), it would run
    the JAX package's code in a port process."""
    if path.suffix == ".py":
        hits = [(n, v) for n, v in _strings(ast.parse(path.read_text()))
                if v.lstrip().startswith("ray_tpu.")]
    else:
        hits = [(i, line.strip()) for i, line in
                enumerate(path.read_text().splitlines(), 1)
                if re.search(r'"ray_tpu\.', line)]
    assert hits == [], hits


# The JAX package's data-plane knobs that the port keeps as constants, and
# those whose twins land with A6c's later parts (state and observability,
# the runtime under stress). Every other knob that ray_tpu/cluster/ and
# ray_tpu/_native/ read from the environment, the port reads as
# RAY_TPU_TORCH_<NAME>.
_KNOBS_KEPT_CONSTANT = {
    "COMPLETION_RING_BYTES", "DISPATCH_FAST", "INLINE_GCS_BUDGET_BYTES",
    "INLINE_NODE_CACHE_BYTES", "KILL_GRACE_S", "LOCALITY_DEBUG",
    "OOM_WATERMARK", "OWNER_GRACE_S", "OWNER_TABLE_BUDGET_BYTES",
    "PROFILE_GCS", "PROFILE_NODE", "TRANSFER_AUDIT_GRACE_S"}
_KNOBS_PENDING = {
    "CHAOS_KILL_WORKER_EVERY_S", "DRAIN_TIMEOUT_S", "EXEC_STAMPS",
    "OOM_GRACE_S", "POISON_THRESHOLD"}


def _env_knobs(package: str, prefix: str) -> set:
    """<NAME> of every string literal ``<prefix><NAME>`` in the .py files
    of ``package``'s cluster/ and _native/ (how both read a knob:
    ``os.environ.get("<prefix><NAME>", ...)``)."""
    names = set()
    for d in ("cluster", "_native"):
        for p in (ROOT / package / d).rglob("*.py"):
            for node in ast.walk(ast.parse(p.read_text())):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    m = re.fullmatch(prefix + r"([A-Z0-9_]+)", node.value)
                    if m:
                        names.add(m.group(1))
    return names


def test_every_data_plane_knob_of_the_jax_package_is_read_or_listed():
    jax_knobs = _env_knobs("ray_tpu", "RAY_TPU_")
    port_knobs = _env_knobs("ray_tpu_torch", "RAY_TPU_TORCH_")
    listed = _KNOBS_KEPT_CONSTANT | _KNOBS_PENDING
    assert not _KNOBS_KEPT_CONSTANT & _KNOBS_PENDING
    assert sorted(jax_knobs - port_knobs - listed) == []
    # The lists hold only knobs of the JAX package that the port does not
    # read: a knob that lands comes off them.
    assert sorted(listed - jax_knobs) == []
    assert sorted(listed & port_knobs) == []
    assert {"WIRE_PICKLE_ONLY", "COLUMNAR_SUBMIT", "DISPATCH_WAVE",
            "COMPLETION_RING", "INLINE_RESULT_MAX", "NATIVE_FRAMEPUMP",
            "NATIVE_FRAMEPUMP_SITES", "TRANSFER_SCHED", "TRANSFER_CHUNK",
            "TRANSFER_MAX_INFLIGHT", "NATIVE_SAN"} <= port_knobs


def test_cluster_segment_prefixes_are_the_ports_own():
    from ray_tpu_torch._native import completion_ring
    from ray_tpu_torch._private import spill

    class _Cfg:
        object_spill_enabled = True
        object_spill_dir = ""

    ring = completion_ring.ring_name(b"\x00\x00\x00\x01")
    assert ring.startswith("rttr-")
    assert os.path.basename(os.path.dirname(
        spill.resolve_spill_dir(_Cfg(), "rtts-x"))) == "ray_tpu_torch_spill"
    src = (ROOT / "ray_tpu_torch" / "cluster" / "controller.py").read_text()
    assert 'f"rtts-{self.node_id[:12]}"' in src
    from ray_tpu.streaming.worker import _chan_shm_name as jax_ring
    from ray_tpu_torch.streaming.worker import _chan_shm_name as port_ring

    assert port_ring("j:e0:0-1:0->0").startswith("rttch-")
    assert jax_ring("j:e0:0-1:0->0").startswith("rtch-")
    assert port_ring("j")[len("rttch-"):] == jax_ring("j")[len("rtch-"):]


def _tiny():
    return TransformerConfig(vocab_size=32, d_model=32, n_layers=1,
                             n_heads=2, n_kv_heads=1, d_ff=32,
                             max_seq_len=16, dtype=torch.float32)


def _cpu_params():
    return init_params(torch.Generator().manual_seed(0), _tiny(),
                       device="cpu")


_ENTRY_POINTS = {
    "default_device": lambda: ray_tpu_torch.default_device(),
    "default_device_cuda": lambda: ray_tpu_torch.default_device("cuda"),
    "init_params": lambda: init_params(torch.Generator(), _tiny()),
    "params_from_numpy": lambda: transformer.params_from_numpy(
        {"embed": np.zeros((2, 2))}),
    "init_cache": lambda: generate.init_cache(_tiny(), 1, 4),
    "generate": lambda: generate.generate(_cpu_params(), [[1, 2]], _tiny(),
                                          2),
    "GenerationEngine": lambda: engine.GenerationEngine(_cpu_params(),
                                                        _tiny()),
    "LMBackend": lambda: LMBackend(_cpu_params(), _tiny()),
    "PagedGenerationEngine": lambda: paged_engine.PagedGenerationEngine(
        _cpu_params(), _tiny(), page_size=8),
    "LMBackend_paged": lambda: LMBackend(_cpu_params(), _tiny(), paged=True,
                                         page_size=8),
}


def _dag():
    demand, parents = random_dag(40, seed=1)
    return demand, parents, uniform_cluster(3)


def _gangs():
    return (np.full((4, 2), 100, np.int32), np.array([0, 0, 1, 1], np.int32),
            np.array([0, 3], np.int32), np.full((3, 2), 1000, np.int32),
            sched.prng_key(0))


_PENDING = (np.ones((3, 2), np.int32), np.array([-1, 0, -1], np.int32),
            np.full((2, 2), 5, np.int32), np.zeros(3, bool),
            np.array([0, 0, 1], bool), np.zeros(3, bool))

# The scheduler's entry points, each called with its ``device`` keyword.
_SCHED_ENTRY_POINTS = {
    "schedule_dag": lambda **kw: sched.schedule_dag(
        *_dag(), sched.prng_key(0), chunk=16, **kw)[0],
    "schedule_dag_collapsed": lambda **kw: sched.schedule_dag_collapsed(
        *_dag(), sched.prng_key(0), chunk=16, **kw)[0],
    "BatchScheduler": lambda **kw: sched.BatchScheduler(
        uniform_cluster(3), chunk=16, **kw).place(_dag()[0]),
    "admit_gangs_host": lambda **kw: sched.admit_gangs_host(*_gangs(), **kw),
    "classify_pending_host": lambda **kw: sched.classify_pending_host(
        *_PENDING, **kw),
    "score_locality_host": lambda **kw: sched.score_locality_host(
        np.array([[0, 5, 5], [0, 0, 0]], np.int64), **kw),
}
_ENTRY_POINTS.update(_SCHED_ENTRY_POINTS)


def _tiny_moe():
    return moe_transformer.MoETransformerConfig(
        vocab_size=32, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=32, max_seq_len=16, n_experts=2, top_k=1)


# The train library and the single-device models (each takes ``device``).
_ENTRY_POINTS.update({
    "init_moe_params": lambda: init_moe_params(torch.Generator(),
                                               _tiny_moe().moe_cfg()),
    "moe_init_params": lambda: moe_transformer.init_params(
        torch.Generator(), _tiny_moe()),
    "init_vision_params": lambda: vision.init_vision_params(
        torch.Generator(), vision.VisionConfig()),
    "vision_params_from_numpy": lambda: vision.vision_params_from_numpy(
        {"stem": np.zeros((3, 3, 1, 8))}),
    "MeshTrainer": lambda: MeshTrainer(lambda g: {"w": torch.zeros(2)},
                                       lambda p, b: p["w"].sum()),
    "TPUTrainer": lambda: TPUTrainer(lambda g: {"w": torch.zeros(2)},
                                     lambda p, b: p["w"].sum(),
                                     lambda rank, world, config: iter([])),
})
# The distributed arrays' constructors (each takes ``device``; the array's
# device resolves in the driver, before any block's task is queued).
_ENTRY_POINTS.update({
    "array_zeros": lambda: dist_array.zeros((4, 4)),
    "array_eye": lambda: dist_array.eye(4),
    "array_random": lambda: dist_array.random((4, 4), seed=1),
})


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_without_device_raise_when_cuda_is_absent(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(_SCHED_ENTRY_POINTS))
def test_scheduler_entry_points_run_on_the_cpu_when_asked(name,
                                                          monkeypatch):
    """Without a card, each scheduler entry point runs when given
    device="cpu" (and a pass handed CPU tensors stays on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = _SCHED_ENTRY_POINTS[name](device="cpu")
    assert out.dtype in (np.int32, torch.int32)
    assert not isinstance(out, torch.Tensor) or out.device.type == "cpu"
    demand, parents, avail = _dag()
    placement, rounds = sched.schedule_dag(
        torch.from_numpy(demand), torch.from_numpy(parents),
        torch.from_numpy(avail), sched.prng_key(0), chunk=16)
    assert placement.device.type == rounds.device.type == "cpu"


def test_entry_points_run_on_the_cpu_when_asked():
    assert ray_tpu_torch.default_device("cpu") == torch.device("cpu")
    out = generate.generate(_cpu_params(), [[1, 2]], _tiny(), 3,
                            device="cpu")
    assert out.shape == (1, 3) and out.dtype == torch.int32


def test_rms_norm_kernel_wrapper_refuses_what_it_does_not_take():
    """Off the CPU, rms_norm takes the kernel or raises: a tensor the
    kernel does not take is refused, never handed to the plain version,
    and nothing is counted."""
    before = fused.rms_norm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.rms_norm(torch.ones(2, 8, device="meta"),
                       torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused._rms_norm_cuda(torch.ones(2, 8), torch.ones(8), 1e-5)
    assert fused.rms_norm.launches == before


def _rms_counts():
    return (fused.rms_norm.launches, fused.add_rms_norm.launches,
            fused.rms_norm.backward_launches)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("case", [
    "not_cuda", "cpu_operand", "a_shape", "a_dtype", "float16"])
def test_add_rms_norm_kernel_wrapper_refuses_what_it_does_not_take(case,
                                                                   grad):
    """Off the CPU, add_rms_norm takes the kernel or raises: a tensor off
    the card, a residual a on another device or of another shape or dtype
    than x, or a dtype the kernel does not take is refused, never handed to
    the plain version, and no counter moves."""
    x, w = torch.ones(2, 8, **_META), torch.ones(8, **_META)
    (x, a, w), err, match = {
        "not_cuda": ((x, x, w), ValueError, "CUDA tensors"),
        "cpu_operand": ((x, torch.ones(2, 8), w), ValueError,
                        "CUDA tensors"),
        "a_shape": ((x, torch.ones(3, 8, **_META), w), ValueError,
                    "differs from x's"),
        "a_dtype": ((x, x.bfloat16(), w), TypeError, "differs from x dtype"),
        "float16": ((x.half(), x.half(), w.half()), TypeError, "float32 or"),
    }[case]
    x.requires_grad_(grad)
    before = _rms_counts()
    with pytest.raises(err, match=match):
        fused.add_rms_norm(x, a, w)
    with pytest.raises(err, match=match):
        fused._rms_norm_cuda(x, w, 1e-5, a)
    assert _rms_counts() == before


@pytest.mark.parametrize("case", ["cpu", "meta", "g_h_shape", "w_dtype"])
def test_rms_norm_backward_kernel_route_refuses_what_it_does_not_take(case):
    """The backward kernel's route, handed CPU or meta tensors, a residual
    gradient of another shape, or a weight of another dtype, raises before
    it launches, and no counter moves."""
    dev = "cpu" if case == "cpu" else "meta"
    h = torch.ones(2, 8, device=dev)
    w, g = torch.ones(8, device=dev), torch.ones(2, 8, device=dev)
    g_h, err, match = None, ValueError, "CUDA tensors"
    if case == "g_h_shape":
        g_h, match = torch.ones(2, 4, device=dev), "differs from x's"
    if case == "w_dtype":
        w, err, match = w.bfloat16(), TypeError, "differs from x dtype"
    before = _rms_counts()
    with pytest.raises(err, match=match):
        fused._rms_norm_bwd_cuda(h, w, g, g_h, 1e-5)
    assert _rms_counts() == before


def test_decode_kernel_wrapper_refuses_what_it_does_not_take():
    before = attention.decode_attention.launches
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.decode_attention(
            torch.ones(1, 2, 64, **meta), torch.ones(1, 4, 2, 64, **meta),
            torch.ones(1, 4, 2, 64, **meta),
            torch.zeros(1, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention._decode_attention_cuda(
            torch.ones(1, 2, 64), torch.ones(1, 4, 2, 64),
            torch.ones(1, 4, 2, 64), torch.zeros(1, dtype=torch.int32))
    assert attention.decode_attention.launches == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["rms_norm"])
    assert list((tmp_path / "build").iterdir()) == []


def test_kernel_sources_exist_and_library_names_track_them():
    for name in build.KERNELS:
        src = build.CSRC / f"{name}.cu"
        assert src.is_file()
        assert 'extern "C"' in src.read_text()
        assert build.lib_path(name).parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


_META = dict(device="meta")


def _flash_meta(D=64, dtype=torch.float32, kv_dtype=None, kv_device="meta"):
    q = torch.ones(1, 4, 2, D, dtype=dtype, **_META)
    k = torch.ones(1, 4, 2, D, dtype=kv_dtype or dtype, device=kv_device)
    stats = torch.ones(1, 2, 4, **_META)
    return q, k, k, q, stats, stats


_FLASH_WRAPPERS = {
    "flash_forward": lambda q, k, v, do, lse, dsum: attention.flash_forward(
        q, k, v),
    "flash_backward_dq": lambda *a: attention.flash_backward_dq(*a),
    "flash_backward_dkv": lambda *a: attention.flash_backward_dkv(*a),
}
_COUNTERS = (fused.rms_norm, fused.add_rms_norm, fused.softmax_cross_entropy,
             attention.flash_forward, attention.flash_backward_dq,
             attention.flash_backward_dkv, attention.decode_attention,
             paged_attention.paged_decode_attention)


@pytest.mark.parametrize("case", [
    "not_cuda", "cpu_operand", "d96", "mixed_dtypes", "float16"])
@pytest.mark.parametrize("name", sorted(_FLASH_WRAPPERS))
def test_flash_kernel_wrappers_refuse_what_they_do_not_take(name, case):
    """Off the CPU, each flash wrapper takes its kernel or raises: a tensor
    off the card, a CPU operand beside a non-CPU one, a head dim outside
    {64, 128}, or dtypes the kernels do not take are refused, never handed
    to the plain version, and nothing is counted."""
    args, err, match = {
        "not_cuda": (_flash_meta(), ValueError, "CUDA tensors"),
        "cpu_operand": (_flash_meta(kv_device="cpu"), ValueError,
                        "CUDA tensors"),
        "d96": (_flash_meta(D=96), ValueError, "D in"),
        "mixed_dtypes": (_flash_meta(kv_dtype=torch.bfloat16), TypeError,
                         "one dtype"),
        "float16": (_flash_meta(dtype=torch.float16), TypeError,
                    "one dtype"),
    }[case]
    before = [f.launches for f in _COUNTERS]
    with pytest.raises(err, match=match):
        _FLASH_WRAPPERS[name](*args)
    assert [f.launches for f in _COUNTERS] == before


def test_flash_attention_autograd_refuses_off_the_cpu():
    q, k, v, _, _, _ = _flash_meta(D=128, kv_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_attention(q, k, v)


@pytest.mark.parametrize("case", ["not_cuda", "cpu_operand", "float16",
                                  "float_labels", "bad_shape"])
def test_xent_kernel_wrapper_refuses_what_it_does_not_take(case):
    logits = torch.ones(4, 32, **_META)
    labels = torch.zeros(4, dtype=torch.long, **_META)
    args, err, match = {
        "not_cuda": ((logits, labels), ValueError, "CUDA tensors"),
        "cpu_operand": ((logits, torch.zeros(4, dtype=torch.long)),
                        ValueError, "CUDA tensors"),
        "float16": ((logits.half(), labels), TypeError, "float32 or"),
        "float_labels": ((logits, labels.float()), TypeError, "int32 or"),
        "bad_shape": ((logits[None], labels), ValueError, "want logits"),
    }[case]
    before = [f.launches for f in _COUNTERS]
    with pytest.raises(err, match=match):
        fused.softmax_cross_entropy(*args)
    with pytest.raises(err, match=match):
        fused._xent_cuda(*args)
    assert [f.launches for f in _COUNTERS] == before


def _paged_meta(D=64, dtype=torch.float32, pages_dtype=None,
                pages_device="meta"):
    q = torch.ones(2, 4, D, dtype=dtype, **_META)
    pages = torch.ones(5, 8, 2, D, dtype=pages_dtype or dtype,
                       device=pages_device)
    table = torch.zeros(2, 3, dtype=torch.int32, **_META)
    lengths = torch.zeros(2, dtype=torch.int32, **_META)
    return q, pages, pages, table, lengths


@pytest.mark.parametrize("case", [
    "not_cuda", "cpu_operand", "d96", "mixed_dtypes", "float16"])
def test_paged_decode_kernel_wrapper_refuses_what_it_does_not_take(case):
    """Off the CPU, paged_decode_attention takes K7 or raises: a tensor off
    the card, a CPU operand beside a non-CPU one, a head dim outside
    {64, 128}, or dtypes the kernel does not take are refused, never handed
    to the plain version, and nothing is counted."""
    args, err, match = {
        "not_cuda": (_paged_meta(), ValueError, "CUDA tensors"),
        "cpu_operand": (_paged_meta(pages_device="cpu"), ValueError,
                        "CUDA tensors"),
        "d96": (_paged_meta(D=96), ValueError, "D in"),
        "mixed_dtypes": (_paged_meta(pages_dtype=torch.bfloat16), TypeError,
                         "one dtype"),
        "float16": (_paged_meta(dtype=torch.float16), TypeError,
                    "one dtype"),
    }[case]
    before = [f.launches for f in _COUNTERS]
    with pytest.raises(err, match=match):
        paged_attention.paged_decode_attention(*args)
    assert [f.launches for f in _COUNTERS] == before


def test_cuda_routes_refuse_cpu_tensors():
    """The CUDA route of each wrapper, handed CPU tensors, raises rather
    than computing on them."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused._xent_cuda(torch.ones(2, 8), torch.zeros(2, dtype=torch.long))
    q = torch.ones(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention._check_flash_args(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused._rms_norm_cuda(torch.ones(2, 8), torch.ones(8), 1e-5)
    pages = torch.ones(3, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention._paged_decode_cuda(
            torch.ones(1, 2, 64), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))


def test_train_step_runs_where_the_parameters_lie():
    """make_train_step takes no device: it runs where the parameters lie,
    which init_params places on the card unless told otherwise."""
    cfg = _tiny()
    init_opt, train_step = transformer.make_train_step(cfg)
    params = _cpu_params()
    opt = init_opt(params)
    _, _, loss = train_step(params, opt, {"tokens": np.ones((1, 5),
                                                           np.int64)})
    assert loss.device.type == "cpu" and torch.isfinite(loss)


# ------------------------------------------------ the ops package's exports


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_ops_package_exports_every_name_of_the_jax_ops_package():
    """Every public name of ``ray_tpu.ops`` is one of ``ray_tpu_torch.ops``,
    and the four functions both export agree on the same numpy-seeded f32
    inputs within 1e-5 (JAX on the CPU takes its XLA path)."""
    import jax.numpy as jnp

    import ray_tpu.ops as jops

    tops = ray_tpu_torch.ops
    missing = sorted(_public(jops) - _public(tops))
    assert not missing, f"ray_tpu_torch.ops lacks {missing}"

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 16, 4, 64), dtype=np.float32)
               for _ in range(3))
    x = rng.standard_normal((6, 64), dtype=np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    logits = rng.standard_normal((5, 40), dtype=np.float32)
    labels = rng.integers(0, 40, size=5).astype(np.int32)
    calls = {
        "attention_reference": ((q, k, v), {"causal": True}),
        "flash_attention": ((q, k, v), {"causal": True}),
        "rms_norm": ((x, w), {}),
        "softmax_cross_entropy": ((logits, labels), {}),
    }
    for name, (args, kw) in calls.items():
        want = np.asarray(getattr(jops, name)(
            *(jnp.asarray(a) for a in args), **kw))
        got = getattr(tops, name)(*(torch.from_numpy(a) for a in args), **kw)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_serve_package_exports_every_name_of_the_jax_serve_package():
    """``ray_tpu_torch.serve.__all__`` holds every name of
    ``ray_tpu.serve.__all__``, each defined; the control plane's modules
    are the reference's, one file to one file, and the fleet's metric
    family is in the port's registry module."""
    import ray_tpu.serve as jserve

    import ray_tpu_torch.metrics
    import ray_tpu_torch.serve as tserve

    missing = sorted(set(jserve.__all__) - set(tserve.__all__))
    assert not missing, f"ray_tpu_torch.serve lacks {missing}"
    assert all(hasattr(tserve, n) for n in tserve.__all__)
    for mod in ("api", "master", "router", "handle", "backend_worker",
                "http_proxy", "metric", "config", "lm"):
        assert (ROOT / "ray_tpu_torch" / "serve" / f"{mod}.py").is_file()
    assert callable(ray_tpu_torch.metrics.serve_fleet_metrics)


# The modules of the train library and the single-device models, one file
# to one file with the JAX package's; the import probe and the source
# checks above walk every file under ray_tpu_torch/, these included.
_A7A_MODULES = ("train/__init__", "train/trainer", "train/mesh_trainer",
                "parallel/__init__", "parallel/moe",
                "models/moe_transformer", "models/vision",
                "parallel/mesh", "parallel/collectives",
                "parallel/ring_attention", "parallel/ulysses",
                "parallel/pipeline")


@pytest.mark.parametrize("module", _A7A_MODULES)
def test_train_and_parallel_sources_are_checked(module):
    path = ROOT / "ray_tpu_torch" / f"{module}.py"
    assert path in PORT_FILES
    assert (ROOT / "ray_tpu" / f"{module}.py").is_file()


# What the JAX package's models, train and parallel packages export that
# the port's do not: the shims over jax versions for shard_map, which have
# no counterpart (the port's per-rank bodies take the mesh).
_AWAITING_A7B = {
    "ray_tpu.models": set(),
    "ray_tpu.train": set(),
    "ray_tpu.parallel": {"resolve_shard_map", "shard_map_compat"},
}


@pytest.mark.parametrize("name", sorted(_AWAITING_A7B))
def test_models_train_and_parallel_export_what_the_jax_packages_do(name):
    """Every public name of the JAX package's models, train and parallel
    packages is the port's too, and each of their submodules has a file in
    the port, but for the jax-version shims, which are listed."""
    import importlib
    import types

    jmod = importlib.import_module(name)
    tmod = importlib.import_module(name.replace("ray_tpu", "ray_tpu_torch",
                                                1))
    tdir = ROOT / "ray_tpu_torch" / name.split(".")[1]
    missing = set()
    for n in _public(jmod):
        val = getattr(jmod, n)
        if isinstance(val, types.ModuleType):
            if not ((tdir / f"{n}.py").is_file() or (tdir / n).is_dir()):
                missing.add(n)
        elif not hasattr(tmod, n):
            missing.add(n)
    assert missing == _AWAITING_A7B[name], sorted(missing)


# The library layer, one file to one file with the JAX package's.
_A81_FILES = sorted(
    str(p.relative_to(ROOT / "ray_tpu"))
    for d in ("tune", "util") for p in (ROOT / "ray_tpu" / d).rglob("*.py")
) + ["projects.py"]


def test_library_layer_has_every_file_of_the_jax_packages():
    assert len(_A81_FILES) == 26
    missing = [f for f in _A81_FILES
               if not (ROOT / "ray_tpu_torch" / f).is_file()]
    assert missing == []
    assert set(_LIBRARY_SOURCES) == {ROOT / "ray_tpu_torch" / f
                                     for f in _A81_FILES}


@pytest.mark.parametrize("name", ["ray_tpu.tune", "ray_tpu.util"])
def test_tune_and_util_export_what_the_jax_packages_do(name):
    """Every public name of the JAX package's tune and util packages is
    the port's too, and each of their submodules has a file in the port."""
    import importlib
    import types

    jmod = importlib.import_module(name)
    tmod = importlib.import_module(name.replace("ray_tpu", "ray_tpu_torch",
                                                1))
    tdir = ROOT / "ray_tpu_torch" / name.split(".")[1]
    missing = set()
    for n in _public(jmod):
        val = getattr(jmod, n)
        if isinstance(val, types.ModuleType):
            if not ((tdir / f"{n}.py").is_file() or (tdir / n).is_dir()):
                missing.add(n)
        elif not hasattr(tmod, n):
            missing.add(n)
    assert missing == set(), sorted(missing)
    if hasattr(jmod, "__all__"):
        assert sorted(tmod.__all__) == sorted(jmod.__all__)


_LIBRARY_PROBE = """
import sys
import ray_tpu_torch.tune, ray_tpu_torch.util, ray_tpu_torch.projects
import ray_tpu_torch.util.multiprocessing, ray_tpu_torch.util.joblib
print("LOADED", sorted(m for m in ("pandas", "yaml", "joblib")
                       if m in sys.modules))
"""


def test_importing_tune_util_and_projects_loads_no_optional_package():
    """pandas, pyyaml and joblib are imported only by the calls that need
    them (``ExperimentAnalysis.dataframe``, ``load_project``,
    ``register_ray``): the machine with the card has none of them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LIBRARY_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# Streaming and the experimental APIs, one file to one file.
_A82_A83_FILES = sorted(
    str(p.relative_to(ROOT / "ray_tpu"))
    for d in ("streaming", "experimental")
    for p in (ROOT / "ray_tpu" / d).rglob("*.py"))


def test_streaming_and_experimental_have_every_file_of_the_jax_packages():
    assert len(_A82_A83_FILES) == 9
    missing = [f for f in _A82_A83_FILES
               if not (ROOT / "ray_tpu_torch" / f).is_file()]
    assert missing == []
    assert set(_STREAMING_SOURCES) == {ROOT / "ray_tpu_torch" / f
                                       for f in _A82_A83_FILES}


@pytest.mark.parametrize("name", ["ray_tpu.streaming",
                                  "ray_tpu.experimental"])
def test_streaming_and_experimental_export_what_the_jax_packages_do(name):
    """Every name that the JAX package's streaming and experimental
    packages define (``_internal_kv_*`` too) is the port's, and their
    ``__all__`` are equal."""
    import importlib
    import types

    jmod = importlib.import_module(name)
    tmod = importlib.import_module(name.replace("ray_tpu", "ray_tpu_torch",
                                                1))
    names = {n for n, v in vars(jmod).items() if not n.startswith("__")
             and not isinstance(v, types.ModuleType)}
    assert names and sorted(names - set(vars(tmod))) == []
    assert getattr(tmod, "__all__", None) == getattr(jmod, "__all__", None)
