"""Boundaries of the port: ray_tpu_torch, chip_smoke.py and flash_variants.py
import no JAX and nothing of ray_tpu; entry points never run on the CPU
unless asked; the CUDA wrappers never fall back to their plain versions;
``ray_tpu_torch.ops`` and ``ray_tpu_torch.serve`` export what ``ray_tpu.ops``
and ``ray_tpu.serve`` do; the cluster runtime's sources read only the port's
own variables and name only the port's own shared-memory segments and spill
directories."""

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
from ray_tpu_torch.models import engine, generate, paged_engine, transformer
from ray_tpu_torch.ops import attention, fused, paged_attention
from ray_tpu_torch.scheduler import kernel as sched
from ray_tpu_torch.scheduler.dag import random_dag, uniform_cluster
from ray_tpu_torch.serve import LMBackend

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
    p for d in ("cluster", "_native", "_private")
    for p in (ROOT / "ray_tpu_torch" / d).rglob("*")
    if p.suffix in (".py", ".cc"))
# The JAX package's knob prefix, arena and completion-ring prefixes and
# spill directory: a port process that named one would read the other
# package's settings or sweep its segments on a shared machine.
_FOREIGN_NAMES = re.compile(r"RAY_TPU_(?!TORCH_)|rtps-|rtcr-|ray_tpu_spill")


@pytest.mark.parametrize("path", _CLUSTER_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_cluster_sources_name_only_the_ports_own_resources(path):
    hits = [(i, line.strip()) for i, line in
            enumerate(path.read_text().splitlines(), 1)
            if _FOREIGN_NAMES.search(line)]
    assert hits == [], hits


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
