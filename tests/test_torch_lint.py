"""The port's linter (``ray_tpu_torch.devtools.lint``) against the JAX
package's, on the CPU: twins of tests/test_lint.py.

Each twin runs the reference test's own program twice (``RefTwin``): as
written, against the JAX package's linter and sources, and with its module
paths and its projects' ``ray_tpu/`` file paths renamed to the port's, its
CLI to the port's (``ray_tpu_torch/scripts/lint.py``). Each run must pass
the reference's assertions, and every call the test makes to its ``lint``
helper must find as many violations in both. The gate runs the port's
linter over ``ray_tpu_torch/`` and ``tests/`` against the port's own
baseline, ``.raylint_torch_baseline.json``.

The kernel-purity cases of the reference write their passes with
``@jax.jit``; the port's passes are plain torch functions that
``scheduler/kernel.py`` names in its ``PASSES`` tuple, so those cases are
written out below in that form."""

import ast
import json
import os
import textwrap

from test_torch_wire_codec import RefTwin

from ray_tpu_torch.devtools.lint import load_project, run_lint
from ray_tpu_torch.devtools.lint import baseline as lint_baseline
from ray_tpu_torch.devtools.lint.checkers import kernel_purity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LINT = RefTwin("test_lint", record={"lint": None}, renames=[
    ("ray_tpu/", "ray_tpu_torch/"),
    ('os.path.join(REPO, "scripts", "lint.py")',
     'os.path.join(REPO, "ray_tpu_torch", "scripts", "lint.py")')])
WRITTEN_OUT = ("TestKernelPurity",)
TWINNED = LINT.twin_classes(globals(), skip=WRITTEN_OUT)


def test_every_reference_test_is_twinned_or_written_out():
    import test_lint

    ref = [f"{c}.{m}" for c, cls in vars(test_lint).items()
           if c.startswith("Test") and isinstance(cls, type)
           for m in vars(cls) if m.startswith("test_")]
    written = [q for q in ref if q.split(".")[0] in WRITTEN_OUT]
    assert sorted(TWINNED + written) == sorted(ref) and len(ref) == 35
    assert len(written) == 6
    assert sorted(f"TestKernelPurity.{m}" for m in vars(TestKernelPurity)
                  if m.startswith("test_")) == sorted(
        written + ["TestKernelPurity.test_undeclared_passes_flagged"])


def test_the_port_lints_clean_with_an_empty_baseline():
    """0 findings on ``ray_tpu_torch/`` without any baseline; the port's
    baseline file is its own, and empty; kernel-purity sees the port's
    passes: the JAX scheduler's ``jax.jit`` programs and the chain
    collapse."""
    path = os.path.join(REPO, lint_baseline.BASELINE_NAME)
    assert lint_baseline.BASELINE_NAME == ".raylint_torch_baseline.json"
    with open(path, "r", encoding="utf-8") as fh:
        assert json.load(fh)["suppressions"] == []
    result = run_lint(REPO, paths=["ray_tpu_torch/"], use_baseline=False)
    assert not result.parse_errors and result.findings == [], \
        "\n".join(f.format() for f in result.findings)
    assert result.files_scanned > 100
    project, _ = load_project(REPO)
    _, names = kernel_purity._declared_passes(
        project.get(kernel_purity.KERNEL_PATH))
    jitted = {n.name for n in ast.parse(real_source(
        "ray_tpu/scheduler/kernel.py")).body
        if isinstance(n, ast.FunctionDef) and n.decorator_list}
    assert len(jitted) == 5
    assert sorted(names) == sorted(jitted | {"schedule_dag_collapsed"})


# ------------------------------------------------- kernel-purity, in torch

def make_project(tmp_path, files):
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    project, errors = load_project(str(tmp_path))
    assert not errors, errors
    return project


def lint(tmp_path, files, rules):
    project = make_project(tmp_path, files)
    return run_lint(str(tmp_path), rules=rules, use_baseline=False,
                    project=project).findings


def real_source(relpath: str) -> str:
    with open(os.path.join(REPO, relpath), "r", encoding="utf-8") as fh:
        return fh.read()


class TestKernelPurity:
    """Written-out twins of test_lint.py::TestKernelPurity."""

    RULE = ["kernel-purity"]

    FILES_CLEAN = {
        "ray_tpu_torch/scheduler/kernel.py": """
            import torch

            PASSES = ("my_pass",)

            def my_pass(x):
                return torch.add(x, 1)
            """,
        "ray_tpu_torch/scheduler/reference.py": """
            def my_pass_reference(x):
                return x + 1
            """,
        "tests/test_torch_sched.py": """
            def test_identity():
                assert my_pass(1) == my_pass_reference(1)
            """,
    }

    def test_clean_pair_passes(self, tmp_path):
        assert lint(tmp_path, self.FILES_CLEAN, self.RULE) == []

    def test_missing_reference_flagged(self, tmp_path):
        files = dict(self.FILES_CLEAN)
        files["ray_tpu_torch/scheduler/reference.py"] = \
            "def other():\n    pass\n"
        findings = lint(tmp_path, files, self.RULE)
        assert any("no `my_pass_reference`" in f.message for f in findings)

    def test_missing_property_test_flagged(self, tmp_path):
        files = dict(self.FILES_CLEAN)
        del files["tests/test_torch_sched.py"]
        files["tests/test_torch_other.py"] = "def test_nothing():\n    pass\n"
        # a JAX package's test naming both is not the port's property test
        files["tests/test_sched.py"] = self.FILES_CLEAN[
            "tests/test_torch_sched.py"]
        findings = lint(tmp_path, files, self.RULE)
        assert any("property" in f.message for f in findings)

    def test_impure_jit_body_flagged(self, tmp_path):
        files = dict(self.FILES_CLEAN)
        files["ray_tpu_torch/scheduler/kernel.py"] = """\
import time
import torch

PASSES = ("my_pass",)

def my_pass(x):
    t = time.time()
    print(x)
    noise = torch.rand(x.shape)
    return torch.add(x, t) + noise
"""
        findings = lint(tmp_path, files, self.RULE)
        msgs = " | ".join(f.message for f in findings)
        assert "time.time" in msgs and "print" in msgs
        assert "torch.rand" in msgs and "torch.add" not in msgs
        assert len(findings) == 3

    def test_shared_spec_helper_exempt(self, tmp_path):
        files = {
            "ray_tpu_torch/scheduler/kernel.py": """
                PASSES = ("draw_bits",)

                def draw_bits(key):
                    return key

                def draw_bits_host(key):
                    return draw_bits(key)
                """,
            "ray_tpu_torch/scheduler/reference.py": """
                from .kernel import draw_bits_host
                """,
        }
        assert lint(tmp_path, files, self.RULE) == []

    def test_undeclared_passes_flagged(self, tmp_path):
        """No PASSES tuple, one that is not all string literals, or a name
        in it with no function: each is a finding, never a silent pass."""
        files = dict(self.FILES_CLEAN)
        for kernel, want in (
                ("def my_pass(x):\n    return x\n", "declares no `PASSES`"),
                ("NAMES = ('my_pass',)\nPASSES = NAMES\n"
                 "def my_pass(x):\n    return x\n", "declares no `PASSES`"),
                ("PASSES = ('my_pass', 'gone')\n"
                 "def my_pass(x):\n    return x\n", "`gone`, which is no")):
            files["ray_tpu_torch/scheduler/kernel.py"] = kernel
            findings = lint(tmp_path, files, self.RULE)
            assert [f.message for f in findings if want in f.message], \
                [f.message for f in findings]

    def test_mutation_of_real_kernel_module_is_caught(self, tmp_path):
        src = real_source("ray_tpu_torch/scheduler/kernel.py")
        anchor = 'PASSES = ("task_bits",'
        assert src.count(anchor) == 1
        rogue = src.replace(anchor, 'PASSES = ("rogue_pass", "task_bits",')
        rogue += "\n\ndef rogue_pass(x):\n    return x * time.time()\n"
        files = {
            "ray_tpu_torch/scheduler/kernel.py": rogue,
            "ray_tpu_torch/scheduler/reference.py":
                real_source("ray_tpu_torch/scheduler/reference.py"),
            "tests/test_torch_scheduler.py":
                real_source("tests/test_torch_scheduler.py"),
        }
        findings = lint(tmp_path, files, self.RULE)
        assert any("rogue_pass" in f.message and "no `rogue_pass_reference`"
                   in f.message for f in findings)
        assert any("time.time" in f.message for f in findings)
        # ... and the unmutated originals stay clean.
        files["ray_tpu_torch/scheduler/kernel.py"] = src
        assert lint(tmp_path, files, self.RULE) == []

