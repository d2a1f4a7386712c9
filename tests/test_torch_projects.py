"""The port's metrics registry, dashboard metrics endpoint and project files
against the JAX package's, on the CPU: twins of every test of
tests/test_metrics_projects.py.

Each twin runs the reference test's own program through both packages
(``LibTwin`` of tests/test_torch_tune.py), with the reference's autouse
registry reset run in each half; the record holds every snapshot of
``metrics.collect_all``, every loaded project and every resolved argv or
the type of the error raised, and must be equal between the two. The
project file keeps its name, ``ray-tpu-project.yaml``, in the port: it is
the user's file format."""

import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_tune import ROOTS, LibTwin, runtime_fixture
from test_torch_wire_codec import JAX, PORT

PROJECTS = LibTwin(
    "test_metrics_projects", {}, autouse=("clean_registry",),
    record={"load_project": None, "resolve_command": None,
            "metrics": {"collect_all"}},
    fixtures={"local_ray": {JAX: runtime_fixture(ray_tpu, num_cpus=8),
                            PORT: runtime_fixture(ray_tpu_torch,
                                                  num_cpus=8)}})
TWINNED = PROJECTS.twin_classes(globals(), module_class="TestMetricsProjects")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_metrics_projects

    ref = [n for n in vars(test_metrics_projects) if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 5


def test_the_project_file_keeps_its_name():
    from ray_tpu import projects as jprojects
    from ray_tpu_torch import projects as tprojects

    assert tprojects.PROJECT_FILE == jprojects.PROJECT_FILE \
        == "ray-tpu-project.yaml"


def test_a_project_without_pyyaml_raises_project_error(tmp_path):
    """pyyaml is imported only when a project is loaded: without it,
    importing the module works and loading raises ``ProjectError``."""
    (tmp_path / "ray-tpu-project.yaml").write_text("name: demo\n")
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from ray_tpu_torch.projects import ProjectError, load_project\n"
        "try:\n"
        f"    load_project({str(tmp_path)!r})\n"
        "except ProjectError as e:\n"
        "    print('refused', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "refused pyyaml unavailable"
