"""The port's tune library against the JAX package's, on the CPU: twins of
every test of tests/test_tune.py and tests/test_tune_durable.py.

Each twin runs the reference test's own program twice (``LibTwin``, a
``RefTwin``): as written, against the JAX package, and with its module
paths renamed to the port's, each half on a fresh local runtime and from
the same seeds of the global ``random`` and of numpy's, which tune's
samplers and PBT draw from. Every call that the test's own code makes into
the library is recorded with its result, or the type of the error it
raised: ``tune.run``'s trials (status, config, last result without its
clock and id, failures, error, the checkpoints kept), the variants,
``explore``'s mutations, the schedulers' decisions, the trainables' results
and checkpoints, the syncer's answers and BOHB's suggestions. The two
records must be equal, and each half passes the reference's assertions.
Where thread timing decides which trials a scheduler cuts or which configs
an adaptive searcher proposes (ASHA, PBT, SuggestSearcher, BOHB under
ASHA), the record keeps each trial's status and error only, and the port
is held to what the reference test asserts.

``LibTwin`` is shared by tests/test_torch_util.py and
tests/test_torch_projects.py. The rest of this file holds the port's own
names and its ``GPU`` resource request."""

import contextlib
import functools
import importlib
import inspect
import math
import os
import random
import sys
import tempfile
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_wire_codec import JAX, PORT, RefTwin, _norm, _Recorded

SEED = 0
ROOTS = {JAX: ray_tpu, PORT: ray_tpu_torch}


def runtime_fixture(rt, **init_kw):
    """A ``local_ray``-style fixture of ``rt``'s package: a fresh local
    runtime for the test, shut down after it."""

    @pytest.fixture
    def fixture():
        if not rt.is_initialized():
            rt.init(**init_kw)
        yield
        rt.shutdown()

    return fixture


def _plain(value):
    """A recorded value: floats rounded to 12 digits (the two packages'
    arithmetic is the same Python), containers element by element."""
    if isinstance(value, float):
        return value if not math.isfinite(value) else round(value, 12)
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, dict):
        return {_plain(k): _plain(v) for k, v in value.items()}
    return _norm(value)


_CLOCK_KEYS = ("trial_id", "time_this_iter_s", "time_total_s")


def result_of(result):
    """A trainable's result without its clock readings and trial id."""
    if not isinstance(result, dict):
        return _plain(result)
    return _plain({k: v for k, v in result.items() if k not in _CLOCK_KEYS})


def path_of(path):
    """A checkpoint path by its last two components and whether it is
    there (the rest is a temporary directory); a trainable's own temporary
    log directory (``trainable_<trial id>_<random>``) by its prefix."""
    if not isinstance(path, str):
        return _plain(path)
    parts = os.path.normpath(path).split(os.sep)[-2:]
    parts = ["trainable_*" if p.startswith("trainable_") else p
             for p in parts]
    return ("/".join(parts), os.path.exists(path))


def _checkpoint(ckpt):
    if ckpt is None:
        return None
    if ckpt.storage == "memory":
        return ("memory", bool(ckpt.value), result_of(ckpt.result))
    return ("disk", path_of(ckpt.value), result_of(ckpt.result))


def analysis_of(analysis, loose=False):
    """``tune.run``'s trials in creation order: status and error always;
    config, last result, failures and checkpoints kept unless ``loose``."""
    out = []
    for t in analysis.trials:
        entry = {"status": t.status, "error": t.error_msg is not None}
        if not loose:
            entry.update(
                config=_plain({k: v for k, v in t.config.items()
                               if not k.startswith("__")}),
                result=result_of(t.last_result),
                failures=t.num_failures,
                newest=_checkpoint(t.checkpoint),
                kept=[_checkpoint(c) for c in
                      t.checkpoint_manager.best_checkpoints()])
        out.append(entry)
    return out


def listed(value):
    return [_plain(v) for v in value]


def as_set(value):
    return sorted((_plain(v) for v in value), key=repr)


class LibTwin(RefTwin):
    """A reference test module of the library layer, run through both
    packages. ``patches`` maps a module of the package (``""`` is its root,
    else a dotted path under it) to ``{attribute: normalizer}``, where the
    attribute may be ``Class.method``; each call that the reference test's
    own code makes (its caller's globals are the test module's) appends
    ``(name, normalizer(result))`` or ``(name, "raised", type)`` to the
    record; a normalizer made by ``consumed`` gets an iterator's items as
    a list and the caller gets them back as a fresh iterator. ``record``
    names module globals of the reference test to record as ``RefTwin``
    does. ``loose`` names tests whose ``tune.run`` record keeps only each trial's
    status and error. ``fixtures`` maps a fixture name to each package's
    version (those the reference takes from tests/conftest.py), and
    ``autouse`` names the reference module's autouse fixtures."""

    def __init__(self, ref, patches, *, renames=(), loose=(), fixtures=None,
                 autouse=(), record=None):
        super().__init__(ref, record=record or {}, renames=(
            ("from ray_tpu import", "from ray_tpu_torch import"),
            *renames))
        self.patches, self.loose = patches, set(loose)
        self.autouse = tuple(autouse)
        for name, by_pkg in (fixtures or {}).items():
            for pkg, fixture in by_pkg.items():
                setattr(self.mods[pkg], name, fixture)

    def _recorder(self, fn, log, name, norm, mod):
        owner_thread = threading.get_ident()

        def call(*args, **kwargs):
            caller = sys._getframe(1).f_globals
            if caller is not mod.__dict__ \
                    or threading.get_ident() != owner_thread:
                return fn(*args, **kwargs)
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:
                log.append((name, "raised", type(e).__name__))
                raise
            if getattr(norm, "consumes", False):
                out = list(out)
                log.append((name, norm(out)))
                return iter(out)
            log.append((name, norm(out)))
            return out

        return call

    def _run_one(self, pkg, qualname, params):
        mod = self.mods[pkg]
        fn_name = qualname.rpartition(".")[2]
        loose = fn_name in self.loose
        random.seed(SEED)
        np.random.seed(SEED)
        log: list = []
        mp = pytest.MonkeyPatch()
        try:
            for path, attrs in self.patches.items():
                root = ROOTS[pkg].__name__
                module = importlib.import_module(
                    f"{root}.{path}" if path else root)
                for attr, norm in attrs.items():
                    owner_name, _, name = attr.rpartition(".")
                    owner = getattr(module, owner_name) if owner_name \
                        else module
                    if norm is analysis_of and loose:
                        norm = functools.partial(analysis_of, loose=True)
                    mp.setattr(owner, name, self._recorder(
                        getattr(owner, name), log, f"{path}.{attr}", norm,
                        mod))
            for name, names in self.record.items():
                mp.setattr(mod, name,
                           _Recorded(getattr(mod, name), log, name, names))
            with contextlib.ExitStack() as stack:
                memo: dict = {}
                for name in self.autouse:
                    self._fixture(mod, None, name, params, stack, memo)
                fn = getattr(mod, fn_name)
                kwargs = {n: self._fixture(mod, None, n, params, stack, memo)
                          for n in inspect.signature(fn).parameters}
                fn(**kwargs)
        finally:
            mp.undo()
        return log


def consumed(norm):
    """``norm`` for a call that returns an iterator (``LibTwin`` consumes
    it into a list first)."""
    def f(items):
        return norm(items)
    f.consumes = True
    return f


_TUNE_PATCHES = {
    "tune": {"run": analysis_of,
             "generate_variants": consumed(listed)},
    "tune.schedulers": {
        "explore": _plain,
        "AsyncHyperBandScheduler.on_trial_result": _plain,
        "MedianStoppingRule.on_trial_result": _plain},
    "tune.trainable": {"Trainable.train": result_of,
                       "Trainable.save": path_of},
    "tune.durable_trainable": {"DurableTrainable.save": path_of},
    "tune.syncer": {"LocalSyncer.sync_up": _plain,
                    "LocalSyncer.sync_down": _plain,
                    "LocalSyncer.delete": _plain},
    "tune.suggest": {"BOHBSearcher.next_trial_config": _plain,
                     "BOHBSearcher.is_finished": _plain,
                     "SuggestSearcher.is_finished": _plain},
}
_LOOSE = ("test_asha_stops_bad_trials", "test_pbt_end_to_end",
          "test_suggest_searcher_adaptive", "test_bohb_with_tune_run_and_asha")
_LOCAL_RAY = {"local_ray": {JAX: runtime_fixture(ray_tpu, num_cpus=8),
                            PORT: runtime_fixture(ray_tpu_torch, num_cpus=8)}}

TUNE = LibTwin("test_tune", _TUNE_PATCHES, loose=_LOOSE, fixtures=_LOCAL_RAY)
TUNE_DURABLE = LibTwin(
    "test_tune_durable", _TUNE_PATCHES, loose=_LOOSE, fixtures=_LOCAL_RAY,
    # The port's cluster runs on the card unless asked for the CPU.
    renames=[('Cluster(head_resources={"CPU": 2}, num_workers=1)',
              'Cluster(head_resources={"CPU": 2}, num_workers=1, '
              'device="cpu")')])
TWINNED = TUNE.twin_classes(globals(), module_class="TestTune") \
    + TUNE_DURABLE.twin_classes(globals(), module_class="TestTuneDurable")


@pytest.fixture(autouse=True)
def _both_shut_down():
    yield
    for rt in ROOTS.values():
        rt.shutdown()


def test_every_reference_test_is_twinned():
    import test_tune
    import test_tune_durable

    ref = [n for m in (test_tune, test_tune_durable) for n in vars(m)
           if n.startswith("test_")]
    assert sorted(TWINNED) == sorted(ref) and len(ref) == 25
    slow = TestTuneDurable.test_durable_trial_resumes_on_fresh_node
    assert [m.name for m in slow.pytestmark] == ["slow"]


# ------------------------------------------------------ the port's own names

def test_the_ports_results_dir_is_its_own():
    from ray_tpu.tune import result as jresult
    from ray_tpu_torch.tune import result as tresult

    assert jresult.DEFAULT_RESULTS_DIR == "/tmp/ray_tpu_results"
    assert tresult.DEFAULT_RESULTS_DIR == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_results")
    assert tresult.DEFAULT_RESULTS_DIR != jresult.DEFAULT_RESULTS_DIR


def _accelerator_probe(rt):
    class Probe(rt.tune.Trainable):
        """Reports the accelerator left free while the trial's actor
        holds its share."""

        def setup(self, config):
            self.key = config["key"]

        def step(self):
            return {"free": rt.available_resources().get(self.key, 0.0),
                    "done": True}

        def save_checkpoint(self, d):
            return d

        def load_checkpoint(self, p):
            pass

    return Probe


@pytest.mark.parametrize("rt,key,init_kw", [
    (ray_tpu, "TPU", {"num_tpus": 1}),
    (ray_tpu_torch, "GPU", {"num_gpus": 1})],
    ids=["jax-TPU", "port-GPU"])
def test_a_trials_accelerator_request_reaches_its_actor(rt, key, init_kw,
                                                        tmp_path):
    """``resources_per_trial={"GPU": 0.5}`` holds half of the port's GPU
    while the trial runs (``num_gpus`` on its actor), as ``{"TPU": 0.5}``
    holds half of the JAX package's TPU; both come back after the run."""
    import ray_tpu.tune  # noqa: F401
    import ray_tpu_torch.tune  # noqa: F401

    rt.init(num_cpus=2, **init_kw)
    analysis = rt.tune.run(
        _accelerator_probe(rt), config={"key": key},
        resources_per_trial={"CPU": 1, key: 0.5},
        local_dir=str(tmp_path), verbose=0)
    assert analysis.trials[0].status == "TERMINATED"
    assert analysis.trials[0].last_result["free"] == 0.5
    assert rt.available_resources().get(key) == 1.0


@pytest.mark.parametrize("rt,key", [(ray_tpu, "TPU"), (ray_tpu_torch, "GPU")],
                         ids=["jax-TPU", "port-GPU"])
def test_an_accelerator_trial_without_the_accelerator_errors(rt, key,
                                                            tmp_path):
    """With no accelerator in the runtime, a trial that asks for one never
    starts (on the CPU or anywhere): it ends in ERROR for want of the
    resource and ``tune.run`` raises, in both packages."""
    import ray_tpu.tune  # noqa: F401
    import ray_tpu_torch.tune  # noqa: F401

    rt.init(num_cpus=2)
    assert key not in rt.cluster_resources()
    with pytest.raises(RuntimeError, match="insufficient cluster resources"):
        rt.tune.run(_accelerator_probe(rt), config={"key": key},
                    resources_per_trial={"CPU": 1, key: 0.5},
                    local_dir=str(tmp_path), verbose=0)
