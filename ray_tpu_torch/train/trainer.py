"""Elastic actor-based data-parallel trainer (counterpart:
``ray_tpu/train/trainer.py``).

Mirrors the reference's TorchTrainer contract
(``python/ray/util/sgd/torch/torch_trainer.py:39``): N worker actors each
hold a data shard and compute gradients; the trainer averages them, steps
the optimizer, and survives worker death (``max_retries`` + elastic
resize). Gradients move through the object store as trees of tensors.

The workers are actors with a CPU share and no ``GPU`` share, so several
share one card, and they run on ``device`` (the card unless the caller
asks for the CPU). The local runtime hands a CUDA tensor over without a
copy, so each worker copies the driver's parameters into leaves of its
own before its backward: two workers that marked the driver's tensors as
requiring grad would accumulate into the same ``.grad``.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import Device, api as _api, default_device
from .._tree import to_device, tree_leaves, tree_map
from ..exceptions import (
    ActorDiedError,
    ClusterUnavailableError,
    NodeDiedError,
    ObjectLostError,
    WorkerCrashedError,
)
from ..remote_function import remote
from .mesh_trainer import (OptimizerFactory, adamw, host,
                           load_optimizer_state)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _own_leaves(params: Any, device: torch.device) -> Any:
    """Parameters as fresh tensors on ``device`` that no one else holds."""
    return tree_map(lambda t: t.detach().to(device, copy=True), params)


def _make_worker_class(num_cpus: float):
    @remote(num_cpus=num_cpus)
    class TrainWorker:
        """One data-parallel rank: builds params deterministically (same
        seed everywhere), iterates its data shard, returns gradients."""

        def setup(self, init_fn, loss_fn, data_creator, rank, world_size,
                  config, seed, device):
            self.rank = rank
            self.world_size = world_size
            self.config = config
            self.device = torch.device(device)
            self.params = _own_leaves(
                init_fn(_generator(seed, self.device)), self.device)
            self.loss_fn = loss_fn
            self._data = iter(data_creator(rank, world_size, config))
            return rank

        def set_params(self, params):
            with torch.no_grad():
                for own, new in zip(tree_leaves(self.params),
                                    tree_leaves(params)):
                    own.copy_(new)
            return True

        def compute_grads(self, params=None):
            """One local batch -> (loss, grads). The trainer may push fresh
            params inline to save a round trip."""
            if params is not None:
                self.set_params(params)
            batch = to_device(next(self._data), self.device)
            leaves = tree_leaves(self.params)
            for p in leaves:
                p.grad = None
                p.requires_grad_(True)
            loss = self.loss_fn(self.params, batch)
            loss.backward()
            grads = tree_map(
                lambda p: (p.grad if p.grad is not None
                           else torch.zeros_like(p)).detach(), self.params)
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
            return loss.item(), grads

        def evaluate(self, num_batches):
            total = 0.0
            with torch.no_grad():
                for _ in range(num_batches):
                    batch = to_device(next(self._data), self.device)
                    total += self.loss_fn(self.params, batch).item()
            return total / max(num_batches, 1)

        def shutdown(self):
            return True

    return TrainWorker


class TPUTrainer:
    def __init__(
        self,
        init_fn: Callable,                   # generator -> params
        loss_fn: Callable,                   # (params, batch) -> scalar loss
        data_creator: Callable,              # (rank, world, config) -> iter
        *,
        optimizer: Optional[OptimizerFactory] = None,  # default AdamW
        learning_rate: float = 3e-4,
        num_workers: int = 2,
        config: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_retries: int = 3,
        num_cpus_per_worker: float = 1,
        device: Device = None,
    ):
        """``init_fn`` gets a ``torch.Generator`` on ``device`` seeded with
        ``seed``, the same in every rank. ``optimizer`` maps the list of
        parameter leaves to a torch optimizer (a torch optimizer binds to
        its tensors); the default is AdamW at ``learning_rate`` with weight
        decay 1e-4, the JAX package's ``optax.adamw`` default."""
        self.device = default_device(device)
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.data_creator = data_creator
        self.config = config or {}
        self.seed = seed
        self.max_retries = max_retries
        self.num_workers = num_workers
        self._worker_cls = _make_worker_class(num_cpus_per_worker)

        self.params = _own_leaves(init_fn(_generator(seed, self.device)),
                                  self.device)
        self.optimizer = (optimizer or adamw(learning_rate))(
            tree_leaves(self.params))
        self.step = 0
        self.workers: List[Any] = []
        self._start_workers(num_workers)

    # ---------------------------------------------------------------- workers
    def _start_workers(self, count: int):
        """(Re)build the worker set at ``count`` ranks — the reference's
        ``_start_workers``/``_resize_workers`` (torch_trainer.py:298,688)."""
        for w in self.workers:
            try:
                _api.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self.workers = [self._worker_cls.remote() for _ in range(count)]
        _api.get([
            w.setup.remote(self.init_fn, self.loss_fn, self.data_creator,
                           rank, count, self.config, self.seed,
                           str(self.device))
            for rank, w in enumerate(self.workers)
        ])
        self._sync_params()

    def _sync_params(self):
        params_ref = _api.put(self.params)
        _api.get([w.set_params.remote(params_ref) for w in self.workers])

    # ------------------------------------------------------------------ train
    def _try_one_step(self) -> float:
        params_ref = _api.put(self.params)
        futures = [w.compute_grads.remote(params_ref) for w in self.workers]
        results = _api.get(futures)
        losses = [loss for loss, _ in results]
        grad_trees = [grads for _, grads in results]
        mean_grads = tree_map(lambda *gs: sum(gs) / len(gs), *grad_trees)
        for p, g in zip(tree_leaves(self.params), tree_leaves(mean_grads)):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return sum(losses) / len(losses)

    def train(self, num_steps: int = 1) -> Dict[str, float]:
        """Runs synchronous DP steps; on worker failure, rebuilds the worker
        set and retries (up to max_retries per train call)."""
        losses = []
        retries = 0
        t0 = time.perf_counter()
        while len(losses) < num_steps:
            try:
                losses.append(self._try_one_step())
            except (ActorDiedError, WorkerCrashedError,
                    ClusterUnavailableError, NodeDiedError, ObjectLostError):
                retries += 1
                if retries > self.max_retries:
                    raise
                # Elastic recovery: respawn the full worker set; params and
                # optimizer state live on the trainer, so nothing is lost.
                self._start_workers(self.num_workers)
        dt = time.perf_counter() - t0
        return {
            "loss": sum(losses) / max(len(losses), 1),
            "last_loss": losses[-1] if losses else float("nan"),
            "num_steps": num_steps,
            "step": self.step,
            "retries": retries,
            "steps_per_s": num_steps / dt if dt > 0 else float("inf"),
        }

    def validate(self, num_batches: int = 1) -> Dict[str, float]:
        self._sync_params()
        vals = _api.get([w.evaluate.remote(num_batches)
                         for w in self.workers])
        return {"val_loss": sum(vals) / len(vals)}

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        """The parameters and the optimizer's ``state_dict()``, on the
        host, and the step."""
        return {"params": tree_map(host, self.params),
                "optimizer": tree_map(host, self.optimizer.state_dict()),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]):
        with torch.no_grad():
            for own, new in zip(tree_leaves(self.params),
                                tree_leaves(state["params"])):
                own.copy_(new)
        load_optimizer_state(self.optimizer, state["optimizer"])
        self.step = state["step"]
        self._sync_params()

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)
        return path

    def restore(self, path: str):
        with open(path, "rb") as f:
            self.load_state_dict(pickle.load(f))

    # -------------------------------------------------------------- lifecycle
    def resize(self, num_workers: int):
        """Elastic resize (reference torch_trainer.py:688)."""
        self.num_workers = num_workers
        self._start_workers(num_workers)

    def shutdown(self):
        for w in self.workers:
            try:
                _api.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []

    # ---------------------------------------------------------------- tune
    @classmethod
    def as_trainable(cls, init_fn, loss_fn, data_creator, **trainer_kwargs):
        """A tune Trainable wrapping this trainer (reference:
        torch_trainer.py:717 TorchTrainer.as_trainable). Tune config keys
        matching constructor kwargs (learning_rate, num_workers, seed, ...)
        override; the rest flow into the trainer's user config. A
        ``device`` key reaches the trainer, and ``cleanup`` shuts the
        trainer's workers down."""
        import os

        from ..tune.trainable import Trainable

        ctor_keys = {"optimizer", "learning_rate", "num_workers", "seed",
                     "max_retries", "num_cpus_per_worker", "device"}

        class TPUTrainerTrainable(Trainable):
            def setup(self, config):
                kwargs = dict(trainer_kwargs)
                user_cfg = dict(kwargs.pop("config", {}) or {})
                for k, v in (config or {}).items():
                    if k.startswith("__"):
                        continue
                    if k in ctor_keys:
                        kwargs[k] = v
                    else:
                        user_cfg[k] = v
                self.trainer = cls(init_fn, loss_fn, data_creator,
                                   config=user_cfg, **kwargs)

            def step(self):
                return self.trainer.train()

            def save_checkpoint(self, checkpoint_dir):
                self.trainer.save(os.path.join(checkpoint_dir, "trainer.pkl"))
                return checkpoint_dir

            def load_checkpoint(self, checkpoint_path):
                if os.path.isdir(checkpoint_path):
                    checkpoint_path = os.path.join(
                        checkpoint_path, "trainer.pkl")
                self.trainer.restore(checkpoint_path)

            def cleanup(self):
                self.trainer.shutdown()

        TPUTrainerTrainable.__name__ = f"{cls.__name__}Trainable"
        return TPUTrainerTrainable
