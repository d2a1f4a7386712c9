"""Single-controller trainer (counterpart: ``ray_tpu/train/mesh_trainer.py``)
on one device.

Works with any (init_fn, loss_fn) pair: the parameters are a tree of
tensors on ``device`` (the card unless the caller asks for the CPU), a
torch optimizer updates them in place, and the losses of ``train`` stay on
the device until the loop ends. This is the JAX package's trainer with no
mesh, "the plain single-chip trainer". Its ``mesh``, ``param_shardings``
and ``batch_spec`` come with the parallelism slice (A7b) of ROADMAP.md.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from .. import Device, default_device
from .._tree import to_device, tree_leaves, tree_map

# A factory of the optimizer over the parameter leaves (a torch optimizer
# binds to its tensors).
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def adamw(learning_rate: float) -> OptimizerFactory:
    """AdamW at ``learning_rate`` with weight decay 1e-4: the JAX package's
    ``optax.adamw(learning_rate)``, whose default decay that is (torch's
    own default is 0.01)."""
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4)


def host(leaf):
    """A tensor leaf detached and on the host; any other leaf as it is."""
    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf


@dataclass
class TrainState:
    """The parameters, the optimizer (live), and the step. ``save`` writes
    the parameters and ``opt_state.state_dict()`` on the host; ``load``
    returns them as a TrainState whose ``opt_state`` is that state dict."""
    params: Any
    opt_state: Any
    step: int = 0

    def save(self, path: str) -> None:
        opt = self.opt_state
        if isinstance(opt, torch.optim.Optimizer):
            opt = opt.state_dict()
        with open(path, "wb") as f:
            pickle.dump({"params": tree_map(host, self.params),
                         "opt_state": tree_map(host, opt),
                         "step": self.step}, f)

    @classmethod
    def load(cls, path: str) -> "TrainState":
        with open(path, "rb") as f:
            data = pickle.load(f)
        return cls(params=data["params"], opt_state=data["opt_state"],
                   step=data["step"])


class MeshTrainer:
    def __init__(
        self,
        init_fn: Callable[[torch.Generator], Any],   # generator -> params
        loss_fn: Callable[[Any, Any], torch.Tensor],  # (params, batch)
        *,
        optimizer: Optional[OptimizerFactory] = None,  # default AdamW
        learning_rate: float = 3e-4,
        mesh=None,
        param_shardings=None,
        batch_spec=None,
        seed: int = 0,
        donate: bool = True,
        device: Device = None,
    ):
        """``init_fn`` gets a ``torch.Generator`` on ``device`` seeded with
        ``seed``. ``optimizer`` maps the parameter leaves to a torch
        optimizer; the default is AdamW at ``learning_rate`` with weight
        decay 1e-4, the JAX package's ``optax.adamw`` default. ``donate``
        is accepted and has no effect: the update is in place."""
        if mesh is not None or param_shardings is not None or \
                batch_spec is not None:
            raise NotImplementedError(
                "MeshTrainer's mesh, param_shardings and batch_spec are not "
                "ported yet; they come with the parallelism slice (A7b) of "
                "ROADMAP.md")
        self.device = default_device(device)
        self.loss_fn = loss_fn
        params = tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(True),
            init_fn(torch.Generator(device=self.device).manual_seed(seed)))
        make = optimizer or adamw(learning_rate)
        self.state = TrainState(params=params,
                                opt_state=make(tree_leaves(params)))

    # ------------------------------------------------------------------ train
    def _train_step_async(self, batch) -> torch.Tensor:
        """One step; returns the loss as a device scalar, unread, so the
        host queues the next step while the device runs this one."""
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.state.params, to_device(batch, self.device))
        loss.backward()
        opt.step()
        self.state.step += 1
        return loss.detach()

    def train_step(self, batch) -> float:
        return self._train_step_async(batch).item()

    def train(self, data: Iterable, num_steps: int) -> Dict[str, float]:
        """Runs ``num_steps`` over ``data``; returns throughput stats
        (mirrors TorchTrainer.train's stats dict). Losses stay on the
        device until the end of the loop — no per-step host sync."""
        it = iter(data)
        losses = []
        t0 = time.perf_counter()
        for _ in range(num_steps):
            losses.append(self._train_step_async(next(it)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        losses = [loss.item() for loss in losses]
        return {
            "loss": sum(losses) / max(len(losses), 1),
            "last_loss": losses[-1] if losses else float("nan"),
            "num_steps": num_steps,
            "steps_per_s": num_steps / dt if dt > 0 else float("inf"),
            "time_s": dt,
        }

    def evaluate(self, data: Iterable, num_batches: int) -> Dict[str, float]:
        it = iter(data)
        total = 0.0
        with torch.no_grad():
            for _ in range(num_batches):
                total += self.loss_fn(self.state.params,
                                      to_device(next(it), self.device)).item()
        return {"val_loss": total / max(num_batches, 1)}

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        self.state.save(path)

    def restore(self, path: str) -> None:
        """Load a checkpoint into the live parameters and optimizer."""
        loaded = TrainState.load(path)
        with torch.no_grad():
            for own, new in zip(tree_leaves(self.state.params),
                                tree_leaves(loaded.params)):
                own.copy_(new)
        self.state.opt_state.load_state_dict(loaded.opt_state)
        self.state.step = loaded.step
