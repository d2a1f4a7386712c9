"""SPMD trainer over a mesh, or the plain trainer on one device
(counterpart: ``ray_tpu/train/mesh_trainer.py``).

Works with any (init_fn, loss_fn) pair: the parameters are a tree of
tensors on ``device`` (the card unless the caller asks for the CPU), a
torch optimizer updates them in place, and the losses of ``train`` stay on
the device until the loop ends.

With a ``mesh`` (``parallel.make_mesh``) every rank makes the same trainer:
the same init from ``seed``, then its shard by ``param_shardings``
(``parallel.shard``; none means replicated), its block of each batch by
``batch_spec`` (every rank is given the whole batch), and after each
backward the gradients averaged over dp and sp (DDP's rule; a loss that is
a mean over its batch then gives the whole batch's gradient). The
optimizer, elementwise, steps the shards. ``loss_fn`` returns this rank's
loss, and the trainer owns the global mean: ``train`` and ``evaluate``
report the mean over dp and sp (one scalar collective a report; the
models' ``loss_fn(..., mesh)``, already the global mean, comes out
unchanged). ``save`` gathers parameters and optimizer state to
the single-device format and rank 0 writes it; ``restore`` shards such a
file again, so checkpoints move between meshes and one device.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from .. import Device, default_device
from .._tree import to_device, tree_leaves, tree_map
from ..parallel.collectives import (_reduce_raw, all_reduce_mean,
                                    reduce_gradients)
from ..parallel.mesh import Mesh, gather, map_specs, shard

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


def load_optimizer_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """``opt.load_state_dict(state)`` that keeps ``opt``'s own
    hyperparameters (learning rate, betas, decay): a checkpoint carries the
    moments and steps, as the JAX package's optax state does, while the
    learning rate stays the one the trainer was built with (a PBT exploit
    restores the donor's state under the explored rate)."""
    kept = [{k: v for k, v in g.items() if k != "params"}
            for g in opt.param_groups]
    opt.load_state_dict(state)
    for group, hyper in zip(opt.param_groups, kept):
        group.update(hyper)


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
        is accepted and has no effect: the update is in place. With a
        ``mesh`` the device is the mesh's."""
        if mesh is None and (param_shardings is not None
                             or batch_spec is not None):
            raise ValueError("param_shardings and batch_spec need a mesh")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a ray_tpu_torch.parallel Mesh, "
                            f"not {type(mesh).__name__}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            default_device(device)
        self.loss_fn = loss_fn
        self.param_shardings = param_shardings
        self.batch_spec = batch_spec
        params = init_fn(torch.Generator(device=self.device).manual_seed(seed))
        if mesh is not None:
            params = shard(params, param_shardings, mesh)
        params = tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(True), params)
        make = optimizer or adamw(learning_rate)
        self.state = TrainState(params=params,
                                opt_state=make(tree_leaves(params)))

    def _local(self, batch):
        """The batch on the device, and this rank's block of it."""
        batch = to_device(batch, self.device)
        if self.mesh is not None and self.batch_spec is not None:
            batch = shard(batch, self.batch_spec, self.mesh)
        return batch

    def _global_mean(self, losses: torch.Tensor) -> torch.Tensor:
        """The ranks' losses averaged over dp and sp: the one place the
        trainer reduces a loss."""
        if self.mesh is None:
            return losses
        return all_reduce_mean(losses, self.mesh, ("dp", "sp"))

    # ------------------------------------------------------------------ train
    def _train_step_async(self, batch) -> torch.Tensor:
        """One step; returns the loss as a device scalar, unread, so the
        host queues the next step while the device runs this one."""
        opt = self.state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.state.params, self._local(batch))
        loss.backward()
        reduce_gradients(tree_leaves(self.state.params), self.mesh)
        opt.step()
        self.state.step += 1
        return loss.detach()

    def train_step(self, batch) -> float:
        return self._global_mean(self._train_step_async(batch)).item()

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
        if losses:
            losses = self._global_mean(torch.stack(losses)).tolist()
        return {
            "loss": sum(losses) / max(len(losses), 1),
            "last_loss": losses[-1] if losses else float("nan"),
            "num_steps": num_steps,
            "steps_per_s": num_steps / dt if dt > 0 else float("inf"),
            "time_s": dt,
        }

    def evaluate(self, data: Iterable, num_batches: int) -> Dict[str, float]:
        it = iter(data)
        with torch.no_grad():
            losses = [self.loss_fn(self.state.params, self._local(next(it)))
                      for _ in range(num_batches)]
        total = (self._global_mean(torch.stack(losses)).sum().item()
                 if losses else 0.0)
        return {"val_loss": total / max(num_batches, 1)}

    # ------------------------------------------------------------- checkpoint
    def _leaf_specs(self) -> list:
        """Each parameter leaf's spec, in leaf order."""
        specs = []
        map_specs(lambda _, spec: specs.append(spec), self.state.params,
                  self.param_shardings)
        return specs

    def _opt_tree(self, sd: dict, fn) -> dict:
        """The optimizer state dict ``sd`` with ``fn(tensor, spec)`` applied
        to each parameter's tensors of one dim or more (Adam's moments,
        laid out as the parameter; its step count is a scalar); a new
        dict, ``sd`` left as it is."""
        specs = self._leaf_specs()
        state = {i: {k: (fn(v, specs[i]) if isinstance(v, torch.Tensor)
                         and v.dim() > 0 else v) for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {**sd, "state": state}

    def save(self, path: str) -> None:
        """Write the checkpoint; under a mesh every rank calls it, the
        parameters and optimizer state are gathered whole, rank 0 writes
        and every rank returns once the file is there."""
        if self.mesh is None:
            self.state.save(path)
            return
        state = TrainState(
            params=gather(self.state.params, self.param_shardings, self.mesh),
            opt_state=self._opt_tree(
                self.state.opt_state.state_dict(),
                lambda v, spec: gather(v, spec, self.mesh)),
            step=self.state.step)
        if self.mesh.rank == 0:
            state.save(path)
        _reduce_raw(torch.zeros(()), self.mesh, self.mesh.axis_names)

    def restore(self, path: str) -> None:
        """Load a checkpoint into the live parameters and optimizer (under a
        mesh, this rank's shard of it)."""
        loaded = TrainState.load(path)
        params, opt_sd = loaded.params, loaded.opt_state
        if self.mesh is not None:
            params = shard(params, self.param_shardings, self.mesh)
            opt_sd = self._opt_tree(opt_sd, lambda v, spec: shard(
                v, spec, self.mesh))
        with torch.no_grad():
            for own, new in zip(tree_leaves(self.state.params),
                                tree_leaves(params)):
                own.copy_(new)
        load_optimizer_state(self.state.opt_state, opt_sd)
        self.state.step = loaded.step
