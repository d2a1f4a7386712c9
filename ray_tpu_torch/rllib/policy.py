"""Policies: actors and losses as plain functions on tensor trees
(reference: rllib/policy/).

The reference carries four policy stacks (TF1/TF2/eager/torch); here there is
one: params are trees of tensors in the JAX package's layout, and
``update`` builds new tensors from the old and rebinds ``self.params`` in
one assignment, never stepping a tensor in place. So a ``get_weights()``
on another thread (IMPALA's driver while its ``LearnerThread`` steps, A3C's
driver) reads one whole tree, before or after an update, as the JAX
package's immutable arrays give it. Weight transport between learner and
rollout workers is a host-side copy of numpy trees (``get_weights``), which
either package's ``set_weights`` takes.

Every policy runs on ``config["device"]`` (``ray_tpu_torch.default_device``:
the card unless the config names the CPU) and draws from its own
``torch.Generator`` there, seeded from ``config["seed"]``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from .. import default_device
from .._tree import tree_leaves, tree_map
from .models import apply_mlp, gumbel_argmax, init_mlp
from .sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGPS, NEXT_OBS, OBS, REWARDS, SampleBatch,
    VALUE_TARGETS,
)


# ---------------------------------------------------------------------------
# Plumbing shared by every policy of the package.
# ---------------------------------------------------------------------------


def policy_device(config: Dict[str, Any]) -> torch.device:
    """The device a policy of ``config`` runs on."""
    return default_device(config.get("device"))


def policy_generator(config: Dict[str, Any],
                     device: torch.device) -> torch.Generator:
    """The policy's generator on ``device``, seeded where the JAX package
    takes ``PRNGKey(config["seed"])``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config.get("seed", 0)))
    return gen


def to_host(tree):
    """A tree with each tensor copied to a numpy array, other leaves as
    they are (``jax.device_get``)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def to_device(tree, device: torch.device):
    """A numpy (or tensor) tree as float32 tensors on ``device``, copied
    (``jax.device_put``), so later writes to the arrays reach no policy."""
    return tree_map(lambda a: torch.tensor(np.asarray(
        a.detach().cpu() if isinstance(a, torch.Tensor) else a),
        dtype=torch.float32, device=device), tree)


def batch_to(batch, keys: Sequence[str], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """Columns ``keys`` of a SampleBatch as float32 tensors on ``device``
    (integer columns are cast back where a loss indexes with them)."""
    return {k: torch.as_tensor(np.asarray(batch[k], dtype=np.float32),
                               device=device) for k in keys}


def value_and_grad(loss_fn: Callable, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    (loss, aux, grads), with the gradients in ``params``' tree and zeros
    for a leaf the loss does not reach."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, aux = loss_fn(live, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return (loss.detach(), tree_map(lambda t: t.detach(), aux),
            tree_map(lambda _: next(it), params))


def aligned(tree, like) -> List[Any]:
    """``tree``'s leaves in the order of ``like``'s: dicts are matched by
    key, whatever order each holds them in (the JAX package's trees come
    with sorted keys, the port's in the order they were built)."""
    return tree_leaves(tree_map(lambda _, x: x, like, tree))


def rebuilt(leaves: Sequence[Any], like):
    """``leaves``, in ``like``'s order, as a tree of ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class Adam:
    """``optax.adam(lr)`` on trees: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, eps_root 0, bias correction by the step count, through
    PyTorch's fused Adam kernel (one launch for every leaf; optax's
    arithmetic up to the order of its roundings). ``step`` returns new
    parameter and state trees and changes none in place; ``step_`` steps
    given leaves in place (the graphed update's own buffers). The moments
    are trees of the parameters' structure, matched to the parameters by
    key at every step."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        return {"step": torch.zeros((), device=leaves[0].device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def step_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              mu: List[torch.Tensor], nu: List[torch.Tensor],
              step: torch.Tensor) -> None:
        """One step of ``params``, ``mu`` and ``nu`` in place; ``step`` is
        this step's count (1 for the first)."""
        torch._fused_adam_(params, grads, mu, nu, [], [step] * len(params),
                           lr=self.lr, beta1=self.b1, beta2=self.b2,
                           weight_decay=0.0, eps=self.eps, amsgrad=False,
                           maximize=False)

    def step(self, params, grads, state):
        p = [t.clone() for t in tree_leaves(params)]
        mu = [t.clone() for t in aligned(state["mu"], params)]
        nu = [t.clone() for t in aligned(state["nu"], params)]
        step = state["step"] + 1
        self.step_(p, aligned(grads, params), mu, nu, step)
        return rebuilt(p, params), {"step": step, "mu": rebuilt(mu, params),
                                    "nu": rebuilt(nu, params)}


_CAPTURE_LOCK = threading.Lock()


class GraphedUpdate:
    """A policy's minibatch step — its rows gathered by index, the loss,
    the gradients and the Adam step — captured once as a CUDA graph for a
    batch of one shape, and replayed for each minibatch of an update: a
    launch a minibatch where the eager step makes about 140, each taking
    about 10 µs of host time on an H100 host.

    Between ``load`` and ``params_out``/``state_out`` the parameters and
    Adam's state live in the graph's own buffers; an update returns copies
    of them, so the policy still rebinds new tensors and a reader on
    another thread never sees the buffers mid-update. The graph replays
    the eager step's kernels in its order, on the same inputs."""

    def __init__(self, loss_fn: Callable, opt: Adam, params,
                 batch: Dict[str, torch.Tensor], rows: int):
        dev = batch[OBS].device
        self.opt = opt
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.idx = torch.arange(rows, device=dev)
        leaves = tree_leaves(params)
        self.p = [t.clone() for t in leaves]
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = torch.zeros((), device=dev)
        it = iter(self.p)
        self.tree = tree_map(lambda _: next(it), params)
        self.keys: List[str] = []
        self.acc = None

        def step():
            mb = {k: v.index_select(0, self.idx)
                  for k, v in self.batch.items()}
            _, stats, grads = value_and_grad(loss_fn, self.tree, mb)
            self.count.add_(1)
            opt.step_(self.p, tree_leaves(grads), self.mu, self.nu,
                      self.count)
            if self.acc is None:
                self.keys = list(stats)
                self.acc = torch.zeros(len(self.keys), device=dev)
            self.acc.add_(torch.stack([stats[k] for k in self.keys]))

        # One capture at a time in the process (DD-PPO's workers learn on
        # threads of their own), on a stream of its own: the rollout
        # workers launch and sync on the default stream meanwhile, which
        # never syncs with it. No device-wide synchronize, which another
        # thread's capture would refuse.
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                for _ in range(3):
                    step()
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(side)

    def load(self, params, state, batch: Dict[str, torch.Tensor]) -> None:
        torch._foreach_copy_(self.p, aligned(params, self.tree))
        torch._foreach_copy_(self.mu, aligned(state["mu"], self.tree))
        torch._foreach_copy_(self.nu, aligned(state["nu"], self.tree))
        self.count.copy_(state["step"])
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def run(self, idx: torch.Tensor) -> None:
        """One minibatch step on the rows ``idx``."""
        self.idx.copy_(idx)
        self.graph.replay()

    def params_out(self, params):
        return rebuilt([t.clone() for t in aligned(self.tree, params)],
                       params)

    def state_out(self) -> Dict[str, Any]:
        return {"step": self.count.clone(),
                "mu": rebuilt([t.clone() for t in self.mu], self.tree),
                "nu": rebuilt([t.clone() for t in self.nu], self.tree)}


def stats_to_floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One host copy for every scalar of ``stats``."""
    keys = list(stats)
    vals = torch.stack([stats[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def sample_actions(gen, params, obs: torch.Tensor):
    """(action, logp, value) of an actor-critic tree, drawn from ``gen``,
    brought to the host in one copy."""
    logits = apply_mlp(params["pi"], obs)
    action = gumbel_argmax(gen, logits)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, action[:, None])[:, 0]
    value = apply_mlp(params["vf"], obs)[..., 0]
    out = torch.stack([action.float(), logp, value]).cpu().numpy()
    return out[0].astype(np.int32), out[1], out[2]


def greedy_actions(params, obs: torch.Tensor) -> np.ndarray:
    return torch.argmax(apply_mlp(params["pi"], obs), dim=-1).to(
        torch.int32).cpu().numpy()


class Policy:
    """Interface (reference rllib/policy/policy.py)."""

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        raise NotImplementedError

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights) -> None:
        raise NotImplementedError


def make_ppo_loss(clip: float, vf_coeff: float, ent_coeff: float):
    """PPO's clipped surrogate + value regression + entropy bonus:
    ``loss_fn(params, mb) -> (loss, stats)``."""

    def loss_fn(params, mb):
        logits = apply_mlp(params["pi"], mb[OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = mb[ACTIONS].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - mb[LOGPS])
        adv = mb[ADVANTAGES]
        # jnp's std is the population std.
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        vf_pred = apply_mlp(params["vf"], mb[OBS])[..., 0]
        vf_loss = torch.mean((vf_pred - mb[VALUE_TARGETS]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = -torch.mean(surr) + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {"policy_loss": -torch.mean(surr),
                       "vf_loss": vf_loss, "entropy": entropy}

    return loss_fn


class PPOPolicy(Policy):
    """Clipped-surrogate PPO with GAE (reference: rllib/agents/ppo/ppo_tf_policy.py).

    One shared-nothing actor-critic MLP pair; ``update`` runs all SGD epochs
    and minibatches, each epoch over a fresh permutation from the policy's
    generator, and rebinds the parameters once at its end.
    """

    _batch_keys = (OBS, ACTIONS, LOGPS, ADVANTAGES, VALUE_TARGETS)

    def __init__(self, obs_dim: int, num_actions: int, config: Dict[str, Any]):
        self.config = config
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [64, 64])
        self.params = {
            "pi": init_mlp(self.gen, [obs_dim] + hid + [num_actions]),
            "vf": init_mlp(self.gen, [obs_dim] + hid + [1]),
        }
        self.opt = Adam(config.get("lr", 5e-4))
        self.opt_state = self.opt.init(self.params)
        self._loss_fn = make_ppo_loss(
            config.get("clip_param", 0.2), config.get("vf_loss_coeff", 0.5),
            config.get("entropy_coeff", 0.0))
        self.num_epochs = config.get("num_sgd_iter", 8)
        self.mb_size = config.get("sgd_minibatch_size", 128)
        # On the card the update replays a CUDA graph of the minibatch
        # step (False: the eager step, as on the CPU).
        self.graphed = self.device.type == "cuda"
        self._graphs: Dict[int, GraphedUpdate] = {}   # by batch rows

    def permutations(self, n: int) -> List[torch.Tensor]:
        """One permutation of the batch's n rows an epoch, from the policy's
        generator (the JAX package's come from its key; a parity check
        passes those to ``update`` instead)."""
        return [torch.randperm(n, generator=self.gen, device=self.device)
                for _ in range(self.num_epochs)]

    def update(self, params, opt_state, batch: Dict[str, torch.Tensor],
               perms: Sequence[torch.Tensor]):
        """Every epoch's ``n // mb_size`` minibatches in order of its
        permutation (rows past the last whole minibatch sit the epoch out);
        returns (params, opt_state, the last epoch's minibatch means). On
        the card each minibatch replays a ``GraphedUpdate``."""
        n = batch[OBS].shape[0]
        num_mb = max(n // self.mb_size, 1)
        if self.graphed:
            return self._graphed_update(params, opt_state, batch, perms,
                                        num_mb)
        for perm in perms:
            acc = 0
            for i in range(num_mb):
                idx = perm[i * self.mb_size:(i + 1) * self.mb_size]
                mb = {k: v.index_select(0, idx) for k, v in batch.items()}
                _, mb_stats, grads = value_and_grad(self._loss_fn, params, mb)
                params, opt_state = self.opt.step(params, grads, opt_state)
                keys = list(mb_stats)
                # summed in order, as the graph's accumulator sums them
                acc = acc + torch.stack([mb_stats[k] for k in keys])
        return params, opt_state, dict(zip(keys, (acc / num_mb).unbind()))

    def _graphed_update(self, params, opt_state, batch, perms, num_mb):
        n = batch[OBS].shape[0]
        graph = self._graphs.get(n)
        if graph is None:
            graph = self._graphs[n] = GraphedUpdate(
                self._loss_fn, self.opt, params, batch, self.mb_size)
        graph.load(params, opt_state, batch)
        for perm in perms:
            graph.acc.zero_()
            for i in range(num_mb):
                graph.run(perm[i * self.mb_size:(i + 1) * self.mb_size])
        means = (graph.acc / num_mb).unbind()
        return (graph.params_out(params), graph.state_out(),
                dict(zip(graph.keys, means)))

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        params = self.params
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            if explore:
                return sample_actions(self.gen, params, obs)
            return greedy_actions(params, obs), None, None

    def value(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            return apply_mlp(self.params["vf"], obs)[..., 0].cpu().numpy()

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        n = batch.count
        mb = self.mb_size
        if n < mb:
            # pad by repetition so the update always has one full minibatch
            reps = -(-mb // n)
            batch = SampleBatch(
                {k: np.tile(np.asarray(v), (reps,) + (1,) * (np.asarray(v).ndim - 1))[:mb]
                 for k, v in batch.items()})
        dev_batch = batch_to(batch, self._batch_keys, self.device)
        params, opt_state, stats = self.update(
            self.params, self.opt_state, dev_batch,
            self.permutations(batch.count))
        self.params, self.opt_state = params, opt_state
        return stats_to_floats(stats)

    def get_weights(self):
        return to_host(self.params)

    def set_weights(self, weights) -> None:
        self.params = to_device(weights, self.device)


class DQNPolicy(Policy):
    """Double-DQN with a target network (reference: rllib/agents/dqn/).

    Epsilon-greedy exploration from numpy's global state, as the JAX
    package draws it; the TD update is one step over the replay minibatch.
    """

    _batch_keys = (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)

    def __init__(self, obs_dim: int, num_actions: int, config: Dict[str, Any]):
        self.config = config
        self.num_actions = num_actions
        self.device = policy_device(config)
        self.gen = policy_generator(config, self.device)
        hid = config.get("hiddens", [64, 64])
        self.params = init_mlp(self.gen, [obs_dim] + hid + [num_actions])
        self.target_params = tree_map(torch.clone, self.params)
        self.opt = Adam(config.get("lr", 1e-3))
        self.opt_state = self.opt.init(self.params)
        self.initial_epsilon = config.get("initial_epsilon", 1.0)
        self.final_epsilon = config.get("final_epsilon", 0.02)
        self.epsilon_timesteps = config.get("epsilon_timesteps", 10000)
        self.steps = 0
        self.gamma = config.get("gamma", 0.99)

    def loss(self, params, target_params, batch):
        """(mean [weighted] squared TD error, per-row |td|)."""
        q = apply_mlp(params, batch[OBS])
        acts = batch[ACTIONS].long()
        q_sel = q.gather(-1, acts[:, None])[:, 0]
        with torch.no_grad():
            # double-DQN: online net picks argmax, target net evaluates
            next_a = torch.argmax(apply_mlp(params, batch[NEXT_OBS]), dim=-1)
            next_q = apply_mlp(target_params, batch[NEXT_OBS]).gather(
                -1, next_a[:, None])[:, 0]
            target = batch[REWARDS] + self.gamma * (
                1.0 - batch[DONES]) * next_q
        td = q_sel - target.detach()
        weights = batch.get("weights")
        sq = td ** 2 if weights is None else weights * td ** 2
        return torch.mean(sq), torch.abs(td)

    def update(self, params, target_params, opt_state, batch):
        loss, td_abs, grads = value_and_grad(
            lambda p, b: self.loss(p, target_params, b), params, batch)
        params, opt_state = self.opt.step(params, grads, opt_state)
        return params, opt_state, loss, td_abs

    @property
    def epsilon(self) -> float:
        """Schedule-derived (not cached at act time): the learner's reported
        epsilon stays honest even though only rollout actors ever act."""
        frac = min(1.0, self.steps / max(self.epsilon_timesteps, 1))
        return (self.initial_epsilon
                + frac * (self.final_epsilon - self.initial_epsilon))

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            obs = torch.as_tensor(np.asarray(obs, dtype=np.float32),
                                  device=self.device)
            return apply_mlp(self.params, obs).cpu().numpy()

    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        q = self.q_values(obs)
        actions = q.argmax(axis=-1)
        if explore:
            mask = np.random.rand(len(actions)) < self.epsilon
            actions = np.where(
                mask, np.random.randint(self.num_actions, size=len(actions)),
                actions)
            self.steps += len(actions)
        return actions, None, None

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        dev = batch_to(batch, self._batch_keys, self.device)
        if "weights" in batch:  # importance weights from prioritized replay
            dev["weights"] = batch_to(batch, ("weights",), self.device)[
                "weights"]
        params, opt_state, loss, td_abs = self.update(
            self.params, self.target_params, self.opt_state, dev)
        self.params, self.opt_state = params, opt_state
        host = torch.cat([loss[None], td_abs]).cpu().numpy()
        self.last_td_error = host[1:]  # per-row |td| for priorities
        return {"loss": float(host[0]),
                "mean_td_error": float(self.last_td_error.mean()),
                "epsilon": self.epsilon}

    def update_target(self) -> None:
        self.target_params = tree_map(torch.clone, self.params)

    def get_weights(self):
        return to_host({"params": self.params,
                        "target": self.target_params,
                        "steps": self.steps})

    def set_weights(self, weights) -> None:
        # Exact restore (checkpoint semantics). Learner-side trainers that
        # broadcast to sampling actors must advance their own counter from
        # globally sampled steps first (see DQN/Dyna/Apex _train_step), or
        # the sync would reset every actor's epsilon schedule to the
        # never-acting learner's zero.
        self.params = to_device(weights["params"], self.device)
        self.target_params = to_device(weights["target"], self.device)
        self.steps = weights.get("steps", self.steps)
