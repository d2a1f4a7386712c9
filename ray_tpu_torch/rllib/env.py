"""Environment API (reference: rllib/env/).

The reference wraps gym; this image has no gym, so the Env protocol is defined
here natively (same reset/step contract) together with vectorization and two
built-in numpy envs used throughout tests and examples. VectorEnv steps all
sub-envs and returns stacked arrays — the natural shape for a policy on
the card (one batched forward pass instead of E scalar ones).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Env:
    """Minimal env protocol (mirrors gym.Env as used by rllib/env/)."""

    observation_dim: int
    num_actions: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, Dict]:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        pass


class CartPole(Env):
    """Classic cart-pole balance, numpy re-implementation of the standard
    dynamics (reference tests use gym's CartPole-v0)."""

    observation_dim = 4
    num_actions = 2

    def __init__(self, max_steps: int = 200):
        self.max_steps = max_steps
        self.rng = np.random.RandomState(0)
        self.state: Optional[np.ndarray] = None
        self.t = 0

    def seed(self, seed: int) -> None:
        self.rng = np.random.RandomState(seed)

    def reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self.t = 0
        return self.state.copy()

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(theta), np.sin(theta)
        # Standard parameters: gravity 9.8, cart 1.0, pole 0.1, length 0.5.
        temp = (force + 0.05 * theta_dot**2 * sinth) / 1.1
        theta_acc = (9.8 * sinth - costh * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * costh**2 / 1.1))
        x_acc = temp - 0.05 * theta_acc * costh / 1.1
        tau = 0.02
        self.state = np.array(
            [x + tau * x_dot, x_dot + tau * x_acc,
             theta + tau * theta_dot, theta_dot + tau * theta_acc],
            dtype=np.float32)
        self.t += 1
        done = bool(
            abs(self.state[0]) > 2.4 or abs(self.state[2]) > 0.2095
            or self.t >= self.max_steps)
        return self.state.copy(), 1.0, done, {}


class StatelessBandit(Env):
    """A k-armed bandit: one step per episode, reward = 1 for the lucky arm.

    Strong, immediate learning signal — used by fast policy-improvement tests
    where CartPole would be too slow (analogue of the reference's mock envs in
    rllib/tests).
    """

    observation_dim = 1
    num_actions = 4

    def __init__(self, best_arm: int = 2):
        self.best_arm = best_arm

    def reset(self) -> np.ndarray:
        return np.zeros(1, dtype=np.float32)

    def step(self, action: int):
        reward = 1.0 if int(action) == self.best_arm else 0.0
        return np.zeros(1, dtype=np.float32), reward, True, {}


class TaskBandit(Env):
    """A task-distribution bandit for meta-RL (reference: the TaskSettableEnv
    protocol MAML trains over, rllib/env/env_context.py + maml's env reqs).

    A *task* is which arm pays out. ``sample_tasks(n)`` draws tasks,
    ``set_task(t)`` switches the env. A meta-learned policy cannot do better
    than uniform before adaptation (the task is unobservable) but should
    adapt to any task from one small support batch.
    """

    observation_dim = 1
    num_actions = 4

    def __init__(self, task: int = 0):
        self.task = task
        self.rng = np.random.RandomState(0)

    def seed(self, seed: int) -> None:
        self.rng = np.random.RandomState(seed)

    def sample_tasks(self, n: int) -> List[int]:
        return [int(t) for t in self.rng.randint(self.num_actions, size=n)]

    def set_task(self, task: int) -> None:
        self.task = int(task)

    def reset(self) -> np.ndarray:
        return np.zeros(1, dtype=np.float32)

    def step(self, action: int):
        reward = 1.0 if int(action) == self.task else 0.0
        return np.zeros(1, dtype=np.float32), reward, True, {}


class ContinuousEnv(Env):
    """Continuous-action env protocol: ``action_dim`` replaces
    ``num_actions``; actions are float arrays in [-1, 1]^action_dim
    (reference: rllib's Box action spaces)."""

    action_dim: int = 0
    num_actions: int = 0


class MoveToTarget(ContinuousEnv):
    """One-step continuous control: obs is a random target in [-1,1]^d,
    reward = -||action - target||^2. The continuous analogue of
    StatelessBandit: optimal policy copies the observation, so actor-critic
    methods show learning in a handful of iterations."""

    observation_dim = 2
    action_dim = 2

    def __init__(self):
        self.rng = np.random.RandomState(0)
        self.target: Optional[np.ndarray] = None

    def seed(self, seed: int) -> None:
        self.rng = np.random.RandomState(seed)

    def reset(self) -> np.ndarray:
        self.target = self.rng.uniform(-0.8, 0.8, 2).astype(np.float32)
        return self.target.copy()

    def step(self, action):
        err = float(np.sum((np.asarray(action) - self.target) ** 2))
        return self.target.copy(), -err, True, {}


class VectorEnv:
    """E independent copies stepped in lockstep (reference: rllib/env/vector_env.py).

    Observations come back stacked [E, obs_dim] so the policy runs one batched
    forward pass; done sub-envs auto-reset. Continuous envs
    (``action_dim > 0``) receive float action vectors; discrete ones ints.
    """

    def __init__(self, make_env, num_envs: int, base_seed: int = 0):
        self.envs: List[Env] = [make_env() for _ in range(num_envs)]
        for i, e in enumerate(self.envs):
            e.seed(base_seed + i)
        self.num_envs = num_envs
        self.observation_dim = self.envs[0].observation_dim
        self.num_actions = self.envs[0].num_actions
        self.action_dim = getattr(self.envs[0], "action_dim", 0)
        self.episode_rewards = np.zeros(num_envs)
        self.episode_lens = np.zeros(num_envs, dtype=np.int64)
        self.completed: List[Tuple[float, int]] = []  # (reward, length)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Dict]]:
        obs, rews, dones, infos = [], [], [], []
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, d, info = env.step(a if self.action_dim else int(a))
            self.episode_rewards[i] += r
            self.episode_lens[i] += 1
            if d:
                self.completed.append(
                    (float(self.episode_rewards[i]), int(self.episode_lens[i])))
                self.episode_rewards[i] = 0.0
                self.episode_lens[i] = 0
                o = env.reset()
            obs.append(o)
            rews.append(r)
            dones.append(d)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, dtype=np.float32),
                np.asarray(dones), infos)

    def pop_episode_stats(self) -> List[Tuple[float, int]]:
        out = self.completed
        self.completed = []
        return out


class MultiAgentEnv:
    """Dict-keyed multi-agent protocol (reference: rllib/env/multi_agent_env.py).

    ``reset() -> {agent_id: obs}``;
    ``step({agent_id: action}) -> (obs_dict, reward_dict, done_dict, info_dict)``
    where ``done_dict["__all__"]`` ends the episode. Only agents present in
    the returned obs dict act on the next step — agents may come and go.
    """

    observation_dim: int
    num_actions: int

    def reset(self) -> Dict[Any, np.ndarray]:
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, int]) -> Tuple[
            Dict[Any, np.ndarray], Dict[Any, float], Dict[Any, bool],
            Dict[Any, Dict]]:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        pass


class MultiAgentBandit(MultiAgentEnv):
    """N independent one-step bandits under one env: agent i's reward is 1
    when it pulls its own lucky arm. The fastest possible behavior test for
    independent multi-agent learning (analogue of the reference's
    BasicMultiAgent mock, rllib/tests/test_multi_agent_env.py)."""

    observation_dim = 1
    num_actions = 4

    def __init__(self, num_agents: int = 2):
        self.num_agents = num_agents
        self.best_arms = [(2 * i + 1) % self.num_actions
                          for i in range(num_agents)]

    def reset(self) -> Dict[Any, np.ndarray]:
        obs = np.zeros(1, dtype=np.float32)
        return {i: obs.copy() for i in range(self.num_agents)}

    def step(self, action_dict):
        rewards = {
            i: 1.0 if int(a) == self.best_arms[i] else 0.0
            for i, a in action_dict.items()
        }
        obs = {i: np.zeros(1, dtype=np.float32) for i in action_dict}
        dones = {i: True for i in action_dict}
        dones["__all__"] = True
        return obs, rewards, dones, {i: {} for i in action_dict}


class TwoStepGame(MultiAgentEnv):
    """The cooperative two-step matrix game used to motivate QMIX
    (reference: rllib/examples/twostep_game.py; Rashid et al. 2018).

    Step 1: agent 0's action picks the payoff matrix (0 -> safe, 1 -> risky).
    Step 2: the joint action is paid out to BOTH agents:
      safe:  always 7.
      risky: [[0, 1], [1, 8]] — 8 requires both agents to coordinate on 1.
    Optimal return is 8; independent greedy learners typically settle on 7.
    Observations: one-hot of (step, chosen branch) + the agent's index.
    """

    observation_dim = 4
    num_actions = 2

    def __init__(self):
        self.stage = 0
        self.branch = 0

    def _obs(self):
        base = np.zeros(4, dtype=np.float32)
        base[self.stage] = 1.0
        base[2] = float(self.branch)
        out = {}
        for i in range(2):
            o = base.copy()
            o[3] = float(i)
            out[i] = o
        return out

    def reset(self):
        self.stage = 0
        self.branch = 0
        return self._obs()

    def step(self, action_dict):
        if self.stage == 0:
            self.branch = int(action_dict[0])
            self.stage = 1
            obs = self._obs()
            return (obs, {0: 0.0, 1: 0.0}, {"__all__": False, 0: False,
                                            1: False}, {0: {}, 1: {}})
        a0, a1 = int(action_dict[0]), int(action_dict[1])
        if self.branch == 0:
            reward = 7.0
        else:
            reward = [[0.0, 1.0], [1.0, 8.0]][a0][a1]
        obs = self._obs()
        return (obs, {0: reward, 1: reward},
                {"__all__": True, 0: True, 1: True}, {0: {}, 1: {}})


_ENV_REGISTRY = {
    "CartPole": CartPole,
    "StatelessBandit": StatelessBandit,
    "MoveToTarget": MoveToTarget,
    "MultiAgentBandit": MultiAgentBandit,
    "TaskBandit": TaskBandit,
    "TwoStepGame": TwoStepGame,
}


def register_env(name: str, creator) -> None:
    """Register a custom env creator (reference: tune/registry.py register_env)."""
    _ENV_REGISTRY[name] = creator


def make_env(spec: Any) -> Env:
    if isinstance(spec, str):
        try:
            return _ENV_REGISTRY[spec]()
        except KeyError:
            raise ValueError(
                f"unknown env {spec!r}; registered: {sorted(_ENV_REGISTRY)}"
            ) from None
    if callable(spec):
        return spec()
    raise TypeError(f"env spec must be str or callable, got {type(spec)}")
