"""ExternalEnv: environments that drive their own loop
(reference: rllib/env/external_env.py).

Instead of the framework stepping the env, the ENV (e.g. a web service, a
simulator with its own clock) calls in: ``start_episode`` /
``get_action(obs)`` / ``log_returns(reward)`` / ``end_episode``. The env
runs on its own thread; ``ExternalEnvSampler`` serves its action queries
with a policy and assembles the experience into SampleBatches identical to
the vectorized path's, so any on-policy trainer can learn from it.
"""

from __future__ import annotations

import queue
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from .sample_batch import (
    ACTIONS, DONES, LOGPS, NEXT_OBS, OBS, REWARDS, SampleBatch, VF_PREDS,
    compute_gae,
)


class ExternalEnv(threading.Thread):
    """Subclass and implement ``run()`` as the external control loop, using
    the four-call episode API from inside it."""

    observation_dim: int
    num_actions: int

    def __init__(self):
        super().__init__(daemon=True)
        self._requests: "queue.Queue" = queue.Queue()
        self._episodes: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    # ---- API used by run() ------------------------------------------------
    def start_episode(self, episode_id: Optional[str] = None) -> str:
        eid = episode_id or uuid.uuid4().hex
        with self._lock:
            self._episodes[eid] = {"pending_reward": 0.0, "rows": []}
        return eid

    def get_action(self, episode_id: str, obs: np.ndarray):
        """Block until the serving policy answers."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._requests.put(("action", episode_id, np.asarray(obs), reply))
        return reply.get()

    def log_returns(self, episode_id: str, reward: float) -> None:
        with self._lock:
            ep = self._episodes.get(episode_id)
            if ep is not None:
                ep["pending_reward"] += float(reward)

    def end_episode(self, episode_id: str, obs: np.ndarray) -> None:
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._requests.put(("end", episode_id, np.asarray(obs), reply))
        reply.get()

    def run(self) -> None:  # pragma: no cover - subclass responsibility
        raise NotImplementedError


class ExternalEnvSampler:
    """Serves an ExternalEnv's queries with ``policy`` and collects the
    resulting experience (reference: external_env.py's ExternalEnvWrapper +
    the sampler integration in rollout_worker.py)."""

    def __init__(self, env: ExternalEnv, policy, config: Dict[str, Any]):
        self.env = env
        self.policy = policy
        self.config = dict(config)
        self.completed: List = []
        if not env.is_alive():
            env.start()

    def sample(self, num_steps: int = 64) -> SampleBatch:
        """Answer ``num_steps`` action queries; returns the post-processed
        batch (GAE-advantaged, same schema as RolloutWorker.sample)."""
        served = 0
        fragments: List[SampleBatch] = []
        while served < num_steps:
            kind, eid, obs, reply = self.env._requests.get()
            with self.env._lock:
                ep = self.env._episodes[eid]
            if kind == "action":
                # Close out the previous row's transition.
                if ep["rows"]:
                    prev = ep["rows"][-1]
                    prev[REWARDS] = ep["pending_reward"]
                    prev[NEXT_OBS] = obs
                    prev[DONES] = 0.0
                ep["pending_reward"] = 0.0
                action, logp, vf = self.policy.compute_actions(obs[None])
                ep["rows"].append({
                    OBS: obs, ACTIONS: int(action[0]),
                    LOGPS: float(logp[0]) if logp is not None else 0.0,
                    VF_PREDS: float(vf[0]) if vf is not None else 0.0,
                    REWARDS: 0.0, NEXT_OBS: obs, DONES: 0.0,
                })
                served += 1
                reply.put(int(action[0]))
            else:  # end
                if ep["rows"]:
                    last = ep["rows"][-1]
                    last[REWARDS] = ep["pending_reward"]
                    last[NEXT_OBS] = obs
                    last[DONES] = 1.0
                    fragments.append(self._postprocess(ep["rows"]))
                    self.completed.append(
                        (sum(r[REWARDS] for r in ep["rows"]),
                         len(ep["rows"])))
                with self.env._lock:
                    del self.env._episodes[eid]
                reply.put(None)
        # Flush any open episodes' collected rows (bootstrapped).
        with self.env._lock:
            open_eps = list(self.env._episodes.values())
        for ep in open_eps:
            if ep["rows"]:
                fragments.append(self._postprocess(ep["rows"]))
                ep["rows"] = []
        return SampleBatch.concat_samples(fragments)

    def _postprocess(self, rows: List[Dict]) -> SampleBatch:
        b = SampleBatch({
            k: np.asarray([r[k] for r in rows], dtype=np.float32)
            for k in (OBS, ACTIONS, LOGPS, VF_PREDS, REWARDS, DONES)
        } | {
            OBS: np.stack([np.asarray(r[OBS], np.float32) for r in rows]),
            NEXT_OBS: np.stack(
                [np.asarray(r[NEXT_OBS], np.float32) for r in rows]),
        })
        last_done = bool(b[DONES][-1])
        last_value = 0.0 if last_done else float(
            self.policy.value(b[NEXT_OBS][-1:])[0])
        return compute_gae(b, last_value, self.config.get("gamma", 0.99),
                           self.config.get("lambda", 0.95))

    def episode_stats(self) -> List:
        out, self.completed = self.completed, []
        return out
