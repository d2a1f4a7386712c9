"""Trial: one hyperparameter configuration's lifecycle.

Reference behavior: ``python/ray/tune/trial.py`` — status machine
PENDING → RUNNING → {PAUSED, TERMINATED, ERROR}; holds config, resources,
checkpoints, and last result.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional

from .checkpoint_manager import Checkpoint, CheckpointManager


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(self, trainable_cls: type, config: Dict,
                 *, experiment_tag: str = "",
                 resources: Optional[Dict[str, float]] = None,
                 stopping_criterion: Optional[Dict[str, Any]] = None,
                 checkpoint_freq: int = 0,
                 checkpoint_at_end: bool = False,
                 keep_checkpoints_num: Optional[int] = None,
                 checkpoint_score_attr: str = "training_iteration",
                 max_failures: int = 0,
                 trial_id: Optional[str] = None):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.trainable_cls = trainable_cls
        self.config = dict(config)
        self.experiment_tag = experiment_tag
        self.resources = resources or {"CPU": 1}
        self.stopping_criterion = stopping_criterion or {}
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_at_end = checkpoint_at_end
        self.max_failures = max_failures

        self.status = Trial.PENDING
        self.last_result: Dict = {}
        self.num_failures = 0
        self.error_msg: Optional[str] = None
        self.runner = None  # actor handle while RUNNING
        score_attr = checkpoint_score_attr or "training_iteration"
        mode = "min" if score_attr.startswith("min-") else "max"
        self.checkpoint_manager = CheckpointManager(
            keep_num=keep_checkpoints_num,
            score_attr=score_attr.replace("min-", ""),
            mode=mode,
        )
        # In-memory checkpoint for PAUSE/resume and PBT exploit.
        self.paused_state: Optional[bytes] = None
        self.restore_path: Optional[str] = None

    @property
    def checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint_manager.newest

    def should_stop(self, result: Dict) -> bool:
        for key, threshold in self.stopping_criterion.items():
            if result.get(key, float("-inf")) >= threshold:
                return True
        return bool(result.get("done"))

    def should_checkpoint(self) -> bool:
        it = self.last_result.get("training_iteration", 0)
        return self.checkpoint_freq > 0 and it % self.checkpoint_freq == 0

    def is_finished(self) -> bool:
        return self.status in (Trial.TERMINATED, Trial.ERROR)

    def __repr__(self):
        name = getattr(self.trainable_cls, "__name__", "trainable")
        return f"{name}_{self.experiment_tag or self.trial_id}"
