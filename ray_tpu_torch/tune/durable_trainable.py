"""DurableTrainable: checkpoints that survive node loss
(reference: python/ray/tune/durable_trainable.py).

Every ``save()`` uploads the checkpoint directory to durable storage keyed
by (trial id, iteration); ``restore()`` transparently syncs the checkpoint
back down when the local path is gone — which is exactly the state of a
trial rescheduled onto a fresh node after its original host (and local
disk) died.

Config keys: ``__upload_dir__`` (the durable root; required), optional
``__syncer__`` (a tune.syncer.Syncer; defaults to LocalSyncer), and
optional ``__keep_durable_num__`` (newest-K durable checkpoints retained
per trial, default 3; 0/None keeps everything). Pruning happens on save —
durable storage must not grow one directory per iteration forever while
the local CheckpointManager rotates only local copies.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .syncer import LocalSyncer, Syncer
from .trainable import Trainable


class DurableTrainable(Trainable):
    def __init__(self, config: Optional[Dict] = None, **kwargs):
        config = dict(config or {})
        self._upload_dir: Optional[str] = config.get("__upload_dir__")
        self._syncer: Syncer = config.get("__syncer__") or LocalSyncer()
        self._keep_durable = config.get("__keep_durable_num__", 3)
        super().__init__(config, **kwargs)

    # -- durable key layout -------------------------------------------------
    def _remote_dir_for(self, checkpoint_dir: str) -> str:
        return os.path.join(self._upload_dir, self.trial_id,
                            os.path.basename(checkpoint_dir.rstrip("/")))

    # -- overrides ----------------------------------------------------------
    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        path = super().save(checkpoint_dir)
        if self._upload_dir:
            local = path if os.path.isdir(path) else os.path.dirname(path)
            ok = self._syncer.sync_up(local, self._remote_dir_for(local))
            if not ok:
                raise RuntimeError(
                    f"durable checkpoint upload failed for {local}")
            self._prune_remote()
        return path

    def _prune_remote(self) -> None:
        """Keep only the newest ``__keep_durable_num__`` durable
        checkpoints (by their checkpoint_N suffix)."""
        if not self._keep_durable:
            return
        root = os.path.join(self._upload_dir, self.trial_id)
        try:
            entries = os.listdir(root)
        except OSError:
            return

        def iter_no(name: str) -> int:
            try:
                return int(name.rsplit("_", 1)[-1])
            except ValueError:
                return -1

        ckpts = sorted((e for e in entries
                        if iter_no(e) >= 0 and not e.endswith((".old",
                                                               ".staging"))),
                       key=iter_no)
        for stale in ckpts[:-self._keep_durable]:
            self._syncer.delete(os.path.join(root, stale))

    def restore(self, checkpoint_path: str) -> None:
        if not os.path.exists(checkpoint_path) and self._upload_dir:
            # Fresh node: the local disk never saw this checkpoint — pull
            # it from durable storage (reference behavior:
            # durable_trainable.py storage_client.sync_down before restore).
            # The gone path may name the checkpoint dir itself or a file
            # inside it; try both interpretations against the remote key.
            candidates = [checkpoint_path, os.path.dirname(checkpoint_path)]
            for local in candidates:
                if local and self._syncer.sync_down(
                        self._remote_dir_for(local), local):
                    break
            else:
                raise FileNotFoundError(
                    f"checkpoint {checkpoint_path} not found locally or "
                    f"under {os.path.join(self._upload_dir, self.trial_id)}")
        super().restore(checkpoint_path)

    def delete_remote_checkpoint(self, checkpoint_dir: str) -> None:
        if self._upload_dir:
            self._syncer.delete(self._remote_dir_for(checkpoint_dir))


def make_durable(trainable_cls: type) -> type:
    """Upgrade any Trainable subclass to the durable save/restore behavior
    (reference: tune.durable(...))."""
    if issubclass(trainable_cls, DurableTrainable):
        return trainable_cls

    class Durable(DurableTrainable, trainable_cls):
        pass

    Durable.__name__ = f"Durable{trainable_cls.__name__}"
    return Durable
