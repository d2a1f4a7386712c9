"""Checkpoint synchronization to durable storage
(reference: python/ray/tune/syncer.py — the sync client abstraction behind
cloud checkpointing; and durable_trainable.py's remote-storage contract).

No cloud SDKs ship in this image, so the built-in backend targets any
mounted durable path (NFS, fuse-mounted bucket, shared disk) via atomic
directory copies, and ``FunctionSyncer`` adapts user-supplied sync
callables/commands (the reference's ``sync_to_cloud`` template hook).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Optional


class Syncer:
    """sync_up/sync_down/delete between a local dir and durable storage."""

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        raise NotImplementedError

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        raise NotImplementedError

    def delete(self, remote_dir: str) -> bool:
        raise NotImplementedError


class LocalSyncer(Syncer):
    """Durable path reachable through the filesystem.

    Crash-safe upload protocol: copy into ``<dir>.staging``, stamp a
    completion marker, swap via two renames (remote -> ``<dir>.old``,
    staging -> remote). A crash at ANY point leaves at least one
    marker-complete copy: ``sync_down`` falls back to ``.old``, and a
    partially-copied staging dir (no marker) is never trusted. ``.old`` is
    only reclaimed once a marker-complete primary exists again.
    """

    _MARKER = ".sync_complete"

    @classmethod
    def _complete(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, cls._MARKER))

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        if not os.path.isdir(local_dir):
            return False
        remote_dir = remote_dir.rstrip("/")
        staging = remote_dir + ".staging"
        old = remote_dir + ".old"
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(os.path.dirname(remote_dir) or ".", exist_ok=True)
        shutil.copytree(local_dir, staging)
        with open(os.path.join(staging, self._MARKER), "w") as f:
            f.write("ok")
        if os.path.isdir(remote_dir):
            # Only displace .old when the primary exists to replace it —
            # after a crash mid-swap, .old may hold the last durable copy
            # until the rename below completes.
            shutil.rmtree(old, ignore_errors=True)
            os.rename(remote_dir, old)
        os.rename(staging, remote_dir)
        shutil.rmtree(old, ignore_errors=True)
        return True

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        remote_dir = remote_dir.rstrip("/")
        source = None
        for cand in (remote_dir, remote_dir + ".old"):
            if os.path.isdir(cand) and self._complete(cand):
                source = cand
                break
        if source is None:
            return False
        shutil.rmtree(local_dir, ignore_errors=True)
        os.makedirs(os.path.dirname(local_dir) or ".", exist_ok=True)
        shutil.copytree(source, local_dir)
        try:
            os.unlink(os.path.join(local_dir, self._MARKER))
        except OSError:
            pass
        return True

    def delete(self, remote_dir: str) -> bool:
        remote_dir = remote_dir.rstrip("/")
        for cand in (remote_dir, remote_dir + ".old",
                     remote_dir + ".staging"):
            shutil.rmtree(cand, ignore_errors=True)
        return True


class FunctionSyncer(Syncer):
    """Adapts ``fn(source, target) -> bool`` callables (or shell command
    templates with {source}/{target}) for custom storage backends."""

    def __init__(self, sync_up_fn: Callable[[str, str], bool] = None,
                 sync_down_fn: Callable[[str, str], bool] = None,
                 delete_fn: Callable[[str], bool] = None,
                 sync_up_template: Optional[str] = None,
                 sync_down_template: Optional[str] = None):
        self._up = sync_up_fn
        self._down = sync_down_fn
        self._delete = delete_fn
        self._up_tpl = sync_up_template
        self._down_tpl = sync_down_template

    @staticmethod
    def _run(template: str, source: str, target: str) -> bool:
        cmd = template.format(source=source, target=target)
        return subprocess.run(cmd, shell=True).returncode == 0

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        if self._up is not None:
            return bool(self._up(local_dir, remote_dir))
        if self._up_tpl is not None:
            return self._run(self._up_tpl, local_dir, remote_dir)
        return False

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        if self._down is not None:
            return bool(self._down(remote_dir, local_dir))
        if self._down_tpl is not None:
            return self._run(self._down_tpl, remote_dir, local_dir)
        return False

    def delete(self, remote_dir: str) -> bool:
        if self._delete is not None:
            return bool(self._delete(remote_dir))
        return False


def get_syncer(upload_dir: Optional[str]) -> Optional[Syncer]:
    """Default syncer for an upload root (None = durability disabled)."""
    if not upload_dir:
        return None
    return LocalSyncer()
