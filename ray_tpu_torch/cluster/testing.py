"""Multi-process test cluster.

Reference counterpart: ``python/ray/cluster_utils.py:11`` ``Cluster`` — the
single most important test fixture: N node controllers + 1 GCS as real
separate processes on one machine, with add_node/remove_node for fault
injection (``cluster_utils.py:61,124``).

``Cluster(device=...)`` names the device of the head's placement passes
(the GCS's ``device``): ``None``, the default, is the card and fails
without one; the CPU is used only when named (``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional


def _subprocess_env() -> Dict[str, str]:
    """Ensure spawned components can import ray_tpu_torch from any cwd."""
    import ray_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, port: int, node_id: str = "",
                 log_path: str = ""):
        self.proc = proc
        self.port = port
        self.node_id = node_id
        self.log_path = log_path

    def kill(self):
        """Hard-kill the controller (and its workers die with the tasks)."""
        self.proc.kill()
        self.proc.wait()
        self._unlink_store()

    def _unlink_store(self):
        """SIGKILL skips the controller's atexit unlink; reap the arena
        and the node's spill directory (the crash-scan recovery files
        matter for a RESTARTED controller, not a test-killed one)."""
        if self.node_id:
            try:
                os.unlink(f"/dev/shm/rtts-{self.node_id[:12]}")
            except OSError:
                pass
            import shutil

            spill_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill",
                                     f"rtts-{self.node_id[:12]}")
            shutil.rmtree(spill_dir, ignore_errors=True)


class Cluster:
    """In-process test cluster (reference python/ray/cluster_utils.py:11).

    Note: by default the constructor installs a process-wide SIGTERM handler
    (routing to ``sys.exit(143)`` so atexit cleanup reaps the process tree)
    — but only when no handler is already installed (SIG_DFL check). An
    embedding application that relies on default SIGTERM termination can opt
    out with ``Cluster(reap_on_sigterm=False)``; it then owns cleanup on
    SIGTERM itself (atexit still covers normal exit).
    """

    def __init__(self, head_resources: Optional[Dict[str, float]] = None,
                 num_workers: int = 2, reap_on_sigterm: bool = True,
                 persist_path: Optional[str] = None,
                 head_with_node: bool = True,
                 extra_env: Optional[Dict[str, str]] = None,
                 device: Optional[str] = None):
        self.nodes: List[ClusterNode] = []
        self._head = None
        self.gcs_port: Optional[int] = None
        self.head_pid: Optional[int] = None
        self.head_resources = head_resources or {"CPU": 4}
        self.num_workers = num_workers
        # HA testing hooks: a persisted head can be paired with a warm
        # standby (start_standby) and hard-killed (kill_head) to drive the
        # failover path; extra_env reaches every spawned component (e.g.
        # RAY_TPU_TORCH_GCS_ADDRS so nodes know the standby's address, or the
        # chaos knobs).
        self.persist_path = persist_path
        self.head_with_node = head_with_node
        self._extra_env = dict(extra_env or {})
        self.device = device
        self.standby: Optional[ClusterNode] = None
        self._start_head()
        # A driver that dies without calling shutdown() (crashed script,
        # timed-out tool) must not orphan the process tree: a leaked head +
        # controllers + workers was measured costing ~2x on every co-hosted
        # benchmark. A STRONG reference on purpose — a dropped Cluster must
        # still be reaped at exit (shutdown() unregisters). atexit runs on
        # normal exit and on SIGTERM only because we route SIGTERM through
        # sys.exit below when no handler is installed; SIGKILL still leaks
        # (nothing can run), so `cli stop` remains the manual cleanup.
        import atexit
        import signal
        import sys

        self._atexit_cb = self.shutdown
        atexit.register(self._atexit_cb)
        if reap_on_sigterm:
            try:
                if signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.gcs_port}"

    def _read_event(self, proc: subprocess.Popen, timeout: float = 30.0,
                    log_path: str = "") -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                if proc.poll() is not None:
                    tail = ""
                    if log_path and os.path.exists(log_path):
                        tail = open(log_path).read()[-2000:]
                    raise RuntimeError(f"cluster process died: {tail}")
                time.sleep(0.05)
                continue
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue
        raise TimeoutError("cluster process did not report startup")

    def _device_args(self) -> List[str]:
        return [] if self.device is None else ["--device", str(self.device)]

    def _env(self) -> Dict[str, str]:
        env = _subprocess_env()
        env.update(self._extra_env)
        return env

    def _start_head(self):
        log_path = tempfile.mktemp(prefix="ray_tpu_torch_head_", suffix=".log")
        cmd = [sys.executable, "-m", "ray_tpu_torch.cluster.launch", "head",
               "--resources", json.dumps(self.head_resources),
               "--num-workers", str(self.num_workers),
               *self._device_args()]
        if self.persist_path:
            cmd += ["--persist", self.persist_path]
        if not self.head_with_node:
            cmd += ["--no-node"]
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE, stderr=open(log_path, "w"), text=True,
            env=self._env(),
        )
        self._head = proc
        evt = self._read_event(proc, log_path=log_path)
        assert evt["event"] == "gcs_started"
        self.gcs_port = evt["port"]
        self.head_pid = evt.get("pid")
        if self.head_with_node:
            evt = self._read_event(proc, log_path=log_path)  # colocated node
            assert evt["event"] == "node_started"
            self.nodes.append(ClusterNode(
                proc, evt["port"], evt.get("node_id", ""), log_path))
        else:
            # Track the head process for shutdown even without a node.
            self.nodes.append(ClusterNode(proc, 0, "", log_path))

    # ----------------------------------------------------------------- HA
    def start_standby(self, port: int = 0) -> ClusterNode:
        """Start a warm-standby head tailing the current leader over the
        shared persistent store. It promotes itself when the leader's
        lease expires (see kill_head)."""
        assert self.persist_path, "standby requires Cluster(persist_path=)"
        log_path = tempfile.mktemp(prefix="ray_tpu_torch_standby_", suffix=".log")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.cluster.launch", "head",
             "--standby", "--peer", self.address,
             "--persist", self.persist_path, "--port", str(port),
             "--resources", json.dumps(self.head_resources),
             "--num-workers", str(self.num_workers),
             *self._device_args()],
            stdout=subprocess.PIPE, stderr=open(log_path, "w"), text=True,
            env=self._env(),
        )
        evt = self._read_event(proc, log_path=log_path)
        assert evt["event"] == "gcs_started" and evt.get("role") == "standby"
        node = ClusterNode(proc, evt["port"], "", log_path)
        self.standby = node
        self.nodes.append(node)  # so shutdown() reaps it
        return node

    def kill_head(self) -> Optional[int]:
        """SIGKILL the head process — the hard leader-death drill. Returns
        the dead head's pid. The colocated controller (if any) dies with
        it; a started standby takes over once the lease expires."""
        pid = self.head_pid
        if self._head is not None and self._head.poll() is None:
            self._head.kill()
            self._head.wait()
        for n in list(self.nodes):
            if n.proc is self._head:
                n._unlink_store()
                self.nodes.remove(n)
        return pid

    def wait_for_leader(self, port: int, timeout: float = 30.0) -> dict:
        """Poll ha_status on ``port`` until that head reports leadership
        (standby promotion complete). Returns the ha_status response."""
        from .protocol import RpcClient

        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                client = RpcClient("127.0.0.1", port)
                try:
                    resp = client.call({"type": "ha_status"})
                    last = resp
                    if resp.get("is_leader"):
                        return resp
                finally:
                    client.close()
            except (ConnectionError, OSError, RuntimeError):
                pass
            time.sleep(0.1)
        raise TimeoutError(f"no leader on port {port} "
                           f"within {timeout}s (last: {last})")

    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 num_workers: int = 2,
                 env: Optional[Dict[str, str]] = None) -> ClusterNode:
        """Start one more node process. ``env`` overlays extra variables on
        just this node."""
        log_path = tempfile.mktemp(prefix="ray_tpu_torch_node_", suffix=".log")
        penv = self._env()
        if env:
            penv.update(env)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.cluster.launch", "node",
             "--gcs", self.address,
             "--resources", json.dumps(resources or {"CPU": 4}),
             "--num-workers", str(num_workers)],
            stdout=subprocess.PIPE, stderr=open(log_path, "w"), text=True,
            env=penv,
        )
        evt = self._read_event(proc, log_path=log_path)
        node = ClusterNode(proc, evt["port"], evt.get("node_id", ""), log_path)
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode):
        node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, count: int, timeout: float = 30.0):
        from .protocol import RpcClient

        client = RpcClient("127.0.0.1", self.gcs_port)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                nodes = client.call({"type": "list_nodes"})["nodes"]
                if sum(1 for n in nodes if n["Alive"]) >= count:
                    return
                time.sleep(0.05)
            raise TimeoutError(f"cluster never reached {count} nodes")
        finally:
            client.close()

    def shutdown(self):
        cb = getattr(self, "_atexit_cb", None)
        if cb is not None:
            import atexit

            atexit.unregister(cb)
            self._atexit_cb = None
        for node in self.nodes:
            if node.proc.poll() is None:
                node.proc.terminate()
        for node in self.nodes:
            try:
                node.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                node.proc.kill()
            node._unlink_store()
        self.nodes.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
