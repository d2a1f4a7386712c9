"""Process entry points for cluster components.

``python -m ray_tpu_torch.cluster.launch head --port P`` starts the GCS (and
optionally a colocated node controller); ``... node --gcs H:P`` starts a
NodeController. Reference counterpart: ``python/ray/node.py`` +
``services.py`` process supervision, collapsed into one module because our
head has no redis/plasma/raylet trio to babysit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys


def _install_sigterm(stop_event: asyncio.Event) -> None:
    """Graceful SIGTERM: lets the finally-blocks run so the shm arena is
    unlinked (a SIGKILL'd controller leaks its segment until reboot)."""
    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop_event.set)
        loop.add_signal_handler(signal.SIGINT, stop_event.set)
    except (NotImplementedError, RuntimeError):
        pass


async def run_head(port: int, resources: dict, num_workers: int,
                   with_node: bool = True, worker_env: dict | None = None,
                   persist: str | None = None,
                   standby_of: tuple | None = None,
                   device: str | None = None):
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.cluster.gcs import GcsServer

    import os

    config = get_config()
    # Fault-injection plan for this head (off unless env knobs are set):
    # frame drop/delay/partition install into the protocol layer; the
    # kill/pause timers model leader death and a hung leader.
    chaos.install_from_env()
    chaos.arm_head_timers()
    gcs = GcsServer(config, port=port, persist_path=persist,
                    standby_of=standby_of, device=device)
    gcs_port = await gcs.start()
    print(json.dumps({"event": "gcs_started", "port": gcs_port,
                      "role": "standby" if standby_of else "leader",
                      "pid": os.getpid()}), flush=True)
    if standby_of is not None:
        # A standby head runs no colocated controller until promoted: its
        # GCS is read-only and nodes belong to the leader.
        with_node = False
    node_stop = None
    if with_node:
        # The controller does blocking RPCs to the GCS, so it must live on
        # its own event loop (thread); sharing the GCS loop deadlocks.
        import threading

        node_stop = threading.Event()

        def node_thread():
            asyncio.run(run_node(
                "127.0.0.1", gcs_port, resources, num_workers,
                worker_env=worker_env, stop_signal=node_stop,
            ))

        threading.Thread(target=node_thread, daemon=True).start()
    stop = asyncio.Event()
    _install_sigterm(stop)
    try:
        await stop.wait()
    finally:
        if node_stop is not None:
            # Wake the colocated controller's loop so its finally block
            # (worker terminate + arena unlink) actually runs.
            node_stop.set()
            await asyncio.sleep(0.5)
        await gcs.stop()


async def run_node(gcs_host: str, gcs_port: int, resources: dict,
                   num_workers: int, worker_env: dict | None = None,
                   stop_signal=None, label: str = ""):
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.cluster.controller import NodeController

    config = get_config()
    node = NodeController(
        config, (gcs_host, gcs_port), resources, num_workers=num_workers,
        worker_env=worker_env, label=label,
    )
    port = await node.start()
    print(json.dumps({"event": "node_started", "port": port,
                      "node_id": node.node_id}), flush=True)
    stop = asyncio.Event()
    _install_sigterm(stop)
    try:
        if stop_signal is not None:
            # Colocated controller: woken by the head's SIGTERM handler
            # (threading.Event — this loop is not the signal-owning thread).
            while not stop_signal.is_set():
                await asyncio.sleep(0.2)
        else:
            await stop.wait()
    finally:
        await node.stop()


def main():
    from ray_tpu_torch._private.stack_dump import register_stack_dump

    register_stack_dump()
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="role", required=True)

    head = sub.add_parser("head")
    head.add_argument("--port", type=int, default=0)
    head.add_argument("--resources", default='{"CPU": 4}')
    head.add_argument("--num-workers", type=int, default=2)
    head.add_argument("--no-node", action="store_true")
    head.add_argument("--worker-env", default="{}")
    head.add_argument("--persist", default=None,
                      help="snapshot file for GCS state (restart recovery)")
    head.add_argument("--standby", action="store_true",
                      help="start as a warm standby: read-only, tails the "
                           "leader named by --peer over the wire, promotes "
                           "itself when the leadership lease expires "
                           "(requires --persist on the SAME shared store "
                           "as the leader)")
    head.add_argument("--device", default=None,
                      help="device of the GCS's placement passes "
                           "(default: the card; 'cpu' names the CPU)")
    head.add_argument("--peer", default=None,
                      help="leader address host:port to tail (--standby)")

    node = sub.add_parser("node")
    node.add_argument("--gcs", required=True)
    node.add_argument("--resources", default='{"CPU": 4}')
    node.add_argument("--num-workers", type=int, default=2)
    node.add_argument("--worker-env", default="{}")
    node.add_argument("--label", default="",
                      help="provider node id for the autoscaler")

    args = parser.parse_args()
    worker_env = json.loads(args.worker_env)
    try:
        if args.role == "head":
            standby_of = None
            if args.standby:
                if not args.peer or not args.persist:
                    parser.error("--standby requires --peer and --persist "
                                 "(shared with the leader)")
                peer_host, peer_port = args.peer.rsplit(":", 1)
                standby_of = (peer_host, int(peer_port))
            asyncio.run(run_head(
                args.port, json.loads(args.resources), args.num_workers,
                with_node=not args.no_node, worker_env=worker_env,
                persist=args.persist, standby_of=standby_of,
                device=args.device,
            ))
        else:
            host, port = args.gcs.rsplit(":", 1)
            asyncio.run(run_node(
                host, int(port), json.loads(args.resources),
                args.num_workers, worker_env=worker_env, label=args.label,
            ))
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
