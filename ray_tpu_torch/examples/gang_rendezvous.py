"""Gang-scheduled multi-process rendezvous via placement groups + GCS kv
(counterpart: ``examples/gang_rendezvous.py``).

The workload placement groups exist for: an N-process worker gang (think
one process per GPU host of a multi-host mesh) that is useless unless ALL
processes get resources — scheduled atomically with
``ray_tpu_torch.placement_group``, one bundle per rank. Rank 0 binds a TCP
listener and publishes its address through the GCS key/value store; every
other rank discovers it there, connects, and the gang runs a checksum
all-reduce over the sockets to prove the full mesh is wired.

    python -m ray_tpu_torch.examples.gang_rendezvous --world-size 4 \
        --strategy SPREAD

Works in local mode or, with RAY_TPU_TORCH_ADDRESS set
(``python -m ray_tpu_torch.scripts.cli submit``),
against a running cluster — where STRICT_SPREAD places one rank per node.
"""

from __future__ import annotations

import argparse
import socket
import time

import ray_tpu_torch


def _kv_key(pg_hex: str) -> bytes:
    return f"rendezvous/{pg_hex}".encode()


@ray_tpu_torch.remote
class GangWorker:
    def __init__(self, rank: int, world_size: int, pg_hex: str):
        self.rank = rank
        self.world_size = world_size
        self.pg_hex = pg_hex
        self.listener = None

    def publish(self) -> str:
        """Rank 0: bind the rendezvous listener and publish host:port
        through the GCS kv so every other rank can find it."""
        from ray_tpu_torch.experimental import _internal_kv_put

        assert self.rank == 0
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(self.world_size)
        addr = f"127.0.0.1:{self.listener.getsockname()[1]}"
        _internal_kv_put(_kv_key(self.pg_hex), addr.encode())
        return addr

    def rendezvous(self, timeout: float = 60.0) -> int:
        """Run the gang handshake; returns the rank checksum every member
        must agree on (sum of all ranks)."""
        if self.rank == 0:
            conns = []
            self.listener.settimeout(timeout)
            for _ in range(self.world_size - 1):
                conn, _ = self.listener.accept()
                conns.append(conn)
            ranks = {0}
            for conn in conns:
                ranks.add(int(conn.recv(64).decode().strip()))
            assert ranks == set(range(self.world_size)), ranks
            checksum = sum(ranks)
            for conn in conns:
                conn.sendall(f"{checksum}\n".encode())
                conn.close()
            self.listener.close()
            return checksum
        from ray_tpu_torch.experimental import _internal_kv_get

        deadline = time.monotonic() + timeout
        addr = None
        while time.monotonic() < deadline:
            blob = _internal_kv_get(_kv_key(self.pg_hex))
            if blob:
                addr = blob.decode()
                break
            time.sleep(0.05)
        assert addr is not None, "rank 0 never published its address"
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=timeout)
        sock.sendall(f"{self.rank}\n".encode())
        checksum = int(sock.recv(64).decode().strip())
        sock.close()
        return checksum


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--world-size", type=int, default=4)
    parser.add_argument("--strategy", default="SPREAD",
                        choices=("PACK", "SPREAD", "STRICT_PACK",
                                 "STRICT_SPREAD"))
    args = parser.parse_args()
    n = args.world_size

    ray_tpu_torch.init(ignore_reinit_error=True)
    pg = ray_tpu_torch.placement_group([{"CPU": 1}] * n, strategy=args.strategy,
                                 name="gang-rendezvous")
    if not pg.wait(60):
        info = ray_tpu_torch.placement_group_table(pg).get(pg.hex, {})
        print(f"gang not schedulable: {info.get('reason', 'timeout')}")
        return 1
    print(f"gang CREATED on nodes "
          f"{[x[:8] for x in ray_tpu_torch.placement_group_table(pg)[pg.hex]['nodes']]}")

    workers = [
        GangWorker.options(placement_group=pg,
                           placement_group_bundle_index=i,
                           num_cpus=1).remote(i, n, pg.hex)
        for i in range(n)
    ]
    addr = ray_tpu_torch.get(workers[0].publish.remote(), timeout=60)
    print(f"rank 0 published {addr}")
    checksums = ray_tpu_torch.get([w.rendezvous.remote() for w in workers],
                            timeout=120)
    expect = n * (n - 1) // 2
    assert all(c == expect for c in checksums), checksums
    print(f"rendezvous complete: world={n} checksum={checksums[0]}")
    ray_tpu_torch.remove_placement_group(pg)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        ray_tpu_torch.shutdown()
    raise SystemExit(rc)
