"""Driver connection to a running cluster (reference: worker.connect,
``python/ray/worker.py:1137``)."""

from __future__ import annotations


def connect_driver(address: str, config):
    """address: "host:port" (or "tcp://host:port") of the GCS."""
    from .core_worker import ClusterCoreWorker

    address = address.replace("tcp://", "")
    host, port = address.rsplit(":", 1)
    return ClusterCoreWorker((host, int(port)), role="driver", config=config)
