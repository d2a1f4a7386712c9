"""ray_tpu_torch.streaming: actor dataflow streaming (reference: streaming/).

The reference's streaming library is a C++ data plane (credit-based channels
on plasma queues, streaming/src/channel.h) under a Python DataStream API
(streaming/python/datastream.py). Here the DataStream API compiles to a
JobGraph executed by JobWorker actors; channels are credit-based bounded
buffers over actor calls (backpressure propagates upstream when credits run
out), and operator state lives in the worker actors.
"""

from .datastream import StreamingContext  # noqa: F401

__all__ = ["StreamingContext"]
