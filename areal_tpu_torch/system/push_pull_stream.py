"""ZMQ PUSH/PULL JSON streams for rollout -> trainer trajectory transport
(reference: realhf/system/push_pull_stream.py — ``ZMQJsonPusher`` :18,
``ZMQJsonPuller`` :63, name-resolving variants :141,163 where pushers shard
across pullers registered in name_resolve).

The port's copy of ``areal_tpu/system/push_pull_stream.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import zmq

from areal_tpu_torch.base import logging_, name_resolve, names, network

logger = logging_.getLogger("push_pull_stream")


class ZMQJsonPusher:
    def __init__(
        self, host: str, port: int, hwm: int = 1000, send_timeout_ms: int = 60000
    ):
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, hwm)
        # block (bounded) instead of raising when the consumer falls behind —
        # backpressure, not data loss
        self.sock.setsockopt(zmq.SNDTIMEO, send_timeout_ms)
        self.sock.connect(f"tcp://{host}:{port}")

    def push(self, data) -> None:
        self.sock.send_string(json.dumps(data))

    def close(self):
        self.sock.close(linger=0)


class ZMQJsonPuller:
    def __init__(
        self,
        host: str = "*",
        port: Optional[int] = None,
        hwm: int = 1000,
        default_timeout_ms: int = 100,
    ):
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PULL)
        self.sock.setsockopt(zmq.RCVHWM, hwm)
        if port is None:
            self.port = self.sock.bind_to_random_port(f"tcp://{host}")
        else:
            self.sock.bind(f"tcp://{host}:{port}")
            self.port = port
        self.default_timeout_ms = default_timeout_ms

    def pull(self, timeout_ms: Optional[int] = None):
        t = self.default_timeout_ms if timeout_ms is None else timeout_ms
        if not self.sock.poll(timeout=t):
            raise queue_Empty()
        return json.loads(self.sock.recv_string())

    def close(self):
        self.sock.close(linger=0)


class queue_Empty(Exception):
    """Raised when pull times out (mirrors queue.Empty semantics)."""


class NameResolvingZmqPusher(ZMQJsonPusher):
    """Pusher that discovers its puller via name_resolve, sharded by
    pusher_index % n_pullers."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        pusher_index: int,
        timeout: float = 120.0,
        **kw,
    ):
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            puller_addrs = name_resolve.get_subtree(
                names.stream_pullers(experiment_name, trial_name)
            )
            if puller_addrs:
                break
            if _time.monotonic() > deadline:
                raise TimeoutError("no stream pullers registered")
            _time.sleep(0.1)
        puller_addrs = sorted(puller_addrs)
        addr = puller_addrs[pusher_index % len(puller_addrs)]
        host, port = addr.rsplit(":", 1)
        super().__init__(host, int(port), **kw)


class NameResolvingZmqPuller(ZMQJsonPuller):
    """Puller that registers its address in name_resolve."""

    def __init__(
        self, experiment_name: str, trial_name: str, puller_index: int, **kw
    ):
        super().__init__(**kw)
        name_resolve.add_subentry(
            names.stream_pullers(experiment_name, trial_name),
            f"{network.gethostip()}:{self.port}",
        )
