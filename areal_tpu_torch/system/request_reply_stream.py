"""Master <-> model-worker request/reply stream.

Rebuild of the reference's ZMQ stream (reference:
realhf/system/request_reply_stream.py — pickled ``Payload`` with
handler/handle_name/data + pre/post hooks :47, per-subscriber PUSH sockets +
one PULL socket on the master with name_resolve discovery :78-141,
``NameResolvingReplyServer`` :351).

Master side: one PUSH socket per model worker + one shared PULL for replies.
Worker side: one PULL (requests) + one PUSH (replies).  Payloads are pickled
host data (SequenceSample etc.); device arrays never cross this boundary.

The port's copy of ``areal_tpu/system/request_reply_stream.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
import uuid
from typing import Any, Dict, List, Optional

import zmq

from areal_tpu_torch.base import logging_, name_resolve, names, network

logger = logging_.getLogger("request_reply_stream")

PUBSUB_BARRIER_NAME = "__stream_barrier__"


@dataclasses.dataclass
class Payload:
    handler: str  # destination worker name
    handle_name: str  # e.g. "train_step", "fetch", "initialize"
    request_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex
    )
    data: Any = None
    pre_hooks: List[Dict] = dataclasses.field(default_factory=list)
    post_hooks: List[Dict] = dataclasses.field(default_factory=list)
    # filled on reply
    is_reply: bool = False
    handled_by: Optional[str] = None


class NoMessage(Exception):
    pass


class MasterRequestReplyStream:
    """Master end: send to any worker, receive replies from all."""

    def __init__(self, experiment_name: str, trial_name: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._ctx = zmq.Context.instance()
        self._send_socks: Dict[str, zmq.Socket] = {}
        self._recv = self._ctx.socket(zmq.PULL)
        port = self._recv.bind_to_random_port("tcp://*")
        self._recv_addr = f"{network.gethostip()}:{port}"
        name_resolve.add(
            names.request_reply_stream(
                experiment_name, trial_name, "master_recv"
            ),
            self._recv_addr,
            replace=True,
        )

    def connect(self, worker_names: List[str], timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        for wname in worker_names:
            key = names.request_reply_stream(
                self.experiment_name, self.trial_name, f"worker_recv/{wname}"
            )
            addr = name_resolve.wait(
                key, timeout=max(0.1, deadline - time.monotonic())
            )
            sock = self._ctx.socket(zmq.PUSH)
            sock.connect(f"tcp://{addr}")
            self._send_socks[wname] = sock

    def post(self, payload: Payload) -> str:
        self._send_socks[payload.handler].send(pickle.dumps(payload))
        return payload.request_id

    def poll_reply(self, block: bool = False, timeout: float = 300.0) -> Payload:
        if block:
            if not self._recv.poll(timeout=int(timeout * 1000)):
                raise TimeoutError("no reply within timeout")
        try:
            msg = self._recv.recv(flags=0 if block else zmq.NOBLOCK)
        except zmq.ZMQError as e:
            raise NoMessage() from e
        return pickle.loads(msg)

    def close(self):
        for s in self._send_socks.values():
            s.close(linger=0)
        self._recv.close(linger=0)


class WorkerRequestReplyStream:
    """Worker end: receive requests, push replies to the master."""

    def __init__(
        self, experiment_name: str, trial_name: str, worker_name: str
    ):
        self.worker_name = worker_name
        self._ctx = zmq.Context.instance()
        self._recv = self._ctx.socket(zmq.PULL)
        port = self._recv.bind_to_random_port("tcp://*")
        name_resolve.add(
            names.request_reply_stream(
                experiment_name, trial_name, f"worker_recv/{worker_name}"
            ),
            f"{network.gethostip()}:{port}",
            replace=True,
        )
        master_addr = name_resolve.wait(
            names.request_reply_stream(
                experiment_name, trial_name, "master_recv"
            ),
            timeout=60,
        )
        self._send = self._ctx.socket(zmq.PUSH)
        self._send.connect(f"tcp://{master_addr}")

    def poll_request(self, block: bool = False, timeout: float = 300.0) -> Payload:
        if block:
            if not self._recv.poll(timeout=int(timeout * 1000)):
                raise TimeoutError("no request within timeout")
        try:
            msg = self._recv.recv(flags=0 if block else zmq.NOBLOCK)
        except zmq.ZMQError as e:
            raise NoMessage() from e
        return pickle.loads(msg)

    def reply(self, request: Payload, data: Any = None):
        self._send.send(
            pickle.dumps(
                Payload(
                    handler="master",
                    handle_name=request.handle_name,
                    request_id=request.request_id,
                    data=data,
                    is_reply=True,
                    handled_by=self.worker_name,
                )
            )
        )

    def close(self):
        self._recv.close(linger=0)
        self._send.close(linger=0)
