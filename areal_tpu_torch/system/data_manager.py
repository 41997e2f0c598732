"""Worker-side host data storage + peer-to-peer transfer.

Rebuild of the reference's ``DataManager`` (reference:
realhf/system/data_manager.py — per-GPU id->SequenceSample storage :38, NCCL
bcast/gather/scatter redistribution :156-441).  On TPU the training data
plane is host numpy (device arrays live only inside jitted steps), so
redistribution is a ZMQ pull between workers: each DataManager serves its
store on a REP socket; ``execute_pull`` fetches (ids × keys) from a peer.

The port's copy of ``areal_tpu/system/data_manager.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import pickle
import threading
from typing import Dict, List, Optional, Sequence

import zmq

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_, name_resolve, names, network
from areal_tpu_torch.system.redistributor import RedistribStep

logger = logging_.getLogger("data_manager")


def _data_stream_key(experiment_name, trial_name, worker_name):
    return names.request_reply_stream(
        experiment_name, trial_name, f"data/{worker_name}"
    )


class DataManager:
    def __init__(
        self, experiment_name: str, trial_name: str, worker_name: str
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_name = worker_name
        self._store: Dict[object, SequenceSample] = {}
        self._ctx = zmq.Context.instance()
        self._serve_sock = self._ctx.socket(zmq.REP)
        port = self._serve_sock.bind_to_random_port("tcp://*")
        name_resolve.add(
            _data_stream_key(experiment_name, trial_name, worker_name),
            f"{network.gethostip()}:{port}",
            replace=True,
        )
        self._peer_socks: Dict[str, zmq.Socket] = {}
        self._lock = threading.Lock()
        # serve peer pulls on a daemon thread so two workers can pull from
        # each other while both are blocked inside an MFC execution
        self._stop = threading.Event()
        self._serve_thread = threading.Thread(
            target=self._serve_loop, daemon=True
        )
        self._serve_thread.start()

    def _serve_loop(self):
        while not self._stop.is_set():
            if self._serve_sock.poll(timeout=100):
                self.serve_pending()

    # -- local store --------------------------------------------------------

    def store(self, sample: SequenceSample):
        with self._lock:
            for one in sample.unpack() if sample.bs > 1 else [sample]:
                sid = one.ids[0]
                if sid in self._store:
                    self._store[sid].update_(one)
                else:
                    self._store[sid] = one

    def has(self, sample_id, key: Optional[str] = None) -> bool:
        with self._lock:
            s = self._store.get(sample_id)
            if s is None:
                return False
            return key is None or (key in s.keys and s.data.get(key) is not None)

    def get_batch(
        self, ids: Sequence[object], keys: Optional[Sequence[str]] = None
    ) -> SequenceSample:
        with self._lock:
            parts = []
            for i in ids:
                s = self._store[i]
                parts.append(s.select(keys) if keys is not None else s)
        return SequenceSample.gather(parts)

    def drop(self, ids: Sequence[object]):
        with self._lock:
            for i in ids:
                self._store.pop(i, None)

    @property
    def n_stored(self) -> int:
        return len(self._store)

    # -- peer transfer ------------------------------------------------------

    def serve_pending(self, max_requests: int = 16):
        """Answer queued peer pull requests (call from the worker poll loop)."""
        for _ in range(max_requests):
            try:
                msg = self._serve_sock.recv(flags=zmq.NOBLOCK)
            except zmq.ZMQError:
                return
            try:
                ids, keys = pickle.loads(msg)
                batch = self.get_batch(ids, keys)
                resp = ("ok", batch)
            except Exception as e:  # noqa: BLE001
                logger.exception("data pull failed")
                resp = ("error", repr(e))
            self._serve_sock.send(pickle.dumps(resp))

    def _peer(self, worker_name: str) -> zmq.Socket:
        if worker_name not in self._peer_socks:
            addr = name_resolve.wait(
                _data_stream_key(
                    self.experiment_name, self.trial_name, worker_name
                ),
                timeout=60,
            )
            sock = self._ctx.socket(zmq.REQ)
            sock.connect(f"tcp://{addr}")
            self._peer_socks[worker_name] = sock
        return self._peer_socks[worker_name]

    def execute_pull(self, step: RedistribStep, timeout: float = 300.0):
        """Fetch (ids × keys) from ``step.src`` and store locally."""
        assert step.dst == self.worker_name
        if step.src == self.worker_name:
            return
        sock = self._peer(step.src)
        sock.send(pickle.dumps((step.ids, step.keys)))
        if not sock.poll(timeout=int(timeout * 1000)):
            raise TimeoutError(f"data pull from {step.src} timed out")
        status, payload = pickle.loads(sock.recv())
        if status != "ok":
            raise RuntimeError(f"data pull from {step.src} failed: {payload}")
        self.store(payload)

    def close(self):
        self._stop.set()
        self._serve_thread.join(timeout=2)
        self._serve_sock.close(linger=0)
        for s in self._peer_socks.values():
            s.close(linger=0)
