"""Dataset facade over a trajectory puller (async mode)
(reference: realhf/system/stream_dataset.py ``PullerStreamDataset`` :23 — a
background thread pulls JSON trajectories from rollout workers and converts
them to SequenceSample; ``__len__`` mirrors the prompt dataset size for epoch
accounting).

The port's copy of ``areal_tpu/system/stream_dataset.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import torch.utils.data

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_
from areal_tpu_torch.system.push_pull_stream import (
    NameResolvingZmqPuller,
    queue_Empty,
)

logger = logging_.getLogger("stream_dataset")


class PullerStreamDataset(torch.utils.data.Dataset):
    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        puller_index: int = 0,
        dataset_size: int = 10**9,
        pull_timeout_ms: int = 100,
        max_queue_size: int = 10000,
    ):
        self.dataset_size = dataset_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue_size)
        self._stop = threading.Event()
        self._puller_args = (experiment_name, trial_name, puller_index)
        self._pull_timeout_ms = pull_timeout_ms
        self._thread = threading.Thread(target=self._pull_loop, daemon=True)
        self._thread.start()

    def _pull_loop(self):
        puller = NameResolvingZmqPuller(*self._puller_args)
        try:
            while not self._stop.is_set():
                try:
                    payload = puller.pull(timeout_ms=self._pull_timeout_ms)
                except queue_Empty:
                    continue
                for traj in payload:
                    sample = SequenceSample.from_json_compatible(traj)
                    self._queue.put(sample)
        finally:
            puller.close()

    def drain(self, max_samples: int) -> List[SequenceSample]:
        """Non-blocking: up to max_samples pulled trajectories."""
        out = []
        while len(out) < max_samples:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return out

    def get(self, timeout: float = 1.0) -> Optional[SequenceSample]:
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def qsize(self) -> int:
        return self._queue.qsize()

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, idx):
        """Blocking fetch of the next pushed trajectory (idx is ignored —
        trajectories arrive in rollout-completion order)."""
        s = self.get(timeout=300.0)
        if s is None:
            raise TimeoutError("no trajectory arrived within 300s")
        return s

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
