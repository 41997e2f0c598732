"""Experiment metrics sinks: JSONL + optional tensorboard/wandb/swanlab
(copy of ``areal_tpu/base/metrics.py``, with tensorboard opt-in as well:
``AREAL_TENSORBOARD=1``, since torch's writer imports TensorFlow where it
is installed).

Rebuild of the reference's observability fan-out (reference:
realhf/system/master_worker.py:291-350 initializes wandb / swanlab /
tensorboard and realhf/base/logging.py ``log_swanlab_wandb_tensorboard``
writes every scalar to all three).  Differences by design: a JSONL sink is
always on (it is the machine-readable artifact tests and the offline
evaluator consume), tensorboard uses torch's bundled ``SummaryWriter``, and
wandb/swanlab are optional imports that degrade to no-ops when the package
or the opt-in env (``AREAL_WANDB=1`` / ``AREAL_SWANLAB=1``) is absent.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("metrics")


class MetricsLogger:
    """Fan-out scalar logger keyed by global step."""

    def __init__(
        self,
        log_dir: str,
        experiment_name: str = "",
        trial_name: str = "",
        enable_tensorboard: Optional[bool] = None,
    ):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl_path = os.path.join(log_dir, "stats.jsonl")
        self._jsonl = open(self._jsonl_path, "a", buffering=1)
        self._tb = None
        if enable_tensorboard is None:
            # opt-in, like wandb and swanlab: importing torch's tensorboard
            # writer pulls in TensorFlow where it is installed
            enable_tensorboard = os.environ.get("AREAL_TENSORBOARD") == "1"
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(log_dir, "tensorboard")
                )
            except Exception:  # noqa: BLE001 - tb is best-effort
                logger.warning("tensorboard unavailable; skipping")
        self._wandb = None
        if os.environ.get("AREAL_WANDB") == "1":
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=experiment_name or "areal_tpu",
                    name=trial_name or None,
                    dir=log_dir,
                    mode=os.environ.get("WANDB_MODE", "online"),
                )
            except Exception:  # noqa: BLE001
                logger.warning("wandb requested but unavailable")
                self._wandb = None
        self._swanlab = None
        if os.environ.get("AREAL_SWANLAB") == "1":
            try:
                import swanlab

                self._swanlab = swanlab
                swanlab.init(
                    project=experiment_name or "areal_tpu",
                    experiment_name=trial_name or None,
                    logdir=log_dir,
                )
            except Exception:  # noqa: BLE001
                logger.warning("swanlab requested but unavailable")
                self._swanlab = None

    def log(self, stats: Dict[str, Any], step: int):
        """Write one step's scalars to every sink."""
        scalars = {
            k: float(v)
            for k, v in stats.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, global_step=step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._swanlab is not None:
            self._swanlab.log(scalars, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._swanlab is not None:
            self._swanlab.finish()
