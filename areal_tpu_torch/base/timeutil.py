"""Frequency control utilities (reference: realhf/base/timeutil.py, FrequencyControl
and EpochStepTimeFreqCtl :127).

Used by the master worker to decide when to save / eval / checkpoint, and the
state is serialized into RecoverInfo so resumed runs keep cadence.

The port's copy of ``areal_tpu/base/timeutil.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FrequencyControl:
    """Triggers every ``frequency_seconds`` seconds and/or ``frequency_steps``
    calls; either may be None.  ``initial_value`` makes the first check fire."""

    frequency_seconds: Optional[float] = None
    frequency_steps: Optional[int] = None
    initial_value: bool = False

    def __post_init__(self):
        self._last_time = time.monotonic()
        self._steps = 0
        self._initial = self.initial_value

    def check(self, steps: int = 1) -> bool:
        self._steps += steps
        if self._initial:
            self._initial = False
            self._last_time = time.monotonic()
            self._steps = 0
            return True
        hit = False
        if (
            self.frequency_steps is not None
            and self._steps >= self.frequency_steps
        ):
            hit = True
        if (
            self.frequency_seconds is not None
            and time.monotonic() - self._last_time >= self.frequency_seconds
        ):
            hit = True
        if hit:
            self._last_time = time.monotonic()
            self._steps = 0
        return hit

    def state_dict(self):
        return {
            "steps": self._steps,
            "elapsed": time.monotonic() - self._last_time,
            "initial": self._initial,
        }

    def load_state_dict(self, state):
        self._steps = state["steps"]
        self._last_time = time.monotonic() - state["elapsed"]
        self._initial = state["initial"]


@dataclasses.dataclass
class EpochStepTimeFreqCtl:
    """Triggers on epoch boundaries, global-step counts, or elapsed seconds —
    whichever fires (reference :127)."""

    freq_epoch: Optional[int] = None
    freq_step: Optional[int] = None
    freq_sec: Optional[float] = None
    initial_value: bool = False

    def __post_init__(self):
        self._epoch_cnt = 0
        self._step_cnt = 0
        self._last_time = time.monotonic()
        self._initial = self.initial_value

    def check(self, epochs: int = 0, steps: int = 1) -> bool:
        self._epoch_cnt += epochs
        self._step_cnt += steps
        if self._initial:
            self._initial = False
            return True
        hit = False
        if self.freq_epoch is not None and self._epoch_cnt >= self.freq_epoch:
            self._epoch_cnt = 0
            hit = True
        if self.freq_step is not None and self._step_cnt >= self.freq_step:
            self._step_cnt = 0
            hit = True
        if (
            self.freq_sec is not None
            and time.monotonic() - self._last_time >= self.freq_sec
        ):
            self._last_time = time.monotonic()
            hit = True
        if hit and self.freq_sec is not None:
            self._last_time = time.monotonic()
        return hit

    def state_dict(self):
        return {
            "epoch_cnt": self._epoch_cnt,
            "step_cnt": self._step_cnt,
            "elapsed": time.monotonic() - self._last_time,
            "initial": self._initial,
        }

    def load_state_dict(self, state):
        self._epoch_cnt = state["epoch_cnt"]
        self._step_cnt = state["step_cnt"]
        self._last_time = time.monotonic() - state["elapsed"]
        self._initial = state["initial"]
