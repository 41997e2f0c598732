"""Hierarchical scoped metric aggregation
(reference: realhf/base/stats_tracker.py:20).

Metrics are recorded under slash-joined scopes with a reduce type; masked
means use *denominators*: ``denominator("mask"); stat(denominator="mask",
loss=...)`` records a masked average whose export divides by the mask count.
Works on numpy / jax arrays / python scalars; everything is pulled to host
numpy at record time (stats are tiny).

The port's copy of ``areal_tpu/base/stats_tracker.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import enum
from typing import Dict, List, Optional, Union

import numpy as np


class ReduceType(enum.Enum):
    AVG = "avg"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    SCALAR = "scalar"


def _to_np(x) -> np.ndarray:
    if hasattr(x, "addressable_shards") or hasattr(x, "device_buffer"):
        x = np.asarray(x)
    return np.asarray(x)


class DistributedStatsTracker:
    def __init__(self, name: str = ""):
        self._scope: List[str] = [name] if name else []
        # key -> list of (sum, denom_sum) or raw values depending on type
        self._values: Dict[str, List[np.ndarray]] = {}
        self._denoms: Dict[str, List[np.ndarray]] = {}
        self._types: Dict[str, ReduceType] = {}
        self._denom_of: Dict[str, str] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scope.append(name)
        try:
            yield
        finally:
            self._scope.pop()

    def _key(self, name: str) -> str:
        return "/".join(self._scope + [name])

    def denominator(self, **kwargs):
        """Record boolean masks that later stats divide by."""
        for name, mask in kwargs.items():
            key = self._key(name)
            mask = _to_np(mask).astype(np.float64)
            self._denoms.setdefault(key, []).append(mask)

    def stat(
        self,
        denominator: str,
        reduce_type: ReduceType = ReduceType.AVG,
        **kwargs,
    ):
        """Record masked statistics. ``denominator`` names a mask previously
        recorded in the same scope."""
        denom_key = self._key(denominator)
        if denom_key not in self._denoms:
            raise ValueError(f"unknown denominator {denom_key}")
        for name, value in kwargs.items():
            key = self._key(name)
            value = _to_np(value).astype(np.float64)
            mask = self._denoms[denom_key][-1]
            if value.shape != mask.shape:
                raise ValueError(
                    f"stat {key}: shape {value.shape} != mask {mask.shape}"
                )
            self._values.setdefault(key, []).append(value)
            self._types[key] = reduce_type
            self._denom_of[key] = denom_key

    def scalar(self, **kwargs):
        for name, value in kwargs.items():
            key = self._key(name)
            self._values.setdefault(key, []).append(
                np.asarray(float(value), dtype=np.float64)
            )
            self._types[key] = ReduceType.SCALAR

    def export(self, reset: bool = True) -> Dict[str, float]:
        """Aggregate everything recorded so far into plain floats."""
        out: Dict[str, float] = {}
        for key, vals in self._values.items():
            rt = self._types[key]
            if rt == ReduceType.SCALAR:
                out[key] = float(np.mean([v for v in vals]))
                continue
            denom_key = self._denom_of[key]
            masks = self._denoms[denom_key]
            # Each recorded value is aligned with the mask recorded at the
            # same position from the tail.
            n = len(vals)
            ms = masks[-n:]
            if rt == ReduceType.AVG:
                num = sum((v * m).sum() for v, m in zip(vals, ms))
                den = sum(m.sum() for m in ms)
                out[key] = float(num / max(den, 1e-8))
            elif rt == ReduceType.SUM:
                out[key] = float(sum((v * m).sum() for v, m in zip(vals, ms)))
            elif rt == ReduceType.MIN:
                cands = [
                    np.where(m > 0, v, np.inf).min()
                    for v, m in zip(vals, ms)
                    if m.sum() > 0
                ]
                out[key] = float(min(cands)) if cands else float("inf")
            elif rt == ReduceType.MAX:
                cands = [
                    np.where(m > 0, v, -np.inf).max()
                    for v, m in zip(vals, ms)
                    if m.sum() > 0
                ]
                out[key] = float(max(cands)) if cands else float("-inf")
        for key, ms in self._denoms.items():
            out.setdefault(
                key + "/count", float(sum(m.sum() for m in ms))
            )
        if reset:
            self._values.clear()
            self._denoms.clear()
            self._types.clear()
            self._denom_of.clear()
        return out


DEFAULT_TRACKER = DistributedStatsTracker()


def scope(name: str):
    return DEFAULT_TRACKER.scope(name)


def denominator(**kwargs):
    return DEFAULT_TRACKER.denominator(**kwargs)


def stat(denominator: str, reduce_type: ReduceType = ReduceType.AVG, **kwargs):
    return DEFAULT_TRACKER.stat(denominator, reduce_type, **kwargs)


def scalar(**kwargs):
    return DEFAULT_TRACKER.scalar(**kwargs)


def export(reset: bool = True) -> Dict[str, float]:
    return DEFAULT_TRACKER.export(reset=reset)
