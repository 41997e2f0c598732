"""Runtime monitoring: device-memory and host sampling, time marks, and
rollout accounting (port of ``areal_tpu/base/monitor.py``).

Device gauges come from ``torch.cuda.memory_stats`` (the caching
allocator's bytes in use and at peak) instead of the TPU's
``device.memory_stats()``; the gauge names stay the reference's
(``hbm_*``), so dashboards read both.  Only the processes that hold the
card read them (the model workers with each train step, the generation
servers with each ``metrics`` reply, each its own allocator); the
background sampler reads the host only, so the master, in a process of
its own, never creates a CUDA context.  After each device sample the HBM
ledger (:mod:`~areal_tpu_torch.observability.hbm_ledger`) is reconciled
against ``torch.cuda.memory_allocated``.  The TPU peak-FLOP table is not
ported (the train engine keeps the card's own, ``engine/train_engine.py``).
The JAX package's time marks are not copied: nothing in the port records
them.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("monitor")


@dataclasses.dataclass
class RolloutStat:
    """Rollout accounting (reference: monitor.py:37)."""

    submitted: int = 0
    accepted: int = 0
    running: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Device/host utilization sampling
# ---------------------------------------------------------------------------


def _host_stats() -> Dict[str, float]:
    out: Dict[str, float] = {}
    try:
        la1, la5, _ = os.getloadavg()
        out["host/load1"] = la1
        out["host/load5"] = la5
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host/rss_gb"] = float(line.split()[1]) / 1e6
                    break
    except OSError:
        pass
    return out


def device_memory_stats() -> Dict[str, float]:
    """Per-device memory gauges from ``torch.cuda.memory_stats`` (bytes
    the caching allocator holds for tensors now and at peak, and the
    card's total memory), also set in the scrape registry; {} without
    CUDA devices."""
    import torch

    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        # no device: the ledger's reconciliation is vacuous (drift 0)
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability.hbm_ledger import get_ledger

        get_ledger().reconcile(get_registry(), None)
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        key = f"device{i}"
        out[f"{key}/hbm_in_use_gb"] = (
            stats.get("allocated_bytes.all.current", 0) / 1e9
        )
        out[f"{key}/hbm_peak_gb"] = stats.get("allocated_bytes.all.peak", 0) / 1e9
        out[f"{key}/hbm_limit_gb"] = (
            torch.cuda.get_device_properties(i).total_memory / 1e9
        )
    try:
        from areal_tpu_torch.observability import get_registry

        reg = get_registry()
        for k, v in out.items():
            dev, field = k.split("/", 1)
            # metric names literal at the call sites, for
            # scripts/check_metric_names.py
            if field == "hbm_in_use_gb":
                reg.gauge("areal_device_hbm_in_use_gb").set(v, device=dev)
            elif field == "hbm_peak_gb":
                reg.gauge("areal_device_hbm_peak_gb").set(v, device=dev)
            elif field == "hbm_limit_gb":
                reg.gauge("areal_device_hbm_limit_gb").set(v, device=dev)
        # the ledger's device tags must sum to at most the allocator's own
        # bytes in tensors; the excess publishes as
        # areal_hbm_ledger_drift_gb (0 while the ledger is honest)
        from areal_tpu_torch.observability.hbm_ledger import get_ledger

        get_ledger().reconcile(reg, sum(
            torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())))
    except Exception:  # noqa: BLE001 - monitoring must not kill work
        logger.exception("metric registry publish failed")
    return out


class UtilizationMonitor:
    """Background sampler (reference: gpu_utilization_monitor thread :266).

    Samples host gauges every ``interval`` seconds into a ring of
    the last ``keep`` snapshots; ``export()`` returns the latest gauges for
    the metrics fan-out."""

    def __init__(self, interval: float = 10.0, keep: int = 360, registry=None):
        self.interval = interval
        self.keep = keep
        self._registry = registry
        self._snapshots: List[Dict[str, float]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="util-monitor", daemon=True
        )
        self._thread.start()

    def _sample(self):
        snap = {"ts": time.time(), **_host_stats()}
        with self._lock:
            self._snapshots.append(snap)
            if len(self._snapshots) > self.keep:
                self._snapshots.pop(0)
        self._publish(snap)

    def _publish(self, snap: Dict[str, float]):
        """Mirror the latest sample into the scrape registry (instead of the
        log-only output the sampler used to be).  Metric names are literal
        at the call sites so scripts/check_metric_names.py can audit them."""
        try:
            from areal_tpu_torch.observability import get_registry

            reg = self._registry or get_registry()
            if "host/load1" in snap:
                reg.gauge("areal_host_load1").set(snap["host/load1"])
            if "host/load5" in snap:
                reg.gauge("areal_host_load5").set(snap["host/load5"])
            if "host/rss_gb" in snap:
                reg.gauge("areal_host_rss_gb").set(snap["host/rss_gb"])
        except Exception:  # noqa: BLE001 - monitoring must not kill work
            logger.exception("metric registry publish failed")

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._sample()
            except Exception:  # noqa: BLE001 - monitoring must not kill work
                logger.exception("utilization sample failed")

    def export(self) -> Dict[str, float]:
        with self._lock:
            if not self._snapshots:
                return {}
            latest = dict(self._snapshots[-1])
        latest.pop("ts", None)
        return latest

    def history(self) -> List[Dict[str, float]]:
        with self._lock:
            return list(self._snapshots)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
