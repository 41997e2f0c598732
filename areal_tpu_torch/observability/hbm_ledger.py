"""Per-subsystem device-memory ledger: who owns the card's bytes (port of
``areal_tpu/observability/hbm_ledger.py``; the device tags are reconciled
against ``torch.cuda.memory_allocated``, the caching allocator's bytes in
tensors, which sits at or above the ledger since the allocator rounds each
block up).

``areal_device_hbm_{in_use,peak,limit}_gb`` (base/monitor.py) say how
full a chip is but not *who* owns the bytes.  This module is the
attribution plane: every allocation seam registers what it holds under a
canonical subsystem tag — serving weight tree, staged swap tree, paged
KV pool, int8 scale pools, prefix-cache host spill tier, gateway stream
buffers, streamed-handoff staging — through cheap thread-safe handles
(register / resize / release).  The ledger exports
``areal_hbm_ledger_bytes{subsystem=}`` plus peak watermarks, rides the
gen-server metrics RPC, and is fleet-merged by the
``ClusterMetricsAggregator``.

Two invariants make it trustworthy rather than decorative:

* **Reconciliation**: the device-tag sum must stay ``<= in_use`` (the
  allocator's own number) within a tolerance; :meth:`HbmLedger.reconcile`
  publishes the excess as ``areal_hbm_ledger_drift_gb`` when not —
  nonzero drift means a double-count or a missed release, never noise.
* **Leak audit**: quiesce points (prefix flush, swap commit, engine
  close) snapshot-diff the ledger against a baseline via
  :meth:`HbmLedger.leaks`; a non-empty diff is a leaked attribution and
  the engine/test suites assert on it.

Host-side tags (``prefix_spill_host``, ``stream_buffers``,
``handoff_staging``) carry host bytes under the same mechanism — they
are excluded from device reconciliation but leak-audited identically.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class SubsystemSpec:
    """One canonical ledger tag.  ``device`` marks tags whose bytes live
    in device HBM (reconciled against the device gauges); the rest hold
    host memory."""

    name: str
    device: bool
    help: str


#: the subsystem tag taxonomy — the ``subsystem`` label vocabulary of
#: ``areal_hbm_ledger_bytes``/``areal_hbm_ledger_peak_bytes``.  The docs
#: table renders from here; add new seams here first.
SUBSYSTEM_TABLE = [
    SubsystemSpec(
        "weights", True,
        "the engine's resident serving weight tree (swap-resized)",
    ),
    SubsystemSpec(
        "staged_weights", True,
        "a device-resident staged swap tree awaiting commit/discard",
    ),
    SubsystemSpec(
        "kv_pool", True,
        "KV storage: the paged pool's k+v data arrays (int8 or model "
        "dtype), or the dense KVCache",
    ),
    SubsystemSpec(
        "kv_scales", True,
        "int8 pools' f32 absmax scale arrays (0 on fp pools)",
    ),
    SubsystemSpec(
        "prefix_spill_host", False,
        "host RAM held by the radix prefix cache's spill tier",
    ),
    SubsystemSpec(
        "stream_buffers", False,
        "undrained gateway SSE token buffers (host)",
    ),
    SubsystemSpec(
        "handoff_staging", False,
        "gathered handoff segment payloads queued for export (host; "
        "import-side payloads scatter on arrival and never stage)",
    ),
]

SUBSYSTEMS = tuple(s.name for s in SUBSYSTEM_TABLE)
DEVICE_SUBSYSTEMS = tuple(s.name for s in SUBSYSTEM_TABLE if s.device)

#: reconciliation slack (the JAX package's, set there for XLA scratch and
#: donated buffers): on the card the caching allocator rounds every block
#: up, so the ledger sits below ``memory_allocated`` and an honest ledger
#: reads 0 drift; only a double count or a missed release exceeds this.
DRIFT_TOLERANCE_BYTES = 64 << 20


class LedgerHandle:
    """One registered allocation.  ``resize`` moves its byte count (the
    delta lands on the subsystem total atomically); ``release`` zeroes
    it and detaches.  All methods are no-ops after release and on a
    disabled ledger — seams never need to guard their calls."""

    __slots__ = ("_ledger", "subsystem", "name", "_bytes", "_released")

    def __init__(self, ledger: "HbmLedger", subsystem: str, name: str):
        self._ledger = ledger
        self.subsystem = subsystem
        self.name = name
        self._bytes = 0
        self._released = False

    @property
    def bytes(self) -> int:
        return self._bytes

    def resize(self, nbytes: int) -> None:
        """Set this allocation's current size (absolute, not a delta)."""
        if self._released or not self._ledger.enabled:
            return
        nbytes = max(0, int(nbytes))
        with self._ledger._lock:
            self._ledger._adjust_locked(self.subsystem, nbytes - self._bytes)
            self._bytes = nbytes

    # a handle is conceptually a named byte count; ``set`` reads better
    # at seams that recompute totals rather than grow/shrink one buffer
    set = resize

    def release(self) -> None:
        if self._released:
            return
        self.resize(0)
        self._released = True


class HbmLedger:
    """Thread-safe subsystem-tagged byte ledger.

    ``enabled=False`` builds a no-op ledger (every handle call returns
    immediately) — the bench's ledger-off arm and a guard for hot loops
    that must not pay even the lock."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._bytes: Dict[str, int] = {s: 0 for s in SUBSYSTEMS}
        self._peak: Dict[str, int] = {s: 0 for s in SUBSYSTEMS}

    # -- registration -------------------------------------------------------

    def register(
        self, subsystem: str, nbytes: int = 0, name: str = ""
    ) -> LedgerHandle:
        """A new handle under ``subsystem`` (must be a canonical tag),
        optionally pre-sized.  ``name`` is a debugging hint only."""
        if subsystem not in self._bytes:
            raise ValueError(
                f"unknown ledger subsystem {subsystem!r}; add it to "
                "hbm_ledger.SUBSYSTEM_TABLE (and docs) first"
            )
        h = LedgerHandle(self, subsystem, name or subsystem)
        if nbytes:
            h.resize(nbytes)
        return h

    def _adjust_locked(self, subsystem: str, delta: int) -> None:
        cur = self._bytes[subsystem] + delta
        # clamp rather than assert: a double-release must not crash a
        # serving worker — reconcile/leak audits surface the bug instead
        self._bytes[subsystem] = max(0, cur)
        if cur > self._peak[subsystem]:
            self._peak[subsystem] = cur

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        """Current bytes for EVERY canonical tag (zeros included, so
        diffs and exports are total functions of the vocabulary)."""
        with self._lock:
            return dict(self._bytes)

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._peak)

    def device_bytes(self) -> int:
        """Sum over device-tagged subsystems (the reconciliation side)."""
        with self._lock:
            return sum(self._bytes[s] for s in DEVICE_SUBSYSTEMS)

    def leaks(
        self, baseline: Optional[Dict[str, int]] = None
    ) -> Dict[str, int]:
        """Non-zero deltas vs ``baseline`` (default: an empty ledger).
        Empty dict = leak-free; the quiesce-point audit contract."""
        base = baseline or {}
        out: Dict[str, int] = {}
        for tag, cur in self.snapshot().items():
            delta = cur - int(base.get(tag, 0))
            if delta != 0:
                out[tag] = delta
        return out

    # -- export -------------------------------------------------------------

    def publish(self, registry) -> None:
        """Mirror current + peak bytes into ``registry`` gauges, one
        sample per canonical tag (absent tags publish 0 so fleet rows
        never have holes)."""
        cur, peak = self.snapshot(), self.watermarks()
        g_cur = registry.gauge("areal_hbm_ledger_bytes")
        g_peak = registry.gauge("areal_hbm_ledger_peak_bytes")
        for tag in SUBSYSTEMS:
            g_cur.set(float(cur[tag]), subsystem=tag)
            g_peak.set(float(peak[tag]), subsystem=tag)

    def reconcile(
        self,
        registry,
        device_in_use_bytes: Optional[int],
        tolerance_bytes: int = DRIFT_TOLERANCE_BYTES,
    ) -> Dict[str, float]:
        """Cross-check the device-tag sum against the device's own
        in-use bytes and publish the excess as
        ``areal_hbm_ledger_drift_gb`` (0 while within tolerance).

        ``device_in_use_bytes=None`` (backends without memory_stats —
        CPU) publishes 0 drift and reports the check as vacuous."""
        ledger_dev = self.device_bytes()
        if device_in_use_bytes is None:
            drift_gb = 0.0
            ok, vacuous = True, True
        else:
            excess = ledger_dev - int(device_in_use_bytes) - tolerance_bytes
            drift_gb = max(0.0, excess / 2**30)
            ok, vacuous = drift_gb == 0.0, False
        registry.gauge("areal_hbm_ledger_drift_gb").set(drift_gb)
        return {
            "ok": ok,
            "vacuous": vacuous,
            "ledger_device_bytes": float(ledger_dev),
            "device_in_use_bytes": (
                float(device_in_use_bytes)
                if device_in_use_bytes is not None else -1.0
            ),
            "drift_gb": drift_gb,
        }


_global_ledger: Optional[HbmLedger] = None
_global_lock = threading.Lock()


def get_ledger() -> HbmLedger:
    """The process-global ledger (created on first use).  Engines and
    workers default to this; tests/benches pass their own."""
    global _global_ledger
    with _global_lock:
        if _global_ledger is None:
            _global_ledger = HbmLedger()
        return _global_ledger


def set_ledger(ledger: Optional[HbmLedger]) -> None:
    global _global_ledger
    with _global_lock:
        _global_ledger = ledger


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor leaf of a nested dict/list/tuple tree
    (torch tensors or numpy arrays) — the weight-tree seams' sizing
    helper.  A torch storage counts once, keyed by its data pointer and
    device, so views of one allocation (the pool's K and V views of one
    buffer, a tied embedding shared by the head) are not counted twice.
    Leaves without bytes (python scalars, ``meta`` tensors) count 0."""
    import torch

    total = 0
    seen = set()
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "meta":
                continue
            st = leaf.untyped_storage()
            key = (leaf.device.type, leaf.device.index, st.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        else:
            total += int(getattr(leaf, "nbytes", 0) or 0)
    return total
