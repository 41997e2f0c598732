"""Request-level SLO plane: latency records + mergeable percentile digests
(the engine-side part of ``areal_tpu/observability/latency.py``).

* :class:`LatencyRecord` — one request's latency decomposition: schedule
  wait (manager gate + routing RPC), admission wait (engine queue), TTFT
  (submit -> first token), TPOT (first -> last token, per inter-token
  gap), swap/preemption stall time, plus tokens / server / mesh devices.
* :class:`LatencyDigest` — a streaming percentile digest as a
  log-bucketed histogram over FIXED bucket boundaries
  (:data:`SLO_BUCKETS`): every worker buckets identically, so merging two
  digests is an exact element-wise add of bucket counts.
* the ``areal_slo_*`` family vocabulary (:data:`SLO_FAMILIES`), exported
  as registry histograms over :data:`SLO_BUCKETS`.

Error bound: boundaries grow geometrically by :data:`SLO_BUCKET_RATIO`
(4 buckets per octave) and a quantile is reported as the geometric
midpoint of its bucket, so an in-range quantile is within
:data:`SLO_REL_ERROR_BOUND` (sqrt(ratio) - 1, ~9.05%) of the empirical
one.  Values outside the covered range clamp to the nearest edge bucket.
The fleet-side merge of scraped digests is not ported yet (ROADMAP.md
queue 1, item 11).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

#: smallest bucket boundary (seconds); waits below this clamp into bucket 0
SLO_BUCKET_LO = 1e-4
#: geometric growth per bucket: 4 buckets per octave
SLO_BUCKET_RATIO = 2.0 ** 0.25
#: boundary count; top boundary = LO * RATIO**(N-1) ~= 1995 s
SLO_N_BUCKETS = 98
#: the FIXED boundary vector every digest in the fleet shares.  Computed
#: from the same expression everywhere (and round-tripped exactly through
#: the prom text renderer/parser), so cross-worker merges are exact.
SLO_BUCKETS: Tuple[float, ...] = tuple(
    SLO_BUCKET_LO * SLO_BUCKET_RATIO ** i for i in range(SLO_N_BUCKETS)
)
#: max relative error of an in-range quantile vs the empirical
#: inverted-CDF quantile of the raw samples (sqrt(ratio) - 1)
SLO_REL_ERROR_BOUND = SLO_BUCKET_RATIO ** 0.5 - 1

#: canonical ``areal_slo_*`` digest families -> the LatencyRecord field
#: each one streams
SLO_FAMILIES: Dict[str, str] = {
    "areal_slo_schedule_wait_seconds": "schedule_wait_s",
    "areal_slo_admission_wait_seconds": "admission_wait_s",
    "areal_slo_ttft_seconds": "ttft_s",
    "areal_slo_tpot_seconds": "tpot_s",
    "areal_slo_stall_seconds": "stall_s",
}

@dataclasses.dataclass
class LatencyRecord:
    """One finished request's latency decomposition.

    All times are seconds on the recording process's monotonic clock;
    each component is measured on ONE clock (client-side schedule wait is
    stamped by the rollout client, everything else by the engine), so
    cross-host clock skew can never fabricate latency.

    ``tpot_s`` is the mean inter-token gap after the first token
    (``None`` for single-token requests — there is no gap to measure);
    ``stall_s`` is time the request spent quiesced by weight swaps or
    parked by preemption while in flight."""

    qid: str
    workload: str = "rollout"
    server: str = ""
    mesh_devices: int = 1
    schedule_wait_s: Optional[float] = None
    admission_wait_s: float = 0.0
    ttft_s: float = 0.0
    tpot_s: Optional[float] = None
    stall_s: float = 0.0
    tokens: int = 0

    def complete(self) -> bool:
        """Every stage of the decomposition is present: the dryrun's
        ``slo`` phase gates on this for a traced rollout."""
        return (
            bool(self.qid)
            and bool(self.server)
            and self.mesh_devices >= 1
            and self.schedule_wait_s is not None
            and self.admission_wait_s >= 0.0
            and self.ttft_s > 0.0
            and self.tpot_s is not None
            and self.stall_s >= 0.0
            and self.tokens >= 2
        )

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class LatencyDigest:
    """Mergeable streaming percentile digest (log-bucketed histogram).

    ``counts`` has ``SLO_N_BUCKETS + 1`` entries: counts[i] covers
    ``(SLO_BUCKETS[i-1], SLO_BUCKETS[i]]`` (bucket 0 covers
    ``(0, SLO_BUCKETS[0]]``, absorbing clamped small values) and the
    final entry is the overflow bucket for values past the top boundary.
    Because the boundaries are process-invariant constants,
    :meth:`merge` is exact — see the module docstring."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts: List[int] = [0] * (SLO_N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        idx = bisect.bisect_left(SLO_BUCKETS, v)  # first boundary >= v
        self.counts[idx] += 1
        self.count += 1
        self.sum += v

    def merge(self, other: "LatencyDigest") -> "LatencyDigest":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Inverted-CDF quantile: the geometric midpoint of the bucket
        holding the ``ceil(q * count)``-th smallest sample.  None when
        empty."""
        if self.count <= 0:
            return None
        q = min(1.0, max(0.0, q))
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if i >= SLO_N_BUCKETS:  # overflow: clamp to top boundary
                    return SLO_BUCKETS[-1]
                # bucket i covers (b[i]/ratio, b[i]]; geometric midpoint
                return SLO_BUCKETS[i] / math.sqrt(SLO_BUCKET_RATIO)
        return SLO_BUCKETS[-1]  # unreachable; counts sum to count

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "mean": (self.sum / self.count) if self.count else None,
            "count": self.count,
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "lo": SLO_BUCKET_LO,
            "ratio": SLO_BUCKET_RATIO,
            "n_buckets": SLO_N_BUCKETS,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LatencyDigest":
        if (
            int(d.get("n_buckets", -1)) != SLO_N_BUCKETS
            or len(d.get("counts", ())) != SLO_N_BUCKETS + 1
        ):
            raise ValueError(
                "digest bucket scheme mismatch: cannot merge digests "
                "built over different boundaries"
            )
        out = cls()
        out.counts = [int(c) for c in d["counts"]]
        out.count = int(d["count"])
        out.sum = float(d["sum"])
        return out
