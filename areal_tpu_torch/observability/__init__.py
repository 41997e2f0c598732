"""Observability plane of the port (copies of the JAX package's jax-free
modules under ``areal_tpu/observability``):

* :mod:`registry` — process-local counters/gauges/histograms with labels,
  which the generation server mirrors its engine's counters into;
* :mod:`latency` — the request-level SLO plane (``LatencyRecord``,
  ``LatencyDigest`` over the fixed ``SLO_BUCKETS``);
* :mod:`tracing` — the flight-recorder span/event ring the engine binds
  at construction.

The canonical metric table, the per-worker ``/metrics`` HTTP server, the
HBM ledger and the compile watch are not ported yet (ROADMAP.md queue 1,
item 11).
"""

from areal_tpu_torch.observability.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from areal_tpu_torch.observability.latency import (  # noqa: F401
    SLO_BUCKETS,
    SLO_FAMILIES,
    SLO_REL_ERROR_BOUND,
    LatencyDigest,
    LatencyRecord,
)
from areal_tpu_torch.observability.tracing import (  # noqa: F401
    TraceConfig,
    Tracer,
    get_tracer,
    set_tracer,
)
