"""Observability plane of the port (port of ``areal_tpu/observability``):

* :mod:`registry` — process-local counters/gauges/histograms with labels,
  their label keys checked against :mod:`table`, the canonical metric,
  trace and stall-kind tables;
* :mod:`prom_text` — the Prometheus text renderer and strict parser;
* :mod:`server` — the per-worker HTTP ``/metrics``, ``/trace``,
  ``/healthz`` and ``/profile`` endpoint, registered in name_resolve;
* :mod:`aggregator` — the master-side scrape and fleet merge;
* :mod:`tracing` / :mod:`trace_collector` — the flight recorder and its
  master-side harvest with the stall watchdog;
* :mod:`latency` — the request-level SLO plane (``LatencyRecord``,
  ``LatencyDigest`` over the fixed ``SLO_BUCKETS``);
* :mod:`hbm_ledger` — per-subsystem device-memory attribution,
  reconciled against ``torch.cuda.memory_allocated`` and leak-audited at
  an engine's close;
* :mod:`compile_watch` — kernel-library loads per watched serving entry
  (``areal_xla_compiles_total{fn=}``) with the steady-state sentinel.
"""

from areal_tpu_torch.observability.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from areal_tpu_torch.observability.table import (  # noqa: F401
    METRIC_TABLE,
    TRACE_TABLE,
    MetricSpec,
    TraceSpec,
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
from areal_tpu_torch.observability.hbm_ledger import (  # noqa: F401
    DEVICE_SUBSYSTEMS,
    SUBSYSTEMS,
    HbmLedger,
    get_ledger,
    set_ledger,
    tree_nbytes,
)
from areal_tpu_torch.observability.compile_watch import (  # noqa: F401
    CompileWatch,
)
