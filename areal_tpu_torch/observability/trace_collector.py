"""Master-side trace collector: harvest, persist, watch for stalls (copy
of ``areal_tpu/observability/trace_collector.py``; each worker's
``/trace`` route is served by its ``/metrics`` server,
:mod:`areal_tpu_torch.observability.server`).

The collector is the assembly half of the distributed flight recorder
(:mod:`tracing` is the worker-side recording half):

* **discovery** reuses the metric-server subtree — every worker that
  serves ``/metrics`` also serves ``GET /trace?since=<seq>`` from the
  same stdlib HTTP server, so there is exactly one discovery plane.
* **harvest** is cursor-based and best-effort: a dead worker, a worker
  appearing mid-run, or a truncated/garbage payload costs one
  ``areal_trace_harvest_errors_total`` increment and a skipped endpoint,
  never a master stall (bounded per-endpoint timeout) or a step failure.
* every harvested event is appended to ``traces.jsonl`` (one JSON object
  per line, stamped with the harvesting step), and :meth:`close` writes
  ``trace_perfetto.json`` — a Chrome/Perfetto ``trace_event`` export of
  the same events for timeline viewing (one process per sampled rollout,
  one thread lane per worker/request id).
* the **stall watchdog** turns silent hangs into attributed alerts: an
  open span with no trace activity past ``stall_span_timeout_s`` (a qid
  decoding with no chunk event, an episode stuck on a dead server), or a
  buffer-resident sample whose weight version lags the current version
  by more than ``stall_buffer_versions``, increments
  ``areal_trace_stall_total{kind=...}`` and logs the last-known span —
  once per span, re-armed if the span closes and reopens.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import Any, Dict, List, Optional, Set, Tuple

from areal_tpu_torch.base import logging_, name_resolve, names
from areal_tpu_torch.observability.table import stall_kind
from areal_tpu_torch.observability.tracing import (
    TraceConfig,
    to_trace_events,
    validate_trace_events,
)

logger = logging_.getLogger("trace_collector")



class StallWatchdog:
    """Flags open spans that stopped making progress.

    Kinds:
      * ``span_deadline`` — no activity (no close, no event on the same
        trace) for ``stall_span_timeout_s``.
      * ``buffer_age`` — an open ``buffer.resident`` span whose recorded
        ``version`` attr lags ``current_version`` by more than
        ``stall_buffer_versions`` (the sample will train hopelessly
        off-policy, or never).

    A span is counted once: the flag is keyed on (worker, tid, name,
    start ts) and cleared when that span is no longer open — a span that
    closed just in time is never counted, and a reopened span re-arms.
    """

    def __init__(self, config: TraceConfig, registry=None, clock=time.time):
        from areal_tpu_torch.observability import get_registry

        self.config = config
        self._clock = clock
        self._m_stalls = (registry or get_registry()).counter(
            "areal_trace_stall_total"
        )
        self._flagged: Set[Tuple] = set()
        # SLO percentile alarm state: consecutive breach count + whether
        # the current breach episode already fired (one alarm per
        # episode; recovery re-arms)
        self._slo_breaches = 0
        self._slo_fired = False

    def check(
        self,
        open_spans: List[Dict[str, Any]],
        current_version: Optional[int] = None,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Returns the newly-flagged stalls (each the last-known span
        dict plus a ``stall_kind`` key); counts + logs each once."""
        now = self._clock() if now is None else now
        live_keys = set()
        stalls = []
        for span in open_spans:
            key = (
                span.get("w"), span.get("tid"), span.get("name"),
                span.get("ts"),
            )
            live_keys.add(key)
            kind = None
            last = span.get("last_ts", span.get("ts", now))
            if now - last > self.config.stall_span_timeout_s:
                kind = stall_kind("span_deadline")
            elif (
                span.get("name") == "buffer.resident"
                and current_version is not None
            ):
                v = (span.get("attrs") or {}).get("version")
                if (
                    isinstance(v, (int, float))
                    and v >= 0
                    and current_version - v > self.config.stall_buffer_versions
                ):
                    kind = stall_kind("buffer_age")
            if kind is None or key in self._flagged:
                continue
            self._flagged.add(key)
            self._m_stalls.inc(kind=kind)
            stall = {**span, "stall_kind": kind}
            stalls.append(stall)
            logger.warning(
                "trace stall (%s): %s", kind,
                json.dumps(stall, default=str)[:512],
            )
        # spans that closed (or were harvested away) re-arm their key
        self._flagged &= live_keys
        return stalls

    def check_slo(self, ttft_p99: Optional[float]) -> bool:
        """Percentile-based SLO alarm: fleet p99 TTFT (the aggregator's
        merged ``slo/areal_slo_ttft_seconds/all/p99`` row) above
        ``config.slo_ttft_p99_s`` for ``config.slo_breach_scrapes``
        consecutive scrape cycles fires
        ``areal_trace_stall_total{kind="slo"}`` ONCE per breach episode
        (a recovered p99 re-arms it).  ``None`` threshold disables; a
        ``None`` observation (no digests scraped yet) neither breaches
        nor resets.  Returns True iff the alarm fired this call."""
        thr = getattr(self.config, "slo_ttft_p99_s", None)
        if thr is None or ttft_p99 is None:
            return False
        if ttft_p99 <= thr:
            self._slo_breaches = 0
            self._slo_fired = False
            return False
        self._slo_breaches += 1
        need = max(1, getattr(self.config, "slo_breach_scrapes", 3))
        if self._slo_breaches < need or self._slo_fired:
            return False
        self._slo_fired = True
        self._m_stalls.inc(kind="slo")
        logger.warning(
            "SLO alarm: fleet p99 TTFT %.3fs above threshold %.3fs for "
            "%d consecutive scrapes",
            ttft_p99, thr, self._slo_breaches,
        )
        return True


class TraceCollector:
    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        out_dir: Optional[str] = None,
        config: Optional[TraceConfig] = None,
        harvest_timeout: float = 2.0,
        registry=None,
        clock=time.time,
    ):
        from areal_tpu_torch.observability import get_registry

        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.config = config or TraceConfig()
        self.harvest_timeout = harvest_timeout
        self._clock = clock
        self.out_dir = out_dir
        self._jsonl = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(out_dir, "traces.jsonl"), "a", buffering=1
            )
        reg = registry or get_registry()
        self._m_errors = reg.counter("areal_trace_harvest_errors_total")
        self._m_events = reg.counter("areal_trace_events_total")
        self.watchdog = StallWatchdog(self.config, registry=reg, clock=clock)
        # per-worker harvest cursor (the worker's last-seen event seq)
        self._cursors: Dict[str, int] = {}
        self._last_open: List[Dict[str, Any]] = []

    # -- discovery ----------------------------------------------------------

    def discover(self) -> Dict[str, str]:
        """{worker: host:port}; the trace RPC rides the metric-server
        endpoints, re-scanned every harvest so workers appearing mid-run
        are picked up."""
        root = names.metric_server_root(
            self.experiment_name, self.trial_name
        )
        out: Dict[str, str] = {}
        for key in name_resolve.find_subtree(root):
            worker = key.rsplit("/", 1)[-1]
            try:
                out[worker] = name_resolve.get(key)
            except name_resolve.NameEntryNotFoundError:
                continue  # unregistered between scan and get
        return out

    # -- harvesting ---------------------------------------------------------

    def harvest_one(self, worker: str, addr: str) -> Dict[str, Any]:
        since = self._cursors.get(worker, 0)
        with urllib.request.urlopen(
            f"http://{addr}/trace?since={since}", timeout=self.harvest_timeout
        ) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
        # a payload that parses but isn't ours is garbage too
        if not isinstance(payload, dict) or not isinstance(
            payload.get("events"), list
        ):
            raise ValueError(f"malformed trace payload from {worker}")
        return payload

    def harvest(
        self,
    ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        """(events, open_spans) across every reachable worker.  Failures
        are counted and skipped — the cursor is NOT advanced for a failed
        endpoint, so nothing in its ring is lost to a transient error."""
        events: List[Dict[str, Any]] = []
        open_spans: List[Dict[str, Any]] = []
        for worker, addr in sorted(self.discover().items()):
            try:
                payload = self.harvest_one(worker, addr)
            except Exception:  # noqa: BLE001 - dead worker != dead master
                self._m_errors.inc(endpoint=worker)
                logger.warning(
                    "trace harvest of %s (%s) failed", worker, addr,
                    exc_info=True,
                )
                continue
            self._cursors[worker] = int(payload.get("seq", 0))
            for e in payload["events"]:
                if isinstance(e, dict):
                    e.setdefault("w", payload.get("worker", worker))
                    events.append(e)
            for s in payload.get("open", []):
                if isinstance(s, dict):
                    s.setdefault("w", payload.get("worker", worker))
                    open_spans.append(s)
        return events, open_spans

    def ingest_local(self, tracer) -> int:
        """Harvest an in-process tracer directly (threaded/dryrun runs
        that have no per-worker HTTP endpoints)."""
        snap = tracer.snapshot(self._cursors.get("_local", 0))
        self._cursors["_local"] = snap["seq"]
        self._record(snap["events"], snap["open"], step=None)
        return len(snap["events"])

    # -- persistence + watchdog --------------------------------------------

    def _record(self, events, open_spans, step):
        if events:
            self._m_events.inc(len(events))
        if self._jsonl is not None:
            for e in events:
                if step is not None:
                    e = {**e, "hstep": step}
                self._jsonl.write(json.dumps(e, default=str) + "\n")
        self._last_open = open_spans

    def _current_version(self) -> Optional[int]:
        """Best-effort read of the latest published weight version (the
        buffer-age watchdog's reference point)."""
        import pickle

        try:
            raw = name_resolve.get(
                names.model_version(
                    self.experiment_name, self.trial_name, "actor"
                )
            )
            info = (
                pickle.loads(bytes.fromhex(raw))
                if isinstance(raw, str)
                else raw
            )
            return int(info["version"])
        except Exception:  # noqa: BLE001 - no version published yet
            return None

    def step(
        self,
        step: int,
        current_version: Optional[int] = None,
        fleet_slo: Optional[Dict[str, float]] = None,
    ) -> int:
        """One collection cycle: harvest every worker, persist, run the
        stall watchdog (span deadlines, buffer age, and — when the
        caller passes the aggregator's fleet SLO row — the p99-TTFT
        percentile alarm).  Returns the number of events harvested."""
        events, open_spans = self.harvest()
        self._record(events, open_spans, step)
        if current_version is None:
            current_version = self._current_version()
        self.watchdog.check(open_spans, current_version=current_version)
        if fleet_slo is not None:
            from areal_tpu_torch.observability.latency import FLEET_TTFT_P99_KEY

            self.watchdog.check_slo(fleet_slo.get(FLEET_TTFT_P99_KEY))
        return len(events)

    # -- export -------------------------------------------------------------

    def export_perfetto(self, path: Optional[str] = None) -> Optional[str]:
        """Convert the jsonl this collector wrote into a Chrome/Perfetto
        ``trace_event`` file (load via ui.perfetto.dev or
        chrome://tracing).  Reads the file back rather than holding every
        event in memory for the trial's lifetime."""
        if self.out_dir is None:
            return None
        src = os.path.join(self.out_dir, "traces.jsonl")
        if not os.path.exists(src):
            return None
        events = load_traces_jsonl(src)
        obj = to_trace_events(events)
        problems = validate_trace_events(obj)
        if problems:  # never export an artifact Perfetto would reject
            logger.error("perfetto export failed validation: %s", problems[:5])
            return None
        path = path or os.path.join(self.out_dir, "trace_perfetto.json")
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
            try:
                self.export_perfetto()
            except Exception:  # noqa: BLE001 - export is best-effort
                logger.exception("perfetto export failed")


def load_traces_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a ``traces.jsonl`` back; skips unparseable lines (a crashed
    writer may leave a truncated tail)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def timeline(events, root: str) -> List[Dict[str, Any]]:
    """All events of one trace root, time-ordered — the 'what happened
    to THIS sample' query the flight recorder exists for."""
    sel = [e for e in events if e.get("root") == root]
    sel.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return sel
