"""End-to-end sample tracing: the flight-recorder span/event API (the
worker-side part of ``areal_tpu/observability/tracing.py``).

* a **trace** is one rollout's lifetime, identified by its rollout qid
  (the *trace root*); every derived request id (group members
  ``{qid}-{i}``, turns ``{qid}@t{j}-{i}``, retries ``{qid}-{i}#r{n}``)
  maps back to the root via :func:`member_root`.
* workers record **spans** (``span_begin``/``span_end`` or the ``span``
  context manager -> one complete event with a duration) and instant
  **events** into a bounded in-memory ring; a full ring drops the oldest
  events (counted).

Sampling: tracing is default-on but records only a deterministic hash
slice of trace roots (:attr:`TraceConfig.sample_rate`), so every worker
samples the same rollouts without coordination; retries are always
recorded, and :meth:`Tracer.force` records a root explicitly (a weight
swap's ``swap-v{n}`` root).  The collector that harvests the rings and
the ``/trace`` HTTP route are not ported yet (ROADMAP.md queue 1, item
11).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional


@dataclasses.dataclass
class TraceConfig:
    """Flight-recorder knobs (threaded through the worker configs in
    ``api/system_api.py``; ``None`` there means "ambient defaults")."""

    enabled: bool = True
    #: fraction of trace roots recorded, decided by a deterministic hash
    #: of the root so every worker samples the same rollouts without
    #: coordination.  Retries / forced roots are always recorded.
    sample_rate: float = 0.1
    #: per-worker ring capacity (events); overflow drops oldest, counted
    ring_size: int = 8192
    #: stall watchdog: an open span with no activity (no end, and no
    #: newer event on its trace) for this long is flagged
    stall_span_timeout_s: float = 120.0
    #: stall watchdog: an open buffer-resident span whose recorded weight
    #: version lags the current version by more than this is flagged
    stall_buffer_versions: int = 8
    #: SLO percentile alarm: fleet-merged p99 TTFT (seconds) above this
    #: threshold for ``slo_breach_scrapes`` CONSECUTIVE scrape cycles
    #: fires ``areal_trace_stall_total{kind="slo"}`` once (re-armed when
    #: p99 recovers).  None disables the alarm.
    slo_ttft_p99_s: Optional[float] = None
    slo_breach_scrapes: int = 3


#: env fallback for processes that receive no TraceConfig (bench arms,
#: standalone tools): AREAL_TRACE=0 disables, AREAL_TRACE_SAMPLE_RATE=x
#: overrides the rate
ENABLE_ENV = "AREAL_TRACE"
RATE_ENV = "AREAL_TRACE_SAMPLE_RATE"

_RETRY_RE = re.compile(r"#r\d+$")


def strip_retry(qid: str) -> str:
    """Drop a retry-retirement suffix: ``{id}#r{n}`` -> ``{id}``."""
    return _RETRY_RE.sub("", qid)


def member_root(qid: str) -> str:
    """Trace root of a DERIVED id (group member / turn member / retry
    id / trajectory id): strip the retry suffix, then one trailing
    ``-{suffix}`` member index, then any ``@t{j}`` turn tag.  Only valid
    for derived ids — the rollout qid itself may end in ``-{counter}``
    and must be passed as its own root by call sites that hold it."""
    qid = strip_retry(qid)
    base = qid.rsplit("-", 1)[0] if "-" in qid else qid
    return base.split("@", 1)[0]


def _default_config() -> TraceConfig:
    cfg = TraceConfig()
    if os.environ.get(ENABLE_ENV, "") in ("0", "false", "off"):
        cfg.enabled = False
    rate = os.environ.get(RATE_ENV)
    if rate:
        try:
            cfg.sample_rate = float(rate)
        except ValueError:
            pass
    return cfg


class Tracer:
    """Per-process (== per-worker in production) trace recorder.

    Thread-safe; every mutation takes one lock.  Events are plain dicts
    (no third-party deps, consistent with the stdlib-only metrics plane):

    ``{"seq", "tid", "root", "name", "ph", "ts", "w", "attrs"}``
    with ``"dur"`` on complete (``ph == "X"``) events.  ``ph`` follows
    the Chrome trace_event phases the collector exports to: ``"X"`` =
    complete span, ``"i"`` = instant event.
    """

    def __init__(
        self,
        config: Optional[TraceConfig] = None,
        worker: str = "",
        clock=time.time,
    ):
        self.config = config or _default_config()
        self.worker = worker
        self._clock = clock
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=max(16, self.config.ring_size)
        )
        self._seq = 0
        self.dropped_total = 0
        # open spans: (tid, name) -> record dict (start ts + last
        # activity, for the collector's stall watchdog), plus a
        # root -> open-keys index so the per-event freshness touch is
        # O(spans of this trace), not a scan of every open span (the
        # master holds one buffer.resident span per sampled buffered
        # sample — a full scan per train.consume event would put
        # O(batch x open-spans) work under this lock every train step)
        self._open: Dict[tuple, Dict[str, Any]] = {}
        self._open_roots: Dict[str, set] = {}
        # memoized per-root sampling decisions (the decode hot loop asks
        # per chunk per row); bounded so an unbounded qid stream cannot
        # grow host memory
        self._decisions: Dict[str, bool] = {}
        self._forced: set = set()

    # -- sampling -----------------------------------------------------------

    def sampled(self, tid: str, root: Optional[str] = None) -> bool:
        """Record events for this id?  Deterministic across processes:
        crc32 of the root against ``sample_rate``, retry ids ("#r") and
        forced roots always sample."""
        if not self.config.enabled:
            return False
        if "#r" in tid:
            return True
        root = root if root is not None else member_root(tid)
        dec = self._decisions.get(root)
        if dec is None:
            if len(self._decisions) >= 4096:
                self._decisions.clear()
            rate = self.config.sample_rate
            dec = (
                rate >= 1.0
                or (rate > 0.0 and zlib.crc32(root.encode()) % 10000 < rate * 10000)
            )
            self._decisions[root] = dec
        return dec or root in self._forced

    def force(self, root: str):
        """Always record this root from now on (retry/stall escalation)."""
        with self._lock:
            if len(self._forced) >= 4096:
                self._forced.clear()
            self._forced.add(root)

    # -- recording ----------------------------------------------------------

    def _append(self, rec: Dict[str, Any]):
        self._seq += 1
        rec["seq"] = self._seq
        if len(self._events) == self._events.maxlen:
            self.dropped_total += 1
        self._events.append(rec)

    def event(
        self, tid: str, name: str, root: Optional[str] = None, **attrs
    ):
        """Record an instant event on trace ``tid``.  ``root`` overrides
        the derived trace root (pass it when ``tid`` IS the rollout qid —
        syntactic derivation would mangle it)."""
        r = root if root is not None else member_root(tid)
        if not self.sampled(tid, r):
            return
        now = self._clock()
        with self._lock:
            self._append(
                {
                    "tid": tid, "root": r, "name": name, "ph": "i",
                    "ts": now, "w": self.worker, "attrs": attrs,
                }
            )
            # any activity on a trace keeps its open spans fresh for the
            # stall watchdog (a decoding qid's request span is "alive" as
            # long as chunk events keep arriving)
            for key in self._open_roots.get(r, ()):
                self._open[key]["last_ts"] = now

    def span_begin(
        self, tid: str, name: str, root: Optional[str] = None, **attrs
    ):
        self._begin(tid, name, root, attrs)

    def span_end(
        self, tid: str, name: str, root: Optional[str] = None, **attrs
    ):
        self._end(tid, name, root, attrs)

    @contextlib.contextmanager
    def span(self, tid: str, name: str, root: Optional[str] = None, **attrs):
        self._begin(tid, name, root, attrs)
        try:
            yield
        finally:
            self._end(tid, name, root, {})

    def _begin(self, tid, name, root, attrs):
        r = root if root is not None else member_root(tid)
        if not self.sampled(tid, r):
            return
        now = self._clock()
        with self._lock:
            self._open[(tid, name)] = {
                "tid": tid, "root": r, "name": name, "ts": now,
                "last_ts": now, "w": self.worker, "attrs": dict(attrs),
            }
            self._open_roots.setdefault(r, set()).add((tid, name))

    def _end(self, tid, name, root, attrs):
        r = root if root is not None else member_root(tid)
        if not self.sampled(tid, r):
            return
        now = self._clock()
        with self._lock:
            rec = self._open.pop((tid, name), None)
            if rec is not None:
                keys = self._open_roots.get(rec["root"])
                if keys is not None:
                    keys.discard((tid, name))
                    if not keys:
                        del self._open_roots[rec["root"]]
            start = rec["ts"] if rec else now
            merged = dict(rec["attrs"]) if rec else {}
            merged.update(attrs)
            self._append(
                {
                    "tid": tid, "root": r, "name": name, "ph": "X",
                    "ts": start, "dur": max(0.0, now - start),
                    "w": self.worker, "attrs": merged,
                }
            )

    # -- harvest ------------------------------------------------------------

    def snapshot(self, since: int = 0) -> Dict[str, Any]:
        """Cursor-based harvest payload: events with ``seq > since`` plus
        every currently-open span (for the stall watchdog).  Read-only —
        repeated snapshots at the same cursor return the same events, so
        a crashed-and-restarted collector loses nothing still in the
        ring."""
        with self._lock:
            events = [e for e in self._events if e["seq"] > since]
            open_spans = [dict(rec) for rec in self._open.values()]
            return {
                "worker": self.worker,
                "seq": self._seq,
                "dropped": self.dropped_total,
                "events": events,
                "open": open_spans,
            }

    def open_spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(rec) for rec in self._open.values()]

    def clear(self):
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._open_roots.clear()
            self._decisions.clear()
            self._forced.clear()


_default_lock = threading.Lock()
_default_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process-global tracer every in-process instrument writes to
    (one worker per process in production, mirroring ``get_registry``)."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer()
        return _default_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Swap (or with None, reset) the process-global tracer — tests and
    bench A/B arms."""
    global _default_tracer
    with _default_lock:
        _default_tracer = tracer


def configure(
    config: Optional[TraceConfig], worker: Optional[str] = None
) -> Tracer:
    """Apply a worker config to the process tracer (keeps the ring)."""
    t = get_tracer()
    if config is not None:
        t.config = config
        t._decisions.clear()
    if worker is not None:
        t.worker = worker
    return t
