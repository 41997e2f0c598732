"""Per-worker HTTP ``/metrics`` endpoint (port of
``areal_tpu/observability/server.py``).

The serving half of the observability plane.
A stdlib ``ThreadingHTTPServer`` runs on a daemon thread — no event-loop or
framework dependency — and registers its address in name_resolve under the
``base/names.py`` metric-server keys so the master-side aggregator (and any
real Prometheus with a file_sd bridge) can discover it.

Routes:
  ``/metrics``  Prometheus text exposition of the worker's registry
  ``/trace``    JSON flight-recorder harvest (``?since=<seq>`` cursor);
                the worker half of the distributed trace plane — same
                discovery key, same server, zero extra threads
  ``/healthz``  200 JSON liveness/lease probe: worker id, uptime, and
                the last-activity timestamp (refreshed by the worker's
                poll loop whenever a poll produced work) — the signal a
                lease/liveness layer or the aggregator's dead-endpoint
                triage reads without parsing a whole metrics page
  ``/profile``  on-demand profiler capture: ``?seconds=N`` starts a
                bounded ``torch.profiler.profile`` capture (CUDA activity
                on the card, CPU activity without one) into the worker's
                capture dir (ONE in flight — a second
                request gets 409), replies immediately with the capture
                path, and registers the path in name_resolve so the
                master/ops tooling can harvest it; ``?status=1`` reports
                without starting.  The capture writes ``trace.json``
                (Chrome trace events, kernel names included) there.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from areal_tpu_torch.base import logging_, name_resolve, names, network
from areal_tpu_torch.observability.registry import MetricsRegistry, get_registry
from areal_tpu_torch.observability.tracing import Tracer, get_tracer

logger = logging_.getLogger("metrics_server")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: launcher-wired fixed port (apps/main.py assigns one per worker from
#: AREAL_METRICS_PORT_BASE); unset/0 = bind any free port
PORT_ENV = "AREAL_METRICS_PORT"


def worker_group(worker_name: str) -> str:
    """Metric-server group of a worker: its type, i.e. the name with any
    trailing ``_<index>`` stripped (``model_worker_3`` -> ``model_worker``,
    ``master`` -> ``master``)."""
    return re.sub(r"_\d+$", "", worker_name)


class MetricsServer:
    """HTTP server exposing one registry; optionally name-resolve
    registered under ``names.metric_server(expr, trial, group, worker)``."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        port: int = 0,
        host: str = "0.0.0.0",
        tracer: Optional[Tracer] = None,
        capture_dir: Optional[str] = None,
    ):
        self.registry = registry or get_registry()
        self.tracer = tracer or get_tracer()
        # /profile state: ONE bounded capture in flight at a time
        self.capture_dir = capture_dir
        self._profile_lock = threading.Lock()
        self._profile_state = {"state": "idle"}
        self._profile_seq = 0
        self._registered_ids: Optional[tuple] = None
        # /healthz state: identity + uptime + last activity.  Activity is
        # stamped by the worker's poll loop (note_activity) whenever a
        # poll produced work, so "alive but wedged" (HTTP up, poll loop
        # stuck) is distinguishable from "alive and working".
        self.worker_name = ""
        self._started_monotonic = time.monotonic()
        self.last_activity_ts = time.time()
        reg = self.registry
        trc = self.tracer
        srv = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = reg.render().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/trace":
                    try:
                        since = int(
                            urllib.parse.parse_qs(query)
                            .get("since", ["0"])[0]
                        )
                    except ValueError:
                        since = 0
                    body = json.dumps(
                        trc.snapshot(since), default=str
                    ).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    body = json.dumps(srv.health()).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/profile":
                    qs = urllib.parse.parse_qs(query)
                    if qs.get("status"):
                        code, reply = 200, srv.profile_status()
                    else:
                        try:
                            seconds = float(
                                qs.get("seconds", ["5"])[0]
                            )
                        except ValueError:
                            seconds = 5.0
                        code, reply = srv.start_profile(seconds)
                    body = json.dumps(reply).encode("utf-8")
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._registered_key: Optional[str] = None

    def health(self) -> dict:
        """The ``/healthz`` body: worker identity, uptime, and how stale
        the poll loop's last productive activity is."""
        now = time.time()
        return {
            "status": "ok",
            "worker": self.worker_name,
            "uptime_s": round(
                time.monotonic() - self._started_monotonic, 3
            ),
            "last_activity_ts": self.last_activity_ts,
            "last_activity_age_s": round(
                max(0.0, now - self.last_activity_ts), 3
            ),
        }

    def note_activity(self):
        """Stamp the last-activity clock (called from the worker's poll
        loop on productive polls; cheap enough for every poll)."""
        self.last_activity_ts = time.time()

    # -- /profile: on-demand bounded profiler capture ------------------------

    #: hard cap on one capture's duration — an operator typo must never
    #: leave the profiler (and its overhead) running for an hour
    PROFILE_MAX_SECONDS = 120.0

    def profile_status(self) -> dict:
        with self._profile_lock:
            return dict(self._profile_state)

    def start_profile(self, seconds: float) -> tuple:
        """Kick off one bounded ``torch.profiler`` capture on a background
        thread.  Returns ``(http_code, reply_dict)``: 200
        with the capture path when started, 409 while another capture is
        in flight (one at a time — captures are heavy), 500 when the
        profiler cannot start."""
        seconds = min(max(0.5, float(seconds)), self.PROFILE_MAX_SECONDS)
        with self._profile_lock:
            if self._profile_state.get("state") == "running":
                return 409, {
                    "status": "busy",
                    **{k: v for k, v in self._profile_state.items()},
                }
            self._profile_seq += 1
            base = self.capture_dir or os.path.join(
                os.environ.get("TMPDIR", "/tmp"), "areal_profiles"
            )
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                base,
                f"{self.worker_name or 'worker'}-{stamp}"
                f"-{self._profile_seq}",
            )
            try:
                os.makedirs(path, exist_ok=True)
            except OSError as e:
                return 500, {"status": "error", "error": str(e)}
            self._profile_state = {
                "state": "running",
                "path": path,
                "seconds": seconds,
                "started_ts": time.time(),
            }
        threading.Thread(
            target=self._profile_run,
            args=(path, seconds),
            daemon=True,
            name=f"profile-capture-{self._profile_seq}",
        ).start()
        self._register_capture(path)
        return 200, {"status": "started", "path": path, "seconds": seconds}

    def _profile_run(self, path: str, seconds: float):
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            # on the card, the device's activity (every kernel the process
            # enqueues, from any thread); without one, the CPU's.  Host ops
            # of every thread on a busy card make a capture's trace too
            # large to export without stalling the worker for seconds
            activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                          else [ProfilerActivity.CPU])
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            # the trace only (written by the profiler's C++ side): the
            # per-op table (key_averages) would build every event in Python
            # on the worker's interpreter
            trace = os.path.join(path, "trace.json")
            prof.export_chrome_trace(trace)
            state = {"state": "done", "path": path, "seconds": seconds,
                     "trace": trace}
        except Exception as e:  # noqa: BLE001 - report, never crash
            logger.exception("profiler capture into %s failed", path)
            state = {"state": "error", "path": path, "error": str(e)}
        with self._profile_lock:
            self._profile_state = state

    def _register_capture(self, path: str):
        """Publish the capture dir under the worker's profiler-capture
        key so the master (and collect_debug_bundle) can harvest it.
        Best-effort: an unregistered capture is still on disk."""
        if self._registered_ids is None:
            return
        expr, trial, worker = self._registered_ids
        try:
            name_resolve.add(
                names.profiler_capture(expr, trial, worker),
                path,
                replace=True,
            )
        except Exception:  # noqa: BLE001 - observability never kills work
            logger.exception("profiler capture registration failed")

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        return f"{network.gethostip()}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.25},
                daemon=True,
                name=f"metrics-server-{self.port}",
            )
            self._thread.start()
        return self

    def register(
        self, experiment_name: str, trial_name: str, worker_name: str
    ) -> str:
        """Publish this endpoint under the canonical metric-server key."""
        key = names.metric_server(
            experiment_name,
            trial_name,
            worker_group(worker_name),
            worker_name,
        )
        name_resolve.add(key, self.address, replace=True)
        self._registered_key = key
        self._registered_ids = (experiment_name, trial_name, worker_name)
        return key

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._registered_key is not None:
            try:
                name_resolve.delete(self._registered_key)
            except Exception:  # noqa: BLE001 - backend may already be gone
                pass
            self._registered_key = None


def start_worker_metrics_server(
    worker_name: str,
    experiment_name: str,
    trial_name: str,
    registry: Optional[MetricsRegistry] = None,
) -> Optional[MetricsServer]:
    """Best-effort per-worker endpoint: bind (launcher-wired port if
    ``AREAL_METRICS_PORT`` is set, else any free port), serve, register.
    Observability must never kill a worker — failures log and return None.

    Per-worker attribution assumes ONE worker per process (the production
    launch unit, apps/remote.py).  The chip check treats a missing
    endpoint as a failure: it asserts each worker's registration.  When several WorkerServers share a
    process (some tests), the default registry is shared too, so every
    endpoint serves the union page — accurate in aggregate, but the
    aggregator will attribute each series to every co-hosted worker; pass
    a dedicated ``registry`` per worker if that matters.  The threaded
    local runner creates workers without WorkerServers, so it registers
    no endpoints at all.
    """
    try:
        port = int(os.environ.get(PORT_ENV, "0") or "0")
        srv = MetricsServer(registry=registry, port=port).start()
        srv.worker_name = worker_name
        srv.register(experiment_name, trial_name, worker_name)
        logger.info(
            "worker %s serving /metrics at %s", worker_name, srv.address
        )
        return srv
    except Exception:  # noqa: BLE001 - see docstring
        logger.exception(
            "metrics server for %s failed to start; continuing without",
            worker_name,
        )
        return None
