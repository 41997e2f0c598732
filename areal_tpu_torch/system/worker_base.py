"""Worker lifecycle base classes (port of ``areal_tpu/system/worker_base.py``:
``Worker`` with its ``_configure`` + ``_poll`` contract and run loop,
``PollResult``, the ``WorkerServer`` command socket with its status and
heartbeat keys in name_resolve and its per-worker ``/metrics`` HTTP server
(:mod:`areal_tpu_torch.observability.server`: ``/metrics``, ``/trace``,
``/healthz``, ``/profile``), and the controller side,
``WorkerControlPanel``, which the multi-process launcher drives).
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import zmq

from areal_tpu_torch.base import constants, logging_, name_resolve, names, network

logger = logging_.getLogger("worker_base")


class WorkerServerStatus(str, enum.Enum):
    IDLE = "IDLE"
    CONFIGURING = "CONFIGURING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    COMPLETED = "COMPLETED"
    ERROR = "ERROR"
    LOST = "LOST"


@dataclasses.dataclass
class PollResult:
    sample_count: int = 0
    batch_count: int = 0


class WorkerException(Exception):
    def __init__(self, worker_name, worker_status, scenario):
        super().__init__(
            f"Worker {worker_name} is {worker_status} while {scenario}"
        )
        self.worker_name = worker_name
        self.worker_status = worker_status


#: seconds between heartbeat writes
HEARTBEAT_INTERVAL = 2.0
HEARTBEAT_TIMEOUT = 30.0


class WorkerServer:
    """Per-worker ZMQ REP command socket, its address registered in
    name_resolve, with the worker's status and heartbeat keys."""

    def __init__(self, worker_name: str, experiment_name: str, trial_name: str):
        self.worker_name = worker_name
        self._handlers: Dict[str, Any] = {}
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        port = self._sock.bind_to_random_port("tcp://*")
        name_resolve.add(
            names.worker(experiment_name, trial_name, worker_name),
            f"{network.gethostip()}:{port}",
            keepalive_ttl=None,
            replace=True,
        )
        # every worker serves its registry at /metrics (and its flight
        # recorder at /trace), found through the names.metric_server keys
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability.server import (
            start_worker_metrics_server,
            worker_group,
        )
        from areal_tpu_torch.observability.tracing import get_tracer

        self.tracer = get_tracer()
        self.tracer.worker = worker_name
        self.metrics_registry = get_registry()
        self.metrics_registry.gauge("areal_worker_info").set(
            1, worker=worker_name, group=worker_group(worker_name)
        )
        self._uptime_gauge = self.metrics_registry.gauge(
            "areal_worker_uptime_seconds"
        )
        self._start_time = time.monotonic()
        self.metrics_server = start_worker_metrics_server(
            worker_name, experiment_name, trial_name, self.metrics_registry
        )
        self._status = WorkerServerStatus.IDLE
        self._status_key = names.worker_status(
            experiment_name, trial_name, worker_name
        )
        name_resolve.add(self._status_key, self._status.value, replace=True)
        self._heartbeat_key = names.worker_heartbeat(
            experiment_name, trial_name, worker_name
        )
        self.beat()
        # beats come from a daemon thread, not the poll loop: one poll may
        # legitimately block for a whole step
        self._beat_stop = threading.Event()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, daemon=True, name=f"beat-{worker_name}"
        )
        self._beat_thread.start()

    def beat(self):
        """Write a liveness timestamp (and tick the uptime gauge: gauges
        are read at scrape time)."""
        name_resolve.add(self._heartbeat_key, str(time.time()), replace=True)
        self._uptime_gauge.set(time.monotonic() - self._start_time)

    def _beat_loop(self):
        while not self._beat_stop.wait(HEARTBEAT_INTERVAL):
            try:
                self.beat()
            except Exception:  # noqa: BLE001 - dying beats = declared LOST
                logger.warning("heartbeat write failed", exc_info=True)

    def register_handler(self, command: str, fn):
        self._handlers[command] = fn

    def note_activity(self):
        """Refresh the ``/healthz`` last-activity stamp (productive polls)."""
        if self.metrics_server is not None:
            self.metrics_server.note_activity()

    def set_status(self, status: WorkerServerStatus):
        self._status = status
        name_resolve.add(self._status_key, status.value, replace=True)

    @property
    def status(self) -> WorkerServerStatus:
        return self._status

    def handle_requests(self, max_requests: int = 8):
        """Non-blocking: serve up to ``max_requests`` queued commands."""
        for _ in range(max_requests):
            try:
                msg = self._sock.recv(flags=zmq.NOBLOCK)
            except zmq.ZMQError:
                return
            try:
                command, kwargs = pickle.loads(msg)
                if command == "status":
                    resp = ("ok", self._status.value)
                elif command in self._handlers:
                    resp = ("ok", self._handlers[command](**kwargs))
                else:
                    resp = ("error", f"unknown command {command}")
            except Exception as e:  # noqa: BLE001 - report to controller
                logger.exception("command %s failed", msg[:64])
                resp = ("error", repr(e))
            self._sock.send(pickle.dumps(resp))

    def close(self):
        self._beat_stop.set()
        self._beat_thread.join(timeout=HEARTBEAT_INTERVAL + 1)
        self._sock.close(linger=0)
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None


class WorkerControlPanel:
    """Controller side: a REQ socket to every worker's server, and the
    workers' status and heartbeat keys."""

    def __init__(self, experiment_name: str, trial_name: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._ctx = zmq.Context.instance()
        self._socks: Dict[str, zmq.Socket] = {}
        # worker -> (last heartbeat value seen, our monotonic time when it
        # was first seen): staleness is judged on this process's clock from
        # the last change, so clock skew between hosts cannot fake a missed
        # (or a fresh) beat
        self._hb_seen: Dict[str, tuple] = {}

    def connect(self, worker_names: List[str], timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        for wname in worker_names:
            addr = name_resolve.wait(
                names.worker(self.experiment_name, self.trial_name, wname),
                timeout=max(0.1, deadline - time.monotonic()),
            )
            sock = self._ctx.socket(zmq.REQ)
            sock.connect(f"tcp://{addr}")
            self._socks[wname] = sock

    @property
    def worker_names(self) -> List[str]:
        return list(self._socks)

    def request(
        self, worker_name: str, command: str, timeout: float = 300.0, **kwargs
    ):
        sock = self._socks[worker_name]
        sock.send(pickle.dumps((command, kwargs)))
        if not sock.poll(timeout=int(timeout * 1000)):
            raise TimeoutError(
                f"worker {worker_name} did not reply to {command}"
            )
        status, payload = pickle.loads(sock.recv())
        if status != "ok":
            raise WorkerException(worker_name, payload, f"requesting {command}")
        return payload

    def group_request(self, command: str, timeout: float = 300.0, **kwargs):
        return {
            w: self.request(w, command, timeout=timeout, **kwargs)
            for w in self.worker_names
        }

    def broadcast(self, worker_names: List[str], command: str,
                  timeout: float = 10.0) -> List[str]:
        """Send ``command`` to every worker of ``worker_names`` at once and
        collect the replies within one ``timeout``: a worker whose poll is
        busy costs the wait once, not once per worker.  Returns the workers
        that did not reply (their sockets are closed: a REQ socket that
        lost its reply cannot send again)."""
        for w in worker_names:
            self._socks[w].send(pickle.dumps((command, {})))
        deadline = time.monotonic() + timeout
        silent = []
        for w in worker_names:
            sock = self._socks[w]
            left = max(0.0, deadline - time.monotonic())
            if sock.poll(timeout=int(left * 1000)):
                sock.recv()
            else:
                silent.append(w)
                sock.close(linger=0)
                del self._socks[w]
        return silent

    def get_worker_status(self, worker_name: str) -> WorkerServerStatus:
        try:
            return WorkerServerStatus(name_resolve.get(names.worker_status(
                self.experiment_name, self.trial_name, worker_name)))
        except name_resolve.NameEntryNotFoundError:
            return WorkerServerStatus.LOST

    def get_heartbeat_age(self, worker_name: str) -> Optional[float]:
        """Seconds, on this process's monotonic clock, since the worker's
        heartbeat value was last seen to change; None if it never beat (a
        worker that never registered cannot be declared lost yet)."""
        try:
            val = name_resolve.get(names.worker_heartbeat(
                self.experiment_name, self.trial_name, worker_name))
        except name_resolve.NameEntryNotFoundError:
            return None
        now = time.monotonic()
        seen = self._hb_seen.get(worker_name)
        if seen is None or seen[0] != val:
            self._hb_seen[worker_name] = (val, now)
            return 0.0
        return now - seen[1]

    def find_stale_workers(
        self, worker_names: List[str], timeout: float = HEARTBEAT_TIMEOUT
    ) -> List[str]:
        """Workers whose heartbeat is older than ``timeout`` and whose
        status is not terminal: they should be alive and stopped beating."""
        stale = []
        for w in worker_names:
            if self.get_worker_status(w) in (
                WorkerServerStatus.COMPLETED, WorkerServerStatus.ERROR
            ):
                continue
            age = self.get_heartbeat_age(w)
            if age is not None and age > timeout:
                stale.append(w)
        return stale

    def close(self):
        for s in self._socks.values():
            s.close(linger=0)


class Worker:
    """Synchronous worker: a subclass implements ``_configure`` and
    ``_poll``; :meth:`run` waits for a config, then polls until
    :meth:`exit`."""

    def __init__(self, server: Optional[WorkerServer] = None):
        self._server = server
        self._configured = False
        self.__running = False
        self.__exiting = False
        self._exit_status: Optional[WorkerServerStatus] = None
        self.worker_name = server.worker_name if server else "worker"
        self.logger = logging_.getLogger(self.worker_name)
        self._config_queue: "queue.Queue" = queue.Queue()
        if server is not None:
            server.register_handler("configure", self._on_configure_cmd)
            server.register_handler("start", self._on_start)
            server.register_handler("pause", self._on_pause)
            server.register_handler("exit", self._on_exit)
            server.register_handler("ping", lambda: "pong")

    # -- command handlers ---------------------------------------------------

    def _on_configure_cmd(self, config=None):
        self._config_queue.put(config)
        return "configured"

    def _on_start(self):
        self.__running = True
        if self._server:
            self._server.set_status(WorkerServerStatus.RUNNING)
        return "started"

    def _on_pause(self):
        self.__running = False
        if self._server:
            self._server.set_status(WorkerServerStatus.PAUSED)
        return "paused"

    def _on_exit(self):
        self.exit()
        return "exiting"

    # -- subclass contract --------------------------------------------------

    def _configure(self, config) -> None:
        raise NotImplementedError()

    def _poll(self) -> PollResult:
        raise NotImplementedError()

    def _exit_hook(self):
        pass

    # -- lifecycle ----------------------------------------------------------

    def configure(self, config):
        if self._server:
            self._server.set_status(WorkerServerStatus.CONFIGURING)
        self._configure(config)
        self._configured = True
        if self._server:
            # a "start" served while the config waited in the queue stands
            self._server.set_status(
                WorkerServerStatus.RUNNING if self.__running
                else WorkerServerStatus.IDLE
            )
        self.logger.debug("%s configured", self.worker_name)

    @property
    def exit_requested(self) -> bool:
        """True once exit() was called."""
        return self.__exiting

    def exit(self, status: WorkerServerStatus = WorkerServerStatus.COMPLETED):
        self.__exiting = True
        self._exit_status = status

    def run(self, config=None) -> WorkerServerStatus:
        if config is not None:
            self.__running = True
            self.configure(config)
        try:
            while not self.__exiting:
                if self._server:
                    self._server.handle_requests()
                if not self._configured:
                    try:
                        cfg = self._config_queue.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self.configure(cfg)
                    continue
                if not self.__running:
                    time.sleep(0.02)
                    continue
                r = self._poll()
                if r.sample_count == r.batch_count == 0:
                    time.sleep(0.002)
                elif self._server:
                    self._server.note_activity()
            status = self._exit_status or WorkerServerStatus.COMPLETED
            if self._server:
                self._server.set_status(status)
            self._exit_hook()
            return status
        except Exception:
            logger.exception("worker %s failed", self.worker_name)
            if self._server:
                self._server.set_status(WorkerServerStatus.ERROR)
            self._exit_hook()
            raise
        finally:
            if self._server:
                self._server.close()


class AsyncWorker(Worker):
    """Worker whose poll is a coroutine (the rollout worker and the
    master), run by :meth:`run_async`."""

    async def _poll_async(self) -> PollResult:
        raise NotImplementedError()

    def _poll(self) -> PollResult:  # pragma: no cover - sync fallback
        raise RuntimeError("AsyncWorker must be run with run_async()")

    def run_async(self, config=None) -> WorkerServerStatus:
        import asyncio

        async def _main():
            if config is not None:
                self._Worker__running = True  # noqa: SLF001
                self.configure(config)
            while not self._Worker__exiting:  # noqa: SLF001
                if self._server:
                    self._server.handle_requests()
                if not self._configured:
                    try:
                        cfg = self._config_queue.get_nowait()
                        self.configure(cfg)
                    except queue.Empty:
                        await asyncio.sleep(0.05)
                    continue
                if not self._Worker__running:  # noqa: SLF001
                    await asyncio.sleep(0.02)
                    continue
                r = await self._poll_async()
                if r.sample_count == r.batch_count == 0:
                    await asyncio.sleep(0.002)
                elif self._server:
                    self._server.note_activity()
            status = self._exit_status or WorkerServerStatus.COMPLETED
            if self._server:
                self._server.set_status(status)
            self._exit_hook()
            return status

        try:
            return asyncio.run(_main())
        except Exception:
            logger.exception("worker %s failed", self.worker_name)
            if self._server:
                self._server.set_status(WorkerServerStatus.ERROR)
            raise
        finally:
            if self._server:
                self._server.close()


def make_server(
    worker_name: str,
    experiment_name: Optional[str] = None,
    trial_name: Optional[str] = None,
) -> WorkerServer:
    return WorkerServer(
        worker_name,
        experiment_name or constants.experiment_name(),
        trial_name or constants.trial_name(),
    )
