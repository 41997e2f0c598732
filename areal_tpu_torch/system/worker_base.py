"""Worker lifecycle base classes (port of ``areal_tpu/system/worker_base.py``:
``Worker`` with its ``_configure`` + ``_poll`` contract and run loop,
``PollResult``, and the ``WorkerServer`` command socket with its status
and heartbeat keys in name_resolve).

Not ported yet: the per-worker ``/metrics`` HTTP server that the JAX
package's ``WorkerServer`` starts (ROADMAP.md queue 1, item 11), and the
controller side (``WorkerControlPanel``) and ``AsyncWorker`` (item 5).
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import queue
import threading
import time
from typing import Any, Dict, Optional

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
        """Write a liveness timestamp."""
        name_resolve.add(self._heartbeat_key, str(time.time()), replace=True)

    def _beat_loop(self):
        while not self._beat_stop.wait(HEARTBEAT_INTERVAL):
            try:
                self.beat()
            except Exception:  # noqa: BLE001 - dying beats = declared LOST
                logger.warning("heartbeat write failed", exc_info=True)

    def register_handler(self, command: str, fn):
        self._handlers[command] = fn

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
