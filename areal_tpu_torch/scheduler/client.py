"""Scheduler clients: submit, watch and stop arrays of worker processes
(port of ``areal_tpu/scheduler/client.py``).

``LocalSchedulerClient`` starts each worker as a subprocess of the
launcher, in a session of its own and with a parent-death signal, so a
launcher that dies takes its workers with it.  ``stop_all`` returns only
once every worker process has exited: on one card, a restart must not
start new processes while the old ones still hold device memory.  The
slurm client lives in ``scheduler/slurm.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import signal
import subprocess
import time
from typing import Dict, List, Optional, Sequence

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("scheduler")


class JobState(str, enum.Enum):
    NOT_FOUND = "NOT_FOUND"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


@dataclasses.dataclass
class JobInfo:
    name: str
    state: JobState
    host: str = "localhost"
    pid: Optional[int] = None
    exit_code: Optional[int] = None


class JobException(Exception):
    def __init__(self, run_name: str, worker_type: str, host: str, reason: JobState):
        super().__init__(f"Job {run_name}:{worker_type} {reason} on {host}")
        self.run_name = run_name
        self.worker_type = worker_type
        self.host = host
        self.reason = reason


# resolved at import: ``preexec_fn`` runs between fork and exec, where an
# import could deadlock on an import lock another thread held at the fork
try:
    import ctypes as _ctypes

    _libc_prctl = _ctypes.CDLL("libc.so.6", use_errno=True).prctl
except OSError:  # not Linux
    _libc_prctl = None

_PR_SET_PDEATHSIG = 1


def _child_setup():
    """Before a worker's exec: a session of its own (so ``killpg`` reaches
    the worker's whole tree), and SIGTERM when the launcher dies (so a
    killed launcher leaves no worker behind)."""
    os.setsid()
    if _libc_prctl is not None:
        _libc_prctl(_PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)


class SchedulerClient:
    """Submit, stop and wait for worker arrays."""

    def __init__(self, expr_name: str, trial_name: str):
        self.expr_name = expr_name
        self.trial_name = trial_name
        self.run_name = f"{expr_name}/{trial_name}"

    def submit(self, worker_type: str, cmd: Sequence[str], **kwargs) -> None:
        raise NotImplementedError()

    def submit_array(
        self, worker_type: str, cmd_list: Sequence[Sequence[str]], **kwargs
    ) -> None:
        for cmd in cmd_list:
            self.submit(worker_type, cmd, **kwargs)

    def stop_all(self) -> None:
        raise NotImplementedError()

    def find_all(self) -> List[JobInfo]:
        raise NotImplementedError()

    def wait(
        self,
        timeout: Optional[float] = None,
        check_status: Sequence[JobState] = (
            JobState.CANCELLED,
            JobState.FAILED,
            JobState.NOT_FOUND,
        ),
        remove_status: Sequence[JobState] = (JobState.COMPLETED,),
        update: bool = False,
    ) -> None:
        raise NotImplementedError()


class LocalSchedulerClient(SchedulerClient):
    """Each worker as a subprocess of this process."""

    #: seconds between SIGTERM and SIGKILL in :meth:`stop_all`
    STOP_GRACE = 10.0

    def __init__(self, expr_name: str, trial_name: str, env: Optional[Dict] = None):
        super().__init__(expr_name, trial_name)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._jobs: Dict[str, JobInfo] = {}
        self._env = dict(os.environ)
        if env:
            self._env.update(env)
        self._counter: Dict[str, int] = {}

    def submit(
        self,
        worker_type: str,
        cmd: Sequence[str],
        env: Optional[Dict] = None,
        log_path: Optional[str] = None,
        **kwargs,
    ) -> None:
        idx = self._counter.get(worker_type, 0)
        self._counter[worker_type] = idx + 1
        name = f"{worker_type}/{idx}"
        penv = dict(self._env)
        if env:
            penv.update(env)
        stdout = None
        if log_path:
            os.makedirs(os.path.dirname(log_path), exist_ok=True)
            stdout = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                list(cmd),
                env=penv,
                stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None,
                preexec_fn=_child_setup,
            )
        finally:
            if stdout is not None:
                stdout.close()  # the child holds its own copy
        self._procs[name] = proc
        self._jobs[name] = JobInfo(name=name, state=JobState.RUNNING, pid=proc.pid)
        logger.info("submitted %s pid=%d: %s", name, proc.pid, " ".join(cmd))

    def _refresh(self):
        for name, proc in self._procs.items():
            job = self._jobs[name]
            if job.state not in (JobState.RUNNING, JobState.PENDING):
                continue
            rc = proc.poll()
            if rc is None:
                continue
            job.exit_code = rc
            job.state = JobState.COMPLETED if rc == 0 else JobState.FAILED

    def stop_all(self) -> None:
        """SIGTERM every running worker's process group, SIGKILL what is
        left after :attr:`STOP_GRACE` seconds, and return once every
        worker process has exited."""
        self._refresh()
        for name, proc in self._procs.items():
            if self._jobs[name].state == JobState.RUNNING:
                _killpg(proc, signal.SIGTERM)
        deadline = time.monotonic() + self.STOP_GRACE
        for name, proc in self._procs.items():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                logger.warning("%s (pid %d) ignored SIGTERM; killing it",
                               name, proc.pid)
                _killpg(proc, signal.SIGKILL)
                proc.wait()
            if self._jobs[name].state == JobState.RUNNING:
                self._jobs[name].state = JobState.CANCELLED

    def find_all(self) -> List[JobInfo]:
        self._refresh()
        return list(self._jobs.values())

    def wait(
        self,
        timeout: Optional[float] = None,
        check_status: Sequence[JobState] = (
            JobState.CANCELLED,
            JobState.FAILED,
            JobState.NOT_FOUND,
        ),
        remove_status: Sequence[JobState] = (JobState.COMPLETED,),
        update: bool = False,
    ) -> None:
        """Block until every job leaves through ``remove_status``; raise
        ``JobException`` as soon as one reaches a ``check_status``."""
        deadline = time.monotonic() + timeout if timeout else None
        remaining = set(self._jobs)
        while remaining:
            self._refresh()
            for name in list(remaining):
                job = self._jobs[name]
                if job.state in check_status:
                    raise JobException(self.run_name, name, job.host, job.state)
                if job.state in remove_status:
                    remaining.discard(name)
            if not remaining:
                return
            if deadline and time.monotonic() > deadline:
                raise TimeoutError(
                    f"jobs still running at timeout: {sorted(remaining)}"
                )
            time.sleep(0.2)


def _killpg(proc: subprocess.Popen, sig: int):
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError):
        pass


def make_scheduler(
    mode: str, expr_name: str, trial_name: str, **kwargs
) -> SchedulerClient:
    if mode == "local":
        return LocalSchedulerClient(expr_name, trial_name, **kwargs)
    if mode == "slurm":
        from areal_tpu_torch.scheduler.slurm import SlurmSchedulerClient

        return SlurmSchedulerClient(expr_name, trial_name, **kwargs)
    raise ValueError(f"unknown scheduler mode {mode!r}")
