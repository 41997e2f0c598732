"""Slurm scheduler client: sbatch job arrays with squeue/sacct polling
(port of ``areal_tpu/scheduler/slurm.py``).

A worker array maps onto one sbatch ``--array`` job whose elements each run
one worker command; the script is the JAX package's, line for line.
Workers meet through name_resolve exactly as with the local scheduler.

State mapping: squeue states {PENDING, CONFIGURING} -> PENDING; {RUNNING,
COMPLETING} -> RUNNING; a job id that left squeue is resolved through sacct
(COMPLETED / FAILED / CANCELLED); without sacct it is taken as COMPLETED.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from areal_tpu_torch.base import logging_
from areal_tpu_torch.scheduler.client import (
    JobException,
    JobInfo,
    JobState,
    SchedulerClient,
)

logger = logging_.getLogger("slurm_scheduler")

_SQUEUE_STATE = {
    "PENDING": JobState.PENDING,
    "CONFIGURING": JobState.PENDING,
    "RUNNING": JobState.RUNNING,
    "COMPLETING": JobState.RUNNING,
    "COMPLETED": JobState.COMPLETED,
    "FAILED": JobState.FAILED,
    "CANCELLED": JobState.CANCELLED,
    "TIMEOUT": JobState.FAILED,
    "OUT_OF_MEMORY": JobState.FAILED,
    "NODE_FAIL": JobState.FAILED,
    "PREEMPTED": JobState.CANCELLED,
}


def _run(cmd: Sequence[str], timeout: float = 30.0) -> str:
    out = subprocess.run(
        list(cmd), capture_output=True, text=True, timeout=timeout
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed ({out.returncode}): {out.stderr.strip()}"
        )
    return out.stdout


class SlurmSchedulerClient(SchedulerClient):
    """One sbatch array job per worker type; squeue-driven wait loop."""

    def __init__(
        self,
        expr_name: str,
        trial_name: str,
        partition: Optional[str] = None,
        account: Optional[str] = None,
        time_limit: Optional[str] = None,
        cpus_per_task: int = 8,
        mem_per_task: str = "16G",
        extra_sbatch_lines: Sequence[str] = (),
        script_dir: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        super().__init__(expr_name, trial_name)
        self.partition = partition
        self.account = account
        self.time_limit = time_limit
        self.cpus_per_task = cpus_per_task
        self.mem_per_task = mem_per_task
        self.extra_sbatch_lines = list(extra_sbatch_lines)
        self.script_dir = script_dir or os.path.join(
            tempfile.gettempdir(), "areal_tpu_torch", "slurm",
            expr_name, trial_name,
        )
        self._env = dict(env or {})
        # job name -> (slurm job id, JobInfo)
        self._jobs: Dict[str, JobInfo] = {}
        self._job_ids: Dict[str, str] = {}

    # -- submission ---------------------------------------------------------

    def submit(self, worker_type: str, cmd: Sequence[str], **kwargs) -> None:
        self.submit_array(worker_type, [cmd], **kwargs)

    def submit_array(
        self,
        worker_type: str,
        cmd_list: Sequence[Sequence[str]],
        log_path: Optional[str] = None,
        **kwargs,
    ) -> None:
        """One sbatch ``--array=0..n-1`` job; element i runs ``cmd_list[i]``."""
        os.makedirs(self.script_dir, exist_ok=True)
        job_name = f"{self.expr_name}_{self.trial_name}_{worker_type}"
        script_path = os.path.join(self.script_dir, f"{worker_type}.sbatch")
        n = len(cmd_list)
        lines = ["#!/bin/bash", f"#SBATCH --job-name={job_name}"]
        if n > 1:
            lines.append(f"#SBATCH --array=0-{n - 1}")
        if self.partition:
            lines.append(f"#SBATCH --partition={self.partition}")
        if self.account:
            lines.append(f"#SBATCH --account={self.account}")
        if self.time_limit:
            lines.append(f"#SBATCH --time={self.time_limit}")
        lines.append(f"#SBATCH --cpus-per-task={self.cpus_per_task}")
        lines.append(f"#SBATCH --mem={self.mem_per_task}")
        if log_path:
            os.makedirs(os.path.dirname(log_path), exist_ok=True)
            lines.append(f"#SBATCH --output={log_path}.%a")
        lines.extend(self.extra_sbatch_lines)
        for k, v in self._env.items():
            lines.append(f"export {k}={v!r}")
        if n > 1:
            lines.append('case "$SLURM_ARRAY_TASK_ID" in')
            for i, cmd in enumerate(cmd_list):
                quoted = " ".join(_shquote(c) for c in cmd)
                lines.append(f"{i}) exec {quoted} ;;")
            lines.append("esac")
        else:
            quoted = " ".join(_shquote(c) for c in cmd_list[0])
            lines.append(f"exec {quoted}")
        with open(script_path, "w") as f:
            f.write("\n".join(lines) + "\n")

        out = _run(["sbatch", script_path])
        # stdout contract: "Submitted batch job <id>"
        job_id = out.strip().split()[-1]
        self._job_ids[worker_type] = job_id
        self._jobs[worker_type] = JobInfo(
            name=worker_type, state=JobState.PENDING, host="slurm"
        )
        logger.info(
            "sbatch %s -> job %s (%d array elements)", worker_type, job_id, n
        )

    # -- state --------------------------------------------------------------

    def _refresh(self):
        if not self._job_ids:
            return
        ids = ",".join(self._job_ids.values())
        try:
            out = _run(
                ["squeue", "-j", ids, "-o", "%i %T", "--noheader"]
            )
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            out = ""  # all jobs may have left the queue
        seen: Dict[str, JobState] = {}
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 2:
                continue
            jid = parts[0].split("_")[0]  # array elements report id_index
            state = _SQUEUE_STATE.get(parts[1], JobState.RUNNING)
            # any running element keeps the array RUNNING; any failed element
            # fails it
            prev = seen.get(jid)
            if state == JobState.FAILED or prev == JobState.FAILED:
                seen[jid] = JobState.FAILED
            elif state == JobState.RUNNING or prev == JobState.RUNNING:
                seen[jid] = JobState.RUNNING
            else:
                seen[jid] = state
        for name, jid in self._job_ids.items():
            job = self._jobs[name]
            if job.state in (
                JobState.COMPLETED,
                JobState.FAILED,
                JobState.CANCELLED,
            ):
                continue
            if jid in seen:
                job.state = seen[jid]
            else:
                job.state = self._resolve_finished(jid)

    def _resolve_finished(self, job_id: str) -> JobState:
        """A job no longer in squeue: ask sacct how it ended."""
        try:
            out = _run(
                ["sacct", "-j", job_id, "-o", "State", "-n", "-P", "-X"]
            )
        except (RuntimeError, OSError, FileNotFoundError,
                subprocess.TimeoutExpired):
            return JobState.COMPLETED  # no accounting: assume clean exit
        states = [s.strip().split()[0] for s in out.splitlines() if s.strip()]
        if any(s.startswith("FAILED") or s.startswith("TIMEOUT")
               or s.startswith("OUT_OF_ME") or s.startswith("NODE_FAIL")
               for s in states):
            return JobState.FAILED
        if any(s.startswith("CANCELLED") for s in states):
            return JobState.CANCELLED
        return JobState.COMPLETED

    # -- control ------------------------------------------------------------

    def stop_all(self) -> None:
        for name, jid in self._job_ids.items():
            try:
                _run(["scancel", jid])
            except (RuntimeError, OSError, subprocess.TimeoutExpired):
                logger.warning("scancel %s (%s) failed", jid, name)
            if self._jobs[name].state in (JobState.PENDING, JobState.RUNNING):
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
        poll_interval: float = 5.0,
    ) -> None:
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
            time.sleep(poll_interval)


def _shquote(s: str) -> str:
    import shlex

    return shlex.quote(str(s))
