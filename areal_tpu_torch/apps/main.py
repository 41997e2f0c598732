"""Experiment launcher: one process per worker, watched, restarted on
failure (port of ``areal_tpu/apps/main.py``).

``launch_experiment`` dumps the ``ExperimentConfig`` for the workers,
starts every worker as ``python -m areal_tpu_torch.apps.remote`` through a
scheduler client, and watches them: a failed job, a master in ERROR, a
heartbeat older than ``AREAL_HEARTBEAT_TIMEOUT`` seconds (default 60) or
the deadline ends the launch.  The restart policy then stops every process
and launches them all again with ``AREAL_RECOVER=1``, up to
``recover_retries`` times: the master resumes from its recover info and
the model workers reload their last train-state checkpoint.  When the
master completes, the other workers are asked to exit and are reaped.

An experiment's ``evaluator`` is stepped by the monitor loop: it submits
an eval job per HF save through the launcher's scheduler layer; every exit
path harvests what finished and stops a job still running.  The gateway
worker stays refused, as ``ExperimentConfig.lazy_init`` refuses it
(ROADMAP.md queue 1, item 16).

Usage::

    python -m areal_tpu_torch.apps.main stop --experiment_name E --trial_name T
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.api import system_api
from areal_tpu_torch.apps import remote
from areal_tpu_torch.base import constants, logging_, name_resolve, names
from areal_tpu_torch.scheduler.client import JobException, JobState, make_scheduler
from areal_tpu_torch.system.worker_base import (
    WorkerControlPanel,
    WorkerServerStatus,
)

logger = logging_.getLogger("launcher")


def _worker_specs(cfg: system_api.ExperimentConfig) -> List[Tuple[str, int, str]]:
    """[(worker_type, index, worker_name)] for every worker process."""
    specs = [("master", 0, cfg.master.worker_name)]
    for i, w in enumerate(cfg.model_workers):
        specs.append(("model_worker", i, w.worker_name))
    for i, w in enumerate(cfg.gen_servers):
        specs.append(("gen_server", i, w.worker_name))
    if cfg.gserver_manager is not None:
        specs.append(("gserver_manager", 0, cfg.gserver_manager.worker_name))
    for i, w in enumerate(cfg.rollout_workers):
        specs.append(("rollout_worker", i, w.worker_name))
    if getattr(cfg, "gateway", None) is not None:
        specs.append(("gateway", 0, cfg.gateway.worker_name))
    return specs


def launch_experiment(
    cfg: system_api.ExperimentConfig,
    mode: str = "local",
    recover_retries: int = 0,
    timeout: Optional[float] = None,
    env: Optional[Dict[str, str]] = None,
) -> None:
    """Launch every worker as its own process and watch them to the end.

    A failed launch is restarted, every process anew and with
    ``AREAL_RECOVER=1``, up to ``recover_retries`` times; the last
    failure is raised."""
    for attempt in range(recover_retries + 1):
        if attempt > 0:
            logger.warning("restarting experiment (recover attempt %d/%d)",
                           attempt, recover_retries)
        try:
            _launch_once(cfg, mode=mode, timeout=timeout, env=env,
                         recover=attempt > 0)
            return
        except (JobException, TimeoutError) as e:
            logger.error("launch %d failed: %s", attempt, e)
            if attempt == recover_retries:
                raise


def _launch_once(
    cfg: system_api.ExperimentConfig,
    mode: str,
    timeout: Optional[float],
    env: Optional[Dict[str, str]],
    recover: bool = False,
) -> None:
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    backend = os.environ.get("AREAL_NAME_RESOLVE", "nfs")
    name_resolve.reconfigure(backend)
    # a launch starts from an empty trial subtree: no address, status or
    # version of a dead process may reach the new ones
    name_resolve.clear_subtree(names.trial_root(cfg.experiment_name,
                                                cfg.trial_name))
    remote.dump_experiment_config(cfg)

    sched = make_scheduler(mode, cfg.experiment_name, cfg.trial_name)
    wenv = {
        "AREAL_NAME_RESOLVE": backend,
        # the server backend finds its endpoint here, so the workers need
        # it as much as the backend's name
        **({"AREAL_NAME_RESOLVE_ADDR": os.environ["AREAL_NAME_RESOLVE_ADDR"]}
           if os.environ.get("AREAL_NAME_RESOLVE_ADDR") else {}),
        **({"AREAL_RECOVER": "1"} if recover else {}),
        **(env or {}),
    }
    log_dir = constants.get_log_path()
    specs = _worker_specs(cfg)
    for wtype, idx, wname in specs:
        sched.submit(
            wtype,
            [sys.executable, "-m", "areal_tpu_torch.apps.remote",
             "--experiment_name", cfg.experiment_name,
             "--trial_name", cfg.trial_name,
             "--worker_type", wtype,
             "--worker_index", str(idx)],
            env=dict(wenv),
            log_path=os.path.join(log_dir, f"{wname}.log"),
        )
    try:
        _monitor(sched, cfg, specs, timeout)
    except BaseException:
        sched.stop_all()
        raise


def _log_tail(log_dir: str, specs, job_name: str, n: int = 20):
    """The last ``n`` lines of a failed job's worker log, for the
    launcher's own log (the scheduler names jobs ``<type>/<index>``)."""
    wtype, _, idx = job_name.partition("/")
    for t, i, wname in specs:
        if t == wtype and str(i) == idx:
            path = os.path.join(log_dir, f"{wname}.log")
            try:
                with open(path, errors="replace") as f:
                    return "".join(f.readlines()[-n:])
            except OSError:
                return f"(no log at {path})"
    return ""


def _monitor(
    sched,
    cfg: system_api.ExperimentConfig,
    specs: List[Tuple[str, int, str]],
    timeout: Optional[float],
) -> None:
    """Watch the jobs and the workers' statuses until the master
    completes, then ask the other workers to exit."""
    deadline = time.monotonic() + timeout if timeout else None
    master_name = cfg.master.worker_name
    status_key = names.worker_status(cfg.experiment_name, cfg.trial_name,
                                     master_name)
    # beats come from a daemon thread: this bounds a process's liveness,
    # not the length of one step
    hb_timeout = float(os.environ.get("AREAL_HEARTBEAT_TIMEOUT", "60"))
    panel = WorkerControlPanel(cfg.experiment_name, cfg.trial_name)
    evaluator = _make_evaluator(cfg)
    try:
        _monitor_loop(sched, deadline, status_key, master_name, panel,
                      [w for _, _, w in specs], hb_timeout,
                      evaluator=evaluator,
                      eval_interval=(cfg.evaluator.interval
                                     if evaluator is not None else 0.0))
    except JobException as e:
        panel.close()
        logger.error("the end of %s's log:\n%s", e.worker_type,
                     _log_tail(constants.get_log_path(), specs,
                               e.worker_type))
        raise
    except BaseException:
        panel.close()
        raise
    finally:
        # every exit path (a worker's failure, the deadline, Ctrl-C)
        # reaps the detached eval job, or a restart would race the orphan
        if evaluator is not None:
            evaluator._harvest()
            evaluator.shutdown()
    _shutdown_workers(sched, specs, panel, master_name)


def _make_evaluator(cfg: system_api.ExperimentConfig):
    """The checkpoint-watching evaluator the monitor loop steps (None when
    the experiment configures none); its jobs go through a local scheduler
    client of their own."""
    from areal_tpu_torch.scheduler.evaluator import make_evaluator

    return make_evaluator(cfg, scheduler_mode="local")


def _monitor_loop(sched, deadline, status_key, master_name, panel,
                  all_names, hb_timeout, evaluator=None, eval_interval=0.0):
    last_hb_check = time.monotonic()
    last_eval_step = time.monotonic()
    while True:
        for job in sched.find_all():
            if job.state == JobState.FAILED:
                logger.error("worker %s failed (exit code %s)", job.name,
                             job.exit_code)
                raise JobException(sched.run_name, job.name, job.host,
                                   job.state)
        try:
            master_status = name_resolve.get(status_key)
        except name_resolve.NameEntryNotFoundError:
            master_status = None
        if master_status == WorkerServerStatus.COMPLETED.value:
            return
        if master_status == WorkerServerStatus.ERROR.value:
            raise JobException(sched.run_name, master_name, "?",
                               JobState.FAILED)
        if time.monotonic() - last_hb_check > 10.0:
            last_hb_check = time.monotonic()
            stale = panel.find_stale_workers(all_names, timeout=hb_timeout)
            if stale:
                for w in stale:
                    logger.error("worker %s heartbeat stale > %.0fs; "
                                 "declaring LOST", w, hb_timeout)
                raise JobException(sched.run_name, stale[0], "?",
                                   JobState.FAILED)
        if evaluator is not None and (
                time.monotonic() - last_eval_step > eval_interval):
            last_eval_step = time.monotonic()
            evaluator.step()
        if deadline and time.monotonic() > deadline:
            raise TimeoutError("experiment timed out")
        time.sleep(0.5)


def _shutdown_workers(sched, specs, panel, master_name):
    """The master is done: ask every other worker to exit, then reap.
    All are asked at once: a worker takes a request only between two of
    its polls, and a rollout worker's poll can wait behind its in-flight
    generate calls for longer than the request's timeout.  A request that
    is not acknowledged in time stays queued, and the worker exits when
    it reads it.  The producers are asked first (rollout workers, then the
    manager, the servers and the model workers), so that none sits in a
    call to a worker that is gone."""
    others = [w for _, _, w in reversed(specs) if w != master_name]
    try:
        panel.connect(others, timeout=10)
        for w in panel.broadcast(others, "exit", timeout=10):
            logger.warning("worker %s did not ack exit", w)
    except Exception:  # noqa: BLE001 - best-effort shutdown
        logger.warning("could not connect the control panel for shutdown")
    finally:
        panel.close()
    try:
        sched.wait(
            timeout=30,
            check_status=(JobState.FAILED,),
            remove_status=(JobState.COMPLETED, JobState.CANCELLED),
        )
    except TimeoutError:
        logger.warning("workers still running after the master's exit; "
                       "killing them")
    finally:
        sched.stop_all()


def main_stop(experiment_name: str, trial_name: str):
    """Ask every worker of a running trial to exit (best effort)."""
    constants.set_experiment_trial_names(experiment_name, trial_name)
    name_resolve.reconfigure(os.environ.get("AREAL_NAME_RESOLVE", "nfs"))
    panel = WorkerControlPanel(experiment_name, trial_name)
    root = names.worker_root(experiment_name, trial_name)
    try:
        workers = [k.rsplit("/", 1)[-1]
                   for k in name_resolve.find_subtree(root)]
        panel.connect(workers, timeout=5)
        for w in workers:
            try:
                panel.request(w, "exit", timeout=5)
            except Exception:  # noqa: BLE001
                pass
    finally:
        panel.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="areal_tpu_torch experiment launcher")
    p.add_argument("command", choices=["stop"])
    p.add_argument("--experiment_name", required=True)
    p.add_argument("--trial_name", required=True)
    args = p.parse_args(argv)
    if args.command == "stop":
        main_stop(args.experiment_name, args.trial_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
