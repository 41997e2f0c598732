"""In-process experiment runner: the master and every worker as threads of
one process (port of ``areal_tpu/apps/local_runner.py``).

The workers are the port's: model workers, generation servers, the
gserver manager, rollout workers and the master.  On one card the
trainer and the servers share the device; each launches its work on its
own CUDA stream where it does (the server's staged restore, the trainer's
steps on the default stream), and nothing here synchronises the whole
device.  An experiment's ``evaluator`` runs on a thread of its own: it
submits an eval job per HF save through the local scheduler client and
logs each result by global step; the run's end stops it and kills a job
still running.  The serving gateway is refused by
``ExperimentConfig.lazy_init`` (ROADMAP.md queue 1, item 16).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from areal_tpu_torch.api import system_api
from areal_tpu_torch.base import constants, logging_, name_resolve, names
from areal_tpu_torch.system.master_worker import MasterWorker
from areal_tpu_torch.system.model_worker import ModelWorker
from areal_tpu_torch.system.worker_base import WorkerServerStatus

logger = logging_.getLogger("local_runner")


def register_impls(threads: bool = True):
    """Import the port's implementation modules so its registries (the
    datasets, agents, envs, backends, interfaces and experiments of
    ``api/*``) populate; with ``threads``, also resolve transformers'
    tokenizer classes now, for workers that will load tokenizers from
    threads of this process."""
    import areal_tpu_torch.agents.math_single_step_agent  # noqa: F401
    import areal_tpu_torch.engine.backend  # noqa: F401
    import areal_tpu_torch.envs.math_code_single_step_env  # noqa: F401
    import areal_tpu_torch.experiments.async_ppo_exp  # noqa: F401
    import areal_tpu_torch.experiments.dpo_exp  # noqa: F401
    import areal_tpu_torch.experiments.null_exp  # noqa: F401
    import areal_tpu_torch.experiments.ppo_math_exp  # noqa: F401
    import areal_tpu_torch.experiments.rm_exp  # noqa: F401
    import areal_tpu_torch.experiments.sft_exp  # noqa: F401
    import areal_tpu_torch.interfaces.dpo_interface  # noqa: F401
    import areal_tpu_torch.interfaces.fused_interface  # noqa: F401
    import areal_tpu_torch.interfaces.null_interface  # noqa: F401
    import areal_tpu_torch.interfaces.ppo_interface  # noqa: F401
    import areal_tpu_torch.interfaces.rm_interface  # noqa: F401
    import areal_tpu_torch.interfaces.rw_interface  # noqa: F401
    import areal_tpu_torch.interfaces.sft_interface  # noqa: F401
    from areal_tpu_torch.data import register_all

    register_all()

    if threads:
        # pre-resolve transformers' lazy attributes in the main thread: its
        # lazy module loader is not thread-safe, and worker threads load
        # tokenizers concurrently at configure time
        from transformers import AutoTokenizer  # noqa: F401


def run_experiment_local(
    cfg: system_api.ExperimentConfig,
    timeout: Optional[float] = None,
) -> MasterWorker:
    """Run to completion in this process; returns the master (stats inside)."""
    register_impls()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    # a trial name run before in this process must not hand its dead
    # workers' addresses to this run's (the manager reads the servers'
    # registrations as they appear)
    name_resolve.clear_subtree(
        names.trial_root(cfg.experiment_name, cfg.trial_name))

    workers: List[ModelWorker] = []
    threads: List[threading.Thread] = []
    errors: List[BaseException] = []

    def _run_worker(w, wcfg):
        try:
            w.run(wcfg)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    for wcfg in cfg.model_workers:
        w = ModelWorker()
        workers.append(w)
        t = threading.Thread(
            target=_run_worker, args=(w, wcfg), daemon=True,
            name=wcfg.worker_name,
        )
        t.start()
        threads.append(t)

    # rollout stack (async experiments)
    aux_threads, aux_workers = _start_rollout_stack(cfg, errors)

    # the automatic evaluator (the component the process launcher drives)
    evaluator = None
    eval_stop = threading.Event()
    if cfg.evaluator is not None:
        from areal_tpu_torch.scheduler.evaluator import (
            make_evaluator,
            run_evaluator_loop,
        )

        evaluator = make_evaluator(cfg)
        et = threading.Thread(
            target=run_evaluator_loop,
            args=(evaluator, eval_stop, cfg.evaluator.interval),
            daemon=True,
            name="evaluator",
        )
        et.start()
        aux_threads.append(et)

    master = MasterWorker()
    master_err: List[BaseException] = []

    def _run_master():
        try:
            master.run_async(cfg.master)
        except BaseException as e:  # noqa: BLE001
            master_err.append(e)

    mt = threading.Thread(target=_run_master, daemon=True, name="master")
    mt.start()
    deadline = time.monotonic() + timeout if timeout else None
    try:
        while mt.is_alive():
            mt.join(timeout=0.5)
            if errors:
                raise RuntimeError("worker failed") from errors[0]
            if deadline and time.monotonic() > deadline:
                raise TimeoutError("experiment timed out")
        if master_err:
            raise RuntimeError("master failed") from master_err[0]
    finally:
        # every worker stops on every exit path: a failed or timed-out run
        # must not leave engines decoding in daemon threads; nor may the
        # evaluator leave its detached eval job running
        eval_stop.set()
        if evaluator is not None:
            evaluator.shutdown()
        for w in workers + aux_workers:
            w.exit()
    for t in threads + aux_threads:
        t.join(timeout=10)
    return master


def _start_rollout_stack(cfg: system_api.ExperimentConfig, errors):
    threads = []
    aux = []
    if cfg.gen_servers:
        from areal_tpu_torch.system.generation_server import (
            GenerationServerWorker,
        )

        for gcfg in cfg.gen_servers:
            aux.append((GenerationServerWorker(), gcfg))
    if cfg.gserver_manager is not None:
        from areal_tpu_torch.system.gserver_manager import GserverManager

        aux.append((GserverManager(), cfg.gserver_manager))
    if cfg.rollout_workers:
        from areal_tpu_torch.system.rollout_worker import RolloutWorker

        for rcfg in cfg.rollout_workers:
            aux.append((RolloutWorker(), rcfg))

    from areal_tpu_torch.system.worker_base import AsyncWorker

    def _run(w, wcfg):
        try:
            if isinstance(w, AsyncWorker):
                w.run_async(wcfg)
            else:
                w.run(wcfg)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    worker_objs = []
    for w, wcfg in aux:
        worker_objs.append(w)
        t = threading.Thread(
            target=_run, args=(w, wcfg), daemon=True,
            name=getattr(wcfg, "worker_name", "aux"),
        )
        t.start()
        threads.append(t)
    return threads, worker_objs
