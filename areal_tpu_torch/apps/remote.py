"""One worker in its own process (port of ``areal_tpu/apps/remote.py``).

The launcher (``apps/main.py``) dumps the whole ``ExperimentConfig`` to the
cache directory; every worker process loads it, picks its own part and
runs one worker to its end.  Name resolution (the nfs backend by default,
or the ``server`` backend) is the only thing the processes share.

A worker's device comes from its config: ``force_cpu_devices=1`` gives the
model workers and generation servers ``device="cpu"``, else they take the
card; the master, the gserver manager and the rollout workers never touch
it.  A world of several processes per worker (``WORLD_SIZE`` above 1) is
refused (ROADMAP.md queue 1, item 10), and so is the serving gateway
(item 16).

``AREAL_WORKER_HOOK=module:function`` calls ``function(worker_type,
worker_index, worker)`` in the worker's process before it runs, for
instrumentation (a smoke run's probes).

Usage::

    python -m areal_tpu_torch.apps.remote --experiment_name E \\
        --trial_name T --worker_type model_worker --worker_index 0
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import sys

def config_cache_path(experiment_name: str, trial_name: str) -> str:
    from areal_tpu_torch.base import constants

    return os.path.join(
        constants.get_cache_path(),
        f"{experiment_name}-{trial_name}-config.pkl",
    )


def dump_experiment_config(cfg) -> str:
    path = config_cache_path(cfg.experiment_name, cfg.trial_name)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(cfg, f)
    os.replace(path + ".tmp", path)
    return path


def load_experiment_config(experiment_name: str, trial_name: str):
    with open(config_cache_path(experiment_name, trial_name), "rb") as f:
        return pickle.load(f)


def _check_world():
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: a worker spread over several processes is "
            "not ported to areal_tpu_torch yet (ROADMAP.md queue 1, item 10)"
        )


def worker_class(worker_type: str):
    """The port's class for ``worker_type``, imported only when asked for:
    the master's, manager's and rollout workers' processes import no
    engine and no kernel module."""
    if worker_type == "master":
        from areal_tpu_torch.system.master_worker import MasterWorker

        return MasterWorker
    if worker_type == "model_worker":
        from areal_tpu_torch.system.model_worker import ModelWorker

        return ModelWorker
    if worker_type == "rollout_worker":
        from areal_tpu_torch.system.rollout_worker import RolloutWorker

        return RolloutWorker
    if worker_type == "gen_server":
        from areal_tpu_torch.system.generation_server import (
            GenerationServerWorker,
        )

        return GenerationServerWorker
    if worker_type == "gserver_manager":
        from areal_tpu_torch.system.gserver_manager import GserverManager

        return GserverManager
    if worker_type == "gateway":
        raise NotImplementedError(
            "the serving gateway worker is not ported to areal_tpu_torch yet "
            "(ROADMAP.md queue 1, item 16)"
        )
    raise ValueError(f"unknown worker type {worker_type!r}")


def worker_config(cfg, worker_type: str, worker_index: int):
    if worker_type == "master":
        return cfg.master
    if worker_type == "model_worker":
        return cfg.model_workers[worker_index]
    if worker_type == "rollout_worker":
        return cfg.rollout_workers[worker_index]
    if worker_type == "gen_server":
        return cfg.gen_servers[worker_index]
    if worker_type == "gserver_manager":
        return cfg.gserver_manager
    raise ValueError(f"unknown worker type {worker_type!r}")


def _run_hook(worker_type: str, worker_index: int, worker):
    spec = os.environ.get("AREAL_WORKER_HOOK")
    if not spec:
        return
    module, _, fn = spec.partition(":")
    getattr(importlib.import_module(module), fn)(
        worker_type, worker_index, worker)


def run_worker(
    experiment_name: str,
    trial_name: str,
    worker_type: str,
    worker_index: int,
) -> str:
    """Run one worker to its end in this process; returns its final
    status."""
    from areal_tpu_torch.apps.local_runner import register_impls
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.system.worker_base import AsyncWorker, make_server

    _check_world()
    cls = worker_class(worker_type)
    name_resolve.reconfigure(os.environ.get("AREAL_NAME_RESOLVE", "nfs"))
    constants.set_experiment_trial_names(experiment_name, trial_name)
    # the registries of api/* (datasets, agents, envs, backends,
    # interfaces) are per process; one worker runs here, so transformers
    # is imported only by the workers that load a tokenizer
    register_impls(threads=False)
    cfg = load_experiment_config(experiment_name, trial_name)
    wcfg = worker_config(cfg, worker_type, worker_index)

    worker = cls(make_server(wcfg.worker_name))
    _run_hook(worker_type, worker_index, worker)
    if isinstance(worker, AsyncWorker):
        status = worker.run_async(wcfg)
    else:
        status = worker.run(wcfg)
    return str(status.value if hasattr(status, "value") else status)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="areal_tpu_torch worker process")
    p.add_argument("--experiment_name", required=True)
    p.add_argument("--trial_name", required=True)
    p.add_argument("--worker_type", required=True)
    p.add_argument("--worker_index", type=int, default=0)
    args = p.parse_args(argv)
    status = run_worker(
        args.experiment_name,
        args.trial_name,
        args.worker_type,
        args.worker_index,
    )
    return 0 if status in ("COMPLETED", "PAUSED") else 1


if __name__ == "__main__":
    sys.exit(main())
