"""Canonical name-resolve key paths (copy of the keys of
``areal_tpu/base/names.py`` that the port's server and workers use).
All functions return slash-separated keys rooted at ``areal_tpu``, the
same layout as the JAX package's, so the two speak one discovery
vocabulary.
"""

from __future__ import annotations

USER_NAMESPACE = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{USER_NAMESPACE}/{experiment_name}/{trial_name}"


def worker_status(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/status/{worker_name}"


def worker_heartbeat(
    experiment_name: str, trial_name: str, worker_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/heartbeat/{worker_name}"


def worker_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/worker/"


def worker(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{worker_root(experiment_name, trial_name)}{worker_name}"


def model_version(
    experiment_name: str, trial_name: str, model_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/model_version/{model_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers/"


def gen_server(experiment_name: str, trial_name: str, server_idx) -> str:
    return f"{gen_servers(experiment_name, trial_name)}{server_idx}"


def used_ports(experiment_name: str, trial_name: str, host_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/used_ports/{host_name}/"
