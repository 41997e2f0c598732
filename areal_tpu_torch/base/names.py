"""Canonical name-resolve key paths (copy of ``areal_tpu/base/names.py``).
All functions return slash-separated keys rooted at ``areal_tpu``, the
same layout as the JAX package's, so the two speak one discovery
vocabulary.
"""

from __future__ import annotations

USER_NAMESPACE = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{USER_NAMESPACE}/{experiment_name}/{trial_name}"


def trial_registry(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/registry"


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


def request_reply_stream(
    experiment_name: str, trial_name: str, stream_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/request_reply_stream/{stream_name}"


def request_reply_stream_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/request_reply_stream/"


def distributed_peer(
    experiment_name: str, trial_name: str, model_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/distributed_peer/{model_name}"


def distributed_master(
    experiment_name: str, trial_name: str, model_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/distributed_master/{model_name}"


def model_version(
    experiment_name: str, trial_name: str, model_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/model_version/{model_name}"


def recover_load(
    experiment_name: str, trial_name: str, model_name: str
) -> str:
    """Which recover checkpoint a model was reloaded from on restart."""
    return f"{trial_root(experiment_name, trial_name)}/recover_load/{model_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers/"

def gen_server(experiment_name: str, trial_name: str, server_idx) -> str:
    return f"{gen_servers(experiment_name, trial_name)}{server_idx}"


def gen_server_spmd(
    experiment_name: str, trial_name: str, server_idx, sub: str
) -> str:
    """Multi-host gen-server control keys (leader PUB address, follower
    readiness).  Deliberately OUTSIDE the ``gen_servers/`` subtree: the
    gserver manager discovers servers by subtree scan, and control keys
    there would be mistaken for server addresses."""
    root = trial_root(experiment_name, trial_name)
    return f"{root}/gen_server_spmd/{server_idx}/{sub}"


def gen_server_manager(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_server_manager"


def gateway(experiment_name: str, trial_name: str) -> str:
    """host:port of the OpenAI-style HTTP/SSE gateway front door."""
    return f"{trial_root(experiment_name, trial_name)}/gateway"


def training_samples(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/training_samples"


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/experiment_status"


def used_ports(experiment_name: str, trial_name: str, host_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/used_ports/{host_name}/"


def verifier_server(experiment_name: str, trial_name: str) -> str:
    """Reward verifier service URL (reference: the functioncall cluster)."""
    return f"{trial_root(experiment_name, trial_name)}/verifier_server"


def metric_server(
    experiment_name: str, trial_name: str, group: str, name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/metric_server/{group}/{name}"


def metric_server_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/metric_server/"


def profiler_capture(
    experiment_name: str, trial_name: str, worker_name: str
) -> str:
    """Latest on-demand profiler capture dir of one worker (written by
    the metric server's ``/profile`` route, harvested by ops tooling)."""
    return (
        f"{trial_root(experiment_name, trial_name)}"
        f"/profiler_capture/{worker_name}"
    )


def profiler_capture_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/profiler_capture/"


def stream_pullers(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/stream_pullers/"


def push_pull_stream(
    experiment_name: str, trial_name: str, stream_name: str
) -> str:
    return f"{trial_root(experiment_name, trial_name)}/push_pull_stream/{stream_name}"


def push_pull_stream_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/push_pull_stream/"
