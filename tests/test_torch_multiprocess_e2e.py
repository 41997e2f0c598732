"""The port's async-PPO experiment as one process per worker, through
``areal_tpu_torch.apps.main.launch_experiment`` on the CPU
(``force_cpu_devices=1``, the tiny experiment of
``tests/test_torch_async_ppo_e2e.py``): the master, the model worker, the
generation server, the gserver manager and two rollout workers, 6
processes of ``python -m areal_tpu_torch.apps.remote``, which meet only
through name resolution: once on the ``nfs`` backend and once on the
``server`` backend (the port's ``NameResolveServer`` in this process).

The master logs at least 2 steps with a finite loss, every trajectory a
train step consumed lies within ``max_head_offpolicyness`` of that step's
version (read from the model worker's process through
``chip_smoke.process_probe``), the device processes' counters files hold
their versions, and no worker process outlives the launch."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def launch_env(tmp_path, monkeypatch, **extra):
    """Every cross-process channel (the name_resolve tree, the config
    cache, logs, saves) under ``tmp_path``, for this process and, through
    the environment they inherit, the workers."""
    env = {
        "AREAL_NAME_RESOLVE": "nfs",
        "AREAL_NAME_RESOLVE_ROOT": str(tmp_path / "name_resolve"),
        "AREAL_CACHE_ROOT": str(tmp_path / "cache"),
        "AREAL_LOG_ROOT": str(tmp_path / "logs"),
        "AREAL_SAVE_ROOT": str(tmp_path / "save"),
        "AREAL_WORKER_HOOK": "chip_smoke:process_probe",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": str(REPO),
        **extra,
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return env


def assert_no_worker_left(probes):
    pids = {r["pid"] for lines in probes.values() for r in lines}
    assert len({r["pid"] for lines in probes.values() for r in lines
                if r["kind"] == "start"}) == len(pids)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    return pids


@pytest.mark.parametrize("backend", ["nfs", "server"])
def test_async_ppo_as_processes(tmp_path, monkeypatch, backend):
    import chip_smoke
    from areal_tpu_torch.apps.main import launch_experiment
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.base.name_resolve_server import NameResolveServer
    from tests.test_torch_async_ppo_e2e import _experiment

    server = None
    extra = {}
    if backend == "server":
        server = NameResolveServer(port=0, host="127.0.0.1").start()
        extra = {"AREAL_NAME_RESOLVE": "server",
                 "AREAL_NAME_RESOLVE_ADDR": f"127.0.0.1:{server.port}"}
    launch_env(tmp_path, monkeypatch, **extra)
    try:
        inputs = chip_smoke.async_inputs(str(tmp_path), 256, rows=24,
                                         words=(2, 12), n_answers=16)
        exp = _experiment("torch", *inputs, f"mp-{backend}",
                          n_rollout_workers=2, max_head_offpolicyness=1)
        cfg = exp.initial_setup()
        assert cfg.model_workers[0].device == "cpu"
        launch_experiment(cfg, mode="local", timeout=120)
        if backend == "server":
            # the workers' keys went through the service
            assert server._store
    finally:
        # no repository may stay aimed at a stopped server
        name_resolve.reconfigure("memory")
        if server is not None:
            server.stop()

    stats, counters, probes = chip_smoke.trial_records(
        constants.get_log_path())
    assert len(stats) >= 2
    assert np.isfinite(stats[-1]["actor_train/loss"])
    assert sorted(probes) == ["gen_server0", "gserver_manager0", "master0",
                              "model_worker0", "rollout_worker0",
                              "rollout_worker1"]
    bound = cfg.gserver_manager.max_head_offpolicyness
    steps = [r for r in probes["model_worker0"] if r["kind"] == "train_step"]
    assert len(steps) == len(stats)
    for rec in steps:
        for vs, ve in zip(rec["version_start"], rec["version_end"]):
            assert 0 <= rec["version"] - vs <= bound, rec
            assert vs <= ve <= rec["version"]
    # the device processes' own counters: the trainer's last version, and
    # a server that served no version the trainer had not published
    (mw,) = counters["model_worker_0"][-1:]
    assert mw["versions"] == {"actor@0": len(stats)}
    assert mw["mbs"]["train_step"] > 0
    gs = counters["gen_server_0"][-1]
    assert 0 <= gs["version"] <= len(stats) and gs["decode_tokens_total"] > 0
    assert len(assert_no_worker_left(probes)) == 6
