"""Kill-and-resume on the port's async-PPO experiment (the counterpart of
``tests/system/test_recover_e2e.py``, which runs the JAX package's sync
PPO; the port has async PPO only).

* In one process (``run_experiment_local``): 2 steps with a recover
  checkpoint every step, then name resolution and the constants reset (the
  restart's boundary) and ``AREAL_RECOVER=1``: the master resumes at step 2
  and runs 2 more steps to 4, the model worker records ``recover_load``
  ending in ``globalstep2``, and its restored train state (float32 weights,
  AdamW moments, update count, version) is bit-equal to the checkpoint.
  The resume runs with ``max_head_offpolicyness=1``, below the 2 steps
  already trained: the restarted manager and server start from version
  0, so the staleness gate admits no rollout until the model worker
  publishes its restored weights again.  Without that republish (the JAX
  package's behaviour, ROADMAP.md section 3) the run makes no step.
* Under the launcher (``chip_smoke.processes_phase`` at tiny size on the
  CPU): the model worker's process is SIGKILLed after step 2's checkpoint,
  the restart policy relaunches every process with ``AREAL_RECOVER=1`` and
  the run resumes to step 3, with the processes phase's gates.
"""

import glob
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.system import gserver_manager as gm
from areal_tpu_torch.system import model_worker as mw
from tests.test_torch_async_ppo_e2e import _record_train_steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))
    monkeypatch.delenv("AREAL_RECOVER", raising=False)
    return chip_smoke.async_inputs(str(tmp_path), 256, rows=24,
                                   words=(2, 12), n_answers=16)


def _make(inputs, steps):
    from areal_tpu_torch.api.system_api import ExperimentSaveEvalControl
    from tests.test_torch_async_ppo_e2e import _experiment

    return _experiment("torch", *inputs, "recover", max_head_offpolicyness=1,
                       exp_ctrl=ExperimentSaveEvalControl(
                           total_train_epochs=10, benchmark_steps=steps,
                           ckpt_freq_steps=1))


def _train_two_steps_and_restart(inputs, tmp_path, monkeypatch):
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import constants, name_resolve

    master1 = run_experiment_local(_make(inputs, 2).initial_setup(),
                                   timeout=120)
    assert len(master1.stats_history) == 2
    ckpts = glob.glob(str(tmp_path / "save" / "**" / "recover" / "actor*"
                          / "globalstep*"), recursive=True)
    assert any(d.endswith("globalstep2") for d in ckpts), ckpts
    # the restart's boundary: fresh process-global state
    name_resolve.reset()
    constants.reset()
    monkeypatch.setenv("AREAL_RECOVER", "1")


def test_kill_and_resume_in_process(inputs, tmp_path, monkeypatch):
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine import checkpoint

    _train_two_steps_and_restart(inputs, tmp_path, monkeypatch)
    restored, applied = [], []
    orig_load = mw.ModelWorker._maybe_recover_load
    orig_flush = gm.GserverManager._flush_and_update

    def load(self, name, backend, model):
        from safetensors import safe_open

        out = orig_load(self, name, backend, model)
        path = os.path.join(name_resolve.get(names.recover_load(
            "test-async-ppo", "recover", name)), "train_state")
        # the checkpoint as written (later steps prune it)
        with safe_open(os.path.join(path, checkpoint.TRAIN_STATE_NAME),
                       framework="pt") as f:
            saved = {k: f.get_tensor(k) for k in f.keys()}
            meta = f.metadata()
        restored.append(dict(
            step=model.version.global_step,
            engine_version=model.engine.version,
            opt_count=model.engine.opt.count,
            manifest=checkpoint.read_manifest(path), saved=saved, meta=meta,
            leaves={"/".join(kp): t.detach().clone() for kp, t in
                    checkpoint._flatten(checkpoint._state_tree(model.engine))}))
        return out

    def flush(self, info):
        out = orig_flush(self, info)
        applied.append(self._model_version)
        return out

    monkeypatch.setattr(mw.ModelWorker, "_maybe_recover_load", load)
    monkeypatch.setattr(gm.GserverManager, "_flush_and_update", flush)
    steps = _record_train_steps(mw, monkeypatch)
    master2 = run_experiment_local(_make(inputs, 4).initial_setup(),
                                   timeout=120)

    # the master resumed at step 2 and ran 2 more steps
    assert len(master2.stats_history) == 2
    assert master2._step_info.global_step == 4
    assert np.isfinite(master2.stats_history[-1]["actor_train/loss"])
    loaded_from = name_resolve.get(names.recover_load(
        "test-async-ppo", "recover", "actor@0"))
    assert loaded_from.endswith("globalstep2"), loaded_from
    # the restored train state is the checkpoint's, bit for bit
    (rec,) = restored
    assert sorted(rec["saved"]) == sorted(rec["leaves"])
    for k, t in rec["leaves"].items():
        saved = rec["saved"][k]
        assert saved.dtype == t.dtype and torch.equal(saved, t), k
    assert (rec["engine_version"] == rec["manifest"]["version"]
            == int(rec["meta"]["version"]) > 0)
    assert rec["opt_count"] == int(rec["meta"]["opt_count"]) > 0
    # the train-step counter resumed, and the manager swapped the restored
    # weights in (v2) before the versions the resumed steps published
    assert rec["step"] == 2
    assert applied and applied[0] == 2 and max(applied) <= 4
    # and no rollout of the initial weights reached the resumed trainer:
    # every trajectory lies within max_head_offpolicyness of its step
    assert [r["version"] for r in steps] == [2, 3]
    for r in steps:
        for vs, ve in zip(r["version_start"], r["version_end"]):
            assert 2 <= vs <= ve <= r["version"] <= vs + 1, r


def test_resume_without_the_republish_stalls(inputs, tmp_path, monkeypatch):
    """The JAX package's resume publishes nothing until the next train
    step, so its restarted server serves version 0 while the trainer is
    at 2: with ``max_head_offpolicyness=1`` the manager's staleness gate
    refuses every rollout and the trainer never gets a batch."""
    from areal_tpu_torch.apps.local_runner import run_experiment_local

    _train_two_steps_and_restart(inputs, tmp_path, monkeypatch)
    monkeypatch.setattr(mw.ModelWorker, "_has_published",
                        lambda self, model: False)
    rejected = []
    orig = gm.GserverManager.is_staled

    def is_staled(self):
        out = orig(self)
        rejected.append(out)
        return out

    monkeypatch.setattr(gm.GserverManager, "is_staled", is_staled)
    with pytest.raises(TimeoutError):
        run_experiment_local(_make(inputs, 4).initial_setup(), timeout=10)
    assert rejected and all(rejected)


@pytest.mark.slow  # two launches of 6 worker processes: ~32 s alone
def test_kill_under_the_launcher(tmp_path, monkeypatch):
    """``chip_smoke.processes_phase`` on the CPU at tiny size: 6 worker
    processes, the model worker's process SIGKILLed after step 2's recover
    checkpoint, every process relaunched with ``AREAL_RECOVER=1``, step 3
    and the HF save; the phase raises on any failed gate."""
    import chip_smoke
    from areal_tpu_torch.models.hf import load_hf_model
    from tests.test_torch_async_ppo_e2e import _tiny_qwen2_dir

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    hf = _tiny_qwen2_dir(str(tmp_path / "qwen2"))
    cfg, _ = load_hf_model(hf, device="cpu")
    res = chip_smoke.processes_phase(
        cfg, torch.device("cpu"), "cpu", hf, rows=24, prompt_words=(2, 12),
        train_bs=4, new_tokens=8, chunk_tokens=4, n_answers=16,
        max_tokens_per_mb=256, timeout=120, group_size=2,
        gen_kv_cache_len=128, gen_max_concurrent_batch=4,
        gen_cache_mode="paged", gen_page_size=16, gen_chunk_size=4)
    assert len(res["step_s"]) == 3
    assert res["ckpt"]["bytes"] > 0 and res["restart_s"] > 0
