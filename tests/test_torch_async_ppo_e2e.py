"""The whole async-PPO loop of the port through its entry point,
``areal_tpu_torch.apps.local_runner.run_experiment_local``, on the CPU
(``force_cpu_devices=1``) at tiny width: a generation server, the gserver
manager, a rollout worker running the math single-step agent and
environment, the master, and a model worker that hosts the actor, runs
actor_inf and actor_train and publishes each version for the manager to
swap in.

``test_async_ppo_e2e_on_the_cpu`` makes the JAX package's e2e assertions
(``tests/system/test_async_ppo_e2e.py``) and two of its own: the manager
applied at least one weight swap, and every trajectory a train step
consumed lies within ``max_head_offpolicyness`` of that step's version.

``test_slice_matches_the_jax_package`` runs one tiny experiment through
both packages' local runners (greedy serving, one rollout worker, one
rollout at a time, ``max_head_offpolicyness=0``, one minibatch, one
prompt in every row, the JAX init converted to the port's tree for the
port's trainer and server): two steps' trajectories (token ids, rewards,
versions) agree exactly and their actor_train statistics to 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.system import model_worker as tmw

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    """A word-level tokenizer with right answers among its 256 words and 24
    math rows (``chip_smoke.async_inputs`` at tiny size)."""
    import chip_smoke

    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))
    return chip_smoke.async_inputs(str(tmp_path), 256, rows=24, words=(2, 12),
                                   n_answers=16)


def _record_train_steps(mw, monkeypatch):
    """Patch ``mw.ModelWorker._handle_model_rpc`` to record, for every
    actor_train call, the model version it trained and the consumed
    trajectories (token ids, rewards, versions), and its statistics."""
    steps = []
    orig = mw.ModelWorker._handle_model_rpc

    def record(self, req):
        spec = req.data
        rec = None
        if spec["handle_name"] == "train_step":
            ids = list(spec["ids"])
            b = self._data_manager.get_batch(ids, [
                "packed_input_ids", "rewards", "version_start", "version_end"])
            rec = dict(
                version=self._models[spec["model_name"]].version.global_step,
                ids=ids,
                tokens=np.asarray(b.data["packed_input_ids"]).tolist(),
                rewards=np.asarray(b.data["rewards"]).tolist(),
                version_start=np.asarray(b.data["version_start"]).tolist(),
                version_end=np.asarray(b.data["version_end"]).tolist())
        out = orig(self, req)
        if rec is not None:
            rec["stats"] = dict(out["stats"])
            steps.append(rec)
        return out

    monkeypatch.setattr(mw.ModelWorker, "_handle_model_rpc", record)
    return steps


def _experiment(pkg, tok_dir, data_path, trial, **kw):
    """The JAX e2e's tiny async experiment (``tests/system/exp_factories.py``
    ``make_async_ppo_exp``) on one device with the paged cache."""
    if pkg == "jax":
        from areal_tpu.api.config import DatasetAbstraction, ModelAbstraction
        from areal_tpu.api.model_api import GenerationHyperparameters
        from areal_tpu.api.system_api import ExperimentSaveEvalControl
        from areal_tpu.engine.optimizer import OptimizerConfig
        from areal_tpu.experiments.async_ppo_exp import AsyncPPOMathExperiment
        from areal_tpu.experiments.ppo_math_exp import PPOHyperparameters
        device = {}
    else:
        from areal_tpu_torch.api.config import (
            DatasetAbstraction,
            ModelAbstraction,
        )
        from areal_tpu_torch.api.model_api import GenerationHyperparameters
        from areal_tpu_torch.api.system_api import ExperimentSaveEvalControl
        from areal_tpu_torch.engine.optimizer import OptimizerConfig
        from areal_tpu_torch.experiments.async_ppo_exp import (
            AsyncPPOMathExperiment,
        )
        from areal_tpu_torch.experiments.ppo_math_exp import (
            PPOHyperparameters,
        )
        device = {"force_cpu_devices": 1}
    args = dict(
        experiment_name="test-async-ppo", trial_name=trial,
        n_model_workers=1,
        exp_ctrl=ExperimentSaveEvalControl(total_train_epochs=4,
                                           benchmark_steps=2),
        tokenizer_path=tok_dir,
        actor=ModelAbstraction("random", {"vocab_size": 256,
                                          "max_position_embeddings": 512}),
        dataset=DatasetAbstraction("math_code_prompt", {
            "dataset_path": data_path, "max_length": 64}),
        train_bs_n_seqs=4, group_size=2,
        actor_optimizer=OptimizerConfig(lr=1e-4),
        ppo=PPOHyperparameters(
            gen=GenerationHyperparameters(max_new_tokens=8, min_new_tokens=1,
                                          temperature=1.0),
            ppo_n_minibatches=2, kl_ctl=0.0, disable_value=True,
            use_decoupled_loss=True),
        n_rollout_workers=1, n_gen_servers=1, max_head_offpolicyness=4,
        max_concurrent_rollouts=4, new_tokens_per_chunk=4,
        gen_kv_cache_len=128, gen_max_concurrent_batch=4,
        gen_cache_mode="paged", gen_page_size=16, gen_chunk_size=4,
        **device,
    )
    args.update(kw)
    return AsyncPPOMathExperiment(**args)


def test_async_ppo_e2e_on_the_cpu(inputs, monkeypatch):
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.observability import get_registry

    steps = _record_train_steps(tmw, monkeypatch)
    # one rollout at a time (so the trainer takes them in the order they
    # were admitted) and offpolicyness 1: the gate admits two batches at
    # version 0, so a third step needs a rollout after a swap, and every
    # trajectory trains at most one version after its first token's
    exp = _experiment("torch", *inputs, "e2e", max_head_offpolicyness=1,
                      max_concurrent_rollouts=1)
    exp.exp_ctrl.benchmark_steps = 3
    cfg = exp.initial_setup()
    names_ = [r.name for r in cfg.master.model_rpcs]
    assert "actor_gen" not in names_ and "rew_inf" not in names_
    assert "actor_train" in names_ and "actor_inf" in names_
    assert cfg.gserver_manager is not None
    assert len(cfg.gen_servers) == 1 and len(cfg.rollout_workers) == 1
    assert cfg.gen_servers[0].device == "cpu"
    assert cfg.model_workers[0].device == "cpu"

    swaps = get_registry().counter("areal_gserver_weight_updates_total")
    swaps0 = swaps.value(mode="staged")
    master = run_experiment_local(cfg, timeout=300)

    assert len(master.stats_history) >= 2
    s = master.stats_history[-1]
    assert np.isfinite(s["actor_train/loss"])
    assert "actor_train/kl" in s
    assert swaps.value(mode="staged") - swaps0 >= 1
    assert len(steps) >= 3
    bound = cfg.gserver_manager.max_head_offpolicyness
    for rec in steps:
        for vs, ve in zip(rec["version_start"], rec["version_end"]):
            assert 0 <= rec["version"] - vs <= bound, rec
            assert vs <= ve <= rec["version"]
    assert max(max(r["version_start"]) for r in steps) >= 1


def _tiny_qwen2_dir(path):
    """A tiny ``Qwen2ForCausalLM`` directory for the tests' 256-word
    tokenizer (its config carries a window with ``use_sliding_window:
    false``, as Qwen2 checkpoints do)."""
    import transformers

    torch.manual_seed(0)
    transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        max_position_embeddings=512, tie_word_embeddings=False,
    )).save_pretrained(path, safe_serialization=True)
    return path


def test_async_ppo_from_an_hf_dir_saves_every_step(inputs, monkeypatch,
                                                   tmp_path):
    """The loop with the recipe's ``actor.type_: hf`` and
    ``save_freq_steps=1``: trainer and server load the same directory, and
    each step's HF save reloads bit-equal to the trainer's weights at that
    step (the last one to its final weights)."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.engine.train_engine import tree_map
    from areal_tpu_torch.models.hf import load_hf_model
    from areal_tpu_torch.system import generation_server as tgs
    from tests.test_torch_hf import _assert_same_tree

    hf_dir = _tiny_qwen2_dir(str(tmp_path / "qwen2"))
    # copies only: a test that fails must not keep a worker (and its ZMQ
    # sockets) alive past its end
    saves, served = [], []
    orig_save, orig_configure = (tmw.ModelWorker._save_model,
                                 tgs.GenerationServerWorker._configure)

    def save(self, model_name, path):
        orig_save(self, model_name, path)
        engine = self._models[model_name].engine
        saves.append((path, engine, engine.version, tree_map(
            lambda t: t.detach().clone(), engine.params)))

    def configure(self, config):
        out = orig_configure(self, config)
        served.append((self.engine.cfg, tree_map(
            lambda t: t.detach().clone(), self.engine.params)))
        return out

    monkeypatch.setattr(tmw.ModelWorker, "_save_model", save)
    monkeypatch.setattr(tgs.GenerationServerWorker, "_configure", configure)
    exp = _experiment("torch", *inputs, "hf-save", actor=ModelAbstraction(
        "hf", {"path": hf_dir, "dtype": "float32"}))
    exp.exp_ctrl.save_freq_steps = 1
    cfg = exp.initial_setup()
    assert cfg.gen_servers[0].model.args["path"] == hf_dir
    master = run_experiment_local(cfg, timeout=300)

    steps = len(master.stats_history)
    assert steps == 2 and all(np.isfinite(s["actor_train/loss"])
                              for s in master.stats_history)
    # the server started from the directory's weights
    cfg0, weights0 = load_hf_model(hf_dir, dtype="float32", device="cpu")
    ((server_cfg, server_weights),) = served
    assert server_cfg == cfg0
    _assert_same_tree(server_weights, weights0)
    assert [os.path.basename(p) for p, *_ in saves] == [
        f"epoch0epochstep{i}globalstep{i}" for i in (1, 2)]
    for path, _, _, weights in saves:
        assert path.startswith(constants.get_save_path())
        with open(os.path.join(path, "config.json")) as f:
            assert json.load(f)["architectures"] == ["Qwen2ForCausalLM"]
        _assert_same_tree(load_hf_model(path, dtype="float32",
                                        device="cpu")[1], weights)
    _, engine, version, last = saves[-1]
    assert engine.version == version > 0
    _assert_same_tree(engine.params, last)
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
        _flat(last), _flat(weights0)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_cli_runs_the_recipe_config_on_the_cpu(inputs):
    """``python -m areal_tpu_torch.apps.main_async_ppo`` on the recipe's
    YAML with the overrides the port needs and a tiny size, every worker on
    the CPU."""
    from pathlib import Path

    from areal_tpu_torch.apps.main_async_ppo import main

    tok_dir, data_path = inputs
    recipe = Path(__file__).resolve().parents[1] / "training" / "configs"
    master = main([
        "--config", str(recipe / "async_ppo.yaml"), "actor.type_=random",
        "actor.args={vocab_size: 256}", "mesh_spec=d1",
        "gen_device_start=null", "exp_ctrl.save_freq_steps=null",
        "exp_ctrl.ckpt_freq_steps=1", "force_cpu_devices=1",
        "trial_name=cli",
        f"tokenizer_path={tok_dir}", f"dataset.args.dataset_path={data_path}",
        "dataset.args.max_length=64", "train_bs_n_seqs=4", "group_size=2",
        "ppo.gen.max_new_tokens=8", "new_tokens_per_chunk=4",
        "gen_kv_cache_len=128", "gen_cache_mode=paged", "gen_page_size=16",
        "gen_chunk_size=4", "gen_max_concurrent_batch=4",
        "max_concurrent_rollouts=2", "exp_ctrl.benchmark_steps=2",
        "mb_spec.max_tokens_per_mb=256",
    ])
    assert len(master.stats_history) == 2
    assert all(np.isfinite(s["actor_train/loss"])
               for s in master.stats_history)
    # a recover checkpoint (train state) after each step, the newest two
    # kept
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.engine import checkpoint

    ckpts = os.path.join(constants.get_recover_path(), "actor@0")
    assert sorted(os.listdir(ckpts)) == ["globalstep1", "globalstep2"]
    # the engine's version counts AdamW updates: the recipe's 4 minibatches
    # in each of the two steps
    assert checkpoint.read_manifest(
        os.path.join(ckpts, "globalstep2", "train_state"))["version"] == 8


def _converted_make_model(monkeypatch, tree, cfg):
    """The port's ``make_model`` with the JAX init tree converted in place
    of torch's draws (in the dtype each caller asks for)."""
    from areal_tpu_torch.engine import backend
    from areal_tpu_torch.models.convert import params_from_jax

    orig = backend.make_model

    def make(*args, dtype=None, **kw):
        model = orig(*args, dtype=dtype, **kw)
        params = params_from_jax(tree, cfg, "cpu")
        model.init_params = (
            params if dtype == torch.float32 else _cast(params, model.model_cfg))
        return model

    monkeypatch.setattr(backend, "make_model", make)


def _cast(params, cfg):
    from areal_tpu_torch.models.transformer import torch_dtype

    dt = torch_dtype(cfg.dtype)
    if isinstance(params, dict):
        return {k: _cast(v, cfg) for k, v in params.items()}
    if isinstance(params, list):
        return [_cast(v, cfg) for v in params]
    return params.to(dt)


@pytest.mark.slow  # JAX's compiles and its master's tensorboard import
def test_slice_matches_the_jax_package(inputs, monkeypatch):
    import jax
    # the JAX master's metrics sink imports torch's tensorboard writer (and
    # TensorFlow with it) while its model worker waits 60 s for the master:
    # import it first
    import torch.utils.tensorboard  # noqa: F401

    from areal_tpu.apps.local_runner import run_experiment_local as jrun
    from areal_tpu.models import transformer as jt
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu.system import model_worker as jmw
    from areal_tpu_torch.apps.local_runner import run_experiment_local as trun
    from tests.test_torch_train_model import port_config

    # every row holds one prompt: the rollout worker skips a prompt at each
    # refused allocation, so which rows a run reaches depends on timing
    tok_dir, data_path = inputs
    with open(data_path) as f:
        rows = [json.loads(line) for line in f]
    same = os.path.join(os.path.dirname(data_path), "one_prompt.jsonl")
    with open(same, "w") as f:
        for r in rows:
            f.write(json.dumps(dict(r, prompt=rows[0]["prompt"])) + "\n")
    # one rollout (a batch) at a time, offpolicyness 0: step 1 trains on a
    # rollout of version 0, step 2 on one generated after the swap to 1
    slice_kw = dict(max_head_offpolicyness=0, max_concurrent_rollouts=1,
                    train_bs_n_seqs=2)
    runs = {}
    for pkg, mw, run in (("jax", jmw, jrun), ("torch", tmw, trun)):
        steps = _record_train_steps(mw, monkeypatch)
        exp = _experiment(pkg, tok_dir, same, f"slice-{pkg}", **slice_kw)
        exp.ppo.ppo_n_minibatches = 1
        cfg = exp.initial_setup()
        cfg.gen_servers[0].greedy = True
        if pkg == "torch":
            jcfg = jtiny(vocab_size=256, max_position_embeddings=512)
            tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
            _converted_make_model(monkeypatch, tree, port_config(jcfg))
        master = run(cfg, timeout=300)
        assert len(master.stats_history) >= 2
        runs[pkg] = steps[:2]
    jsteps, tsteps = runs["jax"], runs["torch"]
    assert len(jsteps) == len(tsteps) == 2
    for j, t in zip(jsteps, tsteps):
        for k in ("version", "tokens", "rewards", "version_start",
                  "version_end"):
            assert t[k] == j[k], k
        for k in ("loss", "grad_norm", "approx_kl", "entropy", "adv_sum",
                  "n_tokens", "kl", "reward_mean"):
            np.testing.assert_allclose(t["stats"][k], j["stats"][k], rtol=TOL,
                                       atol=TOL, err_msg=k)
