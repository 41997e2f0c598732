"""Sync PPO on the port (``experiments/ppo_math_exp.py``, the 7-MFC graph
``actor_gen -> {rew_inf, ref_inf, critic_inf, actor_inf} -> {actor_train,
critic_train}``), run through its entry points on the CPU
(``force_cpu_devices=1``) at tiny width:

- the graph each option set builds (the critic, the reference model with
  ``kl_ctl``, ``ref_ema_eta``, ``reward_source="model"``, ``fuse_rew_ref``,
  the decoupled loss) equals the JAX package's, MFC by MFC and model by
  model, in the sync and in the async experiment;
- the local runner completes the full graph, the GRPO graph, a trained
  reward model's graph and the fused one, as
  ``tests/system/test_ppo_e2e.py`` does for the JAX package;
- ``python -m areal_tpu_torch.apps.main_sync_ppo`` and ``quickstart
  ppo_math`` run the recipe's ``training/configs/sync_ppo.yaml`` with a
  random actor;
- the async loop runs with the reference model and a critic;
- marked slow: both packages' runners on one tiny greedy experiment of the
  full graph give the same tokens and rewards and, over two steps, the
  same actor and critic statistics to 1e-4.
"""

import dataclasses
import enum
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from areal_tpu_torch.system import model_worker as tmw

TOL = 1e-4
RECIPE = Path(__file__).resolve().parents[1] / "training" / "configs"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    """``chip_smoke.async_inputs`` at tiny size: a 256-word tokenizer and
    24 math rows."""
    import chip_smoke

    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))
    return chip_smoke.async_inputs(str(tmp_path), 256, rows=24, words=(2, 12),
                                   n_answers=16)


def _modules(pkg):
    import importlib

    root = "areal_tpu" if pkg == "jax" else "areal_tpu_torch"
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return (m("api.config"), m("api.model_api"), m("api.system_api"),
            m("engine.optimizer"), m("experiments.ppo_math_exp"))


def _experiment(pkg, tok_dir, data_path, trial="e2e", exp_kw=None, **ppo_kw):
    """``tests/system/exp_factories.py make_sync_ppo_exp`` on one device."""
    config, model_api, system_api, optimizer, ppo_exp = _modules(pkg)
    gen = dict(max_new_tokens=16, min_new_tokens=2, temperature=1.0)
    gen.update(ppo_kw.pop("gen", {}))
    kw = dict(
        experiment_name="test-ppo", trial_name=trial, n_model_workers=1,
        exp_ctrl=system_api.ExperimentSaveEvalControl(total_train_epochs=1,
                                                      benchmark_steps=2),
        tokenizer_path=tok_dir,
        actor=config.ModelAbstraction("random", {
            "vocab_size": 256, "max_position_embeddings": 512}),
        dataset=config.DatasetAbstraction("math_code_prompt", {
            "dataset_path": data_path, "max_length": 64}),
        train_bs_n_seqs=4,
        actor_optimizer=optimizer.OptimizerConfig(lr=1e-4),
        critic_optimizer=optimizer.OptimizerConfig(lr=1e-4),
        ppo=ppo_exp.PPOHyperparameters(
            gen=model_api.GenerationHyperparameters(**gen),
            ppo_n_minibatches=2, **ppo_kw),
    )
    if pkg == "torch":
        kw["force_cpu_devices"] = 1
    kw.update(exp_kw or {})
    return ppo_exp.PPOMathExperiment(**kw)


#: fields of the JAX package's configs that the port leaves out (none: the
#: port's OptimizerConfig carries factored_min_dim)
_NOT_CARRIED = set()


def _plain(x):
    """A config object as plain data, whatever package made it."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {type(x).__name__: {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if not f.name.startswith("_")
                                   and f.name not in _NOT_CARRIED}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if type(x).__name__ == "ModelName":
        return str(x)
    return x


def _graph(cfg):
    rpcs = [_plain(r) for r in cfg.master.model_rpcs]
    shards = [(str(s.model_name), _plain(s.model), _plain(s.backend))
              for w in cfg.model_workers for s in w.shards]
    ifaces = {k: _plain(v) for w in cfg.model_workers
              for k, v in w.interfaces.items()}
    return rpcs, shards, ifaces


OPTION_SETS = {
    "full": dict(kl_ctl=0.1),
    "grpo": dict(kl_ctl=0.0, disable_value=True, use_decoupled_loss=True),
    "ref_ema": dict(kl_ctl=0.1, disable_value=True, ref_ema_eta=0.5),
    "recompute": dict(kl_ctl=0.0, recompute_logprob=True),
    "reward_model": dict(kl_ctl=0.1, exp_kw=dict(reward_source="model")),
    "fused": dict(kl_ctl=0.1, exp_kw=dict(fuse_rew_ref=True)),
    "fused_model_reward": dict(kl_ctl=0.1, exp_kw=dict(
        fuse_rew_ref=True, reward_source="model")),
}


@pytest.mark.parametrize("options", list(OPTION_SETS), ids=list(OPTION_SETS))
def test_the_graph_equals_the_jax_packages(options):
    kw = dict(OPTION_SETS[options])
    exp_kw = kw.pop("exp_kw", {})
    graphs = []
    for pkg in ("jax", "torch"):
        exp = _experiment(pkg, None, "unused.jsonl", exp_kw=exp_kw, **kw)
        exp.force_cpu_devices = None
        graphs.append(_graph(exp.initial_setup()))
    (jr, js, ji), (tr, ts, ti) = graphs
    assert [r["MFCDef"]["name"] for r in tr] == [r["MFCDef"]["name"] for r in jr]
    for t, j in zip(tr, jr):
        assert t == j
    assert ts == js
    assert ti == ji


@pytest.mark.parametrize("options", ["full", "ref_ema"])
def test_the_async_graph_keeps_the_reference_and_critic(options):
    """The async experiment inherits the MFCs: its trainer graph equals the
    JAX package's with the critic and the reference model in it."""
    from areal_tpu.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment as JAsync,
    )
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment as TAsync,
    )

    graphs = []
    for pkg, cls in (("jax", JAsync), ("torch", TAsync)):
        exp = _experiment(pkg, None, "unused.jsonl", **OPTION_SETS[options])
        fields = {f.name for f in dataclasses.fields(exp)}
        aexp = cls(**{k: getattr(exp, k) for k in fields})
        aexp.force_cpu_devices = None
        aexp.gen_device_start = None
        graphs.append(_graph(aexp.initial_setup()))
    (jr, js, ji), (tr, ts, ti) = graphs
    names = [r["MFCDef"]["name"] for r in tr]
    assert "ref_inf" in names and "actor_train" in names
    assert ("critic_train" in names) == (options == "full")
    assert tr == jr and ts == js and ti == ji


def _run(cfg):
    from areal_tpu_torch.apps.local_runner import run_experiment_local

    master = run_experiment_local(cfg, timeout=300)
    assert len(master.stats_history) == 2
    return master.stats_history


def test_full_graph_runs(inputs):
    """The 7-node graph with the EMA reference update: every MFC runs,
    the critic trains, and the KL of step 1 is 0 (actor and reference
    start from one init)."""
    exp = _experiment("torch", *inputs, "full", kl_ctl=0.1, ref_ema_eta=0.5)
    cfg = exp.initial_setup()
    assert [r.name for r in cfg.master.model_rpcs] == [
        "actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
        "critic_train"]
    assert cfg.model_workers[0].device == "cpu"
    stats = _run(cfg)
    s = stats[-1]
    for k in ("actor_train/loss", "critic_train/loss", "actor_train/kl"):
        assert np.isfinite(s[k]), k
    for mfc in ("actor_gen", "rew_inf", "ref_inf", "critic_inf",
                "actor_train", "critic_train"):
        assert f"{mfc}/elapsed" in s
    assert abs(stats[0]["actor_train/kl"]) < 1e-6
    assert stats[1]["actor_train/kl"] != 0.0


def test_grpo_graph_runs(inputs):
    exp = _experiment("torch", *inputs, "grpo", kl_ctl=0.0,
                      disable_value=True, use_decoupled_loss=True,
                      exp_kw=dict(group_size=2))
    cfg = exp.initial_setup()
    names = [r.name for r in cfg.master.model_rpcs]
    assert "critic_train" not in names and "ref_inf" not in names
    assert "actor_inf" in names
    s = _run(cfg)[-1]
    assert np.isfinite(s["actor_train/loss"])
    assert s["actor_train/n_tokens"] > 0


def test_fused_graph_runs(inputs):
    exp = _experiment("torch", *inputs, "fused", kl_ctl=0.1,
                      disable_value=True, exp_kw=dict(fuse_rew_ref=True))
    cfg = exp.initial_setup()
    assert "rew_ref_inf" in [r.name for r in cfg.master.model_rpcs]
    s = _run(cfg)[-1]
    assert np.isfinite(s["actor_train/loss"]) and "rew_ref_inf/elapsed" in s
    assert "reward/task_reward" in s


def test_graph_with_a_trained_reward_model_runs(inputs, tmp_path):
    """SFT -> RM -> PPO's last link: a toy reward model trained by
    ``rw_train``, saved as an HF critic directory, scores the rollouts of
    ``reward_source="model"`` from its trained head."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import FinetuneSpec, Model
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.rm_interface import RewardModelInterface
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.hf import load_hf_model
    from areal_tpu_torch.models.transformer import init_params
    from tests.test_torch_reward_interfaces import _paired

    cfg = tiny_config(vocab_size=256, max_position_embeddings=512,
                      is_critic=True)
    rm = Model("reward", TrainEngine(
        cfg, None, init_params(cfg, 3, "cpu", dtype=torch.float32),
        OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0), 40,
        device="cpu"), ft_spec=FinetuneSpec(1, 40, 10), backend_name="llama")
    iface = RewardModelInterface()
    _, sample = _paired(4, seed=11)
    for _ in range(10):
        stats = iface.train_step(rm, sample, MicroBatchSpec())
    assert stats["reward_acc_sum"] >= 3.0
    rm_dir = str(tmp_path / "rm")
    iface.save(rm, rm_dir)
    _, loaded = load_hf_model(rm_dir, is_critic=True, device="cpu")
    assert torch.equal(loaded["value_head"]["w"], rm.engine.params[
        "value_head"]["w"].detach())

    exp = _experiment("torch", *inputs, "rm", kl_ctl=0.0, disable_value=True,
                      exp_kw=dict(reward_source="model", reward_model=
                                  ModelAbstraction("hf", {
                                      "path": rm_dir, "is_critic": True})))
    cfg = exp.initial_setup()
    shard = next(s for s in cfg.model_workers[0].shards
                 if s.model_name.role == "reward")
    assert shard.backend.type_ == "inference"
    s = _run(cfg)[-1]
    assert np.isfinite(s["actor_train/loss"])
    assert np.isfinite(s["actor_train/reward_mean"])
    assert s["actor_train/reward_mean"] != 0.0


@pytest.mark.parametrize("entry", ["main_sync_ppo", "quickstart"])
def test_cli_runs_the_recipe_config_on_the_cpu(inputs, entry):
    """The recipe's YAML with a random actor, every model on the CPU."""
    tok_dir, data_path = inputs
    argv = [
        "--config", str(RECIPE / "sync_ppo.yaml"), "actor.type_=random",
        "actor.args={vocab_size: 256, max_position_embeddings: 512}",
        "mesh_spec=d1", "force_cpu_devices=1",
        "trial_name=cli-" + entry.replace("_", "-"),
        "exp_ctrl.save_freq_steps=null", "exp_ctrl.ckpt_freq_steps=null",
        "exp_ctrl.benchmark_steps=2", f"tokenizer_path={tok_dir}",
        f"dataset.args.dataset_path={data_path}",
        "dataset.args.max_length=64", "train_bs_n_seqs=4",
        "ppo.gen.max_new_tokens=8", "mb_spec.max_tokens_per_mb=256",
    ]
    if entry == "main_sync_ppo":
        from areal_tpu_torch.apps.main_sync_ppo import main

        master = main(argv)
        stats = master.stats_history
    else:
        from areal_tpu_torch.apps import quickstart
        from areal_tpu_torch.base import constants

        assert quickstart.main(["ppo_math"] + argv) == 0
        log = os.path.join(constants.get_log_path(), "config.yaml")
        assert os.path.exists(log)
        return
    assert len(stats) == 2
    assert all(np.isfinite(s["actor_train/loss"]) for s in stats)
    assert "actor_gen/elapsed" in stats[-1] and "actor_inf/elapsed" in stats[-1]


def test_async_loop_with_the_reference_and_a_critic(inputs):
    """The async experiment with ``kl_ctl=0.1`` and the critic: ref_inf,
    critic_inf and critic_train run beside the actor's MFCs."""
    from areal_tpu_torch.apps.local_runner import run_experiment_local
    from tests.test_torch_async_ppo_e2e import _experiment as async_experiment

    exp = async_experiment("torch", *inputs, "kl-critic",
                           max_concurrent_rollouts=2)
    exp.ppo.kl_ctl = 0.1
    exp.ppo.disable_value = False
    cfg = exp.initial_setup()
    names = [r.name for r in cfg.master.model_rpcs]
    assert {"ref_inf", "critic_inf", "critic_train", "actor_train"} <= set(names)
    master = run_experiment_local(cfg, timeout=300)
    s = master.stats_history[-1]
    for k in ("actor_train/loss", "critic_train/loss", "actor_train/kl"):
        assert np.isfinite(s[k]), k
    assert "ref_inf/elapsed" in s and "critic_inf/elapsed" in s


# ---------------------------------------------------------------------------
# both packages on one experiment
# ---------------------------------------------------------------------------


def _record(mw, monkeypatch):
    """Record, per MFC call of ``mw.ModelWorker``, its name, the batch's
    token ids and rewards (train steps) and its statistics."""
    calls = []
    orig = mw.ModelWorker._handle_model_rpc

    def record(self, req):
        spec = req.data
        out = orig(self, req)
        rec = dict(rpc=spec["rpc_name"])
        if spec["handle_name"] == "train_step":
            b = self._data_manager.get_batch(list(spec["ids"]), [
                "packed_input_ids", "rewards"])
            rec.update(tokens=np.asarray(b.data["packed_input_ids"]).tolist(),
                       rewards=np.asarray(b.data["rewards"]).tolist(),
                       stats=dict(out["stats"]))
        calls.append(rec)
        return out

    monkeypatch.setattr(mw.ModelWorker, "_handle_model_rpc", record)
    return calls


def _jax_inits(monkeypatch):
    """The port's ``make_model`` with the JAX package's init trees (the
    actor's and the reference's, and the critic twin's) converted in place
    of torch's draws."""
    import jax

    from areal_tpu.models import transformer as jt
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu_torch.engine import backend
    from areal_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_async_ppo_e2e import _cast
    from tests.test_torch_train_model import port_config

    trees = {}
    for critic in (False, True):
        jcfg = jtiny(vocab_size=256, max_position_embeddings=512,
                     is_critic=critic)
        trees[critic] = (jax.device_get(jt.init_params(
            jcfg, jax.random.PRNGKey(0))), port_config(jcfg))
    orig = backend.make_model

    def make(*args, dtype=None, **kw):
        model = orig(*args, dtype=dtype, **kw)
        if model.init_params is not None:
            tree, cfg = trees[model.model_cfg.is_critic]
            assert cfg == model.model_cfg
            params = params_from_jax(tree, cfg, "cpu")
            model.init_params = (params if dtype == torch.float32
                                 else _cast(params, cfg))
        return model

    monkeypatch.setattr(backend, "make_model", make)


@pytest.mark.slow  # the JAX package's compiles
def test_the_full_graph_matches_the_jax_package(inputs, monkeypatch):
    """Greedy generation, the rule reward, the reference model (kl 0.1) and
    the critic, two steps, the JAX init trees in both: the same tokens and
    rewards, and the actor's and critic's statistics to 1e-4."""
    import torch.utils.tensorboard  # noqa: F401  (see the async slice test)

    from areal_tpu.apps.local_runner import run_experiment_local as jrun
    from areal_tpu.system import model_worker as jmw
    from areal_tpu_torch.apps.local_runner import run_experiment_local as trun

    runs = {}
    for pkg, mw, run in (("jax", jmw, jrun), ("torch", tmw, trun)):
        calls = _record(mw, monkeypatch)
        exp = _experiment(pkg, *inputs, f"both-{pkg}", kl_ctl=0.1,
                          gen=dict(greedy=True))
        # the JAX package's factory reads no is_critic beside a config
        # dict; with keyword arguments both build the critic twin alike
        cfg = exp.initial_setup()
        if pkg == "torch":
            _jax_inits(monkeypatch)
        master = run(cfg, timeout=600)
        assert len(master.stats_history) == 2
        runs[pkg] = [c for c in calls if "stats" in c]
    jc, tc = runs["jax"], runs["torch"]
    assert [c["rpc"] for c in tc] == [c["rpc"] for c in jc] == [
        "actor_train", "critic_train"] * 2
    for j, t in zip(jc, tc):
        assert t["tokens"] == j["tokens"] and t["rewards"] == j["rewards"]
        keys = (("loss", "grad_norm", "kl", "approx_kl", "entropy",
                 "reward_mean", "n_tokens")
                if t["rpc"] == "actor_train" else
                ("loss", "grad_norm", "value_clip_frac", "n_tokens"))
        for k in keys:
            np.testing.assert_allclose(t["stats"][k], j["stats"][k], rtol=TOL,
                                       atol=TOL, err_msg=f"{t['rpc']}: {k}")
