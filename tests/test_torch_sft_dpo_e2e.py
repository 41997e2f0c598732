"""The SFT, DPO, reward-model and null experiments on the port, through
its entry points on the CPU (``force_cpu_devices=1``) at tiny width:

- each experiment's graph (MFCs, models, backends, interfaces) equals the
  JAX package's;
- ``run_experiment_local`` completes ``sft``, ``dpo``, ``rw`` and
  ``null_ppo`` (as ``tests/system/test_{sft,dpo}_e2e.py`` and
  ``test_null_exp.py`` do for the JAX package): the losses finite, DPO's
  first at ln 2 (the actor is its reference), SFT's and DPO's falling;
- ``python -m areal_tpu_torch.apps.main_sft`` / ``main_dpo`` and
  ``quickstart`` run the recipes' ``training/configs/{sft,dpo}.yaml`` with
  a random model (``pack_capacity`` and a remat policy on);
- marked slow: both packages' local runners on one tiny SFT and one DPO
  experiment from the JAX init trees give the same loss trajectories
  (1e-4) over four steps.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.fixtures import (  # noqa: F401
    dataset,
    dataset_path,
    save_path,
    tokenizer,
    tokenizer_path,
)
from tests.test_torch_sync_ppo_e2e import _graph

TOL = 1e-4
RECIPE = Path(__file__).resolve().parents[1] / "training" / "configs"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def logs(tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))


def _experiment(pkg, name, tok_dir, data_path, trial="e2e", steps=4, **kw):
    """One tiny experiment of ``name`` in ``pkg`` ("jax" or "torch"), one
    model worker, ``steps`` steps."""
    import importlib

    root = "areal_tpu" if pkg == "jax" else "areal_tpu_torch"
    config = importlib.import_module(f"{root}.api.config")
    system_api = importlib.import_module(f"{root}.api.system_api")
    optimizer = importlib.import_module(f"{root}.engine.optimizer")
    model = config.ModelAbstraction(
        "random", {"vocab_size": 256, "max_position_embeddings": 512,
                   **({"is_critic": True} if name == "rw" else {})})
    common = dict(
        experiment_name=f"test-{name}".replace("_", "-"), trial_name=trial,
        n_model_workers=1,
        exp_ctrl=system_api.ExperimentSaveEvalControl(
            total_train_epochs=4, benchmark_steps=steps),
        tokenizer_path=tok_dir, train_bs_n_seqs=8)
    if pkg == "torch":
        common["force_cpu_devices"] = 1
    opt = optimizer.OptimizerConfig(lr=1e-3)
    if name == "sft":
        exp = importlib.import_module(f"{root}.experiments.sft_exp")
        return exp.SFTExperiment(
            model=model, optimizer=opt, dataset=config.DatasetAbstraction(
                "prompt_answer", {"dataset_path": data_path, "max_length": 128}),
            **common, **kw)
    if name == "dpo":
        exp = importlib.import_module(f"{root}.experiments.dpo_exp")
        return exp.DPOExperiment(
            actor=model, optimizer=opt, beta=0.5,
            dataset=config.DatasetAbstraction(
                "rw_pair", {"dataset_path": data_path, "max_length": 128}),
            **common, **kw)
    if name == "rw":
        exp = importlib.import_module(f"{root}.experiments.rm_exp")
        return exp.RMExperiment(
            model=model, optimizer=opt, dataset=config.DatasetAbstraction(
                "rw_pair", {"dataset_path": data_path, "max_length": 128}),
            **common, **kw)
    exp = importlib.import_module(f"{root}.experiments.null_exp")
    common.pop("train_bs_n_seqs")
    return exp.NullPPOExperiment(
        dataset=config.DatasetAbstraction(
            "prompt", {"dataset_path": data_path, "max_length": 64}),
        train_bs_n_seqs=4, **common, **kw)


@pytest.mark.parametrize("name", ["sft", "dpo", "rw", "null_ppo"])
def test_the_graph_equals_the_jax_packages(name):
    graphs = []
    for pkg in ("jax", "torch"):
        exp = _experiment(pkg, name, None, "unused.jsonl")
        exp.force_cpu_devices = None
        graphs.append(_graph(exp.initial_setup()))
    assert graphs[1] == graphs[0]


_LOSS = {"sft": "trainDefault/loss", "dpo": "dpo_train/loss",
         "rw": "rw_train/loss"}


@pytest.mark.parametrize("name", ["sft", "dpo", "rw", "null_ppo"])
def test_local_runner_completes_the_experiment(name, dataset_path,
                                               tokenizer_path, logs):
    from areal_tpu_torch.apps.local_runner import run_experiment_local

    cfg = _experiment("torch", name, tokenizer_path, dataset_path).initial_setup()
    master = run_experiment_local(cfg, timeout=300)
    hist = master.stats_history
    assert len(hist) == 4
    if name == "null_ppo":
        assert {r.name for r in cfg.master.model_rpcs} == {"reward", "trainDefault"}
        assert hist[-1]["trainDefault/null/n_seqs"] == 4.0
        assert np.isfinite(hist[-1]["time_perf/e2e"])
        return
    losses = [s[_LOSS[name]] for s in hist]
    assert all(np.isfinite(l) for l in losses), losses
    if name == "dpo":
        # the reference is the actor's abstraction: the same float32
        # weights, so the first loss is ln 2
        assert abs(losses[0] - np.log(2.0)) < 1e-5, losses[0]
    if name in ("sft", "dpo"):
        assert losses[-1] < losses[0], losses
    # the model worker's throughput accounting reaches the master
    key = _LOSS[name].split("/")[0]
    assert hist[-1][f"{key}/tflops"] > 0 and hist[-1][f"{key}/n_tokens"] > 0


@pytest.mark.parametrize("entry", ["main_sft", "main_dpo", "quickstart"])
def test_cli_runs_the_recipe_config_on_the_cpu(entry, dataset_path,
                                               tokenizer_path, logs):
    """The recipes' YAMLs with a random model, rows packed to a capacity
    and a remat policy, on the CPU."""
    name = "dpo" if entry == "main_dpo" else "sft"
    key = "actor" if name == "dpo" else "model"
    argv = [
        "--config", str(RECIPE / f"{name}.yaml"), f"{key}.type_=random",
        f"{key}.args={{vocab_size: 256, max_position_embeddings: 512, "
        "remat: true, remat_policy: qkv_attn}",
        "mesh_spec=d1", "force_cpu_devices=1", "trial_name=cli-" + entry.replace("_", "-"),
        "exp_ctrl.save_freq_steps=null", "exp_ctrl.benchmark_steps=2",
        f"tokenizer_path={tokenizer_path}",
        f"dataset.args.dataset_path={dataset_path}",
        "dataset.args.max_length=128", "train_bs_n_seqs=8",
        "mb_spec.max_tokens_per_mb=256", "optimizer.mu_dtype=bfloat16",
    ]
    if entry == "quickstart":
        from areal_tpu_torch.apps import quickstart
        from areal_tpu_torch.base import constants

        assert quickstart.main(["sft"] + argv) == 0
        assert os.path.exists(
            os.path.join(constants.get_log_path(), "config.yaml"))
        return
    import importlib

    master = importlib.import_module(f"areal_tpu_torch.apps.{entry}").main(argv)
    loss = "dpo_train/loss" if name == "dpo" else "trainDefault/loss"
    assert len(master.stats_history) == 2
    assert all(np.isfinite(s[loss]) for s in master.stats_history)


def test_quickstart_lists_the_experiments(capsys):
    from areal_tpu_torch.apps import quickstart

    assert quickstart.main(["list"]) == 0
    names = set(capsys.readouterr().out.split())
    assert {"sft", "dpo", "rw", "null_ppo", "ppo_math",
            "async_ppo_math"} <= names


@pytest.mark.slow  # the JAX package's compiles, ~1 minute
@pytest.mark.parametrize("name", ["sft", "dpo"])
def test_loss_trajectories_match_the_jax_package(name, dataset_path,
                                                 tokenizer_path, logs,
                                                 monkeypatch):
    """Both packages' local runners from the JAX init trees: the same
    losses and gradient norms over four steps."""
    import torch.utils.tensorboard  # noqa: F401  (see the async slice test)

    from areal_tpu.apps.local_runner import run_experiment_local as jrun
    from areal_tpu_torch.apps.local_runner import run_experiment_local as trun
    from tests.test_torch_sync_ppo_e2e import _jax_inits

    key = "trainDefault" if name == "sft" else "dpo_train"
    hists = {}
    for pkg, run in (("jax", jrun), ("torch", trun)):
        cfg = _experiment(pkg, name, tokenizer_path, dataset_path,
                          trial=f"both-{pkg}").initial_setup()
        if pkg == "torch":
            _jax_inits(monkeypatch)
        hists[pkg] = run(cfg, timeout=600).stats_history
    for j, t in zip(hists["jax"], hists["torch"]):
        for k in ("loss", "grad_norm", "n_tokens"):
            np.testing.assert_allclose(t[f"{key}/{k}"], j[f"{key}/{k}"],
                                       rtol=TOL, atol=TOL, err_msg=k)
    assert len(hists["torch"]) == len(hists["jax"]) == 4


def test_the_cards_training_check_route_and_control():
    """``chip_smoke.train_route_check``, the training phase's gate on the
    flash kernels, at tiny size on the CPU, where the wrapper is the plain
    version: the per-head plain route equals the whole plain attention
    (grouped heads, packed rows, padding), the kernel route lies at 0 from
    it, and the control (each row as one segment) moves the hidden states
    and logprobs of the packed sequences after a row's first."""
    import chip_smoke
    from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.ops.flash_attention import reference_flash_attention

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, h, 16))
                                .astype(np.float32)) for h in (4, 2, 2))
    seg = torch.tensor([[1] * 25 + [2] * 15, [1] * 30 + [0] * 10],
                       dtype=torch.int32)
    assert torch.equal(chip_smoke.per_head_plain_attention(q, k, v, seg),
                       reference_flash_attention(q, k, v, seg))

    cfg = tiny_config(vocab_size=256, use_attention_bias=True)
    lens = [40, 30, 20, 50]
    n = sum(lens)
    sample = SequenceSample.from_default(
        seqlens=lens, ids=[f"s{i}" for i in range(len(lens))],
        data={"packed_input_ids": rng.integers(3, 256, n).astype(np.int32),
              "prompt_mask": np.zeros(n, bool)})
    eng = TrainEngine(cfg, None, init_params(cfg, 0, "cpu", dtype=torch.float32),
                      OptimizerConfig(lr=1e-3), 10, device="cpu",
                      pack_capacity=128)
    chk = chip_smoke.train_route_check(
        eng, sample, MicroBatchSpec(max_tokens_per_mb=256), "packed_input_ids",
        control=True)
    assert chk["rows"] == (2, 128) and chk["segments"] == 4
    assert chk["tokens"] == n
    assert chk["kernel"] == dict(hidden=0.0, logprob=0.0)
    assert chk["control"]["hidden"] > chip_smoke.TOL_TRAIN_HIDDEN
    assert chk["control"]["logprob"] > chip_smoke.TOL_TRAIN_LOGPROB
