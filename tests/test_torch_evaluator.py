"""The port's offline evaluation against the JAX package's:

* ``pass_at_k`` and ``load_benchmark`` give equal outputs on the same
  inputs (benchmark, multiple-choice and training styles, and the same
  refusals);
* ``evaluate_checkpoint`` on one tiny HF directory gives the same tokens
  per request and the same accuracy, pass@k and per-task scores as JAX
  ``areal_tpu.apps.eval``, on the dense cache and on the paged one;
* the automatic evaluator (mirrors ``tests/scheduler/test_evaluator.py``):
  discovery, one job at a time through the scheduler client, harvest by
  global step, resume, failure marking; its device policy never picks the
  CPU unless the config says ``"cpu"``; and the real eval CLI run as its
  job.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from tests.fixtures import dataset, save_path, tokenizer  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- pass@k and the benchmark loader ------------------------------------------


def test_pass_at_k_equals_the_jax_package():
    from areal_tpu.apps.eval import pass_at_k as jpass
    from areal_tpu_torch.apps.eval import pass_at_k

    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 8):
        correct = rng.integers(0, n + 1, 11).tolist()
        for k in sorted({1, n, 2, 4} & set(range(1, n + 1))):
            assert pass_at_k(correct, n, k) == jpass(correct, n, k)
    assert pass_at_k([1], 4, 2) == 0.5 and pass_at_k([0, 4], 4, 1) == 0.5


def test_load_benchmark_equals_the_jax_package(tmp_path):
    from areal_tpu.data.benchmarks import load_benchmark as jload
    from areal_tpu_torch.data.benchmarks import load_benchmark

    d = tmp_path / "aime"
    d.mkdir()
    rows = [
        {"problem": "What is 2 + 2?", "answer": "4", "id": "a"},
        {"question": "Pick one", "options": ["x", "B) y", "z"],
         "correct_option_index": 1},
        {"problem": "Solve it", "solution": "so \\boxed{7}"},
        {"query_id": "t0", "prompt": "raw", "solutions": ["\\boxed{1}"]},
    ]
    path = d / "test.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert load_benchmark(str(path)) == jload(str(path))
    assert load_benchmark(str(path), name="x") == jload(str(path), name="x")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"problem": "no answer"}))
    for fn in (load_benchmark, jload):
        with pytest.raises(ValueError, match="no answer"):
            fn(str(bad))


# -- evaluate_checkpoint against the JAX package's --------------------------------


def _hf_dir(tokenizer, tmp_path):
    """A tiny Qwen2 directory over the fixture tokenizer's vocabulary."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen2Config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        vocab_size=len(tokenizer), max_position_embeddings=4096,
        tie_word_embeddings=False)
    model = transformers.Qwen2ForCausalLM(cfg)
    path = str(tmp_path / "hf")
    model.save_pretrained(path, safe_serialization=True)
    tokenizer.save_pretrained(path)
    return path


def _eval_data(tmp_path, style):
    if style == "benchmark":
        rows = [{"problem": f"What is {i} + {i}?", "answer": str(2 * i)}
                for i in range(5)]
    else:
        rows = [{"query_id": str(i), "prompt": f"What is {i} + {i}?",
                 "solutions": ["\\boxed{%d}" % (2 * i)], "task": "math"}
                for i in range(5)]
    path = tmp_path / f"{style}.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _tokens_of(engine_cls, monkeypatch):
    """Record every result the engine hands out, by qid."""
    seen = {}
    orig = engine_cls.try_get_result

    def rec(self, qid):
        out = orig(self, qid)
        if out is not None:
            seen[qid] = list(out.output_ids)
        return out

    monkeypatch.setattr(engine_cls, "try_get_result", rec)
    return seen


@pytest.mark.parametrize("style,kv_cache_len", [
    ("training", 64), ("benchmark", 2048)], ids=["dense", "paged"])
def test_evaluate_checkpoint_equals_the_jax_package(
        tokenizer, tmp_path, monkeypatch, style, kv_cache_len):
    from areal_tpu.apps import eval as jeval
    from areal_tpu.engine.inference_server import (
        ContinuousBatchingEngine as JaxEngine,
    )
    from areal_tpu_torch.apps import eval as teval
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )

    ckpt, data = _hf_dir(tokenizer, tmp_path), _eval_data(tmp_path, style)
    kw = dict(max_prompts=4, max_new_tokens=6, kv_cache_len=kv_cache_len,
              max_batch=4)
    got_toks = _tokens_of(ContinuousBatchingEngine, monkeypatch)
    got = teval.evaluate_checkpoint(ckpt, data, device="cpu", **kw)
    want_toks = _tokens_of(JaxEngine, monkeypatch)
    want = jeval.evaluate_checkpoint(ckpt, data, **kw)
    assert got_toks == want_toks and len(got_toks) == 4
    for k in ("dataset", "n_prompts", "n_samples", "accuracy", "pass_at_k",
              "per_task"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["paged_kernel_launches"] == 0


def test_eval_cli_writes_its_result(tokenizer, tmp_path, capsys):
    from areal_tpu_torch.apps import eval as teval

    ckpt, data = _hf_dir(tokenizer, tmp_path), _eval_data(tmp_path, "training")
    out = tmp_path / "result" / "eval_result.json"
    assert teval.main(["--ckpt", ckpt, "--dataset", data, "--output",
                       str(out), "--max-prompts", "2", "--max-new-tokens",
                       "4", "--kv-cache-len", "64", "--n-samples", "3",
                       "--temperature", "1.0", "--device", "cpu"]) == 0
    result = json.loads(out.read_text())
    assert result["n_prompts"] == 2 and result["n_samples"] == 3
    assert set(result["pass_at_k"]) == {"1", "3"}
    assert result["pass_at_k"]["3"] >= result["pass_at_k"]["1"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == (
        result)


# -- the automatic evaluator ---------------------------------------------------


class StubMetrics:
    def __init__(self):
        self.logged = []

    def log(self, scores, step):
        self.logged.append((step, scores))


def _mk_ckpt(root, epoch, epochstep, gstep):
    d = os.path.join(root, f"epoch{epoch}epochstep{epochstep}globalstep{gstep}")
    os.makedirs(d, exist_ok=True)
    return d


def _ok_argv(step):
    code = ("import json,sys;json.dump({'accuracy':0.5,'per_task':"
            "{'math':{'accuracy':0.5,'n':2}}},open(sys.argv[1],'w'))")
    return [sys.executable, "-c", code, step.output_path]


def _fail_argv(step):
    return [sys.executable, "-c", "import sys; sys.exit(3)"]


def _drive(ev, until, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not until():
        assert time.monotonic() < deadline, "evaluator did not converge"
        ev.step()
        time.sleep(0.05)


def test_discovery_submit_harvest_resume(tmp_path):
    from areal_tpu_torch.scheduler.client import (
        JobState,
        LocalSchedulerClient,
    )
    from areal_tpu_torch.scheduler.evaluator import (
        AutomaticEvaluator,
        EvalStatus,
    )

    ckpt_root, out_root = str(tmp_path / "ckpts"), str(tmp_path / "eval")
    _mk_ckpt(ckpt_root, 1, 1, 2)
    _mk_ckpt(ckpt_root, 1, 2, 4)
    os.makedirs(os.path.join(ckpt_root, "not_a_ckpt"))

    class Recording(LocalSchedulerClient):
        def __init__(self):
            super().__init__("evaltest", "t0")
            self.submissions = []

        def submit(self, worker_type, cmd, **kw):
            self.submissions.append((worker_type, list(cmd)))
            super().submit(worker_type, cmd, **kw)

    sched, metrics = Recording(), StubMetrics()
    ev = AutomaticEvaluator(ckpt_root, "unused.jsonl", out_root,
                            metrics=metrics, eval_argv=_ok_argv,
                            scheduler=sched)
    ev.step()
    assert sorted(ev._steps) == [2, 4]  # the junk dir ignored
    assert sum(s.status == EvalStatus.RUNNING for s in ev._steps.values()) == 1
    _drive(ev, lambda: len(ev.results) == 2)
    assert [wt for wt, _ in sched.submissions] == ["eval_gs2", "eval_gs4"]
    assert all(j.state == JobState.COMPLETED for j in sched.find_all())
    assert [s for s, _ in metrics.logged] == [2, 4]
    for _, scores in metrics.logged:
        assert scores == {"eval/accuracy": 0.5, "eval/math_accuracy": 0.5}
    assert ev._steps[4].result["per_task"]["math"]["n"] == 2
    ev.shutdown()
    # resume: a fresh evaluator over the same output root marks them done
    ev2 = AutomaticEvaluator(ckpt_root, "unused.jsonl", out_root,
                             eval_argv=_ok_argv)
    assert sorted(ev2.results) == [2, 4]


def test_failed_eval_is_marked_and_not_logged(tmp_path):
    from areal_tpu_torch.scheduler.evaluator import (
        AutomaticEvaluator,
        EvalStatus,
    )

    ckpt_root = str(tmp_path / "ckpts")
    _mk_ckpt(ckpt_root, 1, 1, 9)
    metrics = StubMetrics()
    ev = AutomaticEvaluator(ckpt_root, "unused.jsonl", str(tmp_path / "eval"),
                            metrics=metrics, eval_argv=_fail_argv)
    _drive(ev, lambda: ev._steps and all(
        s.status in (EvalStatus.FAILED, EvalStatus.DONE)
        for s in ev._steps.values()))
    assert ev._steps[9].status == EvalStatus.FAILED and metrics.logged == []
    ev.shutdown()


def test_default_argv_runs_the_ports_cli(tmp_path):
    from areal_tpu_torch.scheduler.evaluator import (
        AutomaticEvaluator,
        EvaluationStep,
    )

    step = EvaluationStep.from_ckpt_dir(
        _mk_ckpt(str(tmp_path), 1, 1, 3), str(tmp_path / "out"))
    ev = AutomaticEvaluator(str(tmp_path), "d.jsonl", str(tmp_path / "out"),
                            max_prompts=5, max_new_tokens=7)
    argv = ev._default_argv(step)
    assert argv[1:3] == ["-m", "areal_tpu_torch.apps.eval"]
    assert "--device" not in argv  # the CLI's default: the card
    ev.device = "cpu"
    assert ev._default_argv(step)[-2:] == ["--device", "cpu"]


@dataclasses.dataclass
class _Spec:
    world_size: int = 1


@dataclasses.dataclass
class _Shard:
    mesh_spec: _Spec


@dataclasses.dataclass
class _Worker:
    shards: list


@dataclasses.dataclass
class _Server:
    device_idx: object = None
    mesh_spec: object = None


@dataclasses.dataclass
class _Cfg:
    model_workers: list
    gen_servers: list = dataclasses.field(default_factory=list)


def test_auto_device_is_a_card_never_the_cpu_unasked(monkeypatch):
    from areal_tpu_torch.scheduler import evaluator as tev

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    one = _Cfg([_Worker([_Shard(_Spec())])], [_Server()])
    # one card, claimed by the workers: the job shares it
    monkeypatch.setattr(tev, "local_card_count", lambda: 1)
    env, device = tev.resolve_eval_env(one, "auto")
    assert env["CUDA_VISIBLE_DEVICES"] == "0" and device is None
    # a spare card: the last one
    monkeypatch.setattr(tev, "local_card_count", lambda: 2)
    env, device = tev.resolve_eval_env(one, "auto")
    assert env["CUDA_VISIBLE_DEVICES"] == "1" and device is None
    # the index maps through a visible-device list
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6")
    assert tev.resolve_eval_env(one, "auto")[0]["CUDA_VISIBLE_DEVICES"] == "6"
    # no card: an error, not the CPU
    monkeypatch.setattr(tev, "local_card_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.resolve_eval_env(one, "auto")
    # the CPU only when asked for, with the cards hidden from the job
    env, device = tev.resolve_eval_env(one, "cpu")
    assert device == "cpu" and env["CUDA_VISIBLE_DEVICES"] == ""
    assert tev.resolve_eval_env(one, "cuda:1")[1] == "cuda:1"
    assert tev.resolve_eval_env(one, "")[1] is None
    assert tev._claimed_devices(_Cfg([], [_Server(device_idx=2)])) == 3


def test_reading_the_card_count_creates_no_context():
    from areal_tpu_torch.scheduler.evaluator import local_card_count

    assert local_card_count() == torch.cuda.device_count()
    assert not torch.cuda.is_initialized()


def test_an_experiment_with_an_evaluator_builds_one(tmp_path, monkeypatch):
    from areal_tpu_torch.api.system_api import (
        EvaluatorConfig,
        ExperimentConfig,
        MasterWorkerConfig,
    )
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.scheduler import evaluator as tev

    monkeypatch.setenv("AREAL_LOG_ROOT", str(tmp_path / "logs"))
    monkeypatch.setenv("AREAL_SAVE_ROOT", str(tmp_path / "save"))
    constants.set_experiment_trial_names("evalexp", "t0")
    cfg = ExperimentConfig(
        experiment_name="evalexp", trial_name="t0",
        master=MasterWorkerConfig(worker_name="master"),
        evaluator=EvaluatorConfig(dataset_path="d.jsonl", device="cpu",
                                  max_prompts=3))
    cfg.lazy_init()  # no refusal
    ev = tev.make_evaluator(cfg)
    try:
        assert ev.device == "cpu" and ev.max_prompts == 3
        # the master saves under "actor@0"; the bare role names replica 0
        assert ev.ckpt_root == os.path.join(constants.get_save_path(),
                                            "actor@0")
        assert ev.output_root == os.path.join(constants.get_log_path(),
                                              "eval")
    finally:
        ev.shutdown()


def test_evaluator_runs_the_real_eval_cli(tokenizer, tmp_path):
    """The evaluator's job is the port's eval CLI (here on the CPU, as
    configured): it loads a real tiny checkpoint and its scores reach the
    metrics by global step."""
    import shutil

    from areal_tpu_torch.scheduler.evaluator import (
        AutomaticEvaluator,
        resolve_eval_env,
    )

    src = _hf_dir(tokenizer, tmp_path)
    step_dir = _mk_ckpt(str(tmp_path / "ckpts"), 1, 1, 7)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), step_dir)
    data = _eval_data(tmp_path, "training")
    env, device = resolve_eval_env(_Cfg([]), "cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"
    metrics = StubMetrics()
    ev = AutomaticEvaluator(str(tmp_path / "ckpts"), data,
                            str(tmp_path / "eval_out"), metrics=metrics,
                            max_prompts=1, max_new_tokens=4, env=env,
                            device=device)
    _drive(ev, lambda: len(ev.results) == 1, timeout=180.0)
    (step, scores), = metrics.logged
    assert step == 7 and "eval/accuracy" in scores
    assert ev._steps[7].result["device"] == "cpu"
    ev.shutdown()
