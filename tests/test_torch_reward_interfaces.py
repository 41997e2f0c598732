"""The port's reward-side interfaces against the JAX package's:

- ``rw_math`` (``MultiTaskRewardInterface``): the same rewards for the
  same decoded answers, right and wrong, and code tasks refused;
- ``fused-inference``: the sub-interfaces' union in their order, ``None``
  results skipped (``tests/engine/test_fused_interface.py``), the sync
  graph's ``rew_ref_inf`` MFC, and a fused reward + reference pass equal
  to the two passes made apart;
- ``rw_train`` (``RewardModelInterface``): two Bradley-Terry steps from the
  same float32 critic init (statistics and parameters to 1e-4), the
  rewards and pair accuracy of inference and evaluate, and a step that
  does not depend on how its pairs split into micro-batches
  (``tests/engine/test_rm_interface.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base.topology import MeshSpec
from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.train_engine import TrainEngine as JEngine
from areal_tpu.interfaces import rm_interface as jrm
from areal_tpu.interfaces import rw_interface as jrw
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelInterfaceAbstraction
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.interfaces import ppo_interface as tppo
from areal_tpu_torch.interfaces import rm_interface as trm
from areal_tpu_torch.interfaces import rw_interface as trw
from areal_tpu_torch.interfaces.fused_interface import FusedInferenceInterface
from areal_tpu_torch.models.convert import params_from_jax
from tests.engine.test_dpo_interface import VOCAB, make_paired_sample
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# rw_math
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def word_tokenizer(tmp_path_factory):
    """``chip_smoke.async_inputs``' word-level tokenizer: ids 3-6 each
    spell a right answer to every row, the rest are words ``w<i>``."""
    import chip_smoke
    from areal_tpu_torch.api.dataset_api import load_hf_tokenizer

    tok_dir, _ = chip_smoke.async_inputs(str(tmp_path_factory.mktemp("tok")),
                                         64, rows=1, n_answers=4)
    return load_hf_tokenizer(tok_dir)


def _answers(seed=0, n=8):
    """Prompt + answer sequences; every other answer holds a right one."""
    rng = np.random.default_rng(seed)
    seqs, masks = [], []
    for i in range(n):
        prompt = rng.integers(7, 64, int(rng.integers(2, 6)))
        answer = rng.integers(7, 64, int(rng.integers(1, 5)))
        if i % 2 == 0:
            answer[int(rng.integers(0, len(answer)))] = 3 + i % 4
        seqs.append(np.r_[prompt, answer].astype(np.int32))
        masks.append(np.r_[np.ones(len(prompt), bool),
                           np.zeros(len(answer), bool)])
    return seqs, masks


def _rw_sample(cls, seqs, masks, tasks):
    return cls.from_default(
        [len(s) for s in seqs], [f"q{i}" for i in range(len(seqs))],
        dict(packed_input_ids=np.concatenate(seqs),
             prompt_mask=np.concatenate(masks)),
        metadata=dict(solutions=[["\\boxed{42}"]] * len(seqs), task=tasks))


def test_math_rewards_equal_the_jax_package(word_tokenizer):
    seqs, masks = _answers()
    tasks = ["math"] * 6 + ["stem"] * 2
    jout = jrw.MultiTaskRewardInterface().inference(
        jmodel_api.Model("reward", None, word_tokenizer, None),
        _rw_sample(JSample, seqs, masks, tasks), JSpec())
    tout = trw.MultiTaskRewardInterface().inference(
        model_api.Model("reward", None, word_tokenizer),
        _rw_sample(SequenceSample, seqs, masks, tasks), MicroBatchSpec())
    assert tout.keys == jout.keys == {"rewards"}
    assert tout.seqlens == jout.seqlens
    np.testing.assert_array_equal(tout.data["rewards"], jout.data["rewards"])
    # right answers score above wrong ones
    r = tout.data["rewards"]
    assert (r[0::2] > r[1::2]).all()


def test_code_tasks_are_refused(word_tokenizer):
    seqs, masks = _answers(n=2)
    with pytest.raises(NotImplementedError, match="item 15"):
        trw.MultiTaskRewardInterface().inference(
            model_api.Model("reward", None, word_tokenizer),
            _rw_sample(SequenceSample, seqs, masks, ["math", "code"]),
            MicroBatchSpec())


# ---------------------------------------------------------------------------
# fused-inference
# ---------------------------------------------------------------------------


class _StubIface(model_api.ModelInterface):
    def __init__(self, key: str):
        self.key = key

    def inference(self, model, data, mb_spec):
        return SequenceSample.from_default(
            [1] * data.bs, list(data.ids),
            {self.key: np.arange(data.bs, dtype=np.float32)})


class _NoneIface(model_api.ModelInterface):
    def inference(self, model, data, mb_spec):
        return None


def _prompt_sample(bs=3):
    return SequenceSample.from_default(
        [4] * bs, [str(i) for i in range(bs)],
        {"packed_input_ids": np.zeros(4 * bs, np.int64)})


def test_fused_union_and_order():
    fused = FusedInferenceInterface(
        {"a": _StubIface("rewards"), "b": _StubIface("values")})
    out = fused.inference(None, _prompt_sample(), MicroBatchSpec())
    assert {"rewards", "values"} <= set(out.keys)
    np.testing.assert_array_equal(out.data["rewards"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out.data["values"], [0.0, 1.0, 2.0])


def test_fused_skips_none_results():
    fused = FusedInferenceInterface({"a": _NoneIface(),
                                     "b": _StubIface("rewards")})
    out = fused.inference(None, _prompt_sample(), MicroBatchSpec())
    assert set(out.keys) == {"rewards"}
    assert FusedInferenceInterface({"a": _NoneIface()}).inference(
        None, _prompt_sample(), MicroBatchSpec()) is None


def test_fused_reward_and_reference_pass_equals_the_two_apart(word_tokenizer):
    """``rew_ref_inf`` as the sync graph builds it (abstractions of
    ``rw_math`` and ``ppo_actor``) on a reference model: the rewards and
    reference logprobs of the two interfaces run apart."""
    cfg = port_config(jtiny(vocab_size=64))
    tree = jax.device_get(jt.init_params(jtiny(vocab_size=64),
                                         jax.random.PRNGKey(5)))
    model = model_api.Model("ref", TrainEngine(
        cfg, None, params_from_jax(tree, cfg, "cpu"), device="cpu"),
        word_tokenizer)
    rw = ModelInterfaceAbstraction("rw_math", {"group_size": 1})
    ref = ModelInterfaceAbstraction("ppo_actor", {"kl_ctl": 0.1})
    fused = FusedInferenceInterface({"rew": rw, "ref": ref})
    seqs, masks = _answers(seed=2)
    out = fused.inference(model, _rw_sample(SequenceSample, seqs, masks,
                                            ["math"] * 8), MicroBatchSpec())
    assert out.keys == {"rewards", "packed_ref_logprobs"}
    apart = [model_api.make_interface(a).inference(
        model, _rw_sample(SequenceSample, seqs, masks, ["math"] * 8),
        MicroBatchSpec()) for a in (rw, ref)]
    np.testing.assert_array_equal(out.data["rewards"], apart[0].data["rewards"])
    np.testing.assert_array_equal(out.data["packed_ref_logprobs"],
                                  apart[1].data["packed_ref_logprobs"])


def test_ppo_graph_fuses_rew_ref():
    from areal_tpu_torch.api.config import DatasetAbstraction, ModelAbstraction
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMathExperiment

    exp = PPOMathExperiment(
        actor=ModelAbstraction("random", {"vocab_size": 64}),
        dataset=DatasetAbstraction("math_code_prompt", {}),
        fuse_rew_ref=True)
    assert exp.use_ref
    cfg = exp.initial_setup()
    names = {r.name for r in cfg.master.model_rpcs}
    assert "rew_ref_inf" in names
    assert "rew_inf" not in names and "ref_inf" not in names
    rpc = next(r for r in cfg.master.model_rpcs if r.name == "rew_ref_inf")
    assert set(rpc.output_keys) == {"rewards", "packed_ref_logprobs"}
    roles = {s.model_name.role for w in cfg.model_workers for s in w.shards}
    assert "reward" not in roles and "ref" in roles


# ---------------------------------------------------------------------------
# rw_train
# ---------------------------------------------------------------------------

OPT = dict(lr=5e-3, warmup_steps_proportion=0.0)


def _rms(seed=0):
    jcfg = jtiny(vocab_size=VOCAB, is_critic=True)
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**OPT),
                 100)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT), 100, device="cpu")
    return (jmodel_api.Model("reward", je, None, mesh,
                             ft_spec=jmodel_api.FinetuneSpec(1, 100, 10)),
            model_api.Model("reward", te,
                            ft_spec=model_api.FinetuneSpec(1, 100, 10)),
            cfg)


def _paired(n_prompts, seed):
    js = make_paired_sample(n_prompts=n_prompts, seed=seed)
    ts = SequenceSample(
        keys=set(js.keys), trailing_shapes=dict(js.trailing_shapes),
        dtypes=dict(js.dtypes), ids=list(js.ids),
        seqlens={k: [list(ls) for ls in v] for k, v in js.seqlens.items()},
        data={k: v.copy() for k, v in js.data.items()})
    return js, ts


def test_rm_train_steps_match_the_jax_package():
    """Two steps (one micro-batch, then two), inference and evaluate."""
    jm, tm, cfg = _rms(seed=3)
    ji, ti = jrm.RewardModelInterface(), trm.RewardModelInterface()
    for step, n_mbs in enumerate((1, 2)):
        js, ts = _paired(4, seed=7)
        jst = ji.train_step(jm, js, JSpec(n_mbs=n_mbs))
        tst = ti.train_step(tm, ts, MicroBatchSpec(n_mbs=n_mbs))
        assert tst["n_tokens"] == jst["n_tokens"] == 4.0  # pairs
        for k in ("loss", "grad_norm", "margin_sum", "reward_acc_sum",
                  "score_abs_sum", "n_seqs"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
        assert tm.version.global_step == jm.version.global_step == step + 1
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params),
                                 cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    js, ts = _paired(6, seed=9)
    jr = ji.inference(jm, js, JSpec())
    tr = ti.inference(tm, ts, MicroBatchSpec())
    assert tr.keys == {"rewards"} and tr.seqlens == jr.seqlens
    assert tr.data["rewards"].shape == (12,)
    np.testing.assert_allclose(tr.data["rewards"], jr.data["rewards"],
                               rtol=TOL, atol=TOL)
    assert ti.evaluate(tm, [ts]) == pytest.approx(ji.evaluate(jm, [js]))
    assert ti.evaluate(tm, None) == {}


def test_rm_learns_the_pair_order():
    """Twenty steps on four pairs: the loss falls from about log 2 and the
    scorer orders at least three of the four pairs right."""
    _, tm, _ = _rms()
    iface = trm.RewardModelInterface()
    _, ts = _paired(4, seed=7)
    first = iface.train_step(tm, ts, MicroBatchSpec())
    assert abs(first["loss"] - np.log(2.0)) < 0.2
    for _ in range(20):
        stats = iface.train_step(tm, ts, MicroBatchSpec())
    assert stats["loss"] < first["loss"]
    assert stats["reward_acc_sum"] / stats["n_tokens"] >= 0.75
    ev = iface.evaluate(tm, [ts])
    assert ev["eval_pairs"] == 4.0 and ev["eval_pair_acc"] >= 0.75


@pytest.mark.parametrize("n_mbs", [2, 3, 4])
def test_rm_microbatch_split_invariance(n_mbs):
    _, ts = _paired(4, seed=8)
    iface = trm.RewardModelInterface()
    _, m1, _ = _rms(seed=1)
    s1 = iface.train_step(m1, ts, MicroBatchSpec(n_mbs=1))
    _, m2, _ = _rms(seed=1)
    s2 = iface.train_step(m2, ts, MicroBatchSpec(n_mbs=n_mbs))
    assert s2["n_mbs"] == n_mbs
    np.testing.assert_allclose(s1["loss"], s2["loss"], atol=1e-5)
    for (k, a), (_, b) in zip(_flat(m1.engine.params), _flat(m2.engine.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=k)


def test_rm_needs_a_critic_head():
    cfg = port_config(jtiny(vocab_size=VOCAB))
    _, ts = _paired(2, seed=1)
    from areal_tpu_torch.models.transformer import init_params

    lm = model_api.Model("reward", TrainEngine(
        cfg, None, init_params(cfg, 0, "cpu", dtype=torch.float32),
        OptimizerConfig(**OPT), 10, device="cpu"))
    with pytest.raises(AssertionError, match="critic-head"):
        trm.RewardModelInterface().train_step(lm, ts, MicroBatchSpec())
    assert tppo.critic_values_fwd is trm.critic_values_fwd
