"""The port's critic against the JAX package's: the value loss
(``critic_loss_fn``, mse and huber, to 1e-6), the value head's forward and
``critic_values_fwd``, ``PPOCriticInterface`` inference then two train
steps on the same float32 init and rollout (values, returns, statistics
and every parameter to 1e-4; ``tests/engine/test_ppo_interface.py``'s
critic case), and critics read from and written to HF directories: an LM
checkpoint becomes a critic with a zero value head and an untied
embedding, and a trained head is written as ``value_head.weight`` and read
back by either package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.base.topology import MeshSpec
from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.train_engine import TrainEngine as JEngine
from areal_tpu.interfaces import ppo_functional as jfn
from areal_tpu.interfaces import ppo_interface as jppo
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import load_hf_model as jload
from areal_tpu.models.hf import save_hf_model as jsave
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.engine import backend
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.interfaces import ppo_functional as tfn
from areal_tpu_torch.interfaces import ppo_interface as tppo
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.hf import load_hf_model, save_hf_model
from tests.test_torch_hf import _assert_same_tree
from tests.test_torch_ppo_actor import OPT, rollout
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("loss_type", ["mse", "huber"])
@pytest.mark.parametrize("eps_clip", [0.2, 5.0])
def test_critic_loss_matches_the_jax_package(loss_type, eps_clip):
    rng = np.random.default_rng(3)
    shape = (4, 33)
    value = rng.normal(0, 8, shape).astype(np.float32)
    old = value + rng.normal(0, 1, shape).astype(np.float32)
    target = rng.normal(0, 12, shape).astype(np.float32)  # some |diff| > 10
    mask = (rng.random(shape) < 0.7).astype(np.float32)
    jl, js = jfn.critic_loss_fn(*map(jnp.asarray, (value, old, target)),
                                eps_clip, jnp.asarray(mask),
                                loss_fn_type=loss_type)
    tl, ts = tfn.critic_loss_fn(*map(torch.from_numpy, (value, old, target)),
                                eps_clip, torch.from_numpy(mask),
                                loss_fn_type=loss_type)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts["clip_mask"].numpy(),
                                  np.asarray(js["clip_mask"]))
    np.testing.assert_allclose(ts["loss"].numpy(), np.asarray(js["loss"]),
                               rtol=1e-6, atol=1e-6)
    assert ts["clip_mask"].any() or eps_clip > 1


def _critics():
    jcfg = jtiny(vocab_size=64, is_critic=True, remat=True)
    cfg = port_config(jcfg)
    assert cfg.is_critic and not cfg.tied_embedding
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(2)))
    assert tree["value_head"]["w"].shape == (cfg.hidden_dim, 1)
    assert "lm_head" not in tree
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**OPT), 10)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT), 10, device="cpu")
    return (jmodel_api.Model("critic", je, None, mesh),
            model_api.Model("critic", te), jcfg, cfg)


def test_value_head_forward_matches_the_jax_package():
    jm, tm, jcfg, cfg = _critics()
    rng = np.random.default_rng(0)
    B, T = 3, 10
    tokens = rng.integers(0, 64, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    seg = np.ones((B, T), np.int32)
    seg[1, 6:] = 0
    pos[1, 6:] = 0
    want = np.asarray(jt.forward(jm.engine.params, jcfg, tokens, pos, seg))
    with torch.no_grad():
        got = tt.forward(tm.engine.params, cfg, *(
            torch.from_numpy(a).long() for a in (tokens, pos)),
            torch.from_numpy(seg))
    assert got.shape == (B, T) and got.dtype == torch.float32
    real = seg.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=TOL,
                               atol=TOL)
    batch = dict(tokens=torch.from_numpy(tokens).long(),
                 positions=torch.from_numpy(pos).long(),
                 seg_ids=torch.from_numpy(seg))
    with torch.no_grad():
        v = tppo.critic_values_fwd(tm.engine.params, cfg, batch)
    jv = jppo.critic_values_fwd(jm.engine.params, jcfg, dict(
        tokens=tokens, positions=pos, seg_ids=seg))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    assert (v.numpy()[~real] == 0).all()


CRITIC = dict(n_minibatches=2, value_eps_clip=0.2, kl_ctl=0.1, discount=1.0,
              gae_lambda=1.0, max_reward_clip=5.0)


@pytest.mark.parametrize("loss_type", ["mse", "huber"])
def test_critic_inference_then_train_steps_match_the_jax_package(loss_type):
    """critic_inf, then two critic_train steps of 2 minibatches over 2
    micro-batches each: values, the prepared returns, the statistics and
    every parameter after both steps to 1e-4."""
    jm, tm, _, cfg = _critics()
    ji = jppo.PPOCriticInterface(**CRITIC, value_loss_type=loss_type)
    ti = tppo.PPOCriticInterface(**CRITIC, value_loss_type=loss_type)
    js, ts = rollout(cfg.vocab_size, seed=4)
    jspec, tspec = JSpec(n_mbs=2), MicroBatchSpec(n_mbs=2)
    jv, tv = ji.inference(jm, js, jspec), ti.inference(tm, ts, tspec)
    assert tv.keys == {"values"} and tv.seqlens == jv.seqlens
    np.testing.assert_allclose(tv.data["values"], jv.data["values"], rtol=TOL,
                               atol=TOL)
    js.update_(jv)
    ts.update_(tv)
    for step in range(2):
        jst = ji.train_step(jm, js, jspec)
        tst = ti.train_step(tm, ts, tspec)
        for k in ("advantages", "returns", "ppo_loss_mask"):
            np.testing.assert_allclose(ts.data[k], js.data[k], rtol=TOL,
                                       atol=TOL, err_msg=k)
        assert tst["n_mbs"] == jst["n_mbs"] == 4
        for k in ("loss", "grad_norm", "value_clip_frac", "n_tokens"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
        assert tm.version.global_step == jm.version.global_step == step + 1
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params),
                                 cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_padding_micro_batches_add_nothing_to_the_denominator():
    """A minibatch split into 3 micro-batches: the JAX package pads the
    count to 4 with an all-zero micro-batch whose floored loss count
    (``max(sum(mask), 1)``) adds 1 to the step's denominator, so its loss
    and gradients shrink by 30/31 here; the port has no padding
    micro-batch, and its step equals its one-micro-batch step."""
    jm, tm, _, cfg = _critics()
    js, ts = rollout(cfg.vocab_size, seed=4)
    ji = jppo.PPOCriticInterface(**{**CRITIC, "n_minibatches": 1})
    ti = tppo.PPOCriticInterface(**{**CRITIC, "n_minibatches": 1})
    js.update_(ji.inference(jm, js, JSpec()))
    ts.update_(ti.inference(tm, ts, MicroBatchSpec()))
    jst = ji.train_step(jm, js, JSpec(n_mbs=3))
    _, tm1, _, _ = _critics()  # the same init, for one micro-batch
    tst = ti.train_step(tm, ts, MicroBatchSpec(n_mbs=3))
    mask_tokens = float(ts.data["ppo_loss_mask"].sum())
    assert tst["n_mbs"] == jst["n_mbs"] == 3
    assert tst["n_tokens"] == mask_tokens == jst["n_tokens"] - 1
    np.testing.assert_allclose(jst["loss"] * jst["n_tokens"] / mask_tokens,
                               tst["loss"], rtol=TOL)
    one = ti.train_step(tm1, ts, MicroBatchSpec(n_mbs=1))
    for k in ("loss", "grad_norm", "n_tokens"):
        np.testing.assert_allclose(tst[k], one[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    for (k, a), (_, b) in zip(_flat(tm.engine.params), _flat(tm1.engine.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


# ---------------------------------------------------------------------------
# critics in HF directories
# ---------------------------------------------------------------------------


@pytest.fixture
def tied_qwen2(tmp_path):
    """A tiny Qwen2 directory with a tied embedding, as Qwen2.5's."""
    import transformers

    torch.manual_seed(0)
    path = str(tmp_path / "qwen2_tied")
    transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=64, tie_word_embeddings=True,
    )).save_pretrained(path, safe_serialization=True)
    return path


def _jax_critic(path):
    jcfg, jparams = jload(path, is_critic=True, dtype="float32")
    cfg = port_config(jcfg)
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg,
                                               "cpu")


def test_an_lm_checkpoint_loads_as_a_critic_in_both_packages(tied_qwen2):
    cfg, params = load_hf_model(tied_qwen2, is_critic=True, dtype="float32",
                                device="cpu")
    jcfg, jparams, jcfg_port, jtree = _jax_critic(tied_qwen2)
    assert cfg == jcfg_port and cfg.is_critic and not cfg.tied_embedding
    assert "lm_head" not in params
    assert torch.count_nonzero(params["value_head"]["w"]) == 0
    _assert_same_tree(params, jtree)
    # and through the model factory, as a critic twin of an hf actor
    m = backend.make_model(ModelAbstraction(
        "hf", {"path": tied_qwen2, "is_critic": True, "dtype": "float32"}),
        None, device="cpu", dtype=torch.float32)
    assert m.model_cfg == cfg and m.backend_name == "qwen2"
    _assert_same_tree(m.init_params, params)
    # a zero head gives zero values
    tokens = torch.randint(0, 128, (2, 7))
    pos = torch.arange(7).expand(2, 7)
    with torch.no_grad():
        v = tt.forward(params, cfg, tokens, pos, torch.ones_like(tokens,
                                                                 dtype=torch.int32))
    assert v.shape == (2, 7) and torch.count_nonzero(v) == 0


def test_a_trained_head_is_saved_and_reloaded_by_either_package(tied_qwen2,
                                                                tmp_path):
    cfg, params = load_hf_model(tied_qwen2, is_critic=True, dtype="float32",
                                device="cpu")
    params["value_head"]["w"] = torch.linspace(-1, 1, cfg.hidden_dim)[:, None]
    jcfg, jparams, _, _ = _jax_critic(tied_qwen2)
    jparams["value_head"]["w"] = jnp.asarray(params["value_head"]["w"].numpy())
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save_hf_model(ours, "qwen2", cfg, params)
    jsave(theirs, "qwen2", jcfg, jparams)
    configs = []
    for d in (ours, theirs):
        with open(os.path.join(d, "config.json")) as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]
    assert configs[0]["tie_word_embeddings"] is False
    _assert_same_tree(_jax_critic(ours)[3], params)
    _assert_same_tree(load_hf_model(theirs, is_critic=True, dtype="float32",
                                    device="cpu")[1], params)
    # read as an LM, a critic's directory has no head to give
    with pytest.raises(KeyError, match="lm_head"):
        load_hf_model(ours, dtype="float32", device="cpu")


def test_a_random_critic_twin_has_a_value_head():
    """The sync graph's critic twin of a ``random`` actor given by a
    ``config`` dict: the port's factory applies ``is_critic``, so the
    critic has a value head; the JAX package's builds the dict's config
    without it (an LM head where values are due)."""
    from areal_tpu.api.config import ModelAbstraction as JAbs
    from areal_tpu.engine.backend import make_model as jmake
    from areal_tpu_torch.experiments.ppo_math_exp import PPOMathExperiment

    conf = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2,
                head_dim=8, intermediate_dim=64, vocab_size=64,
                dtype="float32", tied_embedding=True)
    exp = PPOMathExperiment(actor=ModelAbstraction("random",
                                                   {"config": conf}))
    cfg = exp.initial_setup()
    (twin,) = [s.model for w in cfg.model_workers for s in w.shards
               if s.model_name.role == "critic"]
    assert twin.args == {"config": conf, "is_critic": True}
    m = backend.make_model(twin, None, device="cpu", dtype=torch.float32)
    assert m.model_cfg.is_critic and not m.model_cfg.tied_embedding
    assert "value_head" in m.init_params and "lm_head" not in m.init_params
    j = jmake(JAbs("random", dict(twin.args)), None, None)
    assert not j.model_cfg.is_critic and "value_head" not in j.init_params
