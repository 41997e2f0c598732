"""The port's HF checkpoint import and export (``areal_tpu_torch/models/hf``)
against the JAX package's (``areal_tpu/models/hf``) and ``transformers``, on
tiny models built from local ``transformers`` configs
(``tests/model/test_hf_parity.py``'s ``_tiny_hf_model``).

* For llama, qwen2, qwen3, mistral, gemma and gpt2: the port's loaded
  config and tree equal the JAX package's (its tree through
  ``params_from_jax``) exactly; the port's logits match ``transformers``
  (atol 2e-3, rtol 1e-3, the reference test's tolerance) and the JAX
  forward within 1e-4.
* A sliding-window mistral: the port's training forward and gradients
  against the JAX package's (1e-4 / 2e-2) and ``transformers``.
* ``save_hf_model``: ``transformers`` reloads the port's export with logits
  within 1e-5; a sharded export (the shard limit made small) writes an
  index file both packages load, split as the JAX package splits; either
  package loads what the other wrote.
* A bf16 directory, as published checkpoints come, loads in the port to
  the JAX package's tree; the ``pytorch_model.bin`` route loads too.
* ``make_model(type_="hf")``: post-load overrides, the float32 master and
  serving trees, a typo refused before any read, and the refusals by name
  (MoE, critics, ``rope_scaling``, training at a head_dim the flash
  kernels do not build on a card).
* The model worker's ``save`` hook writes a directory ``transformers``
  reloads, and an experiment with ``save_freq_steps`` sets up.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jt
from areal_tpu.models.hf import load_hf_model as jload
from areal_tpu.models.hf import registry as jregistry
from areal_tpu.models.hf import save_hf_model as jsave
from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.engine import backend
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.hf import load_hf_model, registry, save_hf_model
from tests.model.test_hf_parity import _tiny_hf_model
from tests.test_torch_train_model import _flat, _jax_leaves_by_layer, port_config

FAMILIES = ("llama", "qwen2", "qwen3", "mistral", "gemma", "gpt2")
HF_ATOL, HF_RTOL = 2e-3, 1e-3
TOL = 1e-4
GRAD_TOL = 2e-2
SAVE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf(family, tmp_path):
    torch.manual_seed(0)
    return _tiny_hf_model(family, tmp_path)


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k


def _jax_tree(path):
    jcfg, jparams = jload(path, dtype="float32")
    cfg = port_config(jcfg)
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg,
                                               "cpu")


def _tokens(vocab, B=2, T=12, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T))


def _dense_args(tokens):
    B, T = tokens.shape
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    return tokens.astype(np.int32), pos, np.ones_like(pos)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_jax_and_transformers(family, tmp_path):
    hf_model, path = _hf(family, tmp_path)
    cfg, params = load_hf_model(path, dtype="float32", device="cpu")
    jcfg, jparams, jcfg_port, jtree = _jax_tree(path)
    assert cfg == jcfg_port
    _assert_same_tree(params, jtree)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for _, t in _flat(params))

    tokens = _tokens(cfg.vocab_size)
    args = _dense_args(tokens)
    with torch.no_grad():
        ours = tt.forward(params, cfg, *map(torch.from_numpy, args)).numpy()
        ref = hf_model(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, ref, atol=HF_ATOL, rtol=HF_RTOL)
    jout = np.asarray(jt.forward(jparams, jcfg, *map(jnp.asarray, args)))
    np.testing.assert_allclose(ours, jout, atol=TOL, rtol=TOL)


def _sliding_mistral(tmp_path):
    import transformers

    torch.manual_seed(0)
    path = str(tmp_path / "mistral_window")
    model = transformers.MistralForCausalLM(transformers.MistralConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=64, sliding_window=4,
        attn_implementation="eager")).eval().float()
    model.save_pretrained(path, safe_serialization=True)
    return model, path


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_sliding_window_forward_and_gradients(remat, tmp_path):
    """Mistral with a window of 4 over T=12: one row of two packed
    segments, one row with padding; the port's masked dense attention
    against the JAX package's, forward and parameter gradients."""
    hf_model, path = _sliding_mistral(tmp_path)
    cfg, params = load_hf_model(path, dtype="float32", device="cpu")
    jcfg, jparams, _, _ = _jax_tree(path)
    assert cfg.sliding_window == jcfg.sliding_window == 4
    cfg = dataclasses.replace(cfg, remat=remat)
    jcfg = dataclasses.replace(jcfg, remat=remat)

    tokens = _tokens(cfg.vocab_size)
    # the whole row against transformers' own window
    with torch.no_grad():
        ours = tt.forward(params, cfg, *map(
            torch.from_numpy, _dense_args(tokens))).numpy()
        ref = hf_model(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, ref, atol=HF_ATOL, rtol=HF_RTOL)

    seg = np.array([[1] * 7 + [2] * 5, [1] * 9 + [0] * 3], np.int32)
    pos = np.array([list(range(7)) + list(range(5)),
                    list(range(9)) + [0] * 3], np.int32)
    args = (tokens.astype(np.int32), pos, seg)
    w = np.random.default_rng(1).standard_normal(
        tokens.shape + (cfg.vocab_size,)).astype(np.float32)
    w *= (seg != 0)[..., None]
    real = seg != 0

    def jloss(p):
        return jnp.sum(jt.forward(p, jcfg, *map(jnp.asarray, args)) * w)

    jout = np.asarray(jt.forward(jparams, jcfg, *map(jnp.asarray, args)))
    jg = dict(_flat(_jax_leaves_by_layer(jax.grad(jloss)(jparams),
                                         cfg.n_layers)))
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_(True)
    out = tt.forward(params, cfg, *map(torch.from_numpy, args))
    np.testing.assert_allclose(out.detach().numpy()[real], jout[real],
                               atol=TOL, rtol=TOL)
    (out * torch.from_numpy(w)).sum().backward()
    assert leaves.keys() == jg.keys()
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[k]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_reloads_in_transformers(family, tmp_path):
    import transformers

    hf_model, path = _hf(family, tmp_path)
    cfg, params = load_hf_model(path, dtype="float32", device="cpu")
    out = str(tmp_path / "exported")
    save_hf_model(out, registry.load_hf_config(path)[0].name, cfg, params)
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    reloaded = transformers.AutoModelForCausalLM.from_pretrained(out).float()
    tokens = torch.arange(10)[None, :] % cfg.vocab_size
    with torch.no_grad():
        a = hf_model(tokens).logits.numpy()
        b = reloaded(tokens).logits.numpy()
    np.testing.assert_allclose(a, b, atol=SAVE_TOL)


@pytest.mark.parametrize(
    "change, what",
    [
        (dict(use_attention_bias=True), "use_attention_bias"),
        (dict(use_qk_norm=True), "use_qk_norm"),
        (dict(activation="gelu"), "activation"),
        ({}, "q/b"),
    ],
    ids=["qkv_bias", "qk_norm", "activation", "leaf"],
)
def test_export_refuses_a_model_the_family_cannot_hold(change, what,
                                                       tmp_path):
    """A model saved as a family whose files would reload it as another
    (a random actor reports 'llama' whatever its architecture) raises
    before anything is written."""
    from areal_tpu_torch.models.config import tiny_config

    cfg = tiny_config(vocab_size=32, **change)
    params = tt.init_params(cfg, 0, "cpu", dtype=torch.float32)
    if not change:  # a leaf the llama export has no name for
        params["layers"][0]["attn"]["q"]["b"] = torch.zeros(cfg.q_dim)
    out = str(tmp_path / "saved")
    with pytest.raises(ValueError, match=f"llama.*{what}"):
        save_hf_model(out, "llama", cfg, params)
    assert not os.path.exists(out)


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
def test_sharded_export_loads_in_both_packages(family, tmp_path, monkeypatch):
    _, path = _hf(family, tmp_path)
    cfg, params = load_hf_model(path, dtype="float32", device="cpu")
    jcfg, jparams = jload(path, dtype="float32")
    limit = 20000
    monkeypatch.setattr(registry, "MAX_SHARD_BYTES", limit)
    monkeypatch.setattr(jregistry, "MAX_SHARD_BYTES", limit)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save_hf_model(ours, family, cfg, params)
    jsave(theirs, family, jcfg, jparams)
    index = "model.safetensors.index.json"
    with open(os.path.join(ours, index)) as f, \
            open(os.path.join(theirs, index)) as g:
        mine, ref = json.load(f), json.load(g)
    assert mine == ref and len(set(mine["weight_map"].values())) > 2
    for d in (ours, theirs):
        assert sorted(os.listdir(d)) == sorted(
            set(ref["weight_map"].values()) | {"config.json", index})
        got = load_hf_model(d, dtype="float32", device="cpu")[1]
        _assert_same_tree(got, params)
        _assert_same_tree(_jax_tree(d)[3], params)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_package_loads_what_the_other_wrote(family, tmp_path):
    _, path = _hf(family, tmp_path)
    cfg, params = load_hf_model(path, dtype="float32", device="cpu")
    jcfg, jparams = jload(path, dtype="float32")
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save_hf_model(ours, family, cfg, params)
    jsave(theirs, family, jcfg, jparams)
    configs = []
    for d in (ours, theirs):
        with open(os.path.join(d, "config.json")) as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]
    _assert_same_tree(_jax_tree(ours)[3], params)
    _assert_same_tree(load_hf_model(theirs, dtype="float32",
                                    device="cpu")[1], params)


def test_bf16_directory_loads_in_both_packages(tmp_path):
    hf_model, _ = _hf("qwen2", tmp_path)
    path = str(tmp_path / "bf16")
    hf_model.to(torch.bfloat16).save_pretrained(path, safe_serialization=True)
    from safetensors import safe_open

    with safe_open(os.path.join(path, "model.safetensors"), "pt") as f:
        assert {f.get_tensor(k).dtype for k in f.keys()} == {torch.bfloat16}
    cfg, params = load_hf_model(path, device="cpu")
    assert cfg.dtype == "bfloat16"
    sd = hf_model.state_dict()
    q = params["layers"][1]["attn"]["q"]
    assert q["w"].dtype == torch.float32
    assert torch.equal(q["w"], sd["model.layers.1.self_attn.q_proj.weight"]
                       .float().T)
    assert torch.equal(q["b"], sd["model.layers.1.self_attn.q_proj.bias"]
                       .float())
    assert torch.equal(params["lm_head"]["w"], sd["lm_head.weight"].float().T)
    # the JAX package reads through safetensors.numpy, whose bfloat16 is
    # the one ml_dtypes registers with numpy when jax is imported
    _assert_same_tree(params, _jax_tree(path)[3])


def test_pytorch_bin_directory_loads(tmp_path):
    hf_model, path = _hf("llama", tmp_path)
    binary = str(tmp_path / "bin")
    hf_model.save_pretrained(binary, safe_serialization=False)
    assert any(f.endswith(".bin") for f in os.listdir(binary))
    _assert_same_tree(load_hf_model(binary, device="cpu")[1],
                      load_hf_model(path, device="cpu")[1])


# -- make_model(type_="hf") ----------------------------------------------


@pytest.fixture
def llama_dir(tmp_path):
    return _hf("llama", tmp_path)[1]


def _config_dir(tmp_path, **hf):
    d = tmp_path / "cfg"
    d.mkdir(exist_ok=True)
    base = dict(architectures=["LlamaForCausalLM"], hidden_size=32,
                intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
    (d / "config.json").write_text(json.dumps(dict(base, **hf)))
    return str(d)


def _no_read(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("checkpoint was read")

    monkeypatch.setattr(registry, "load_hf_model", boom)


def test_make_model_hf_trainer_and_server_trees(llama_dir):
    m = backend.make_model(
        ModelAbstraction("hf", {"path": llama_dir, "dtype": "float32",
                                "remat": True, "norm_eps": 1e-5}),
        None, device="cpu", dtype=torch.float32)
    assert m.backend_name == "llama"
    assert m.model_cfg.remat and m.model_cfg.norm_eps == 1e-5
    assert m.model_cfg.dtype == "float32"
    _assert_same_tree(m.init_params,
                      load_hf_model(llama_dir, dtype="float32",
                                    device="cpu")[1])
    s = backend.make_model(ModelAbstraction("hf", {"path": llama_dir}), None,
                           device="cpu")
    assert s.model_cfg.dtype == "bfloat16"
    layer = s.init_params["layers"][0]
    assert layer["attn"]["q"]["w"].dtype == torch.bfloat16
    assert layer["attn_norm"]["scale"].dtype == torch.float32
    assert torch.equal(layer["attn"]["q"]["w"],
                       m.init_params["layers"][0]["attn"]["q"]["w"]
                       .to(torch.bfloat16))


def test_make_model_hf_typo_raises_before_the_read(llama_dir, monkeypatch):
    _no_read(monkeypatch)
    with pytest.raises(ValueError, match="remat_polcy"):
        backend.make_model(ModelAbstraction(
            "hf", {"path": llama_dir, "remat_polcy": "qkv_attn"}), None,
            device="cpu")
    # a bad override fails in TransformerConfig, also first: an unknown
    # remat policy, and the mixture of experts the port refuses
    with pytest.raises(ValueError, match="remat_policy"):
        backend.make_model(ModelAbstraction(
            "hf", {"path": llama_dir, "remat_policy": "qkv_atn"}), None,
            device="cpu")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        backend.make_model(ModelAbstraction(
            "hf", {"path": llama_dir, "n_experts": 4}), None, device="cpu")


@pytest.mark.parametrize(
    "hf,args,err,what",
    [
        (dict(architectures=["MixtralForCausalLM"], num_local_experts=4),
         {}, NotImplementedError, "item 9"),
        (dict(architectures=["Qwen3MoeForCausalLM"], num_experts=4), {},
         NotImplementedError, "item 9"),
        (dict(rope_scaling={"rope_type": "llama3", "factor": 8.0}), {},
         ValueError, "rope_scaling"),
    ],
    ids=["mixtral", "qwen3_moe", "rope_scaling"],
)
def test_make_model_hf_refusals(hf, args, err, what, tmp_path, monkeypatch):
    path = _config_dir(tmp_path, **hf)
    with pytest.raises(err, match=what):
        backend.make_model(ModelAbstraction("hf", dict(path=path, **args)),
                           None, device="cpu")


def test_training_at_head_dim_256_is_refused_on_a_card(tmp_path,
                                                       monkeypatch):
    """Gemma's head_dim of 256 is trained on a card now (the flash kernels
    build 64, 128 and 256): a trainer's card load gets as far as the read,
    as a server's and the CPU's do."""
    from areal_tpu_torch.ops.flash_attention import HEAD_DIMS

    assert 256 in HEAD_DIMS
    path = _config_dir(tmp_path, architectures=["GemmaForCausalLM"],
                       hidden_size=512, num_attention_heads=2,
                       num_key_value_heads=1, head_dim=256)
    _no_read(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    gemma = ModelAbstraction("hf", {"path": path})
    for device, dtype in (("cuda", torch.float32), ("cuda", None),
                          ("cpu", torch.float32)):
        with pytest.raises(AssertionError, match="read"):
            backend.make_model(gemma, None, device=device, dtype=dtype)


def test_sliding_window_training_is_refused_on_a_card(tmp_path, monkeypatch):
    """The flash kernel takes the window now: a trainer's load of a
    sliding-window model on a card gets as far as the read, as a server's
    load and the CPU's do."""
    path = _config_dir(tmp_path, architectures=["MistralForCausalLM"],
                       sliding_window=4)
    _no_read(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mistral = ModelAbstraction("hf", {"path": path})
    for device, dtype in (("cuda", torch.float32), ("cuda", None),
                          ("cpu", torch.float32)):
        with pytest.raises(AssertionError, match="read"):
            backend.make_model(mistral, None, device=device, dtype=dtype)

# -- the save hook and the experiment --------------------------------------


def test_model_worker_save_hook_writes_an_hf_dir(llama_dir, tmp_path):
    import transformers

    from areal_tpu_torch.api import model_api
    from tests.test_torch_model_worker import MODEL, _worker

    import areal_tpu_torch.engine.backend  # noqa: F401 - registers "train"

    w, shard = _worker("torch", "hf-save")
    shard.model = ModelAbstraction("hf", {"path": llama_dir,
                                          "dtype": "float32"})
    w._handle_initialize(shard, model_api.FinetuneSpec(
        total_train_epochs=1, dataset_size=8, train_batch_size=8))
    out = str(tmp_path / "saved")
    os.makedirs(out)  # an older save at the path is replaced
    w._run_hook({"type": "save", "model_name": MODEL, "path": out})
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["architectures"] == ["LlamaForCausalLM"]
    engine = w._models[MODEL].engine
    _assert_same_tree(load_hf_model(out, dtype="float32", device="cpu")[1],
                      engine.params)
    reloaded = transformers.AutoModelForCausalLM.from_pretrained(out).float()
    original = transformers.AutoModelForCausalLM.from_pretrained(
        llama_dir).float()
    tokens = torch.arange(10)[None, :]
    with torch.no_grad():
        np.testing.assert_allclose(reloaded(tokens).logits.numpy(),
                                   original(tokens).logits.numpy(),
                                   atol=SAVE_TOL)


def test_experiment_with_save_freq_steps_sets_up():
    from areal_tpu_torch.api.system_api import ExperimentSaveEvalControl
    from areal_tpu_torch.experiments.async_ppo_exp import (
        AsyncPPOMathExperiment,
    )
    from areal_tpu_torch.experiments.ppo_math_exp import PPOHyperparameters

    exp = AsyncPPOMathExperiment(
        actor=ModelAbstraction("hf", {"path": "/ckpt/model"}),
        ppo=PPOHyperparameters(disable_value=True, kl_ctl=0.0),
        exp_ctrl=ExperimentSaveEvalControl(save_freq_steps=10))
    cfg = exp.initial_setup()
    assert cfg.master.exp_ctrl.save_freq_steps == 10
    # the tokenizer defaults to the actor's HF path
    assert exp.tokenizer_path == "/ckpt/model"


@pytest.mark.parametrize("cache_mode", ["auto", "paged"])
def test_serving_a_sliding_window_model_is_refused(cache_mode):
    """The paged cache serves global attention: asked for a window, it is
    refused (as the reference refuses it); ``"auto"`` resolves a window to
    the dense cache, which serves it."""
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.models.config import tiny_config

    cfg = tiny_config(vocab_size=32, sliding_window=4)
    make = lambda: ContinuousBatchingEngine(  # noqa: E731
        cfg, tt.init_params(cfg, 0, "cpu"), kv_cache_len=4096,
        cache_mode=cache_mode, page_size=16, chunk_size=4, device="cpu")
    if cache_mode == "paged":
        with pytest.raises(ValueError, match="sliding-window"):
            make()
    else:
        assert not make().paged


def test_hf_entry_points_default_to_cuda(llama_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_hf_model(llama_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.make_model(ModelAbstraction("hf", {"path": llama_dir}), None)
