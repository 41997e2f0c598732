"""The port's ``TrainEngine`` against the JAX package's, from the same
float32 init on a one-device mesh: three ``train_batch`` steps of an SFT
loss with one micro-batch and with several (the grad-accumulation
equivalence of ``tests/engine/test_train_engine.py``), and
``forward_batch`` outputs in the original sequence order.

Loss, grad norm and every parameter after the steps agree to 1e-4
relative (float32 on both sides; the sums run in another order), and the
one- and several-micro-batch runs of the port agree with each other to
the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base.topology import MeshSpec
from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.train_engine import TrainEngine as JEngine
from areal_tpu.interfaces.sft_interface import sft_loss_fn as jsft_loss
from areal_tpu.interfaces.ppo_interface import model_logprobs_fwd as jlogp_fwd
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine, tree_leaves
from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.ops.loss import masked_cross_entropy
from tests.test_torch_train_model import port_config

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def sft_loss(params, cfg, batch):
    """The port's counterpart of the JAX package's ``sft_loss_fn``:
    next-token NLL over transitions inside a segment whose target is not
    a prompt token."""
    hidden = tt.hidden_states(
        params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
    )
    B, T, D = hidden.shape
    w = tt.head_weight(params, cfg).to(hidden.dtype)
    seg = batch["seg_ids"]
    valid = (seg[:, 1:] != 0) & (seg[:, :-1] == seg[:, 1:])
    valid &= ~batch["prompt_mask"][:, 1:].bool()
    loss_sum, count = masked_cross_entropy(
        hidden[:, :-1].reshape(-1, D), w, batch["tokens"][:, 1:].reshape(-1),
        valid.reshape(-1),
    )
    return loss_sum, count, {"nll_sum": loss_sum, "n_valid_tokens": count}


def make_samples(bs, vocab, seed):
    rng = np.random.RandomState(seed)
    seqlens = rng.randint(4, 24, size=bs).tolist()
    tokens = rng.randint(1, vocab, size=sum(seqlens)).astype(np.int32)
    prompt = np.zeros(sum(seqlens), dtype=bool)
    off = 0
    for L in seqlens:
        prompt[off : off + max(1, L // 3)] = True
        off += L
    ids = [f"s{i}" for i in range(bs)]
    data = {"packed_input_ids": tokens, "prompt_mask": prompt}
    return (
        JSample.from_default(seqlens, ids, {k: v.copy() for k, v in data.items()}),
        SequenceSample.from_default(seqlens, ids, data),
    )


OPT = dict(lr=1e-2, weight_decay=0.05, lr_scheduler_type="constant",
           warmup_steps_proportion=0.0, gradient_clipping=1.0)


def _engines(pack=True, remat=False):
    jcfg = jtiny(vocab_size=64, remat=remat)
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**OPT),
                 100, pack_sequences=pack)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT), 100, pack_sequences=pack,
                     device="cpu")
    return je, te, cfg


def _port_layout(jparams, n_layers):
    out = {k: v for k, v in jparams.items() if k != "layers"}
    out["layers"] = [
        jax.tree.map(lambda a: np.asarray(a)[l], jparams["layers"])
        for l in range(n_layers)
    ]
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-8)


SPECS = {
    "one_mb": dict(n_mbs=1),
    "three_mbs": dict(n_mbs=3),
    "token_budget": dict(max_tokens_per_mb=60),
}


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "padded"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_train_batch_matches_reference(spec, pack):
    je, te, cfg = _engines(pack=pack)
    js, ts = make_samples(10, 64, seed=1)
    for _ in range(3):
        jst = je.train_batch(js, jsft_loss, JSpec(**SPECS[spec]))
        tst = te.train_batch(ts, sft_loss, MicroBatchSpec(**SPECS[spec]))
        assert tst["n_mbs"] == jst["n_mbs"]
        for k in ("loss", "grad_norm", "n_tokens", "nll_sum", "n_valid_tokens"):
            assert _rel(tst[k], jst[k]) < TOL, (k, tst[k], jst[k])
    jp = dict(_flat(_port_layout(jax.device_get(je.params), cfg.n_layers)))
    tp = dict(_flat(te.params))
    assert jp.keys() == tp.keys()
    for k in tp:
        np.testing.assert_allclose(
            tp[k].detach().numpy(), jp[k], rtol=TOL, atol=TOL, err_msg=k
        )


def test_micro_batch_accumulation_equivalence():
    """One micro-batch and four give the same update (the port alone)."""
    _, one, _ = _engines()
    _, four, _ = _engines()
    _, ts = make_samples(8, 64, seed=2)
    a = one.train_batch(ts, sft_loss, MicroBatchSpec(n_mbs=1))
    b = four.train_batch(ts, sft_loss, MicroBatchSpec(n_mbs=4))
    assert b["n_mbs"] == 4 and a["n_mbs"] == 1
    assert _rel(a["loss"], b["loss"]) < TOL
    for p, q in zip(tree_leaves(one.params), tree_leaves(four.params)):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=TOL, atol=2e-5)


def test_forward_batch_in_original_order():
    je, te, _ = _engines()
    js, ts = make_samples(9, 64, seed=3)
    jout = je.forward_batch(js, jlogp_fwd(), JSpec(n_mbs=3), output_shift=1)
    tout = te.forward_batch(ts, model_logprobs_fwd(), MicroBatchSpec(n_mbs=3),
                            output_shift=1)
    assert te.last_forward_mbs == 3
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)


def test_host_params_round_trip():
    """get_host_params gives the port's layout as numpy; set_params copies
    a tree back into the engine's float32 leaves in place."""
    _, te, cfg = _engines()
    host = te.get_host_params()
    assert len(host["layers"]) == cfg.n_layers
    assert host["layers"][0]["attn"]["q"]["w"].dtype == np.float32
    leaf = te.params["embed"]["weight"]
    te.set_params(tt_scaled(host, 2.0))
    assert te.params["embed"]["weight"] is leaf  # same tensor, new values
    np.testing.assert_array_equal(leaf.detach().numpy(),
                                  2.0 * host["embed"]["weight"])


def tt_scaled(tree, c):
    if isinstance(tree, dict):
        return {k: tt_scaled(v, c) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tt_scaled(v, c) for v in tree]
    return tree * c


def test_refuses_bf16_master_weights_and_meshes():
    cfg = port_config(jtiny(vocab_size=64))
    params = tt.init_params(cfg, 0, "cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        TrainEngine(cfg, None, params, device="cpu")
    with pytest.raises(NotImplementedError):
        TrainEngine(cfg, object(), tt.init_params(cfg, 0, "cpu"), device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree


def test_swapped_in_weights_do_not_follow_training():
    """``update_weights`` copies the trainer's weights when it is called: a
    train step before or after the swap applies (AdamW updates the float32
    master weights in place) leaves the served version as it was."""
    from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
    from areal_tpu_torch.engine.sampling import SamplingParams

    _, te, cfg = _engines()
    eng = ContinuousBatchingEngine(
        cfg, tt.init_params(cfg, 1, "cpu"), sampling=SamplingParams(greedy=True),
        device="cpu", max_batch=2, kv_cache_len=64, cache_mode="paged",
        page_size=16, prefill_chunk_tokens=16, chunk_size=4,
    )
    version1 = [t.detach().clone() for t in tree_leaves(te.params)]
    _, ts = make_samples(6, 64, seed=4)
    eng.update_weights(te.params, version=1)
    te.train_batch(ts, sft_loss, MicroBatchSpec(n_mbs=1))
    eng.step()  # the swap applies here
    te.train_batch(ts, sft_loss, MicroBatchSpec(n_mbs=1))
    assert eng.version == 1
    trained = tree_leaves(te.params)
    assert all(not torch.equal(a, b) for a, b in zip(trained, version1))
    for served, want in zip(tree_leaves(eng.params), version1):
        assert torch.equal(served, want)
