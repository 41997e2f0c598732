"""The port's ``PPOActorInterface`` against the JAX package's: actor_inf
(``inference``: the proximal logprobs) then actor_train (``train_step``),
twice, with the async-PPO recipe's flags (``training/configs/
async_ppo.yaml``: no critic, ``kl_ctl=0``, decoupled loss,
``behav_imp_weight_cap=5``, 4 minibatches, remat, sequence packing), on
a hand-built rollout and the same float32 init.  A small token budget per
micro-batch makes minibatches accumulate over several micro-batches.

``prox_logp``, the advantages, the returned statistics and every
parameter after two steps agree to 1e-4 (float32 on both sides).  The lr
is 1e-3 with no warm-up (the recipe's 1e-6 would not move a float32
tiny model measurably in two steps).

The last test measures, on a bf16 tiny model, how far the serving
engine's logprobs of its own greedy output lie from the trainer's
recompute of them, in the JAX package and in the port alike, and holds
the port's gap to no more than the JAX package's own.
"""

import dataclasses

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
from areal_tpu.interfaces import ppo_interface as jppo
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.interfaces import ppo_interface as tppo
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config

TOL = 1e-4

#: the recipe's actor flags (async_ppo.yaml), as both interfaces take them
RECIPE = dict(
    n_minibatches=4, kl_ctl=0.0, disable_value=True, use_decoupled_loss=True,
    behav_imp_weight_cap=5.0, eps_clip=0.2, discount=1.0, gae_lambda=1.0,
    adv_norm=True,
)
OPT = dict(lr=1e-3, weight_decay=0.05, lr_scheduler_type="constant",
           warmup_steps_proportion=0.0, gradient_clipping=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rollout(vocab, seed=0, n=8):
    """Prompt + response sequences with behaviour logprobs, rewards and
    truncation flags, as the rollout side hands them to the trainer."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(3, 12, n)
    rlen = rng.integers(2, 15, n)
    lens = (plen + rlen).tolist()
    tokens = rng.integers(0, vocab, sum(lens)).astype(np.int32)
    prompt = np.concatenate(
        [np.r_[np.ones(p, bool), np.zeros(r, bool)] for p, r in zip(plen, rlen)]
    )
    behav = np.concatenate(
        [np.r_[np.zeros(p - 1), -rng.uniform(0.5, 6.0, r)] for p, r in zip(plen, rlen)]
    ).astype(np.float32)
    data = dict(
        packed_input_ids=tokens,
        prompt_mask=prompt,
        packed_logprobs=behav,
        rewards=rng.standard_normal(n).astype(np.float32),
        seq_no_eos_mask=(rng.random(n) < 0.3).astype(np.float32),
    )
    ids = [f"q{i}" for i in range(n)]
    return (
        JSample.from_default(lens, ids, {k: v.copy() for k, v in data.items()}),
        SequenceSample.from_default(lens, ids, data),
    )


def _models():
    jcfg = jtiny(vocab_size=64, remat=True)
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(1)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**OPT), 10)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT), 10, device="cpu")
    return (
        jmodel_api.Model("actor", je, None, mesh),
        model_api.Model("actor", te),
        cfg,
    )


def test_inference_then_train_step_matches_reference():
    jm, tm, cfg = _models()
    ji, ti = jppo.PPOActorInterface(**RECIPE), tppo.PPOActorInterface(**RECIPE)
    js, ts = rollout(cfg.vocab_size)
    jspec, tspec = JSpec(max_tokens_per_mb=24), MicroBatchSpec(max_tokens_per_mb=24)
    for step in range(2):
        jprox = ji.inference(jm, js, jspec)
        tprox = ti.inference(tm, ts, tspec)
        np.testing.assert_allclose(
            tprox.data["prox_logp"], jprox.data["prox_logp"], rtol=TOL, atol=TOL
        )
        js.update_(jprox)
        ts.update_(tprox)
        jst = ji.train_step(jm, js, jspec)
        tst = ti.train_step(tm, ts, tspec)
        for k in ("advantages", "returns", "ppo_loss_mask"):
            np.testing.assert_allclose(ts.data[k], js.data[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        assert tst["n_mbs"] == jst["n_mbs"] > RECIPE["n_minibatches"]
        for k in ("loss", "grad_norm", "actor_clip_frac", "approx_kl",
                  "entropy", "adv_sum", "n_tokens", "kl", "reward_mean"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
        assert tm.version.global_step == jm.version.global_step == step + 1
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params), cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_out_of_slice_paths_are_refused():
    # every remat policy of the reference is carried; MoE stays refused
    assert port_config(jtiny(remat=True, remat_policy="dots")).remat_policy == "dots"
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        port_config(jtiny(n_experts=4))


# ---------------------------------------------------------------------------
# serving vs training logprobs of the same tokens, bf16
# ---------------------------------------------------------------------------


def _gap(engine_outputs, logp_of):
    """(mean, max) |serving logprob - training recompute| over every
    generated token."""
    diffs = []
    for o in engine_outputs:
        seq = list(o.prompt_ids) + list(o.output_ids)
        lp = logp_of(seq)[len(o.prompt_ids) - 1:]
        diffs.append(np.abs(np.asarray(o.output_logprobs) - lp))
    d = np.concatenate(diffs)
    return float(d.mean()), float(d.max())


def test_serving_vs_training_logprob_gap_bf16():
    """Greedy output of a bf16 tiny model served by the paged engine, its
    logprobs recomputed by the trainer's ``model_logprobs_fwd`` at the
    same weights: in the JAX package and in the port, the gap (bf16
    activations rounded at other places by the two forwards) is no
    larger in the port than in the JAX package, in mean and in max."""
    from areal_tpu.api.model_api import APIGenerateInput as JIn
    from areal_tpu.api.model_api import GenerationHyperparameters as JGen
    from areal_tpu.engine.inference_server import ContinuousBatchingEngine as JCB
    from areal_tpu.engine.sampling import SamplingParams as JSampling
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
    from areal_tpu_torch.engine.sampling import SamplingParams

    jcfg = dataclasses.replace(
        jtiny(vocab_size=512, n_layers=4, hidden_dim=64, n_q_heads=4,
              n_kv_heads=2, head_dim=16, intermediate_dim=128,
              max_position_embeddings=256, use_attention_bias=True),
        dtype="bfloat16",
    )
    cfg = port_config(jcfg)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 40, 23)]
    new = 24
    kw = dict(max_batch=4, kv_cache_len=128, cache_mode="paged", page_size=16,
              prefill_chunk_tokens=16, chunk_size=4)

    def serve(eng, inputs):
        for x in inputs:
            eng.submit(x)
        for _ in range(1000):
            if not eng.has_work:
                break
            eng.step()
        res = eng.drain_results()
        return [res[x.qid] for x in inputs]

    # the JAX package: its engine, then its trainer-side recompute
    jparams = jax.tree.map(jnp.asarray, tree)
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               prefix_cache=False, **kw)
    jouts = serve(jeng, [
        JIn(qid=f"j{i}", prompt_ids=p, input_ids=p,
            gconfig=JGen(max_new_tokens=new, greedy=True))
        for i, p in enumerate(prompts)
    ])
    jfwd = jax.jit(lambda p, b: jppo.model_logprobs_fwd()(p, jcfg, b))

    def jlogp(seq):
        T = len(seq)
        b = dict(tokens=jnp.asarray([seq], jnp.int32),
                 positions=jnp.arange(T, dtype=jnp.int32)[None],
                 seg_ids=jnp.ones((1, T), jnp.int32))
        return np.asarray(jfwd(jparams, b))[0, : T - 1]

    jgap = _gap(jouts, jlogp)

    # the port: its engine on bf16 serving weights, its trainer on the
    # float32 master weights (cast to bf16 at use)
    teng = ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
        sampling=SamplingParams(greedy=True), prefix_cache=False, **kw,
    )
    touts = serve(teng, [
        APIGenerateInput(
            qid=f"t{i}", prompt_ids=p, input_ids=p,
            gconfig=GenerationHyperparameters(max_new_tokens=new, greedy=True))
        for i, p in enumerate(prompts)
    ])
    master = params_from_jax(tree, cfg, "cpu")
    fwd = tppo.model_logprobs_fwd()

    def tlogp(seq):
        T = len(seq)
        b = dict(tokens=torch.tensor([seq], dtype=torch.int32),
                 positions=torch.arange(T, dtype=torch.int32)[None],
                 seg_ids=torch.ones((1, T), dtype=torch.int32))
        with torch.no_grad():
            return fwd(master, cfg, b)[0, : T - 1].numpy()

    tgap = _gap(touts, tlogp)
    print(f"serving-vs-training logprob gap (mean, max): JAX {jgap}, port {tgap}")
    assert tgap[0] <= jgap[0] and tgap[1] <= jgap[1]
