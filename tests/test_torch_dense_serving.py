"""The port's dense-cache serving against the JAX package's, on the CPU:
``models/transformer.py decode_chunk`` on the same cache (global
attention, the sliding-window mask over a short cache, and the
window-gather path over a long one), the windowed prompt attention a
card's prefill uses against the masked product, the dense engine's
greedy tokens against the JAX dense engine's (a global model and a
sliding-window one, through a weight swap), and a dense server's
``metrics()`` with ``preempted_total`` (the JAX dense engine has no such
attribute, which its server's metrics read)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import APIGenerateInput as JaxInput
from areal_tpu.api.model_api import GenerationHyperparameters as JaxGen
from areal_tpu.engine.inference_server import (
    ContinuousBatchingEngine as JaxEngine,
)
from areal_tpu.engine.sampling import SamplingParams as JaxSampling
from areal_tpu.engine.sampling import sample_logits_keyed as jsample
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
)
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.engine.sampling import sample_logits_keyed as tsample
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 42
TOL = 1e-4
ENGINE = dict(max_batch=4, kv_cache_len=128, chunk_size=4, stop_tokens=(EOS,),
              cache_mode="dense")
PROMPT_LENS = (3, 20, 33, 47, 16, 9, 1, 127)
BUDGETS = (17, 9, 23, 5, 12, 30, 1, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(window=None, seeds=(0,)):
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=512,
                       sliding_window=window)
    trees = [jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
             for s in seeds]
    return jcfg, port_config(jcfg), trees


# -- decode_chunk --------------------------------------------------------------


@pytest.mark.parametrize("case", ["global", "window_mask", "window_gather"])
def test_decode_chunk_matches_jax(case):
    """One chunk over a cache holding rows of different lengths (one
    inactive, one with a one-token budget, one that stops at EOS): tokens,
    logprobs, emitted, state and the cache after the window's merge,
    against the JAX function.  ``window_mask``: a window of 48 over a
    cache of 64 (the masked read, whose lower bound moves every step);
    ``window_gather``: a window of 24 over a cache of 256 (each row's
    last 128 slots gathered once per chunk)."""
    window, S = {"global": (None, 64), "window_mask": (48, 64),
                 "window_gather": (24, 256)}[case]
    jcfg, cfg, (tree,) = _model(window)
    params = params_from_jax(tree, cfg, "cpu")
    B, W = 4, 8
    rng = np.random.default_rng(0)
    lens = np.array([S - 20, 5, 37, S // 2], np.int32)
    k = (rng.standard_normal((cfg.n_layers, B, cfg.n_kv_heads, S,
                              cfg.head_dim)) * 0.5).astype(np.float32)
    v = (rng.standard_normal(k.shape) * 0.5).astype(np.float32)
    cur = rng.integers(0, 64, B).astype(np.int32)
    active = np.array([True, True, False, True])
    budgets = np.array([W, 1, 5, W], np.int32)
    seeds = np.arange(B, dtype=np.int32)
    jcache = jt.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                        lengths=jnp.asarray(lens))
    jsamp = JaxSampling(greedy=True)
    base = jax.random.PRNGKey(0)

    def jfn(logits, _sub, positions, rs):
        return jsample(logits, base, rs, positions, jsamp)

    jout = jt.decode_chunk(
        jax.tree.map(jnp.asarray, tree), jcfg, jcache, jnp.asarray(cur),
        jnp.asarray(active), jnp.asarray(budgets), base, W, jfn,
        lambda t: t == EOS, attn_len=S, row_seeds=jnp.asarray(seeds))
    tcache = tt.KVCache(k=torch.from_numpy(k.copy()),
                        v=torch.from_numpy(v.copy()),
                        lengths=torch.from_numpy(lens))
    tsamp = SamplingParams(greedy=True)
    tout = tt.decode_chunk(
        params, cfg, tcache, torch.from_numpy(cur), torch.from_numpy(active),
        torch.from_numpy(budgets), W,
        lambda lg, pos, rs: tsample(lg, 0, rs, pos, tsamp),
        lambda t: t == EOS, attn_len=S, row_seeds=torch.from_numpy(seeds))
    tc, *trest = tout
    jc, *jrest = jout[:7]
    for t, j in zip(trest, jrest):
        t, j = t.numpy(), np.asarray(j)
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)
    assert trest[2].any() and not trest[2][2].any()


def test_chunk_wider_than_the_window_is_refused():
    _, cfg, (tree,) = _model(window=4)
    cache = tt.KVCache.zeros(cfg, 1, 32, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk_size <= sliding_window"):
        tt.decode_chunk(params_from_jax(tree, cfg, "cpu"), cfg, cache,
                        one, one.bool(), one, 8, None, None)


def test_windowed_prompt_attention_is_the_masked_product():
    """A card's sliding-window prefill of an empty cache (the flash
    kernel's wrapper over the prompt with the window; its plain version
    here) equals the reference's masked attention over the cache at every
    real query."""
    from areal_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(2)
    B, T, Hq, Hkv, hd, window = 2, 37, 4, 2, 8, 10
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, T, hd)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(T).expand(B, T)
    seg = (pos < torch.tensor([37, 20])[:, None]).to(torch.int32)
    kv_pos = torch.arange(T)[None, None]
    mask = ((kv_pos <= pos[:, :, None]) & (seg != 0)[:, :, None]
            & (pos[:, :, None] - kv_pos < window))
    want = tt.cache_attention(q, k, v, mask)
    got = flash_attention(q, k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), seg, window=window)
    real = seg.bool()
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the dense engine ----------------------------------------------------------


def _wave(eng, make, prompts, tag):
    for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(make(f"{tag}{i}", p, b))
    for _ in range(800):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise AssertionError("engine did not drain")
    res = eng.drain_results()
    return [res[f"{tag}{i}"] for i in range(len(prompts))]


def _tin(qid, p, b):
    return APIGenerateInput(qid=qid, prompt_ids=p, input_ids=p,
                            gconfig=GenerationHyperparameters(max_new_tokens=b))


def _jin(qid, p, b):
    return JaxInput(qid=qid, prompt_ids=p, input_ids=p,
                    gconfig=JaxGen(max_new_tokens=b, greedy=True))


def _same(port, ref):
    assert [o.output_ids for o in port] == [o.output_ids for o in ref]
    assert [o.no_eos for o in port] == [o.no_eos for o in ref]
    assert [(o.version_start, o.version_end) for o in port] == [
        (o.version_start, o.version_end) for o in ref]
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 24], ids=["global", "window"])
def test_dense_engine_matches_jax_dense_engine(window):
    """Two waves of requests (more than the rows, staggered budgets, a
    one-token prompt and budget, a prompt too long to serve, and for the
    window model prompts past the window), a weight swap between them and
    a third wave mid-swap: the tokens, logprobs, stops and versions of the
    JAX dense engine, and the same prefill and decode work."""
    jcfg, cfg, trees = _model(window, seeds=(0, 1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(6, 64, n).tolist() for n in PROMPT_LENS]
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, trees[0]),
                     sampling=JaxSampling(greedy=True), **ENGINE)
    teng = ContinuousBatchingEngine(
        cfg, params_from_jax(trees[0], cfg, "cpu"), device="cpu",
        sampling=SamplingParams(greedy=True), **ENGINE)
    assert not teng.paged and not jeng.paged
    _same(_wave(teng, _tin, prompts, "a"), _wave(jeng, _jin, prompts, "a"))
    teng.update_weights(params_from_jax(trees[1], cfg, "cpu"))
    jeng.update_weights(jax.tree.map(jnp.asarray, trees[1]))
    _same(_wave(teng, _tin, prompts, "b"), _wave(jeng, _jin, prompts, "b"))
    # a swap while rows decode: they recompute and continue
    outs = []
    for eng, make, tree in ((teng, _tin, params_from_jax(trees[0], cfg,
                                                         "cpu")),
                            (jeng, _jin, jax.tree.map(jnp.asarray,
                                                      trees[0]))):
        for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(make(f"c{i}", p, b))
        for _ in range(3):
            eng.step()
        eng.update_weights(tree, version=5)
        for _ in range(800):
            if not eng.has_work:
                break
            eng.step()
        res = eng.drain_results()
        outs.append([res[f"c{i}"] for i in range(len(prompts))])
    _same(*outs)
    assert teng.prefill_tokens_total == jeng.prefill_tokens_total
    assert teng.prefill_calls == jeng.prefill_calls
    assert teng.close() == {}


def test_dense_metrics_read_preempted_total():
    """A dense server's ``metrics()`` answers with ``preempted_total`` (0:
    the dense cache never preempts).  The JAX dense engine sets that
    counter only on the paged path, so its server's metrics raise
    there."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
    )

    jcfg, _, (tree,) = _model()
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                     sampling=JaxSampling(greedy=True), **ENGINE)
    assert not hasattr(jeng, "preempted_total")
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names("dense", "t0")
    worker = GenerationServerWorker()
    worker.configure(GenServerConfig(
        worker_name="dense_server", device="cpu", greedy=True,
        model=ModelAbstraction("random", {"vocab_size": 64,
                                          "max_position_embeddings": 256}),
        max_concurrent_batch=2, kv_cache_len=128, chunk_size=4))
    try:
        eng = worker.engine
        assert not eng.paged
        eng.submit(_tin("m0", [7, 8, 9], 6))
        while eng.has_work:
            eng.step()
        m = worker.metrics()
        assert m["cache_mode"] == "dense" and m["preempted_total"] == 0
        assert m["gen_tokens_total"] == 6 and m["decode_chunks_total"] > 0
        assert m["kv_quant_storage_bits"] == 32
    finally:
        worker._exit_hook()
