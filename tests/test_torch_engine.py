"""The torch port's paged ``ContinuousBatchingEngine`` against the JAX
package's, on the same converted weights and the same requests: exact
greedy tokens, logprobs within 1e-4 (fp32), the same ``no_eos`` and
version stamps, zero leaked pool blocks at ``close()``, outputs that
follow ``update_weights``, and identical streams at pipeline depths 1
and 2."""

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
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
)
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 42  # a token some of these greedy streams reach
TOL = 1e-4
ENGINE = dict(
    max_batch=4, kv_cache_len=128, chunk_size=4, stop_tokens=(EOS,),
    cache_mode="paged", page_size=16, prefill_chunk_tokens=16,
)
# prompts crossing page (16) and prefill-chunk (16) boundaries, more
# requests than rows, staggered budgets so rows finish mid-ring, a
# one-token prompt, a one-token budget, and a prompt too long to serve
PROMPT_LENS = (3, 20, 33, 47, 16, 9, 1, 127)
BUDGETS = (17, 9, 23, 5, 12, 30, 1, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    trees = [
        jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
        for s in (0, 1)
    ]
    return jcfg, port_config(jcfg), trees


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(6, vocab, n).tolist() for n in PROMPT_LENS]


def _run(eng, make_input, prompts, tag, max_steps=600):
    for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(make_input(f"{tag}{i}", p, b))
    for _ in range(max_steps):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise AssertionError("engine did not drain")
    res = eng.drain_results()
    return [res[f"{tag}{i}"] for i in range(len(prompts))]


def _jax_input(qid, p, b):
    return JaxInput(qid=qid, prompt_ids=p, input_ids=p,
                    gconfig=JaxGen(max_new_tokens=b, greedy=True))


def _port_input(qid, p, b):
    return APIGenerateInput(qid=qid, prompt_ids=p, input_ids=p,
                            gconfig=GenerationHyperparameters(max_new_tokens=b))


def _jax_engine(jcfg, tree, **kw):
    return JaxEngine(
        jcfg, jax.tree.map(jnp.asarray, tree),
        sampling=JaxSampling(greedy=True), prefix_cache=False,
        **dict(ENGINE, **kw),
    )


def _port_engine(cfg, tree, **kw):
    return ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"),
        sampling=SamplingParams(greedy=True), device="cpu",
        **dict(ENGINE, **kw),
    )


def _assert_same(port, ref):
    assert [o.output_ids for o in port] == [o.output_ids for o in ref]
    assert [o.no_eos for o in port] == [o.no_eos for o in ref]
    assert [(o.version_start, o.version_end) for o in port] == [
        (o.version_start, o.version_end) for o in ref
    ]
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def reference(model):
    """The JAX engine's outputs: a first wave, then a second wave after
    ``update_weights`` to the second tree."""
    jcfg, _, trees = model
    prompts = _prompts(jcfg.vocab_size)
    eng = _jax_engine(jcfg, trees[0])
    first = _run(eng, _jax_input, prompts, "a")
    eng.update_weights(jax.tree.map(jnp.asarray, trees[1]))
    second = _run(eng, _jax_input, prompts, "b")
    return prompts, first, second


def test_engine_matches_jax_and_follows_weights(model, reference):
    _, cfg, trees = model
    prompts, first, second = reference
    # the requests exercise both ways to stop
    assert any(not o.no_eos for o in first) and any(o.no_eos for o in first)
    eng = _port_engine(cfg, trees[0])
    got = _run(eng, _port_input, prompts, "a")
    _assert_same(got, first)
    eng.update_weights(params_from_jax(trees[1], cfg, "cpu"))
    got2 = _run(eng, _port_input, prompts, "b")
    _assert_same(got2, second)
    assert [o.output_ids for o in got2] != [o.output_ids for o in got]
    assert eng.close() == {}
    assert eng.free_pool_blocks == eng.n_blocks


def test_update_weights_mid_flight(model):
    """A swap while rows are decoding: in-flight rows recompute their KV
    under the new weights and continue, as in the JAX engine."""
    jcfg, cfg, trees = model
    prompts = _prompts(jcfg.vocab_size, seed=1)
    outs = []
    for make, eng, new in (
        (_jax_input, _jax_engine(jcfg, trees[0]),
         jax.tree.map(jnp.asarray, trees[1])),
        (_port_input, _port_engine(cfg, trees[0]),
         params_from_jax(trees[1], cfg, "cpu")),
    ):
        for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(make(f"m{i}", p, b))
        for _ in range(6):
            eng.step()
        eng.update_weights(new, version=7)
        for _ in range(600):
            if not eng.has_work:
                break
            eng.step()
        res = eng.drain_results()
        outs.append([res[f"m{i}"] for i in range(len(prompts))])
    _assert_same(outs[1], outs[0])
    # some requests straddle the swap: sampled under both versions
    assert any(o.version_start == 0 and o.version_end == 7 for o in outs[1])


def test_pipeline_depths_agree(model, reference):
    _, cfg, trees = model
    prompts, first, _ = reference
    for depth in (1, 3):
        eng = _port_engine(cfg, trees[0], pipeline_depth=depth)
        got = _run(eng, _port_input, prompts, "a")
        _assert_same(got, first)
        assert eng.close() == {}
