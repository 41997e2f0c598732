"""The torch port's position-keyed sampler against the JAX package's.

JAX's and torch's random streams differ, so greedy decoding is held to
exact tokens, and sampled tokens to JAX's distribution (a frequency check)
and to the property the engine relies on: a request's draw at a position
does not depend on chunk size or pipeline depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine.sampling import SamplingParams as JaxSampling
from areal_tpu.engine.sampling import sample_logits_keyed as jax_keyed
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
)
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import (
    SamplingParams,
    _filtered_logits,
    keyed_gumbel,
    sample_logits_keyed,
)
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.transformer import init_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logits(B, V, seed):
    return np.random.default_rng(seed).normal(0, 2, (B, V)).astype(np.float32)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_greedy_is_exact(temperature):
    logits = _logits(16, 100, 0)
    rows = np.arange(16, dtype=np.int32)
    pos = np.arange(16, dtype=np.int32) + 5
    tj, lj = jax_keyed(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(rows),
        jnp.asarray(pos), JaxSampling(greedy=True, temperature=temperature),
    )
    tt, lt = sample_logits_keyed(
        torch.from_numpy(logits), 0, torch.from_numpy(rows),
        torch.from_numpy(pos),
        SamplingParams(greedy=True, temperature=temperature),
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize(
    "params",
    [SamplingParams(top_k=5), SamplingParams(top_p=0.8, temperature=0.7)],
)
def test_filters_match_jax(params):
    from areal_tpu.engine.sampling import _filtered_logits as jax_filtered

    logits = _logits(8, 50, 1)
    want = np.asarray(jax_filtered(
        jnp.asarray(logits), JaxSampling(**vars(params))
    ))
    got = _filtered_logits(torch.from_numpy(logits), params).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_sampled_frequencies_match_jax():
    """N draws of one distribution, at N different positions, from each
    sampler: both empirical frequencies sit within 5 standard errors
    (5 * sqrt(p(1-p)/N), about 0.011 at p=0.5, N=5000) of the filtered
    softmax, and of each other within twice that."""
    V, N = 12, 5000
    params = dict(temperature=0.8, top_p=0.9, top_k=8)
    base = _logits(1, V, 2)
    logits = np.repeat(base, N, axis=0)
    rows = np.full((N,), 1234, np.int32)
    pos = np.arange(N, dtype=np.int32)
    tj, _ = jax_keyed(
        jnp.asarray(logits), jax.random.PRNGKey(3), jnp.asarray(rows),
        jnp.asarray(pos), JaxSampling(**params),
    )
    tt, _ = sample_logits_keyed(
        torch.from_numpy(logits), 3, torch.from_numpy(rows),
        torch.from_numpy(pos), SamplingParams(**params),
    )
    filt = _filtered_logits(
        torch.from_numpy(base) / params["temperature"], SamplingParams(**params)
    )
    p = torch.softmax(filt, dim=-1)[0].numpy()
    fj = np.bincount(np.asarray(tj), minlength=V) / N
    ft = np.bincount(tt.numpy(), minlength=V) / N
    se = np.sqrt(p * (1 - p) / N)
    assert (np.abs(ft - p) <= 5 * se + 1e-12).all(), (ft, p)
    assert (np.abs(fj - p) <= 5 * se + 1e-12).all(), (fj, p)
    assert (np.abs(ft - fj) <= 10 * se + 1e-12).all(), (ft, fj)
    # filtered-out tokens are never drawn
    assert (ft[p == 0] == 0).all()


def test_gumbel_is_keyed():
    rows = torch.tensor([1, 1, 2], dtype=torch.int32)
    pos = torch.tensor([10, 10, 10], dtype=torch.int32)
    g = keyed_gumbel(7, rows, pos, 1000)
    assert torch.equal(g[0], g[1])  # same (seed, request, position)
    assert not torch.equal(g[0], g[2])  # another request
    assert not torch.equal(g[0], keyed_gumbel(8, rows, pos, 1000)[0])
    assert not torch.equal(g[0], keyed_gumbel(7, rows, pos + 1, 1000)[0])
    u = torch.exp(-torch.exp(-g))  # back to the uniforms
    assert 0.45 < float(u.mean()) < 0.55 and float(u.min()) > 0


def test_sampled_streams_invariant_to_chunk_size_and_depth():
    cfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    params = init_params(cfg, 0, torch.device("cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).tolist() for n in (5, 21, 34)]
    streams = []
    for chunk, depth in ((4, 1), (3, 2), (5, 3)):
        eng = ContinuousBatchingEngine(
            cfg, params, max_batch=2, kv_cache_len=128, chunk_size=chunk,
            pipeline_depth=depth, cache_mode="paged", page_size=16,
            prefill_chunk_tokens=16, sampling=SamplingParams(temperature=1.0),
            device="cpu", seed=11,
        )
        for i, p in enumerate(prompts):
            eng.submit(APIGenerateInput(
                qid=f"s{i}", prompt_ids=p, input_ids=p,
                gconfig=GenerationHyperparameters(max_new_tokens=14),
            ))
        while eng.has_work:
            eng.step()
        res = eng.drain_results()
        streams.append([res[f"s{i}"].output_ids for i in range(3)])
        assert eng.close() == {}
    assert streams[0] == streams[1] == streams[2]
    assert all(len(s) == 14 for s in streams[0])
