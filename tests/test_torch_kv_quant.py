"""The torch port's int8 KV pool against the JAX package's: ``quantize_kv``
bit for bit, the pool layouts and their byte counts, the paged forwards
over an int8 pool, and a greedy wave of the engine with
``kv_cache_dtype="int8"`` against the JAX engine with the same setting on
the same converted weights (identical tokens, logprobs within 1e-4 in
float32), with the storage counters and zero leaked blocks at close."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from areal_tpu.models import paged as jpaged
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_engine import (
    _assert_same,
    _jax_engine,
    _jax_input,
    _port_engine,
    _port_input,
    _prompts,
    _release_idle,
    _run,
)
from tests.test_torch_model import port_config

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _quant_inputs():
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal((6, 3, 16)) * 3.0).astype(np.float32)
    vals[0, 0] = 0.0  # an all-zero vector
    vals[1, 2] = 1e-38  # a scale below the 1e-30 floor of the divisor
    # exact ties at half a step: absmax 127 gives scale 1, so these sit on
    # .5 and round half to even
    vals[2, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                  -126.5, 0.0, 4.5, 5.5, -3.5, 6.5, 7.5]
    vals[3] = rng.standard_normal((3, 16)).astype(np.float32) * 1e-3
    return vals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    vals = _quant_inputs()
    jq, js = jpaged.quantize_kv(jnp.asarray(vals).astype(dtype))
    tq, ts = tpaged.quantize_kv(torch.from_numpy(vals).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the zero vector: zero values and a zero scale on both sides
    assert (tq[0, 0] == 0).all() and ts[0, 0] == 0
    # ties round half to even
    assert tq[2, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_alloc_kv_pool_and_layout_bytes(kv_cache_dtype):
    jcfg = tiny_config()
    cfg = port_config(jcfg)
    jk, jv, jks, jvs = jpaged.alloc_kv_pool(jcfg, 6, 16, kv_cache_dtype)
    tk, tv, tks, tvs = tpaged.alloc_kv_pool(cfg, 6, 16, "cpu", kv_cache_dtype)
    for t, j in ((tk, jk), (tv, jv), (tks, jks), (tvs, jvs)):
        if j is None:
            assert t is None
            continue
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert (t == 0).all()
    for dtype in (None, "bfloat16"):
        want = jpaged.kv_pool_layout_bytes(
            jcfg, 6, 16, kv_cache_dtype, dtype=dtype and jnp.bfloat16
        )
        got = tpaged.kv_pool_layout_bytes(
            cfg, 6, 16, kv_cache_dtype, dtype=dtype and torch.bfloat16
        )
        assert got == want
    nbytes = sum(t.numel() * t.element_size() for t in (tk, tv))
    sbytes = sum(t.numel() * t.element_size() for t in (tks, tvs)
                 if t is not None)
    assert (nbytes, sbytes) == tpaged.kv_pool_layout_bytes(
        cfg, 6, 16, kv_cache_dtype)
    with pytest.raises(ValueError):
        tpaged.alloc_kv_pool(cfg, 6, 16, "cpu", "fp8")


def test_int8_forwards_match_jax():
    """One fill chunk then one decode chunk over an int8 pool: logits,
    tokens, logprobs, and the int8 pools and scales after each, against
    the JAX functions on the same pools (its jnp reference attention)."""
    jcfg = __graft_entry__._flagship_tiny()
    cfg = port_config(jcfg)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_jax(tree, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    BS, MB, NB = 8, 6, 16
    jpool = list(jpaged.alloc_kv_pool(jcfg, NB, BS, "int8"))
    tpool = list(tpaged.alloc_kv_pool(cfg, NB, BS, "cpu", "int8"))
    tables = np.stack([np.arange(0, MB), np.arange(MB, 2 * MB)]).astype(np.int32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    starts, lens = np.zeros(2, np.int32), np.array([12, 7], np.int32)
    jl, *jpool = jpaged.paged_fill_chunk(
        jparams, jpool[0], jpool[1], jcfg, jnp.asarray(toks),
        jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(tables),
        use_kernel=False, k_scale=jpool[2], v_scale=jpool[3],
    )
    tl = tpaged.paged_fill_chunk(
        params, tpool[0], tpool[1], cfg, torch.from_numpy(toks),
        torch.from_numpy(starts), torch.from_numpy(lens),
        torch.from_numpy(tables), tpool[2], tpool[3],
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)

    def same_pools():
        for t, j in zip(tpool, jpool):
            a, b = t.numpy(), np.asarray(j)
            if a.dtype == np.int8:
                # values sitting on a rounding edge may flip by one step
                assert (np.abs(a.astype(int) - b.astype(int)) <= 1).all()
                assert (a != b).mean() < 1e-3
            else:
                np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-7)

    same_pools()

    from areal_tpu.engine.sampling import SamplingParams as JaxSampling
    from areal_tpu.engine.sampling import sample_logits_keyed as jax_sample
    from areal_tpu_torch.engine.sampling import (
        SamplingParams,
        sample_logits_keyed,
    )

    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    args = (tables, lens, cur, np.ones(2, bool), np.array([5, 9], np.int32))
    seeds = np.array([3, 4], np.int32)
    jout = jpaged.paged_decode_chunk(
        jparams, jpool[0], jpool[1], jcfg, *(jnp.asarray(a) for a in args),
        jax.random.PRNGKey(1), 4,
        lambda lg, _r, pos, sd: jax_sample(
            lg, jax.random.PRNGKey(0), sd, pos, JaxSampling(greedy=True)),
        lambda t: t < 0, use_kernel=False, max_len=MB * BS,
        row_seeds=jnp.asarray(seeds), k_scale=jpool[2], v_scale=jpool[3],
    )
    jpool = [jout[0], jout[1], jout[10], jout[11]]
    tout = tpaged.paged_decode_chunk(
        params, tpool[0], tpool[1], cfg, *(torch.from_numpy(a.copy()) for a in args),
        4,
        lambda lg, pos, sd: sample_logits_keyed(
            lg, 0, sd, pos, SamplingParams(greedy=True)),
        lambda t: t < 0, MB * BS, torch.from_numpy(seeds),
        deep_kernel=True, k_scale=tpool[2], v_scale=tpool[3],
    )
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[4]),
                               rtol=TOL, atol=TOL)
    same_pools()


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, port_config(jcfg), tree


def test_int8_engine_wave_matches_jax(model):
    jcfg, cfg, tree = model
    prompts = _prompts(jcfg.vocab_size, seed=2)
    ref = _run(_jax_engine(jcfg, tree, kv_cache_dtype="int8"), _jax_input,
               prompts, "q")
    eng = _port_engine(cfg, tree, kv_cache_dtype="int8")
    assert eng.k_pool.dtype == torch.int8
    assert eng.k_scale.shape == eng.k_pool.shape[:-1]
    assert (eng.kv_pool_bytes, eng.kv_scale_bytes) == (
        tpaged.kv_pool_layout_bytes(cfg, eng.n_blocks, eng.page_size, "int8"))
    # mid-wave: the int8 pool holds blocks
    for i, (p, b) in enumerate(zip(prompts, (30,) * len(prompts))):
        eng.submit(_port_input(f"h{i}", p, b))
    for _ in range(3):
        eng.step()
    st = eng.kv_quant_stats()
    assert st["quantized"] == 1 and st["storage_bits"] == 8
    assert st["quantized_blocks_held"] == eng.n_blocks - eng.free_pool_blocks > 0
    while eng.has_work:
        eng.step()
    eng.drain_results()
    got = _run(eng, _port_input, prompts, "q")
    _assert_same(got, ref)
    # the int8 wave against the fp wave, folded into the quality counters
    fp = _run(_port_engine(cfg, tree), _port_input, prompts, "q")
    checked = sum(len(o.output_ids) for o in got)
    diverged = sum(a.output_ids != b.output_ids for a, b in zip(got, fp))
    eng.note_kv_divergence_check(checked, diverged)
    st = eng.kv_quant_stats()
    assert st["divergence_checks_total"] == checked
    assert st["divergence_diverged_total"] == diverged
    # the parked rows hold quantized blocks until they are released
    assert st["quantized_blocks_held"] == eng.n_blocks - eng.free_pool_blocks
    assert eng.close() == {}
    _release_idle(eng)
    assert eng.kv_quant_stats()["quantized_blocks_held"] == 0
    assert eng.close() == {}
    assert eng.free_pool_blocks == eng.n_blocks


def test_fp_engine_reports_unquantized(model):
    _, cfg, tree = model
    eng = _port_engine(cfg, tree)
    st = eng.kv_quant_stats()
    assert st["quantized"] == 0 and st["storage_bits"] == 32
    assert st["quantized_blocks_held"] == 0
    assert eng.k_scale is None and eng.kv_scale_bytes == 0
