"""The engine's HBM-ledger seams against the JAX engine's: after the same
tiny workload both engines attribute the same ``weights``, ``kv_pool``
and ``kv_scales`` bytes (bf16-free float32 model; paged fp and int8
pools, and the dense cache), the same ``prefix_spill_host`` bytes after
the same spill, and the same ``staged_weights`` bytes through a staged
swap; ``close()`` reports a tree left staged and releases the handles,
and an engine collected without ``close()`` gives its attributions
back."""

import gc

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
from areal_tpu.observability.hbm_ledger import HbmLedger as JaxLedger
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
)
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.observability.hbm_ledger import HbmLedger, tree_nbytes
from tests.test_torch_model import port_config

ENGINE = dict(max_batch=3, kv_cache_len=64, chunk_size=4, page_size=16,
              prefill_chunk_tokens=16)
PROMPTS = ([7, 8, 9, 10, 11], list(range(6, 30)), [3, 4])
RESIDENT = ("weights", "kv_pool", "kv_scales")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=512)
    trees = [jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
             for s in (0, 7)]
    return jcfg, port_config(jcfg), trees


def _pair(model, **kw):
    jcfg, cfg, trees = model
    opts = dict(ENGINE, **kw)
    port = ContinuousBatchingEngine(
        cfg, params_from_jax(trees[0], cfg, "cpu"), device="cpu",
        sampling=SamplingParams(greedy=True), hbm_ledger=HbmLedger(), **opts)
    ref = JaxEngine(jcfg, jax.tree.map(jnp.asarray, trees[0]),
                    sampling=JaxSampling(greedy=True),
                    hbm_ledger=JaxLedger(), **opts)
    return port, ref


def _serve(eng, pkg, prompts=PROMPTS, max_new=6, tag="q"):
    inp, gen = ((APIGenerateInput, GenerationHyperparameters)
                if pkg == "port" else (JaxInput, JaxGen))
    for i, p in enumerate(prompts):
        eng.submit(inp(qid=f"{tag}{i}", prompt_ids=list(p), input_ids=list(p),
                       gconfig=gen(max_new_tokens=max_new, greedy=True)))
    for _ in range(500):
        if not eng.has_work:
            break
        eng.step()
    return eng.drain_results()


@pytest.mark.parametrize("kw", [
    dict(cache_mode="paged"),
    dict(cache_mode="paged", kv_cache_dtype="int8"),
    dict(cache_mode="dense"),
], ids=["paged", "int8_pool", "dense"])
def test_resident_attributions_equal_the_jax_engines(model, kw):
    port, ref = _pair(model, **kw)
    before = port.hbm_ledger.snapshot()
    _serve(port, "port")
    _serve(ref, "jax")
    got, want = port.hbm_ledger.snapshot(), ref.hbm_ledger.snapshot()
    assert got == before  # a workload moves no resident attribution
    assert {k: got[k] for k in RESIDENT} == {k: want[k] for k in RESIDENT}
    assert got["weights"] == tree_nbytes(port.params) > 0
    if port.paged:
        assert got["kv_pool"] == port.kv_pool_bytes
        assert got["kv_scales"] == port.kv_scale_bytes
        assert (got["kv_scales"] > 0) == (kw.get("kv_cache_dtype") == "int8")
    else:
        assert got["kv_pool"] == tree_nbytes(
            [port.cache.k, port.cache.v, port.cache.lengths])


def test_prefix_spill_host_equals_after_the_same_spill(model):
    from tests.test_torch_prefix_spill import PRESSURE, _replay

    port, ref = _pair(model, cache_mode="paged", **PRESSURE)
    for e in (port, ref):
        e.park_ttl_steps = 0
    _replay(port, "port")
    _replay(ref, "jax")
    got = port.hbm_ledger.snapshot()["prefix_spill_host"]
    assert port.prefix_cache_stats()["spilled_blocks_total"] > 0
    assert got == ref.hbm_ledger.snapshot()["prefix_spill_host"]
    assert got == port.prefix_cache_stats()["host_bytes_held"] > 0
    # a held tier is accounted for: no leak
    assert port.close() == {}


def test_staged_weights_through_a_staged_swap(model):
    jcfg, cfg, trees = model
    port, ref = _pair(model, cache_mode="paged")
    new = {"port": params_from_jax(trees[1], cfg, "cpu"),
           "jax": jax.tree.map(jnp.asarray, trees[1])}
    seen = {}
    for pkg, eng in (("port", port), ("jax", ref)):
        led = eng.hbm_ledger
        marks = [led.snapshot()["staged_weights"]]
        eng.stage_weights(new[pkg], version=1)
        marks.append(led.snapshot()["staged_weights"])
        eng.commit_staged(expected_version=1)
        marks.append(led.snapshot()["staged_weights"])
        _serve(eng, pkg, prompts=PROMPTS[:1], max_new=3)
        marks.append(led.snapshot()["staged_weights"])
        eng.stage_weights(new[pkg], version=2)
        eng.discard_staged()
        marks.append(led.snapshot()["staged_weights"])
        seen[pkg] = (marks, led.snapshot()["weights"], led.watermarks())
    assert seen["port"] == seen["jax"]
    marks = seen["port"][0]
    assert marks == [0, marks[1], marks[1], 0, 0] and marks[1] > 0
    assert port.version == 1


def test_close_reports_a_staged_tree_and_releases_the_handles(model):
    jcfg, cfg, trees = model
    port, _ = _pair(model, cache_mode="paged")
    port.stage_weights(params_from_jax(trees[1], cfg, "cpu"), version=1)
    n = port.hbm_ledger.snapshot()["staged_weights"]
    assert n > 0
    assert port.close() == {"staged_weights": n}
    assert set(port.hbm_ledger.snapshot().values()) == {0}
    assert port.close() == {}  # idempotent


def test_a_collected_engine_gives_its_attributions_back(model):
    jcfg, cfg, trees = model
    led = HbmLedger()
    eng = ContinuousBatchingEngine(
        cfg, params_from_jax(trees[0], cfg, "cpu"), device="cpu",
        hbm_ledger=led, **dict(ENGINE, cache_mode="paged"))
    assert led.snapshot()["kv_pool"] == eng.kv_pool_bytes > 0
    del eng
    gc.collect()
    assert set(led.snapshot().values()) == {0}
    assert led.watermarks()["kv_pool"] > 0
    np.testing.assert_equal(led.leaks(), {})
