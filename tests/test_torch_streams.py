"""Token streams in the port's engine against the JAX package's (mirrors
``tests/engine/test_gateway_stream.py`` on the paged, dense and
speculative engines): every folded token is pushed once, in fold order,
so the drained concatenation equals ``output_ids``, and both packages
stream the same greedy tokens; the bounded buffer drops the same tokens
and counts them; the stale-stream backstop names a stream at the same
engine step; a cancel releases a streamed request in every state; a row
preempted and re-prefilled pushes nothing twice; the ledger's
``stream_buffers`` tag holds the undrained tokens' bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import APIGenerateInput as JaxInput
from areal_tpu.api.model_api import GenerationHyperparameters as JaxGen
from areal_tpu.engine import spec_decode as jspec
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
from areal_tpu_torch.engine import spec_decode as tspec
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.observability.hbm_ledger import HbmLedger
from tests.test_torch_model import port_config

ENGINE = dict(max_batch=2, kv_cache_len=128, chunk_size=4, page_size=16,
              prefill_chunk_tokens=16)
MODES = {
    "paged": dict(cache_mode="paged"),
    "dense": dict(cache_mode="dense"),
    "spec": dict(cache_mode="paged", spec=True),
}
MOTIF = [7, 8, 9, 10]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=512)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, port_config(jcfg), tree


def make(model, pkg, mode, **kw):
    """One package's greedy engine in ``mode``, without the prefix cache
    or parking, on its own ledger."""
    jcfg, cfg, tree = model
    opts = dict(ENGINE, **MODES[mode])
    opts.update(kw)
    spec = opts.pop("spec", False)
    if pkg == "port":
        eng = ContinuousBatchingEngine(
            cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
            sampling=SamplingParams(greedy=True), prefix_cache=False,
            spec_decode_params=(tspec.SpecDecodeParams(enabled=True)
                                if spec else None),
            hbm_ledger=HbmLedger(), **opts)
    else:
        eng = JaxEngine(
            jcfg, jax.tree.map(jnp.asarray, tree),
            sampling=JaxSampling(greedy=True), prefix_cache=False,
            spec_decode_params=(jspec.SpecDecodeParams(enabled=True)
                                if spec else None),
            hbm_ledger=JaxLedger(), **opts)
    eng.park_ttl_steps = 0
    return eng


def req(pkg, qid, prompt, max_new, **metadata):
    inp, gen = ((APIGenerateInput, GenerationHyperparameters)
                if pkg == "port" else (JaxInput, JaxGen))
    return inp(qid=qid, prompt_ids=list(prompt), input_ids=list(prompt),
               gconfig=gen(max_new_tokens=max_new, greedy=True),
               metadata=metadata or None)


def run_until_done(eng, drain_into=None, qid=None, max_steps=2000):
    for _ in range(max_steps):
        if not eng.has_work:
            return
        eng.step()
        if drain_into is not None:
            drain_into.extend(eng.drain_stream(qid) or [])
    raise AssertionError("engine did not drain")


def assert_pool_pristine(eng):
    eng.step()
    eng.step()  # parked rows released (TTL 0)
    if getattr(eng, "_prefix_cache", None) is not None:
        eng._prefix_cache.flush()
    if eng.paged:
        assert eng.free_pool_blocks == eng.n_blocks
        assert (np.asarray(eng._block_ref) == 0).all()


def _stream_once(model, pkg, mode):
    eng = make(model, pkg, mode)
    prompt = MOTIF * 4 if mode == "spec" else [7, 8, 9]
    eng.submit(req(pkg, "s1", prompt, 24, stream=True))
    eng.submit(req(pkg, "plain", [3, 4, 5], 8))  # no stream opened
    assert eng.stream_stats()["opened_total"] == 1
    acc = []
    run_until_done(eng, drain_into=acc, qid="s1")
    acc.extend(eng.drain_stream("s1") or [])
    out = eng.drain_results()
    # interleaved drains reassemble the exact output, no drop, no repeat
    assert acc == list(out["s1"].output_ids)
    assert eng.drain_stream("plain") is None
    eng.stream_close("s1")
    assert eng.drain_stream("s1") is None
    stats = eng.stream_stats()
    assert stats["open_streams"] == 0
    return acc, stats, eng


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_delivers_every_token_exactly_once(model, mode):
    got, stats, eng = _stream_once(model, "port", mode)
    ref, ref_stats, _ = _stream_once(model, "jax", mode)
    assert got == ref and stats == ref_stats
    if mode == "spec":
        # a verify window pushes only the tokens it accepted
        assert eng.spec_stats()["accepted_total"] > 0
    assert eng.close() == {}
    assert eng.hbm_ledger.snapshot()["stream_buffers"] == 0


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_stream_buffer_is_bounded_with_drop_accounting(model, mode):
    seen = {}
    for pkg in ("port", "jax"):
        eng = make(model, pkg, mode)
        eng.stream_buffer_cap = 4  # read at submit
        eng.submit(req(pkg, "s1", [7, 8, 9], 16, stream=True))
        run_until_done(eng)  # nobody drains: the buffer overflows
        held = eng.hbm_ledger.snapshot()["stream_buffers"]
        tail = eng.drain_stream("s1")  # before drain_results prunes it
        out = eng.drain_results()["s1"]
        assert tail == list(out.output_ids)[-4:]
        st = eng.stream_stats()
        assert st["dropped_tokens_total"] == len(out.output_ids) - 4
        seen[pkg] = (tail, st, held)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2] == 4 * 4  # four int32 ids undrained


def test_stale_stream_backstop_names_a_stream_at_the_same_step(model):
    seen = {}
    for pkg in ("port", "jax"):
        eng = make(model, pkg, "paged")
        eng.stream_stale_steps = 2
        eng.submit(req(pkg, "ghost", [7, 8, 9], 64, stream=True))
        stale = []
        for _ in range(5):
            eng.step()
            stale.append(eng.stale_stream_qids())
        assert eng.cancel("ghost") is True
        assert eng.stale_stream_qids() == []
        # a drained stream never goes stale
        eng.submit(req(pkg, "live", [3, 4, 5], 32, stream=True))
        for _ in range(5):
            eng.step()
            eng.drain_stream("live")
            assert eng.stale_stream_qids() == []
        assert eng.cancel("live") is True
        assert_pool_pristine(eng)
        seen[pkg] = stale
    assert seen["port"] == seen["jax"]
    assert seen["port"][-1] == ["ghost"] and seen["port"][0] == []


def test_cancel_releases_a_stream_in_every_lifecycle_state(model):
    eng = make(model, "port", "paged", max_batch=4)
    eng.submit(req("port", "pend", [11, 12, 13], 8, stream=True))
    assert eng.cancel("pend") is True  # pending
    eng.submit(req("port", "mid", [7, 8, 9], 64, stream=True))
    eng.step()
    eng.step()
    assert eng.cancel("mid") is True  # decoding
    eng.submit(req("port", "done", [3, 4, 5], 4, stream=True))
    run_until_done(eng)
    assert eng.cancel("done") is True  # finished, not collected
    assert eng.try_get_result("done") is None
    assert eng.cancel("never-existed") is False
    assert eng.cancelled_total == 3
    assert eng.stream_stats()["open_streams"] == 0
    assert_pool_pristine(eng)
    assert eng.close() == {}


def test_undrained_stream_is_a_leak_at_close(model):
    eng = make(model, "port", "paged")
    eng.submit(req("port", "s1", [7, 8, 9], 6, stream=True))
    run_until_done(eng)
    assert eng.close() == {"stream_buffers": 4 * 6}
    assert eng.hbm_ledger.snapshot()["stream_buffers"] == 0  # released


def test_a_preempted_row_pushes_each_token_once(model):
    """Pool pressure preempts the bulk row; its re-prefill pushes nothing,
    and each stream still reads its output once, equal to the JAX
    engine's."""
    seen = {}
    for pkg in ("port", "jax"):
        eng = make(model, pkg, "paged", kv_cache_len=96, kv_pool_tokens=96)
        eng.submit(req(pkg, "bulk", list(range(6, 30)), 48, stream=True,
                       workload="rollout", priority_class="bulk"))
        eng.step()
        eng.submit(req(pkg, "int", [7, 8, 9, 10, 11, 12], 48, stream=True,
                       workload="chat", priority_class="interactive"))
        acc = {"bulk": [], "int": []}
        for _ in range(2000):
            if not eng.has_work:
                break
            eng.step()
            for q in acc:
                acc[q].extend(eng.drain_stream(q) or [])
        out = eng.drain_results()
        for q in acc:
            assert acc[q] == list(out[q].output_ids), (pkg, q)
        assert eng.preempted_by_class.get("bulk", 0) >= 1
        seen[pkg] = acc
    assert seen["port"] == seen["jax"]
