"""The port's self-speculative decoding against the JAX package's
(``areal_tpu/engine/spec_decode.py``), on the CPU: the n-gram drafter and
its bookkeeping step for step, ``paged_verify_chunk`` on the same pools,
spec-on greedy streams equal to spec-off and to the JAX engine's, the
accept/reject bookkeeping under drafts the test sets (as the reference's
tests set them) equal to the JAX engine's, no block leaked by rejected
drafts, no rejected draft served through the prefix cache, and every
verify window's kernel calls marked for the launch count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import APIGenerateInput as JaxInput
from areal_tpu.api.model_api import GenerationHyperparameters as JaxGen
from areal_tpu.api.system_api import SpecDecodeConfig as JaxSpecConfig
from areal_tpu.engine import batching as jbatching
from areal_tpu.engine import dispatch as jdispatch
from areal_tpu.engine import spec_decode as jspec
from areal_tpu.engine.inference_server import (
    ContinuousBatchingEngine as JaxEngine,
)
from areal_tpu.engine.sampling import SamplingParams as JaxSampling
from areal_tpu.models import paged as jpaged
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.api.model_api import (
    APIGenerateInput,
    GenerationHyperparameters,
)
from areal_tpu_torch.api.system_api import SpecDecodeConfig
from areal_tpu_torch.engine import batching, dispatch
from areal_tpu_torch.engine import spec_decode as tspec
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 5
VOCAB = 64
TOL = 1e-4
MOTIF = [7, 8, 9, 10]
# repetitive motifs (the drafter engages) and irregular prompts
PROMPTS = [MOTIF * 5, [10, 11, 12, 13, 14], [3, 2] * 6, [21, 22, 23, 24]]
BUDGETS = [25, 9, 23, 12]
ENGINE = dict(max_batch=4, kv_cache_len=128, chunk_size=8, stop_tokens=(EOS,),
              cache_mode="paged", page_size=16, prefill_chunk_tokens=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=VOCAB, max_position_embeddings=256)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, port_config(jcfg), tree


def _port_engine(cfg, tree, spec=None, **kw):
    return ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"),
        sampling=SamplingParams(greedy=True), device="cpu",
        spec_decode_params=spec, **dict(ENGINE, **kw),
    )


def _jax_engine(jcfg, tree, spec=None, **kw):
    return JaxEngine(
        jcfg, jax.tree.map(jnp.asarray, tree),
        sampling=JaxSampling(greedy=True), spec_decode_params=spec,
        **dict(ENGINE, **kw),
    )


def _wave(eng, make, prompts=PROMPTS, budgets=BUDGETS, tag="q"):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(make(f"{tag}{i}", list(p), b))
    for _ in range(600):
        if not eng.has_work:
            break
        eng.step()
    assert not eng.has_work, "engine did not drain"
    res = eng.drain_results()
    return [res[f"{tag}{i}"] for i in range(len(prompts))]


def _port_input(qid, p, b):
    return APIGenerateInput(qid=qid, prompt_ids=p, input_ids=p,
                            gconfig=GenerationHyperparameters(max_new_tokens=b))


def _jax_input(qid, p, b):
    return JaxInput(qid=qid, prompt_ids=p, input_ids=p,
                    gconfig=JaxGen(max_new_tokens=b, greedy=True))


def _same(port, ref):
    assert [o.output_ids for o in port] == [o.output_ids for o in ref]
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)


def _params(mod, **kw):
    return mod.SpecDecodeParams(enabled=True, **kw)


# -- the drafter and the settings ---------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_draft_tokens=3, ngram_max=2, ngram_min=1),
    dict(max_draft_tokens=15, ngram_max=4, ngram_min=2, warmup_verifies=1,
         min_accept_rate=0.5),
], ids=["default", "short", "long"])
def test_drafter_matches_reference_step_for_step(kw):
    """Histories that grow as a decoding row's does (periodic stretches,
    noise, a motif coming back): every draft, and the EMA, fallback and
    cool-down after each outcome, equal the JAX ``SpecRowState``'s."""
    rng = np.random.default_rng(0)
    history = list(rng.integers(0, 20, 6))
    jst, tst = jspec.SpecRowState(), tspec.SpecRowState()
    jp, tp = _params(jspec, **kw), _params(tspec, **kw)
    for step in range(120):
        want = jst.draft(list(history), jp)
        got = tst.draft(list(history), tp)
        assert got == want, step
        assert tst.wants_draft(step) == jst.wants_draft(step)
        productive = bool(want) and step % 3 != 0
        jst.note_draft_result(productive, step)
        tst.note_draft_result(productive, step)
        if want:
            acc = int(rng.integers(0, len(want) + 1))
            assert tst.observe(acc, len(want), tp) == jst.observe(
                acc, len(want), jp)
        assert (tst.ema, tst.verifies, tst.fallback, tst.miss_streak,
                tst.cooldown_until) == (jst.ema, jst.verifies, jst.fallback,
                                        jst.miss_streak, jst.cooldown_until)
        # the row's next tokens: a repeating cycle, noise, or a motif again
        phase = (step // 15) % 3
        if phase == 0:
            history.append(history[-4])
        elif phase == 1:
            history.append(int(rng.integers(0, 20)))
        else:
            history.extend(MOTIF[: 1 + step % 3])


def test_settings_and_constants_match_reference():
    assert dispatch.DEFAULT_SPEC_MIN_ACCEPT_RATE == (
        jdispatch.DEFAULT_SPEC_MIN_ACCEPT_RATE)
    assert dispatch.DEFAULT_SPEC_VERIFY_COST == jdispatch.DEFAULT_SPEC_VERIFY_COST
    for n in range(1, 65):
        assert batching.spec_window_bucket(n) == jbatching.spec_window_bucket(n)
    assert tspec.resolve_spec_params(None) is None
    assert tspec.resolve_spec_params(SpecDecodeConfig()) is None
    for block in (dict(enabled=True),
                  dict(enabled=True, max_draft_tokens=3, min_accept_rate=0.4,
                       verify_cost_over_decode_step=1.25)):
        got = tspec.resolve_spec_params(SpecDecodeConfig(**block))
        want = jspec.resolve_spec_params(JaxSpecConfig(**block))
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}


# -- the verify pass ------------------------------------------------------------


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_paged_verify_chunk_matches_jax(model, kv_cache_dtype):
    """Rows of different cached lengths, one not participating, one
    inactive, drafts of different lengths (a row near ``max_len``): the
    outputs, the state advance and the pools after, against the JAX
    function on the same pools."""
    jcfg, cfg, tree = model
    params = params_from_jax(tree, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    BS, MB, NB, B = 8, 6, 32, 4
    max_len = MB * BS
    jpool = list(jpaged.alloc_kv_pool(jcfg, NB, BS, kv_cache_dtype))
    tpool = list(tpaged.alloc_kv_pool(cfg, NB, BS, "cpu", kv_cache_dtype))
    tables = np.arange(B * MB, dtype=np.int32).reshape(B, MB) % NB
    rng = np.random.default_rng(3)
    lens = np.array([11, 3, 20, max_len - 3], np.int32)
    toks = rng.integers(0, VOCAB, (B, int(lens.max()))).astype(np.int32)
    jl, *jpool = jpaged.paged_fill_chunk(
        jparams, jpool[0], jpool[1], jcfg, jnp.asarray(toks),
        jnp.zeros(B, jnp.int32), jnp.asarray(lens), jnp.asarray(tables),
        use_kernel=False, k_scale=jpool[2], v_scale=jpool[3])
    tpaged.paged_fill_chunk(
        params, tpool[0], tpool[1], cfg, torch.from_numpy(toks),
        torch.zeros(B, dtype=torch.int32), torch.from_numpy(lens),
        torch.from_numpy(tables), tpool[2], tpool[3])
    if kv_cache_dtype == "auto":
        jpool = jpool[:2] + [None, None]
    max_draft = 7
    drafts = rng.integers(0, VOCAB, (B, max_draft)).astype(np.int32)
    dlens = np.array([7, 2, 0, 5], np.int32)
    parts = np.array([True, False, True, True])
    active = np.array([True, True, False, True])
    budgets = np.array([9, 4, 6, 30], np.int32)
    cur = rng.integers(0, VOCAB, B).astype(np.int32)
    jout = jspec.paged_verify_chunk(
        jparams, jpool[0], jpool[1], jcfg, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(cur), jnp.asarray(drafts),
        jnp.asarray(dlens), jnp.asarray(parts), jnp.asarray(active),
        jnp.asarray(budgets), max_draft=max_draft, stop_tokens=(EOS,),
        sampling=JaxSampling(greedy=True), use_kernel=False, max_len=max_len,
        k_scale=jpool[2], v_scale=jpool[3])
    eos = torch.tensor(EOS)
    tout = tspec.paged_verify_chunk(
        params, tpool[0], tpool[1], cfg, torch.from_numpy(tables),
        torch.from_numpy(lens), torch.from_numpy(cur),
        torch.from_numpy(drafts), torch.from_numpy(dlens),
        torch.from_numpy(parts), torch.from_numpy(active),
        torch.from_numpy(budgets), max_draft=max_draft,
        stop_fn=lambda t: t == eos, sampling=SamplingParams(greedy=True),
        max_len=max_len, k_scale=tpool[2], v_scale=tpool[3])
    # port: (lengths, out_t, out_l, emitted, cur, active, budgets);
    # JAX: (k_pool, v_pool, lengths, out_t, out_l, emitted, cur, active,
    # budgets[, k_scale, v_scale])
    for t, j in zip(tout, jout[2:9]):
        t, j = t.numpy(), np.asarray(j)
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(t, j)
    jpools = [jout[0], jout[1]] + list(jout[9:11])
    for t, j in zip(tpool, jpools):
        if t is None:
            continue
        a, b = t.numpy(), np.asarray(j)
        if a.dtype == np.int8:
            assert (np.abs(a.astype(int) - b.astype(int)) <= 1).all()
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_verify_windows_mark_their_kernel_calls(model, monkeypatch):
    """Every verify window calls the paged kernel's wrapper once per layer
    with ``verify=True`` (what its ``verify_launches`` counts on a card),
    and nothing else does: the launch gate of the card's phase."""
    jcfg, cfg, tree = model
    calls = []
    real = tpaged.paged_flash_attention

    def recording(*a, verify=False, **k):
        calls.append(verify)
        return real(*a, **k)

    monkeypatch.setattr(tpaged, "paged_flash_attention", recording)
    eng = _port_engine(cfg, tree, spec=_params(tspec))
    _wave(eng, _port_input)
    n = eng.spec_verify_chunks_total
    assert n > 0
    assert sum(calls) == cfg.n_layers * n
    # and fill chunks and decode steps make the rest, unmarked
    want = cfg.n_layers * (eng.prefill_calls
                           + eng.chunk_size * eng.decode_chunks_total)
    assert len(calls) - sum(calls) == want


# -- the engine -----------------------------------------------------------------


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_spec_on_tokens_equal_spec_off_and_jax(model, prefix_cache):
    """Spec-on greedy streams equal spec-off's and the JAX spec-on
    engine's (logprobs within 1e-4), with drafts really verified and
    accepted, and the same verify and acceptance counts as the JAX
    engine's."""
    jcfg, cfg, tree = model
    spec = dict(max_draft_tokens=7)
    on = _port_engine(cfg, tree, spec=_params(tspec, **spec),
                      prefix_cache=prefix_cache)
    got = _wave(on, _port_input)
    off = _wave(_port_engine(cfg, tree, prefix_cache=prefix_cache),
                _port_input)
    jeng = _jax_engine(jcfg, tree, spec=_params(jspec, **spec),
                       prefix_cache=prefix_cache)
    ref = _wave(jeng, _jax_input)
    assert on.spec_verify_chunks_total > 0 and on.spec_accepted_total > 0
    _same(got, off)
    _same(got, ref)
    assert on.spec_stats() == jeng.spec_stats()
    assert on.close() == {}


def test_spec_is_disabled_on_dense_and_sampled_engines(model):
    jcfg, cfg, tree = model
    dense = _port_engine(cfg, tree, spec=_params(tspec), cache_mode="dense")
    assert dense._spec is None
    _same(_wave(dense, _port_input), _wave(_port_engine(cfg, tree),
                                           _port_input))
    assert dense.spec_verify_chunks_total == 0
    sampled = ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"), device="cpu",
        spec_decode_params=_params(tspec), **ENGINE)
    assert sampled._spec is None


def _forced(refs, mutate):
    """A ``SpecRowState.draft`` that proposes ``mutate``-d slices of the
    known greedy streams (matched by prompt), as the reference's tests
    do."""

    def draft(self, history, params):
        for prompt, ref in refs.items():
            if tuple(history[: len(prompt)]) == prompt:
                pos = len(history) - len(prompt)
                return mutate(list(ref[pos : pos + params.max_draft_tokens]))
        return []

    return draft


def _bookkeeping(model, monkeypatch, mutate, prompts, budgets):
    """One wave on both packages' engines under the same forced drafts:
    outputs equal to plain greedy, the same spec counters; returns the
    port's engine."""
    jcfg, cfg, tree = model
    plain = _wave(_port_engine(cfg, tree), _port_input, prompts, budgets)
    refs = {tuple(p): o.output_ids for p, o in zip(prompts, plain)}
    monkeypatch.setattr(tspec.SpecRowState, "draft", _forced(refs, mutate))
    monkeypatch.setattr(jspec.SpecRowState, "draft", _forced(refs, mutate))
    eng = _port_engine(cfg, tree, spec=_params(tspec))
    got = _wave(eng, _port_input, prompts, budgets)
    jeng = _jax_engine(jcfg, tree, spec=_params(jspec))
    ref = _wave(jeng, _jax_input, prompts, budgets)
    _same(got, plain)
    _same(got, ref)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_verify_chunks_total > 0
    return eng


@pytest.mark.parametrize("case", ["full_accept", "first_token_reject",
                                  "mid_window_reject"])
def test_accept_and_reject_bookkeeping(model, monkeypatch, case):
    if case == "full_accept":
        eng = _bookkeeping(model, monkeypatch, lambda c: c, PROMPTS[:2],
                           BUDGETS[:2])
        # every draft inside the budget is accepted
        assert eng.spec_accepted_total >= 0.7 * eng.spec_drafted_total
        assert eng.spec_fallback_rows_total == 0
    elif case == "first_token_reject":
        eng = _bookkeeping(model, monkeypatch,
                           lambda c: [(t + 1) % VOCAB for t in c],
                           PROMPTS[:2], BUDGETS[:2])
        assert eng.spec_accepted_total == 0 and eng.spec_rejected_total > 0
        assert eng.spec_fallback_rows_total >= 1  # the EMA tripped
    else:
        eng = _bookkeeping(
            model, monkeypatch,
            lambda c: c[:2] + [(t + 1) % VOCAB for t in c[2:]],
            PROMPTS[:1], BUDGETS[:1])
        assert 0 < eng.spec_accepted_total < eng.spec_drafted_total
        # no verify accepts past the forced divergence
        assert eng.spec_accepted_total <= 2 * eng.spec_verify_chunks_total
    samples = eng.drain_spec_accept_samples()
    assert len(samples) == eng.spec_draft_row_passes_total
    assert eng.drain_spec_accept_samples() == []


def test_rejected_drafts_leak_no_block_and_never_reach_the_cache(
        model, monkeypatch):
    """Always-wrong drafts write KV past each row's length.  Turn 2 of the
    conversation reuses the cached prefix and still equals a spec-off
    replay (no rejected draft's KV is served through the prefix cache);
    afterwards, with the rows released and the cache flushed, every block
    is free."""
    jcfg, cfg, tree = model
    p0 = MOTIF * 5
    (plain,) = _wave(_port_engine(cfg, tree), _port_input, [p0], [20])
    monkeypatch.setattr(
        tspec.SpecRowState, "draft",
        _forced({tuple(p0): plain.output_ids},
                lambda c: [(t + 1) % VOCAB for t in c]))
    eng = _port_engine(cfg, tree, spec=_params(tspec), prefix_cache=True)
    (t1,) = _wave(eng, _port_input, [p0], [20], tag="turn1_")
    assert t1.output_ids == plain.output_ids
    assert eng.spec_rejected_total > 0
    conv = p0 + list(t1.output_ids) + [11, 12]
    hits = eng.prefix_cache_stats()["hits_total"]
    (t2,) = _wave(eng, _port_input, [conv], [10], tag="turn2_")
    assert eng.prefix_cache_stats()["hits_total"] > hits
    (want,) = _wave(_port_engine(cfg, tree, prefix_cache=False), _port_input,
                    [conv], [10])
    assert t2.output_ids == want.output_ids
    assert eng.close() == {}
    eng.park_ttl_steps = 0
    eng.step()
    eng._prefix_cache.flush()
    assert eng.free_pool_blocks == eng.n_blocks
    assert (np.asarray(eng._block_ref) == 0).all()
