"""The port's dense KV cache and generation (``models/transformer.py``
``KVCache``/``prefill``/``decode_step``, ``engine/generation.py``) against
the JAX package's, on the same float32 tiny model (the JAX init converted
by ``params_from_jax``) and numpy-seeded prompts.

``prefill`` and ``decode_step`` logits and cache contents agree to 1e-4;
greedy ``generate_tokens`` gives the JAX package's tokens exactly, their
logprobs to 1e-4, with a stop token, ``min_new_tokens`` and group
expansion (the cases of ``tests/engine/test_generation.py``), and
``generate_for_sample``'s four keys are equal.  A card's attention paths
(``flash_decode`` for decode, the flash kernel for the prefill of an empty
cache) compute, in their plain versions, what the CPU's masked product
does; and a card refuses what they do not cover (a non-empty cache's
prefill, a sliding window) before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.api.model_api import GenerationHyperparameters as JGen
from areal_tpu.base.topology import MeshSpec
from areal_tpu.engine import generation as jgen
from areal_tpu.engine.train_engine import TrainEngine as JEngine
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.api.model_api import GenerationHyperparameters
from areal_tpu_torch.engine import generation as tgen
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.ops import decode_attention as tda
from areal_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_train_model import port_config

TOL = 1e-4
VOCAB = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seed=7, **kw):
    jcfg = jtiny(vocab_size=VOCAB, **kw)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    cfg = port_config(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).tolist() for n in lens]


def _padded(prompts, T):
    toks = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (len(prompts), 1))
    seg = (pos < lens[:, None]).astype(np.int32)
    return toks, pos, seg, lens


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _close_cache(tcache, jcache):
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("window", [None, 4], ids=["dense", "window4"])
def test_prefill_and_decode_match_the_jax_package(window):
    """A prefill of three rows of different lengths, three decode steps
    (one row inactive in the last two), then a second prefill into the
    non-empty cache: logits and cache contents to 1e-4 at each stage."""
    jcfg, jp, cfg, tp = _pair(sliding_window=window)
    S = 32
    prompts = _prompts([8, 5, 3])
    toks, pos, seg, lens = _padded(prompts, 8)
    jc = jt.KVCache.zeros(jcfg, 3, S)
    tc = tt.KVCache.zeros(cfg, 3, S, device="cpu")
    assert tc.empty and tc.max_len == S
    jl, jc = jt.prefill(jp, jcfg, toks, pos, seg, jc)
    tl, tc = tt.prefill(tp, cfg, _t(toks, torch.long), _t(pos, torch.long),
                        _t(seg), tc)
    assert not tc.empty
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _close_cache(tc, jc)

    rng = np.random.default_rng(1)
    for step in range(3):
        nxt = rng.integers(1, VOCAB, 3).astype(np.int32)
        active = np.array([True, step == 0, True])
        jl, jc = jt.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                active=jnp.asarray(active))
        tl, tc = tt.decode_step(tp, cfg, _t(nxt), tc, active=_t(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {step}")
        _close_cache(tc, jc)

    # a continuation of every row: absolute positions from each length
    more = _prompts([2, 3, 1], seed=2)
    toks2, _, seg2, _ = _padded(more, 4)
    pos2 = np.asarray(jc.lengths)[:, None] + np.arange(4, dtype=np.int32)
    jl, jc = jt.prefill(jp, jcfg, toks2, pos2, seg2, jc)
    tl, tc = tt.prefill(tp, cfg, _t(toks2, torch.long), _t(pos2, torch.long),
                        _t(seg2), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _close_cache(tc, jc)


def test_prefill_last_pos_gives_each_rows_last_logits(models):
    jcfg, jp, cfg, tp = models
    prompts = _prompts([6, 2, 4], seed=3)
    toks, pos, seg, lens = _padded(prompts, 8)
    last = np.maximum(lens - 1, 0)
    jl, _ = jt.prefill(jp, jcfg, toks, pos, seg, jt.KVCache.zeros(jcfg, 3, 16),
                       last_pos=jnp.asarray(last))
    tl, _ = tt.prefill(tp, cfg, _t(toks, torch.long), _t(pos, torch.long),
                       _t(seg), tt.KVCache.zeros(cfg, 3, 16, device="cpu"),
                       last_pos=_t(last))
    assert tuple(tl.shape) == (3, 1, VOCAB)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    full, _ = tt.prefill(tp, cfg, _t(toks, torch.long), _t(pos, torch.long),
                         _t(seg), tt.KVCache.zeros(cfg, 3, 16, device="cpu"))
    np.testing.assert_allclose(
        tl[:, 0].numpy(), full[torch.arange(3), _t(last)].numpy(), rtol=1e-6,
        atol=1e-6)


def _gen(pkg, models, prompts, g, eos, seed=0):
    jcfg, jp, cfg, tp = models
    if pkg == "jax":
        return jgen.generate_tokens(jp, jcfg, prompts, JGen(**g), eos,
                                    jax.random.PRNGKey(seed))
    return tgen.generate_tokens(tp, cfg, prompts, GenerationHyperparameters(**g),
                                eos, seed)


def _same_outputs(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a["output_ids"] == b["output_ids"]
        assert a["no_eos"] == b["no_eos"]
        np.testing.assert_allclose(a["output_logprobs"], b["output_logprobs"],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "g,eos_from_first",
    [
        (dict(greedy=True, max_new_tokens=8), False),
        (dict(greedy=True, max_new_tokens=8, n=2), True),
        (dict(greedy=True, max_new_tokens=6, min_new_tokens=3), True),
        (dict(greedy=True, max_new_tokens=5, stop_token_ids=[1, 2]), False),
        (dict(greedy=True, max_new_tokens=40, n=3), False),
    ],
    ids=["greedy", "group_eos", "min_new_tokens", "stop_ids", "forty_tokens"],
)
def test_greedy_generation_matches_the_jax_package(models, g, eos_from_first):
    """Exact tokens, stop flags and logprobs to 1e-4; with ``eos`` the
    first greedy token of the first prompt, that row stops at once, or
    runs at least ``min_new_tokens`` where set (the ban keeps eos out)."""
    prompts = _prompts([4, 9, 2, 6], seed=4)
    eos = None
    if eos_from_first:
        eos = _gen("jax", models, prompts[:1],
                   dict(greedy=True, max_new_tokens=1), None)[0][
                       "output_ids"][0]
    j = _gen("jax", models, prompts, g, eos)
    t = _gen("torch", models, prompts, g, eos)
    _same_outputs(t, j)
    if eos is not None:
        n0 = len(t[0]["output_ids"])
        if g.get("min_new_tokens"):
            assert n0 >= g["min_new_tokens"]
            assert eos not in t[0]["output_ids"][: g["min_new_tokens"]]
        else:
            assert n0 == 1 and not t[0]["no_eos"]


def test_greedy_matches_teacher_forcing(models):
    """The cache path and the training forward agree: greedy generation is
    the repeated argmax of the full forward, and its logprobs are the
    trainer's recompute (``tests/engine/test_generation.py``)."""
    _, _, cfg, tp = models
    prompt = [3, 14, 15, 9]
    out = _gen("torch", models, [prompt], dict(greedy=True, max_new_tokens=8),
               None)[0]
    seq = list(prompt)
    for _ in range(8):
        t = torch.tensor([seq])
        pos = torch.arange(len(seq))[None]
        logits = tt.forward(tp, cfg, t, pos, torch.ones_like(t, dtype=torch.int32))
        seq.append(int(torch.argmax(logits[0, -1])))
    assert out["output_ids"] == seq[len(prompt):]
    t = torch.tensor([seq])
    lp = tt.logprobs_of_labels(tp, cfg, t, torch.arange(len(seq))[None],
                               torch.ones_like(t, dtype=torch.int32))[0]
    np.testing.assert_allclose(out["output_logprobs"],
                               lp[len(prompt) - 1:].numpy(), atol=2e-4)


def test_sampled_group_expansion(models):
    """Sampled rows (the two packages' random streams differ, so only the
    shape of the result is compared): one result per group member,
    finite non-positive logprobs, and the same draws for the same seed."""
    g = dict(n=4, max_new_tokens=5, temperature=1.0, top_p=0.95)
    outs = _gen("torch", models, [[1, 2, 3]], g, None, seed=1)
    assert len(outs) == 4
    for o in outs:
        assert len(o["output_ids"]) == 5 and o["no_eos"]
        assert all(np.isfinite(o["output_logprobs"]))
        assert all(lp <= 0 for lp in o["output_logprobs"])
    assert outs == _gen("torch", models, [[1, 2, 3]], g, None, seed=1)
    # each member draws on its own row's key
    assert len({tuple(o["output_ids"]) for o in outs}) > 1


def test_the_loop_stops_when_no_row_is_active(models):
    """Every row stops on the first token: one prefill and no decode step
    (the reference's device loop exits on the same condition)."""
    prompts = _prompts([3, 3], seed=5)
    first = _gen("torch", models, prompts, dict(greedy=True, max_new_tokens=1),
                 None)
    stops = sorted({o["output_ids"][0] for o in first})
    tgen.counters = tgen.GenerationCounters()
    out = _gen("torch", models, prompts,
               dict(greedy=True, max_new_tokens=16, stop_token_ids=stops),
               None)
    assert [len(o["output_ids"]) for o in out] == [1, 1]
    assert tgen.counters == tgen.GenerationCounters(
        decode_steps=0, prefills=1)
    out = _gen("torch", models, prompts, dict(greedy=True, max_new_tokens=16),
               None)
    assert tgen.counters.decode_steps == 15 and tgen.counters.prefills == 2


def test_generate_for_sample_matches_the_jax_package(models):
    """sync PPO's ``actor_gen`` on both packages' engines: the same ids,
    sequence lengths and the four keys (``packed_logprobs`` to 1e-4)."""
    jcfg, jp, cfg, tp = models
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    jm = jmodel_api.Model("actor", JEngine(jcfg, mesh, jp), None, mesh)
    tm = model_api.Model("actor", TrainEngine(cfg, None, tp, device="cpu"))
    prompts = _prompts([5, 2, 7], seed=6)
    lens = [len(p) for p in prompts]
    data = dict(packed_prompts=np.concatenate(prompts).astype(np.int32))
    ids = ["a", "b", "c"]
    g = dict(greedy=True, max_new_tokens=6, n=2, stop_token_ids=[5])
    j = jgen.generate_for_sample(jm, JSample.from_default(lens, ids, dict(data)),
                                 JGen(**g))
    t = tgen.generate_for_sample(tm, SequenceSample.from_default(lens, ids, data),
                                 GenerationHyperparameters(**g))
    assert t.ids == j.ids and t.keys == j.keys
    assert t.seqlens == j.seqlens
    for k in ("packed_input_ids", "prompt_mask", "seq_no_eos_mask"):
        np.testing.assert_array_equal(t.data[k], j.data[k], err_msg=k)
    np.testing.assert_allclose(t.data["packed_logprobs"],
                               j.data["packed_logprobs"], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the card's attention paths, in their plain versions, and its refusals
# ---------------------------------------------------------------------------


def test_flash_decode_attention_is_the_cache_attention():
    """``decode_step``'s card path (``flash_decode`` over slots
    ``[0, lengths]``, normalised) computes the CPU's masked product."""
    rng = np.random.default_rng(8)
    B, Hq, Hkv, S, hd = 4, 12, 2, 64, 16
    q = _t(rng.standard_normal((B, 1, Hq, hd)).astype(np.float32))
    k, v = (_t(rng.standard_normal((B, Hkv, S, hd)).astype(np.float32))
            for _ in range(2))
    lengths = torch.tensor([0, 1, 37, 63], dtype=torch.int32)
    mask = (torch.arange(S)[None, :] <= lengths[:, None].long())[:, None]
    np.testing.assert_allclose(
        tt.flash_decode_attention(q, k, v, lengths + 1).numpy(),
        tt.cache_attention(q, k, v, mask).numpy(), rtol=1e-5, atol=1e-5)


def test_flash_prefill_is_the_cache_attention_of_an_empty_cache():
    """The prefill of an empty cache on a card (the flash kernel over the
    prompt with seg ids 1 real, 0 padding) computes the CPU's masked
    product at every real query."""
    rng = np.random.default_rng(9)
    B, T, S, Hq, Hkv, hd = 3, 8, 16, 4, 2, 8
    lens = torch.tensor([8, 5, 1])
    q = _t(rng.standard_normal((B, T, Hq, hd)).astype(np.float32))
    k, v = (_t(rng.standard_normal((B, T, Hkv, hd)).astype(np.float32))
            for _ in range(2))
    pos = torch.arange(T).expand(B, T)
    seg = (pos < lens[:, None]).to(torch.int32)
    kc, vc = (torch.zeros(B, Hkv, S, hd) for _ in range(2))
    kc[:, :, :T], vc[:, :, :T] = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S)[None, None] <= pos[:, :, None]) & (seg != 0)[:, :, None]
    want = tt.cache_attention(q, kc, vc, mask)
    got = tfa.flash_attention(q, k, v, seg)
    real = seg.bool()
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(),
                               rtol=1e-5, atol=1e-5)


def _meta_model(**kw):
    cfg = tt.TransformerConfig(**{**vars(port_config(jtiny(vocab_size=VOCAB))),
                                  **kw})
    params = tt.init_params(cfg, 0, "cpu")
    meta = jax.tree.map(lambda t: t.to("meta"), params,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    return cfg, meta


def _counted(monkeypatch):
    """Count every call of the kernel wrappers (launched or refused)."""
    calls = []
    for mod, name in ((tda, "_launch"), (tfa, "_launch_fwd")):
        orig = getattr(mod, name)

        def wrapped(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("what", ["nonempty_prefill", "window_decode",
                                  "window_prefill"])
def test_a_card_refuses_before_any_launch(what, monkeypatch):
    """Off the CPU (``meta`` tensors stand for a card's here), a prefill
    into a written cache and a sliding window are refused by name before
    any kernel wrapper is called."""
    calls = _counted(monkeypatch)
    cfg, p = _meta_model(sliding_window=4 if "window" in what else None)
    cache = tt.KVCache.zeros(cfg, 2, 64, device="meta")
    toks = torch.zeros((2, 4), dtype=torch.long, device="meta")
    pos = torch.zeros((2, 4), dtype=torch.long, device="meta")
    seg = torch.ones((2, 4), dtype=torch.int32, device="meta")
    if what == "nonempty_prefill":
        cache.empty = False
        with pytest.raises(NotImplementedError, match="non-empty KV cache"):
            tt.prefill(p, cfg, toks, pos, seg, cache)
    elif what == "window_decode":
        with pytest.raises(NotImplementedError, match="sliding_window 4"):
            tt.decode_step(p, cfg, toks[:, 0], cache)
    else:
        with pytest.raises(NotImplementedError, match="sliding_window 4"):
            tt.prefill(p, cfg, toks, pos, seg, cache)
    assert calls == []


def test_a_card_goes_to_the_kernels_and_never_falls_back(monkeypatch):
    """Off the CPU the empty cache's prefill calls the flash kernel's
    wrapper and a decode step ``flash_decode``'s, which refuse a tensor
    that is not on a card rather than compute the plain product."""
    calls = _counted(monkeypatch)
    cfg, p = _meta_model()
    cache = tt.KVCache.zeros(cfg, 2, 64, device="meta")
    toks = torch.zeros((2, 4), dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError):
        tt.prefill(p, cfg, toks, toks, torch.ones((2, 4), dtype=torch.int32,
                                                  device="meta"), cache)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tt.decode_step(p, cfg, toks[:, 0], cache)
    assert calls == ["_launch_fwd", "_launch"]
