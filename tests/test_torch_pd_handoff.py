"""Prefill/decode disaggregation in the torch port against the JAX
package's (``tests/system/test_pd_disagg.py``'s scenarios), on the CPU.

Each scenario runs twice, once on two JAX engines and once on two port
engines, with the same tiny config, the same weights (the JAX init,
converted), float32 and greedy sampling, driven by the same code: a
prefill engine P whose request names ``handoff_to``, its KV moved to a
decode engine D (a monolithic unit, or streamed segments pumped as the
server does), and the continuation decoded on D.  The port's tokens equal
the JAX engines', its logprobs agree within 1e-4, and its handoff
counters, reject reasons, resumes and prefill work are the JAX engines'.
Every fail-closed case ends with both of the port's pools whole (the
refcount audit of ``close()``, then every block free once parked rows are
released and the cache flushed).  Also here: ``stack_host_payloads`` and
``restore_blocks_host_stacked`` op by op, the payload bit-identical
through the import (bf16 and int8 pools), and a 1P+1D fleet of
generation servers behind the gserver manager, over ZMQ, against the JAX
package's fleet.
"""

import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import paged as jpaged
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 5
TOL = 1e-4
PROMPT = list(np.arange(24) % 40 + 6)
ENGINE = dict(max_batch=4, kv_cache_len=256, chunk_size=4, stop_tokens=(EOS,),
              cache_mode="paged", page_size=8, prefill_chunk_tokens=16)


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


class Pkg:
    """One package's engines, requests and weight trees on the shared
    weights."""

    def __init__(self, name, model):
        self.name = name
        self.jcfg, self.cfg, self.tree = model

    @property
    def port(self) -> bool:
        return self.name == "port"

    def params(self):
        if self.port:
            return params_from_jax(self.tree, self.cfg, "cpu")
        return jax.tree.map(jnp.asarray, self.tree)

    def engine(self, **kw):
        settings = dict(ENGINE, **kw)
        if self.port:
            from areal_tpu_torch.engine.inference_server import (
                ContinuousBatchingEngine,
            )
            from areal_tpu_torch.engine.sampling import SamplingParams

            return ContinuousBatchingEngine(
                self.cfg, self.params(), device="cpu",
                sampling=SamplingParams(greedy=True), **settings)
        from areal_tpu.engine.inference_server import ContinuousBatchingEngine
        from areal_tpu.engine.sampling import SamplingParams

        return ContinuousBatchingEngine(
            self.jcfg, self.params(), sampling=SamplingParams(greedy=True),
            **settings)

    def req(self, qid, prompt, max_new, metadata=None):
        if self.port:
            from areal_tpu_torch.api import model_api
        else:
            from areal_tpu.api import model_api
        return model_api.APIGenerateInput(
            qid=qid, prompt_ids=list(prompt), input_ids=list(prompt),
            gconfig=model_api.GenerationHyperparameters(
                max_new_tokens=max_new, greedy=True),
            metadata=dict(metadata or {}))

    def gather(self, eng, blocks):
        """``blocks``' pool bytes as float64 numpy arrays, one per
        component."""
        paged = tpaged if self.port else jpaged
        out = paged.gather_blocks_host(eng.k_pool, eng.v_pool, blocks,
                                       k_scale=eng.k_scale,
                                       v_scale=eng.v_scale)
        return [_np(a) for a in out]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def both(model):
    return [Pkg("jax", model), Pkg("port", model)]


def drain(eng, max_steps=800):
    for _ in range(max_steps):
        if not eng.has_work:
            return
        eng.step()
    raise AssertionError("engine did not drain")


def collect(eng, qid):
    out = eng.drain_results()[qid]
    return list(out.output_ids), list(out.output_logprobs), out.no_eos


def unified(pkg, prompt, max_new, qid, **kw):
    eng = pkg.engine(**kw)
    eng.submit(pkg.req(qid, prompt, max_new))
    drain(eng)
    return collect(eng, qid)


def stats(eng):
    """The counters compared across the packages (seconds aside)."""
    h = dict(eng.handoff_stats())
    h.pop("seconds_total")
    return dict(handoff=h, peer=eng.prefix_peer_stats(),
                resumed=eng.resumed_total, prefill=eng.prefill_tokens_total,
                free=eng.free_pool_blocks)


def assert_pristine(pkg, eng):
    """Zero-leak audit: the port's refcount audit accounts for every held
    block; with the parked rows released and the cache flushed, the whole
    pool is free, every refcount 0."""
    if pkg.port:
        assert eng.close() == {}
    eng.park_ttl_steps = 0
    eng.step()
    eng.step()
    if eng._prefix_cache is not None:
        eng._prefix_cache.flush()
    assert eng.free_pool_blocks == eng.n_blocks
    assert (np.asarray(eng._block_ref) == 0).all()
    if pkg.port:
        assert eng.close() == {}


def same_runs(runs):
    """The JAX run and the port's: equal tokens and counters, logprobs
    within TOL."""
    (jn, jr), (pn, pr) = runs
    assert jn == "jax" and pn == "port"
    assert jr.keys() == pr.keys()
    for k in jr:
        if k.startswith("logp"):
            np.testing.assert_allclose(pr[k], jr[k], rtol=TOL, atol=TOL)
        else:
            assert pr[k] == jr[k], (k, pr[k], jr[k])


# -- the host payload helpers, op by op ------------------------------------------


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_stacked_payload_helpers_match_the_reference(kv):
    """``stack_host_payloads`` stacks per-block payloads (gathered blocks and
    host-tier entries mixed) as the reference does, and
    ``restore_blocks_host_stacked`` writes the blocks the reference's writes,
    bit for bit, an int8 pool's scales included; a payload that does not
    match its destinations is refused."""
    jcfg = tiny_config(vocab_size=32)
    cfg = port_config(jcfg)
    NB, BS = 10, 4
    tpool = list(tpaged.alloc_kv_pool(cfg, NB, BS, "cpu", kv))
    rng = np.random.default_rng(3)
    for t in tpool:
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(
                rng.integers(-127, 128, t.shape, dtype=np.int8)))
        else:
            t.copy_(torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32)))
    jpool = [None if t is None else jnp.asarray(t.numpy()) for t in tpool]
    got = tpaged.gather_blocks_host(*tpool[:2], [2, 5, 8], *tpool[2:])
    want = jpaged.gather_blocks_host(*jpool[:2], [2, 5, 8],
                                     k_scale=jpool[2], v_scale=jpool[3])
    per_t = [tuple(a[i] for a in got) for i in (2, 0, 1)]
    per_j = [tuple(a[i] for a in want) for i in (2, 0, 1)]
    st, sj = tpaged.stack_host_payloads(per_t), jpaged.stack_host_payloads(per_j)
    assert len(st) == len(sj) == (4 if kv == "int8" else 2)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dst = [7, 0, 3]
    tpaged.restore_blocks_host_stacked(*tpool[:2], st, dst, *tpool[2:])
    out = jpaged.restore_blocks_host_stacked(
        *jpool[:2], sj, dst, k_scale=jpool[2], v_scale=jpool[3])
    for t, j in zip([t for t in tpool if t is not None], out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        tpaged.restore_blocks_host_stacked(*tpool[:2], st, [1, 2], *tpool[2:])
    with pytest.raises(ValueError):
        tpaged.stack_host_payloads([])


# -- the monolithic handoff -------------------------------------------------------


def drive_disagg(pkg, P, D, prompt, max_new, qid, swap_before=None,
                 swap_after=None):
    """Prefill on P with ``handoff_to``, move the unit to D (what the
    server does before its client reply), decode the continuation on D.
    ``swap_before``/``swap_after`` are weight trees D swaps to (version 1)
    at the named race point.  Returns the run's observables."""
    P.submit(pkg.req(qid, prompt, max_new, {"handoff_to": "D"}))
    drain(P)
    first, first_lp, no_eos = collect(P, qid)
    assert len(first) == 1 and no_eos
    unit = P.export_handoff(qid)
    assert unit is not None
    if swap_before is not None:
        D.update_weights(swap_before, 1)
        D.step()
    ok, reason = D.import_handoff(unit)
    if swap_after is not None:
        D.update_weights(swap_after, 1)
        D.step()
    D.submit(pkg.req(qid, list(prompt) + first, max_new - 1))
    drain(D)
    rest, rest_lp, _ = collect(D, qid)
    return dict(tokens=first + rest, logp=first_lp + rest_lp, ok=ok,
                reason=reason, p=stats(P), d=stats(D))


def test_disagg_greedy_parity_with_unified(model):
    """The handed-off stream equals a unified engine's, the decode engine
    resumes with no prefill, and the counters equal the JAX engines'."""
    runs = []
    for pkg in both(model):
        ref, ref_lp, _ = unified(pkg, PROMPT, 10, "pd0")
        P, D = pkg.engine(), pkg.engine()
        run = drive_disagg(pkg, P, D, PROMPT, 10, "pd0")
        assert run["ok"] and run["tokens"] == ref
        np.testing.assert_allclose(run["logp"], ref_lp, rtol=TOL, atol=TOL)
        assert run["d"]["resumed"] == 1 and run["d"]["prefill"] == 0
        assert run["d"]["handoff"]["imports_total"] == 1
        assert run["p"]["handoff"]["exports_total"] == 1
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(run, ref=ref)))
    same_runs(runs)


@pytest.mark.parametrize("race", ["before_import", "after_import",
                                  "int8_weights"])
def test_handoff_racing_a_weight_swap_fails_closed(model, race):
    """A swap on D between export and import rejects the unit (``version``;
    also when the swapped tree is int8 serving weights); a swap after the
    import evicts the parked row.  Either way stale KV is never decoded:
    the continuation prefills and gives the unified stream."""
    runs = []
    for pkg in both(model):
        kw = dict(serving_weight_dtype="int8") if race == "int8_weights" \
            else {}
        ref, ref_lp, _ = unified(pkg, PROMPT, 10, "pd1", **kw)
        P, D = pkg.engine(**kw), pkg.engine(**kw)
        tree = D.prepare_weights(pkg.params()) if kw else pkg.params()
        where = "swap_after" if race == "after_import" else "swap_before"
        run = drive_disagg(pkg, P, D, PROMPT, 10, "pd1", **{where: tree})
        if race == "after_import":
            assert run["ok"]
        else:
            assert not run["ok"] and run["reason"] == "version"
            assert run["d"]["handoff"]["import_rejects"] == {"version": 1}
        assert run["d"]["resumed"] == 0 and run["d"]["prefill"] > 0
        assert run["tokens"] == ref
        np.testing.assert_allclose(run["logp"], ref_lp, rtol=TOL, atol=TOL)
        if pkg.port and kw:
            from areal_tpu_torch.models import quantize

            assert quantize.is_quantized_tree(D.params)
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, run))
    same_runs(runs)


def _parked_unit(pkg, qid="pd3", **kw):
    P = pkg.engine(**kw)
    P.submit(pkg.req(qid, PROMPT, 8, {"handoff_to": "D"}))
    drain(P)
    P.drain_results()
    unit = P.export_handoff(qid)
    assert unit is not None
    return P, unit


def test_import_rejects_dense_and_layout_mismatches(model):
    """A dense engine rejects a unit (``dense``), a pool of another page
    size rejects it (``layout``), and a payload of another block geometry
    is rejected before a block is allocated; the reasons equal the JAX
    engines' and nothing leaks."""
    runs = []
    for pkg in both(model):
        P, unit = _parked_unit(pkg)
        got = []
        dense = pkg.engine(cache_mode="dense")
        got.append(dense.import_handoff(dict(unit)))
        other = pkg.engine(page_size=16)
        got.append(other.import_handoff(dict(unit)))
        bad = dict(unit, payload=tuple(a[:, :1] for a in unit["payload"]))
        victim = pkg.engine()
        free0 = victim.free_pool_blocks
        got.append(victim.import_handoff(bad))
        assert victim.free_pool_blocks == free0
        assert got == [(False, "dense"), (False, "layout"), (False, "layout")]
        for eng in (P, other, victim):
            assert_pristine(pkg, eng)
        runs.append((pkg.name, dict(got=got, other=stats(other),
                                    victim=stats(victim))))
    same_runs(runs)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_handoff_payload_bit_identical_through_import(model, kv):
    """The blocks D holds after the import equal the exported payload bit
    for bit (an int8 pool's bytes and scales: four components, no
    requantization), and the payload equals the JAX engine's (within 1e-4
    in float32; the int8 codes and scales exactly but for ties at
    rounding)."""
    payloads = {}
    for pkg in both(model):
        P, unit = _parked_unit(pkg, "pd4", kv_cache_dtype=kv)
        D = pkg.engine(kv_cache_dtype=kv)
        ok, reason = D.import_handoff(unit)
        assert ok, reason
        rid = next(i for i, r in enumerate(D.rows)
                   if r is not None and r.req.qid == "pd4")
        back = pkg.gather(D, D._row_blocks[rid])
        sent = [_np(a) for a in unit["payload"]]
        assert len(sent) == (4 if kv == "int8" else 2)
        for a, b in zip(sent, back):
            np.testing.assert_array_equal(a, b)
        if pkg.port:
            assert all(a.dtype == b.dtype for a, b in zip(
                unit["payload"], tpaged.gather_blocks_host(
                    D.k_pool, D.v_pool, D._row_blocks[rid], D.k_scale,
                    D.v_scale)))
        assert_pristine(pkg, D)
        payloads[pkg.name] = sent
    for j, t in zip(payloads["jax"], payloads["port"]):
        if kv == "int8" and j.dtype == np.float64 and np.all(j == np.round(j)):
            # int8 codes: a value at a rounding tie may land one code apart
            assert np.mean(j != t) < 1e-3 and np.max(np.abs(j - t)) <= 1
        else:
            np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


# -- the streamed handoff --------------------------------------------------------


def drive_streamed(pkg, P, D, prompt, max_new, qid, on_segment=None,
                   continuation=True):
    """Prefill on a streaming P, pumping its segments into D as they are
    exported (the server's ``_pump_handoff_streams`` in one thread), then
    decode the continuation on D.  ``on_segment(i, seg) -> bool`` may take
    a segment over (False skips the default import).  Returns (tokens,
    logprobs, segments)."""
    P.submit(pkg.req(qid, prompt, max_new, {"handoff_to": "D"}))
    segs = []
    for _ in range(600):
        if not P.has_work:
            break
        P.step()
        for seg in P.drain_handoff_segments():
            i = len(segs)
            segs.append(seg)
            if on_segment is not None and not on_segment(i, seg):
                continue
            D.import_handoff_segment(seg)
    first, first_lp, no_eos = collect(P, qid)
    if not continuation or max_new <= 1 or not (no_eos and first):
        return first, first_lp, segs
    D.submit(pkg.req(qid, list(prompt) + first, max_new - 1))
    drain(D)
    rest, rest_lp, _ = collect(D, qid)
    return first + rest, first_lp + rest_lp, segs


def _seg_view(segs):
    return [(s["seq"], s.get("n_blocks"), s.get("block_start"),
             s.get("total_blocks"), bool(s.get("final")),
             bool(s.get("abort"))) for s in segs]


def test_streamed_handoff_parity_at_chunk_boundaries(model):
    """The streamed stream equals the unified one, D resumes with no
    prefill, and the export is chunked: numbered segments at fill-chunk
    boundaries (the same segments, block ranges and counters as the JAX
    engines')."""
    runs = []
    for pkg in both(model):
        ref, ref_lp, _ = unified(pkg, PROMPT, 10, "st0")
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        got, lp, segs = drive_streamed(pkg, P, D, PROMPT, 10, "st0")
        assert got == ref
        np.testing.assert_allclose(lp, ref_lp, rtol=TOL, atol=TOL)
        d, p = stats(D), stats(P)
        assert d["resumed"] == 1 and d["prefill"] == 0
        data = [s for s in segs if not s.get("abort")]
        assert len(data) >= 3
        assert [s["seq"] for s in data] == list(range(len(data)))
        assert data[-1]["final"] and not data[0]["final"]
        assert p["handoff"]["exports_total"] == 1
        assert d["handoff"]["imports_total"] == 1
        assert (d["handoff"]["segment_imports_total"]
                == p["handoff"]["segment_exports_total"])
        assert d["handoff"]["pending_streams"] == 0
        assert d["handoff"]["import_rejects"] == {}
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(tokens=got, logp=lp, p=p, d=d,
                                    segs=_seg_view(segs))))
    same_runs(runs)


def test_streamed_version_skew_fails_closed_zero_leak(model):
    """A swap on D after segment 0 makes every later segment's version check
    fail: the partial blocks are freed on D, nothing is left on P, and the
    continuation prefills to the unified stream."""
    runs = []
    for pkg in both(model):
        ref, _, _ = unified(pkg, PROMPT, 10, "sv0")
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        free0 = D.free_pool_blocks
        tree = pkg.params()
        replies = []

        def swap_after_first(i, seg):
            replies.append(D.import_handoff_segment(seg))
            if i == 0:
                D.update_weights(tree, 1)
                D.step()
            return False

        first, _, segs = drive_streamed(pkg, P, D, PROMPT, 10, "sv0",
                                        on_segment=swap_after_first,
                                        continuation=False)
        assert replies[0] == (True, "")
        assert all(r == (False, "version") for r in replies[1:])
        assert len(segs) >= 3 and D.free_pool_blocks == free0
        assert D.handoff_stats()["pending_streams"] == 0
        assert not P._handoff_streams
        D.submit(pkg.req("sv0", list(PROMPT) + first, 9))
        drain(D)
        rest, _, _ = collect(D, "sv0")
        assert D.resumed_total == 0 and D.prefill_tokens_total > 0
        assert first + rest == ref
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(tokens=first + rest, replies=replies,
                                    p=stats(P), d=stats(D))))
    same_runs(runs)


def test_streamed_dead_peer_expires_under_the_ttl(model):
    """Only segment 0 arrives (the sender died): D holds the row's blocks
    until the TTL sweep frees them (``expired``), with nothing leaked."""
    runs = []
    for pkg in both(model):
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        free0 = D.free_pool_blocks
        drive_streamed(pkg, P, D, PROMPT, 10, "dp0",
                       on_segment=lambda i, seg: i == 0, continuation=False)
        held = (D.handoff_stats()["pending_streams"],
                free0 - D.free_pool_blocks)
        assert held[0] == 1 and held[1] > 0
        if pkg.port:
            assert D.close() == {}  # the pending stream's blocks counted
        D.handoff_pending_ttl_steps = 3
        for _ in range(10):
            D.step()
        assert D.handoff_stats()["pending_streams"] == 0
        assert D.free_pool_blocks == free0
        assert D.handoff_stats()["import_rejects"] == {"expired": 1}
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(held=held, p=stats(P), d=stats(D))))
    same_runs(runs)


def test_streamed_abort_on_a_one_token_budget(model):
    """A request that ends at its first token after segments went out sends
    an abort; D frees the partial blocks at once (``abort``)."""
    runs = []
    for pkg in both(model):
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        free0 = D.free_pool_blocks
        got, lp, segs = drive_streamed(pkg, P, D, PROMPT, 1, "ab0")
        assert len(got) == 1 and segs and segs[-1].get("abort")
        assert P.handoff_stats()["segment_aborts_total"] == 1
        assert D.handoff_stats()["pending_streams"] == 0
        assert D.free_pool_blocks == free0
        assert D.handoff_stats()["import_rejects"] == {"abort": 1}
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(tokens=got, logp=lp,
                                    segs=_seg_view(segs), p=stats(P),
                                    d=stats(D))))
    same_runs(runs)


def test_streamed_restarted_segment_zero_replaces_without_leak(model):
    """A stream that restarts (segment 0 again) replaces the half-received
    one on D: the blocks are swapped, not doubled, and no reject counts."""
    runs = []
    for pkg in both(model):
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        free0 = D.free_pool_blocks
        segs = []
        drive_streamed(pkg, P, D, PROMPT, 10, "rs0",
                       on_segment=lambda i, seg: segs.append(seg) and False,
                       continuation=False)
        seg0 = next(s for s in segs if s.get("seq") == 0)
        replies = [D.import_handoff_segment(seg0)]
        held = free0 - D.free_pool_blocks
        replies.append(D.import_handoff_segment(seg0))
        assert replies == [(True, ""), (True, "")] and held > 0
        assert free0 - D.free_pool_blocks == held
        assert D.handoff_stats()["pending_streams"] == 1
        D._release_pending_handoff("rs0")
        assert D.free_pool_blocks == free0
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(held=held, d=stats(D))))
    same_runs(runs)


def test_streamed_segment_gap_is_rejected(model):
    """A segment out of order (one lost in between) is a sequence gap: the
    partial blocks are freed (``stream``) and nothing leaks."""
    runs = []
    for pkg in both(model):
        P, D = pkg.engine(handoff_streaming=True), pkg.engine()
        free0 = D.free_pool_blocks
        replies = []

        def skip_one(i, seg):
            if i != 1:
                replies.append(D.import_handoff_segment(seg))
            return False

        drive_streamed(pkg, P, D, PROMPT, 10, "gp0", on_segment=skip_one,
                       continuation=False)
        assert replies[0] == (True, "") and replies[1] == (False, "stream")
        assert D.free_pool_blocks == free0
        assert_pristine(pkg, P)
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(replies=replies, d=stats(D))))
    same_runs(runs)


@pytest.mark.slow  # int8 arms: the reference marks its quantized arms slow
@pytest.mark.parametrize("streaming", [False, True])
def test_disagg_int8_pool_greedy_parity(model, streaming):
    """On int8 pools the handed-off stream equals the int8 unified engine's
    and the JAX engines', and a streamed import's blocks equal the
    concatenated segment payloads bit for bit."""
    runs = []
    for pkg in both(model):
        kw = dict(kv_cache_dtype="int8")
        ref, _, _ = unified(pkg, PROMPT, 10, "si0", **kw)
        P = pkg.engine(handoff_streaming=streaming, **kw)
        D = pkg.engine(**kw)
        if streaming:
            first, _, segs = drive_streamed(pkg, P, D, PROMPT, 10, "si0",
                                            continuation=False)
            rid = next(i for i, r in enumerate(D.rows)
                       if r is not None and r.req.qid == "si0")
            back = pkg.gather(D, D._row_blocks[rid])
            data = [s for s in segs if not s.get("abort") and s["n_blocks"]]
            for c in range(len(back)):
                sent = np.concatenate([_np(s["payload"][c]) for s in data])
                np.testing.assert_array_equal(sent, back[c])
            D.submit(pkg.req("si0", PROMPT + first, 9))
            drain(D)
            rest, _, _ = collect(D, "si0")
            got = first + rest
        else:
            got = drive_disagg(pkg, P, D, PROMPT, 10, "si0")["tokens"]
        assert got == ref
        assert D.resumed_total == 1 and D.prefill_tokens_total == 0
        assert_pristine(pkg, D)
        runs.append((pkg.name, dict(tokens=got, d=stats(D))))
    same_runs(runs)


def test_prefill_backlog_counts_handoff_fills(model):
    """The prefill backlog the manager routes on rises on submit and falls
    to 0 once a handoff fill parks, and once a request too long to serve
    fails; the port's readings equal the JAX engine's."""
    runs = []
    for pkg in both(model):
        P = pkg.engine()
        seen = [P.prefill_backlog_tokens()]
        P.submit(pkg.req("bl0", PROMPT, 8, {"handoff_to": "D"}))
        seen.append(P.prefill_backlog_tokens())
        drain(P)
        seen.append(P.prefill_backlog_tokens())
        too_long = list(np.arange(300) % 40 + 6)
        P.submit(pkg.req("bl1", too_long, 8))
        seen.append(P.prefill_backlog_tokens())
        drain(P)
        assert P.drain_results()["bl1"].output_ids == []
        seen.append(P.prefill_backlog_tokens())
        assert seen == [0, len(PROMPT), 0, len(too_long), 0]
        runs.append((pkg.name, dict(seen=seen)))
    same_runs(runs)


# -- a 1P+1D fleet over worker RPC -------------------------------------------------


FLEET_MODEL = {"vocab_size": 64, "max_position_embeddings": 256, "seed": 0}
FLEET = dict(max_concurrent_batch=2, kv_cache_len=128, chunk_size=4,
             greedy=True, cache_mode="paged", page_size=16,
             prefill_chunk_tokens=32)


def _run_fleet(pkg_name, monkeypatch, tree, prompt, new_tokens):
    """Two generation servers in threads (``prefill`` and ``decode``), the
    gserver manager and a ``PartialRolloutManager`` client, each on the
    package's own memory name_resolve; one chunked generation.  Returns
    (output, prefill server metrics, decode server metrics, manager
    status)."""
    if pkg_name == "port":
        from areal_tpu_torch.api.config import ModelAbstraction
        from areal_tpu_torch.api.model_api import GenerationHyperparameters
        from areal_tpu_torch.api.system_api import (
            GenServerConfig,
            GserverManagerConfig,
        )
        from areal_tpu_torch.base import constants, name_resolve, names
        from areal_tpu_torch.engine import backend
        from areal_tpu_torch.system import generation_server as gs
        from areal_tpu_torch.system.gserver_manager import (
            GserverManager,
            GserverManagerClient,
        )
        from areal_tpu_torch.system.partial_rollout import (
            PartialRolloutManager,
        )

        real = backend.make_model

        def make_model(cfg, name, mesh=None, tokenizer=None, device=None):
            # serve the JAX init, converted: the port's random init draws
            # torch's numbers
            m = real(cfg, name, mesh, tokenizer=tokenizer, device=device)
            m.init_params = params_from_jax(tree, m.model_cfg, "cpu")
            return m

        monkeypatch.setattr(backend, "make_model", make_model)
        extra = dict(device="cpu")
    else:
        from areal_tpu.api.config import ModelAbstraction
        from areal_tpu.api.model_api import GenerationHyperparameters
        from areal_tpu.api.system_api import (
            GenServerConfig,
            GserverManagerConfig,
        )
        from areal_tpu.base import constants, name_resolve, names
        from areal_tpu.system import generation_server as gs
        from areal_tpu.system.gserver_manager import (
            GserverManager,
            GserverManagerClient,
        )
        from areal_tpu.system.partial_rollout import PartialRolloutManager

        extra = {}
    expr, tr = "pdfleet", pkg_name
    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names(expr, tr)
    model_abs = ModelAbstraction("random", dict(FLEET_MODEL))
    workers, threads = [], []
    manager = mgr_client = prm = None
    try:
        for name, role in (("gen_server_0", "prefill"),
                           ("gen_server_1", "decode")):
            w = gs.GenerationServerWorker()
            t = threading.Thread(target=w.run, daemon=True, args=(
                GenServerConfig(worker_name=name, role=role, model=model_abs,
                                **FLEET, **extra),))
            t.start()
            workers.append(w)
            threads.append(t)
            name_resolve.wait(names.gen_server(expr, tr, name), timeout=60)
        manager = GserverManager()
        t = threading.Thread(target=manager.run, daemon=True, args=(
            GserverManagerConfig(worker_name="gserver_manager", n_servers=2),))
        t.start()
        threads.append(t)
        name_resolve.wait(names.gen_server_manager(expr, tr), timeout=60)
        mgr_client = GserverManagerClient(expr, tr, timeout=30.0)
        prm = PartialRolloutManager(
            mgr_client,
            GenerationHyperparameters(max_new_tokens=new_tokens, greedy=True),
            new_tokens_per_chunk=6, request_timeout=60.0)
        out = asyncio.run(prm._gen_one("pdr0-0", prompt))
        metrics = []
        for name in ("gen_server_0", "gen_server_1"):
            addr, _, _, role, _ = gs.parse_server_registration(
                name_resolve.get(names.gen_server(expr, tr, name)))
            client = gs.GenServerClient(addr, timeout=10.0)
            metrics.append(dict(client.call("metrics", {}), reg_role=role,
                                addr=addr))
            client.close()
        status = mgr_client.call("get_status", {})
        return out, metrics[0], metrics[1], status
    finally:
        if prm is not None:
            prm.close()
        if mgr_client is not None:
            mgr_client.close()
        if manager is not None:
            manager.exit()
        for w in workers:
            w.exit()
        for t in threads:
            t.join(30)


def test_pd_fleet_over_worker_rpc_matches_the_jax_fleet(model, monkeypatch):
    """A real 1P+1D fleet: the manager routes the first chunk to the
    prefill server with ``handoff_to``, the client copies it into the
    request, the prefill server streams the KV to the decode server over
    the ``import_handoff_segment`` RPC before its reply, and every
    continuation resumes on the decode server.  The answer's tokens equal
    the JAX fleet's (logprobs within 1e-4) and a unified engine's; the
    servers' handoff counters equal the JAX servers'."""
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.engine.sampling import SamplingParams

    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    prompt = list(np.arange(40) % 60 + 2)
    got = {}
    for name in ("jax", "port"):
        got[name] = _run_fleet(name, monkeypatch, tree, prompt, 12)
    (jout, jp, jd, jst), (pout, pp, pd, pst) = got["jax"], got["port"]
    assert len(pout.output_ids) == 12
    assert list(pout.output_ids) == list(jout.output_ids)
    np.testing.assert_allclose(pout.output_logprobs, jout.output_logprobs,
                               rtol=TOL, atol=TOL)
    cfg = port_config(jcfg)
    ref = ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"), max_batch=2,
        kv_cache_len=128, chunk_size=4, sampling=SamplingParams(greedy=True),
        cache_mode="paged", page_size=16, prefill_chunk_tokens=32,
        device="cpu")
    ref.submit(Pkg("port", (jcfg, cfg, tree)).req("ref0", prompt, 12))
    drain(ref)
    assert collect(ref, "ref0")[0] == list(pout.output_ids)
    for m, role in ((pp, "prefill"), (pd, "decode")):
        assert m["role"] == m["reg_role"] == role
    assert pp["handoff_exports_total"] == 1
    assert pd["handoff_imports_total"] == 1
    assert pd["handoff_import_rejects"] == {}
    assert pp["handoff_segment_exports_total"] >= 2
    assert (pd["handoff_segment_imports_total"]
            == pp["handoff_segment_exports_total"])
    assert pd["handoff_pending_streams"] == 0
    assert pp["prefill_backlog_tokens"] == 0
    assert pst["pd_enabled"] is True
    assert pst["server_roles"][pp["addr"]] == "prefill"
    keys = [k for k in jp if k.startswith(("handoff_", "prefix_peer_"))
            and k != "handoff_seconds_total"]
    assert keys
    for k in keys + ["role", "segment_transport", "prefill_backlog_tokens"]:
        assert pp[k] == jp[k], k
        assert pd[k] == jd[k], k
    # every continuation resumed on the decode server: nothing prefilled
    assert pd["prefill_tokens_total"] == 0 and pp["prefill_tokens_total"] > 0


def test_an_idle_server_waits_instead_of_stepping():
    """A decode server with nothing to dispatch waits on its socket
    (``IDLE_WAIT_S``) instead of stepping its engine every 2 ms like the
    JAX server's loop: the engine's step clock, which the 512-step TTL of a
    half-received stream counts, advances a few tens of times a second, so
    that TTL is not a second of idle wall time."""
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenServerConfig
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.system import generation_server as gs

    name_resolve.reconfigure("memory")
    constants.set_experiment_trial_names("pdidle", "t0")
    w = gs.GenerationServerWorker()
    t = threading.Thread(target=w.run, daemon=True, args=(GenServerConfig(
        worker_name="gen_server_0", role="decode", device="cpu",
        model=ModelAbstraction("random", dict(FLEET_MODEL)), **FLEET),))
    t.start()
    try:
        name_resolve.wait(names.gen_server("pdidle", "t0", "gen_server_0"),
                          timeout=60)
        s0 = w.engine._step_seq
        time.sleep(1.0)
        steps = w.engine._step_seq - s0
    finally:
        w.exit()
        t.join(30)
    assert 0 < steps <= 1.0 / gs.IDLE_WAIT_S + 5, steps
