"""Staged weight swaps of the port's engine against the JAX engine's, case
by case after ``tests/engine/test_weight_swap.py``: ``stage_weights`` makes
a device-resident copy while decode continues and ``commit_staged`` swaps
it in with the semantics of ``update_weights`` (ring drained under the old
weights, prefix cache flushed, in-flight KV recomputed), behind a
version-consistent commit barrier.

Both engines run the paged cache on the same converted weights and the
same requests, and take the same calls at the same steps: their tokens
are equal, logprobs within 1e-4, the version each token was sampled under
equal (the port reports it per token; the JAX engine's is read off the
number of tokens a row held when the swap recomputed it), and the
interrupted counts equal.  The reference file's dense-mode cases run in
paged mode here (the port has no dense cache); its TP-mesh, spec-decode
and HBM-ledger cases are not ported (ROADMAP.md).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import APIGenerateInput as JaxInput
from areal_tpu.api.model_api import GenerationHyperparameters as JaxGen
from areal_tpu.engine import checkpoint as jck
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
from areal_tpu_torch.engine import checkpoint as tck
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 5
TOL = 1e-4
ENGINE = dict(
    max_batch=4, kv_cache_len=128, chunk_size=8, stop_tokens=(EOS,),
    cache_mode="paged", page_size=16, prefill_chunk_tokens=32,
)

_jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
_cfg = port_config(_jcfg)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees():
    """v0 and v1 weights: the reference test's PRNGKey(0) and (42) trees,
    as numpy."""
    return [jax.device_get(jt.init_params(_jcfg, jax.random.PRNGKey(s)))
            for s in (0, 42)]


class Pair:
    """The JAX engine and the port's, driven by the same calls.  ``w0``
    and ``w1`` name the two trees in each engine's own form."""

    def __init__(self, trees, params=0, **kw):
        self.jw = [jax.tree.map(jnp.asarray, t) for t in trees]
        self.tw = [params_from_jax(t, _cfg, "cpu") for t in trees]
        self.jax = JaxEngine(_jcfg, self.jw[params],
                             sampling=JaxSampling(greedy=True),
                             **dict(ENGINE, **kw))
        self.port = ContinuousBatchingEngine(
            _cfg, self.tw[params], sampling=SamplingParams(greedy=True),
            device="cpu", **dict(ENGINE, **kw))
        # tokens each JAX row held when a swap recomputed it: the tokens
        # before were sampled under the old weights
        self.split = {}
        orig = self.jax._refill_rows_paged

        def recorded(entries):
            for rid, _ in entries:
                row = self.jax.rows[rid]
                self.split[row.req.qid] = len(row.generated)
            return orig(entries)

        self.jax._refill_rows_paged = recorded

    def both(self, fn):
        """``fn(engine, weights, module)`` on each side; returns the pair
        of results (JAX first)."""
        return (fn(self.jax, self.jw, jck), fn(self.port, self.tw, tck))

    def submit(self, qid, prompt, budget):
        self.jax.submit(JaxInput(
            qid=qid, prompt_ids=list(prompt), input_ids=list(prompt),
            gconfig=JaxGen(max_new_tokens=budget, greedy=True)))
        self.port.submit(APIGenerateInput(
            qid=qid, prompt_ids=list(prompt), input_ids=list(prompt),
            gconfig=GenerationHyperparameters(max_new_tokens=budget,
                                              greedy=True)))

    def step(self, n=1):
        for _ in range(n):
            self.jax.step()
            self.port.step()

    def run_until_done(self, max_steps=600):
        for eng in (self.jax, self.port):
            for _ in range(max_steps):
                if not eng.has_work:
                    break
                eng.step()
            assert not eng.has_work, "engine did not drain"

    def result(self, qid):
        """Both engines' outputs for ``qid``, held together; returns the
        port's."""
        ref = self.jax.wait_result(qid, timeout=5)
        got = self.port.wait_result(qid, timeout=5)
        assert got.output_ids == ref.output_ids
        np.testing.assert_allclose(got.output_logprobs, ref.output_logprobs,
                                   rtol=TOL, atol=TOL)
        assert (got.version_start, got.version_end, got.no_eos) == (
            ref.version_start, ref.version_end, ref.no_eos)
        n = len(ref.output_ids)
        k = self.split.get(qid)
        if k is None:  # no swap recomputed it: every token is of one version
            k = n if ref.version_start == ref.version_end else 0
        assert got.output_versions == (
            [ref.version_start] * k + [ref.version_end] * (n - k))
        return got


def _split(out):
    """Tokens sampled under the first version of ``out``."""
    return sum(v == out.version_start for v in out.output_versions)


# -- stage/commit API unit ------------------------------------------------------


def test_commit_without_stage_raises(trees):
    p = Pair(trees)
    for eng in (p.jax, p.port):
        with pytest.raises(RuntimeError, match="no staged weights"):
            eng.commit_staged()


def test_commit_version_mismatch_fails_before_flip(trees):
    """Committing a different version than was staged fails with nothing
    flipped; the tree stays staged and a correct commit works."""
    p = Pair(trees)
    p.both(lambda e, w, _: e.stage_weights(w[1], version=3))
    for eng in (p.jax, p.port):
        with pytest.raises(RuntimeError, match="v3"):
            eng.commit_staged(expected_version=4)
        assert eng.version == 0
        assert eng.staged_version == 3
    assert p.both(lambda e, w, _: e.commit_staged(expected_version=3)) == (0, 0)
    p.step()
    assert (p.jax.version, p.port.version) == (3, 3)


def test_discard_staged_drops_uncommitted_tree(trees):
    p = Pair(trees)
    p.both(lambda e, w, _: e.stage_weights(w[1], version=1))
    for eng in (p.jax, p.port):
        eng.discard_staged()
        assert eng.staged_version is None
        with pytest.raises(RuntimeError, match="no staged weights"):
            eng.commit_staged()


def test_stage_is_nonblocking_for_decode_and_commit_is_pointer_flip(trees):
    """Staging from another thread while the engine thread decodes, then a
    commit: a v0 prefix and a v1 tail, the swap counters attributing stage
    and pause time."""
    p = Pair(trees)
    prompt = [7, 8, 9]
    p.submit("q0", prompt, 100)
    p.step(3)
    for eng, w in ((p.jax, p.jw), (p.port, p.tw)):
        t = threading.Thread(target=eng.stage_weights, args=(w[1], 1))
        before = eng.decode_tokens_total if eng is p.port else None
        t.start()
        for _ in range(2):
            eng.step()  # decode goes on while the tree stages
        t.join()
        if before is not None:
            assert eng.decode_tokens_total > before
        assert eng.staged_version == 1
    assert p.both(lambda e, w, _: e.commit_staged(expected_version=1)) == (1, 1)
    p.run_until_done()
    out = p.result("q0")
    assert out.version_start == 0 and out.version_end == 1
    assert 0 < _split(out) < len(out.output_ids)
    stats = p.port.swap_stats()
    assert stats["swaps_total"] == 1 and stats["swaps_staged_total"] == 1
    assert stats["stage_s"] > 0.0 and stats["pause_s"] > 0.0
    assert {k: v for k, v in p.jax.swap_stats().items() if "_s" not in k} == {
        k: v for k, v in stats.items() if "_s" not in k}


def test_staged_commit_matches_full_reload_stream(trees):
    """A pointer-flip commit and a full reload at the same point emit the
    same stream."""

    def run(staged):
        p = Pair(trees)
        p.submit("q0", [11, 12, 13], 20)
        p.step(2)
        if staged:
            p.both(lambda e, w, _: e.stage_weights(w[1], version=1))
            n = p.both(lambda e, w, _: e.commit_staged(expected_version=1))
        else:
            n = p.both(lambda e, w, _: e.update_weights(w[1], version=1))
        assert n[0] == n[1]
        p.run_until_done()
        return p.result("q0").output_ids

    assert run(True) == run(False)


# -- interplay: chunked prefill / prefix cache -----------------------------------


def test_staged_commit_mid_chunked_prefill_restarts_fill_under_v1(trees):
    """A commit while a long prompt is mid chunked prefill restarts the
    fill under the new weights: its output matches a fresh engine on v1."""
    prompt = list(np.arange(90) % 50 + 6)  # 3 prefill chunks of 32
    p = Pair(trees)
    # a decoding row first, so fills advance one chunk per step
    p.submit("d0", [7, 8, 9], 60)
    p.step(2)
    p.submit("q0", prompt, 10)
    p.step()
    for eng in (p.jax, p.port):
        fill = next((f for f in eng._filling if f.targets), None)
        assert fill is not None and 0 < fill.fill_pos < len(prompt)
    p.both(lambda e, w, _: e.stage_weights(w[1], version=1))
    p.both(lambda e, w, _: e.commit_staged(expected_version=1))
    p.run_until_done()
    got = p.result("q0")
    p.result("d0")
    fresh = Pair(trees, params=1)
    fresh.submit("f0", prompt, 10)
    fresh.run_until_done()
    assert got.output_ids == fresh.result("f0").output_ids
    assert got.version_end == 1 and got.output_versions == [1] * len(
        got.output_ids)


def test_staged_commit_flushes_prefix_cache_and_fresh_replay_matches(trees):
    """The commit flushes the radix cache, and a turn after it matches a
    fresh engine on the new weights."""
    p = Pair(trees, prefix_cache=True, prefix_cache_min_tokens=1)
    conv = list(np.arange(40) % 50 + 6)
    p.submit("t0", conv, 8)
    p.run_until_done()
    first = p.result("t0")
    for eng in (p.jax, p.port):
        assert eng.prefix_cache_stats()["blocks_held"] > 0
    p.both(lambda e, w, _: e.stage_weights(w[1], version=1))
    p.both(lambda e, w, _: e.commit_staged(expected_version=1))
    p.step()
    for eng in (p.jax, p.port):
        assert eng.prefix_cache_stats()["blocks_held"] == 0
        assert eng.prefix_cache_stats()["flushes_total"] == 1
    conv2 = conv + list(first.output_ids) + [11, 12, 13]
    p.submit("t1", conv2, 8)
    p.run_until_done()
    got = p.result("t1")
    fresh = Pair(trees, params=1, prefix_cache=True)
    fresh.submit("f1", conv2, 8)
    fresh.run_until_done()
    assert got.output_ids == fresh.result("f1").output_ids


# -- staged restore through a published snapshot -----------------------------------


def test_stage_from_published_snapshot_chunked(tmp_path, trees):
    """The staged pipeline through a published snapshot on each side (an
    orbax tree for the JAX engine, a safetensors file for the port):
    manifest validation, chunked restore onto the engine's tree, stage,
    commit."""
    p = Pair(trees)

    def publish(eng, w, ck):
        snap = str(tmp_path / ("port" if ck is tck else "jax") / "v1")
        ck.save_params(w[1], snap)
        ck.write_manifest(w[1], snap, version=1)
        return snap

    snaps = p.both(publish)
    p.submit("q0", [21, 22, 23, 24], 60)
    p.step(2)
    for eng, ck, snap in ((p.jax, jck, snaps[0]), (p.port, tck, snaps[1])):
        manifest = ck.read_manifest(snap)
        assert manifest is not None and manifest["version"] == 1
        assert ck.validate_manifest(eng.params, manifest) == []
        restored = ck.load_params_staged(eng.params, snap,
                                         chunk_bytes=16 * 1024)
        # the port's server stages a restored tree as its own (no copy)
        eng.stage_weights(restored, version=1,
                          **({"owned": True} if eng is p.port else {}))
    assert p.both(lambda e, w, _: e.commit_staged(expected_version=1)) == (1, 1)
    p.run_until_done()
    out = p.result("q0")
    assert out.version_end == 1 and _split(out) < len(out.output_ids)


def test_stage_keeps_an_owned_tree_and_copies_a_borrowed_one(tmp_path, trees):
    """An owned tree (a restored snapshot) is staged as it is; a tree the
    caller still holds is copied, so the caller's in-place updates (a
    trainer's AdamW) never reach the staged version."""
    p = Pair(trees)
    eng = p.port
    tck.save_params(p.tw[1], str(tmp_path / "v1"))
    owned = tck.load_params_like(eng.params, str(tmp_path / "v1"))
    eng.stage_weights(owned, version=1, owned=True)
    for (_, a), (_, b) in zip(tck._flatten(eng._staged_params),
                              tck._flatten(owned)):
        assert a is b
    borrowed = params_from_jax(trees[1], _cfg, "cpu")
    eng.stage_weights(borrowed, version=2)
    before = [t.clone() for _, t in tck._flatten(borrowed)]
    for _, t in tck._flatten(borrowed):
        t.add_(1.0)
    for (_, a), want in zip(tck._flatten(eng._staged_params), before):
        assert torch.equal(a, want)


def test_manifest_mismatch_detected_before_restore(tmp_path, trees):
    """A snapshot of another architecture is reported by both packages'
    ``validate_manifest`` before any restore."""
    other_jcfg = tiny_config(vocab_size=32, max_position_embeddings=128,
                             hidden_dim=16)
    other = jt.init_params(other_jcfg, jax.random.PRNGKey(7))
    p = Pair(trees)
    tck.save_params(p.tw[1], str(tmp_path / "port"))
    tck.write_manifest(p.tw[1], str(tmp_path / "port"), version=1)
    jck.save_params(p.jw[1], str(tmp_path / "jax"))
    jck.write_manifest(p.jw[1], str(tmp_path / "jax"), version=1)
    for ck, tmpl, snap in (
        (jck, other, "jax"),
        (tck, params_from_jax(jax.device_get(other), port_config(other_jcfg),
                              "cpu"), "port"),
    ):
        problems = ck.validate_manifest(
            tmpl, ck.read_manifest(str(tmp_path / snap)))
        assert problems, "shape mismatches must be reported"
        assert any("mismatch" in s or "missing" in s for s in problems)


# -- stale stages, idempotent commit retries -----------------------------------------


def test_stale_stage_is_dropped_not_parked(trees):
    """A stage that lands after the round already converged by a full
    reload (same or newer version) is dropped."""
    p = Pair(trees)
    p.both(lambda e, w, _: e.update_weights(w[1], version=2))
    p.step()
    for eng, w in ((p.jax, p.jw), (p.port, p.tw)):
        assert eng.version == 2
        eng.stage_weights(w[0], version=1)  # late stale stage
        assert eng.staged_version is None
        eng.stage_weights(w[0], version=2)  # same version: also stale
        assert eng.staged_version is None
        eng.stage_weights(w[0], version=3)  # newer: kept
        assert eng.staged_version == 3


def test_full_reload_apply_discards_older_staged_tree(trees):
    p = Pair(trees)
    p.both(lambda e, w, _: e.stage_weights(w[1], version=1))
    p.both(lambda e, w, _: e.update_weights(w[1], version=2))
    p.step()  # applies the full reload
    for eng in (p.jax, p.port):
        assert eng.version == 2
        assert eng.staged_version is None
        with pytest.raises(RuntimeError, match="no staged weights"):
            eng.commit_staged()


def test_commit_retry_after_lost_reply_is_idempotent(trees):
    """A commit whose reply was lost is retried; the retry is acknowledged
    (before and after the engine applied it), and a different version with
    nothing staged is still an error."""
    from areal_tpu.base import logging_ as jlogging
    from areal_tpu.system.generation_server import (
        GenerationServerWorker as JaxServer,
    )
    from areal_tpu_torch.base import logging_ as tlogging
    from areal_tpu_torch.system.generation_server import (
        GenerationServerWorker,
    )

    p = Pair(trees)
    servers = []
    for cls, eng, log in ((JaxServer, p.jax, jlogging),
                          (GenerationServerWorker, p.port, tlogging)):
        srv = cls.__new__(cls)
        srv.engine = eng
        srv._staging = None
        srv.logger = log.getLogger("test-gsw")
        servers.append(srv)
    p.both(lambda e, w, _: e.stage_weights(w[1], version=5))
    for srv in servers:
        assert srv._commit_staged({"version": 5}) == 0  # first commit
        assert srv.engine.pending_version == 5
        assert srv._commit_staged({"version": 5}) == 0  # retry before apply
    p.step()
    for srv in servers:
        assert srv.engine.version == 5
        assert srv._commit_staged({"version": 5}) == 0  # retry after apply
        with pytest.raises(RuntimeError, match="no staged weights"):
            srv._commit_staged({"version": 6})


def test_concurrent_stages_and_commits_never_mix_versions(trees):
    """Stress: sixteen threads stage, commit and discard trees of many
    versions while the engine thread decodes, with a short switch
    interval.  Whatever interleaving happens, the served weights always
    are the tree of the served version, and a staged tree always is the
    tree of the staged version (each version's final-norm scale holds its
    number)."""
    import sys
    import time

    base = params_from_jax(trees[0], _cfg, "cpu")

    def tree_of(v):
        t = dict(base, final_norm=dict(base["final_norm"]))
        t["final_norm"]["scale"] = torch.full_like(
            base["final_norm"]["scale"], float(v))
        return t

    versions = list(range(1, 65))
    eng = ContinuousBatchingEngine(
        _cfg, tree_of(0), sampling=SamplingParams(greedy=True),
        device="cpu", **ENGINE)
    eng.submit(APIGenerateInput(
        qid="q", prompt_ids=[7, 8, 9], input_ids=[7, 8, 9],
        gconfig=GenerationHyperparameters(max_new_tokens=120)))
    stop = threading.Event()
    errors = []

    def worker(i):
        rng = np.random.default_rng(i)
        try:
            while not stop.is_set():
                v = int(rng.choice(versions))
                eng.stage_weights(tree_of(v), v)
                op = rng.random()
                if op < 0.5:
                    try:
                        eng.commit_staged(expected_version=v)
                    except RuntimeError:
                        pass  # another thread restaged or committed first
                elif op < 0.6:
                    eng.discard_staged()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def scale(tree):
        return float(tree["final_norm"]["scale"][0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 4.0
        applied = 0
        while time.monotonic() < deadline:
            eng.step()
            assert scale(eng.params) == eng.version
            with eng._lock:
                if eng._staged_params is not None:
                    assert scale(eng._staged_params) == eng._staged_version
                if eng._new_params is not None:
                    assert scale(eng._new_params[0]) == eng._new_params[1]
            applied = eng.swaps_total
            if not eng.has_work:
                eng.submit(APIGenerateInput(
                    qid=f"q{applied}-{eng._step_seq}", prompt_ids=[7, 8, 9],
                    input_ids=[7, 8, 9],
                    gconfig=GenerationHyperparameters(max_new_tokens=120)))
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert applied > 0 and eng.swaps_staged_total == applied
    while eng.has_work:
        eng.step()
    assert scale(eng.params) == eng.version
    assert eng.close() == {}
