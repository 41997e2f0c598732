"""The fleet KV fabric (peer prefix pulls) in the torch port against the JAX
package's (``tests/system/test_kv_fabric.py``'s scenarios), on the CPU.

A target engine gets a request whose metadata names ``kv_source`` (the
owner of a longer cached prefix, as the gserver manager's schedule answer
does); it registers a pull, the owner's ``export_prefix`` answers with
numbered segments, and the target imports them (``import_prefix_segment``)
before it prefills the rest, as the generation server pumps them.  Each
scenario runs on two JAX engines and on two port engines on the same
weights: equal tokens, logprobs within 1e-4, equal pull counters, reject
reasons and prefill work, and both of the port's pools whole at the end.
Also here: ``export_walk`` op by op against the reference over both
tiers, and the pulled bytes bit-identical through the import (int8 pools:
four components, no requantization).
"""

import numpy as np
import pytest

from areal_tpu.engine.prefix_cache import RadixPrefixCache as JaxCache
from areal_tpu_torch.engine.prefix_cache import RadixPrefixCache
from tests.test_torch_pd_handoff import (  # noqa: F401 - fixtures
    TOL,
    _np,
    _one_torch_thread,
    assert_pristine,
    both,
    collect,
    drain,
    model,
    same_runs,
    stats,
)

PROMPT0 = list(np.arange(40) % 40 + 6)
EXTRA = [7, 9, 11, 13, 15, 17, 19, 21]


def pump_pull(target, owner, fail=None, on_segment=None, max_steps=600):
    """Step the target until it drains, serving its pull intents from the
    owner (the server's ``_pump_prefix_pulls`` in one thread).
    ``fail(preq)`` replaces the owner's RPC; ``on_segment(i, seg) -> bool``
    may take a segment over (False skips the default import)."""
    for _ in range(max_steps):
        if not target.has_work:
            return
        target.step()
        for preq in target.drain_prefix_pull_requests():
            if fail is not None:
                fail(preq)
                continue
            segs = owner.export_prefix(preq["qid"], preq["tokens"])
            if not segs:
                target.prefix_pull_failed(preq["qid"], "miss")
                continue
            for i, seg in enumerate(segs):
                if on_segment is not None and not on_segment(i, seg):
                    continue
                ok, _ = target.import_prefix_segment(seg)
                if not ok:
                    break
    raise AssertionError("target did not drain")


def turn0(pkg, eng, qid="c@t0", max_new=8):
    eng.submit(pkg.req(qid, PROMPT0, max_new))
    drain(eng)
    return collect(eng, qid)[0]


def answer(pkg, eng, conv, qid="c@t1", source=None):
    """Submit ``conv`` (naming ``source`` as its ``kv_source``) and return
    its (tokens, logprobs) once the engine drains, pulls served by
    nobody."""
    eng.submit(pkg.req(qid, conv, 8, {"kv_source": source} if source else None))
    drain(eng)
    return collect(eng, qid)[:2]


def fabric_pair(pkg, **target_kw):
    owner = pkg.engine()
    target = pkg.engine(prefix_pull_min_tokens=8, **target_kw)
    owner.park_ttl_steps = target.park_ttl_steps = 0
    return owner, target


def conversation(pkg):
    """Turn 1 of the conversation (turn 0's prompt and answer and a user
    suffix) and its tokens on a fresh engine, the fallback's reference."""
    out0 = turn0(pkg, pkg.engine())
    conv = PROMPT0 + out0 + EXTRA
    fresh = pkg.engine()
    return out0, conv, answer(pkg, fresh, conv)


def pull_run(target, owner=None):
    run = dict(target=stats(target))
    if owner is not None:
        run["owner"] = stats(owner)
        run["owner_cache"] = owner.prefix_cache_stats()
    return run


# -- the export walk, op by op ---------------------------------------------------


class _Log:
    def __init__(self):
        self.calls = []

    def acquire(self, blocks):
        self.calls.append(("acquire", list(blocks)))

    def release(self, blocks):
        self.calls.append(("release", list(blocks)))


def _cache_pair(page, capacity, host_blocks):
    """The two packages' caches with the same settings and a host tier;
    each fetch returns the blocks' ids as their payload (numpy on one side,
    torch on the other)."""
    import torch

    out = []
    for cls, lib in ((JaxCache, np), (RadixPrefixCache, torch)):
        log = _Log()

        def fetch(blocks, lib=lib):
            ids = (np.asarray(blocks, np.int64) if lib is np
                   else torch.tensor(blocks, dtype=torch.int64))
            return ids * 10, ids * 10 + 1

        out.append((cls(page_size=page, capacity_blocks=capacity,
                        acquire=log.acquire, release=log.release,
                        host_bytes_budget=host_blocks * 8, block_bytes=8,
                        spill_fetch=fetch), log))
    return out


def _walk_view(entries):
    return [(k, v if k == "device" else [int(a) for a in v])
            for k, v in entries]


def test_export_walk_matches_the_reference():
    """On one seeded trace of inserts, spilling evictions, restores and
    walks, ``export_walk`` returns the reference's entries (resident blocks
    by id, spilled ones by their payload) and stops where it stops; the
    LRU order it refreshes gives the same later evictions, and the stats
    and allocator calls stay equal (a walk counts no hit or miss)."""
    caches = _cache_pair(page=4, capacity=12, host_blocks=5)
    rng = np.random.default_rng(5)
    bases = [rng.integers(0, 7, 30).tolist() for _ in range(3)]
    nxt, walks = 100, 0
    for step in range(1, 90):
        seq = bases[int(rng.integers(0, 3))][: int(rng.integers(6, 30))]
        op = step % 5
        k = int(rng.integers(1, 4))
        blocks = list(range(nxt, nxt + -(-len(seq) // 4)))
        nxt += 40
        views = []
        for c, log in caches:
            walk = None
            if op == 0:
                c.insert(seq, blocks, step=step, version=c.version)
            elif op == 1:
                c.evict(k)
            elif op == 2:
                m = c.match(seq, step=step, record=False)
                if m.restore_nodes:
                    c.begin_restore(m.restore_nodes)
                    c.complete_restore(
                        m.restore_nodes, blocks[: len(m.restore_nodes)],
                        ready_step=step + 2)
            else:
                walk = _walk_view(c.export_walk(seq, step=step))
            views.append((walk, c.stats(), list(log.calls)))
        assert views[0] == views[1], step
        walks += bool(views[0][0])
    assert walks > 5


def test_export_walk_stops_at_gaps():
    """The walk stops at a spilled node whose payload was trimmed and at a
    restore not usable yet, exports spilled nodes from the host, and is
    capped at ``len(tokens) - 1``, as the reference's."""
    out = []
    for c, log in _cache_pair(page=2, capacity=8, host_blocks=1):
        toks = [1, 2, 3, 4, 5, 6, 7]
        c.insert(toks, [10, 11, 12, 13], step=1, version=0)
        walks = [_walk_view(c.export_walk(toks, step=2)),
                 _walk_view(c.export_walk(toks[:5], step=2))]
        c.evict(2)  # one node spills, the budget trims or drops the other
        walks.append(_walk_view(c.export_walk(toks, step=3)))
        m = c.match(toks, step=4, record=False)
        if m.restore_nodes:
            c.begin_restore(m.restore_nodes)
            c.complete_restore(m.restore_nodes, [20] * len(m.restore_nodes),
                               ready_step=6)
        walks.append(_walk_view(c.export_walk(toks, step=5)))
        walks.append(_walk_view(c.export_walk(toks, step=6)))
        out.append((walks, c.stats(), log.calls))
    assert out[0] == out[1]
    walks = out[1][0]
    assert [k for k, _ in walks[0]] == ["device"] * 3
    assert [k for k, _ in walks[1]] == ["device"] * 2


# -- pulls between engines -------------------------------------------------------


def test_peer_pull_parity_and_prefill_savings(model):
    """The pulled-prefix answer equals the owner's local hit and a fresh
    prefill, and the target prefills only the suffix it did not pull; the
    counters equal the JAX engines'."""
    runs = []
    for pkg in both(model):
        out0, conv, (ref, ref_lp) = conversation(pkg)
        uni = pkg.engine()
        assert turn0(pkg, uni) == out0
        assert answer(pkg, uni, conv)[0] == ref
        owner, target = fabric_pair(pkg)
        assert turn0(pkg, owner) == out0
        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner)
        got, lp, _ = collect(target, "c@t1")
        assert got == ref
        np.testing.assert_allclose(lp, ref_lp, rtol=TOL, atol=TOL)
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 1 and st["pull_bytes_total"] > 0
        assert st["pull_rejects"] == {} and st["pending_pulls"] == 0
        assert target.prefill_tokens_total <= len(conv) - 40
        assert target.prefix_cache_stats()["hits_total"] >= 1
        run = dict(pull_run(target, owner), tokens=got, logp=lp)
        assert_pristine(pkg, target)
        assert_pristine(pkg, owner)
        runs.append((pkg.name, run))
    same_runs(runs)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_pulled_bytes_bit_identical_through_import(model, kv):
    """The pulled blocks the target's cache matches equal the concatenated
    segment payloads bit for bit (an int8 pool's four components); the
    segments' payloads equal the JAX owner's (float32 within 1e-4; int8
    codes and scales exactly but for rounding ties)."""
    sent = {}
    for pkg in both(model):
        owner = pkg.engine(kv_cache_dtype=kv)
        target = pkg.engine(kv_cache_dtype=kv, prefix_pull_min_tokens=8)
        owner.park_ttl_steps = target.park_ttl_steps = 0
        out0 = turn0(pkg, owner)
        conv = PROMPT0 + out0 + EXTRA
        segs = []

        def keep(i, seg):
            segs.append(seg)
            ok, reason = target.import_prefix_segment(seg)
            assert ok, reason
            return False

        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, on_segment=keep)
        assert len(segs) >= 2
        assert len(segs[0]["payload"]) == (4 if kv == "int8" else 2)
        m = target._prefix_cache.match(conv, step=target._step_seq,
                                       record=False)
        total = sum(s["n_blocks"] for s in segs)
        assert len(m.blocks) >= total
        back = pkg.gather(target, m.blocks[:total])
        wire = [np.concatenate([_np(s["payload"][c]) for s in segs])
                for c in range(len(back))]
        for a, b in zip(wire, back):
            np.testing.assert_array_equal(a, b)
        sent[pkg.name] = wire
        assert_pristine(pkg, target)
    for j, t in zip(sent["jax"], sent["port"]):
        if kv == "int8" and np.all(j == np.round(j)) and np.abs(j).max() > 1:
            assert np.mean(j != t) < 1e-3 and np.max(np.abs(j - t)) <= 1
        else:
            np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_pull_segment_version_skew_fails_closed(model):
    """A segment of another weight version is rejected (``version``), the
    partial blocks are freed and the admission prefills the same answer."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, _) = conversation(pkg)
        owner, target = fabric_pair(pkg)
        turn0(pkg, owner)
        free0 = target.free_pool_blocks
        replies = []

        def skew_after_first(i, seg):
            if i == 0:
                replies.append(target.import_prefix_segment(seg))
                assert target.free_pool_blocks < free0
            elif i == 1:
                replies.append(target.import_prefix_segment(
                    dict(seg, version=99)))
            return False

        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, on_segment=skew_after_first)
        got = collect(target, "c@t1")[0]
        assert got == ref and replies == [(True, ""), (False, "version")]
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 0 and st["pending_pulls"] == 0
        assert st["pull_rejects"] == {"version": 1}
        assert target.prefill_tokens_total >= len(conv) - 8
        run = dict(pull_run(target), tokens=got, replies=replies)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)


def test_pull_racing_a_weight_swap_fails_closed(model):
    """A swap on the target mid-pull fails the pull (``version``), a late
    segment bounces off the settled record (``stream``), and the answer
    is prefilled under the new weights."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, _) = conversation(pkg)
        owner, target = fabric_pair(pkg)
        turn0(pkg, owner)
        tree = pkg.params()
        replies = []

        def swap_after_first(i, seg):
            replies.append(target.import_prefix_segment(seg))
            if i == 0:
                target.update_weights(tree, 1)
                target.step()
                assert target.prefix_peer_pull_rejects.get("version") == 1
            return False

        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, on_segment=swap_after_first)
        got = collect(target, "c@t1")[0]
        assert got == ref and replies[0] == (True, "")
        assert all(not ok for ok, _ in replies[1:])
        assert target.prefix_peer_stats()["pulls_total"] == 0
        assert target.prefill_tokens_total >= len(conv) - 8
        run = dict(pull_run(target), tokens=got, replies=replies)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)


@pytest.mark.parametrize("owner_state", ["dead", "cold"])
def test_pull_from_a_dead_or_cold_owner_prefills(model, owner_state):
    """The owner's RPC fails (``rpc``) or its cache is empty (``miss``): the
    pull settles at once and the next admission prefills the same answer;
    nothing leaks."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, _) = conversation(pkg)
        owner, target = fabric_pair(pkg)

        def dead(preq):
            target.prefix_pull_failed(preq["qid"], "rpc")

        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, fail=dead if owner_state == "dead" else None)
        got = collect(target, "c@t1")[0]
        assert got == ref
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 0 and st["pending_pulls"] == 0
        assert st["pull_rejects"] == {
            "rpc" if owner_state == "dead" else "miss": 1}
        run = dict(pull_run(target), tokens=got)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)


def test_stalled_pull_expires_under_the_ttl(model):
    """Only segment 0 arrives: the TTL sweep fails the pull (``expired``),
    frees the blocks segment 0 took, and the admission prefills."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, _) = conversation(pkg)
        owner, target = fabric_pair(pkg)
        turn0(pkg, owner)
        target.handoff_pending_ttl_steps = 3
        held = []

        def only_seg0(i, seg):
            if i == 0:
                target.import_prefix_segment(seg)
                held.append(target.n_blocks - target.free_pool_blocks)
                if pkg.port:
                    assert target.close() == {}  # the pull's blocks count
            return False

        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, on_segment=only_seg0)
        got = collect(target, "c@t1")[0]
        assert got == ref and held and held[0] > 0
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 0 and st["pending_pulls"] == 0
        assert st["pull_rejects"] == {"expired": 1}
        run = dict(pull_run(target), tokens=got, held=held)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)


def test_pull_skipped_when_the_local_prefix_is_long(model):
    """A target that already holds most of the prefix consumes the hint and
    registers no pull (the gap is under ``prefix_pull_min_tokens``); its
    cache serves the prefix."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, _) = conversation(pkg)
        owner = pkg.engine()
        target = pkg.engine(prefix_pull_min_tokens=32)
        owner.park_ttl_steps = target.park_ttl_steps = 0
        turn0(pkg, owner)
        turn0(pkg, target, qid="local@t0")
        seen = []
        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner, fail=seen.append)
        got = collect(target, "c@t1")[0]
        assert seen == [] and got == ref
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 0 and st["pending_pulls"] == 0
        assert target.prefix_cache_stats()["hits_total"] >= 1
        run = dict(pull_run(target), tokens=got)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)


def test_pull_from_the_spilled_tier(model):
    """A prefix the owner spilled to host memory exports from the host
    payloads (nothing restored on the owner), and the pulled answer equals
    a fresh prefill's."""
    runs = []
    for pkg in both(model):
        _, conv, (ref, ref_lp) = conversation(pkg)
        owner = pkg.engine(prefix_cache_host_bytes=1 << 24)
        owner.park_ttl_steps = 0
        turn0(pkg, owner)
        owner.step()
        owner.step()  # the TTL releases the parked row
        owner._prefix_cache.evict(owner.prefix_cache_stats()["blocks_held"])
        assert owner.prefix_cache_stats()["host_blocks_held"] > 0
        target = pkg.engine(prefix_pull_min_tokens=8)
        target.park_ttl_steps = 0
        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner)
        got, lp, _ = collect(target, "c@t1")
        assert got == ref
        np.testing.assert_allclose(lp, ref_lp, rtol=TOL, atol=TOL)
        st = target.prefix_peer_stats()
        assert st["pulls_total"] == 1 and st["pull_rejects"] == {}
        assert target.prefill_tokens_total <= len(conv) - 40
        assert owner.prefix_cache_stats()["restored_blocks_total"] == 0
        run = dict(pull_run(target, owner), tokens=got, logp=lp)
        assert_pristine(pkg, target)
        assert_pristine(pkg, owner)
        runs.append((pkg.name, run))
    same_runs(runs)


@pytest.mark.slow  # int8 arm: the reference marks its quantized arms slow
def test_peer_pull_int8_greedy_parity(model):
    """On int8 pools the pulled-prefix answer equals the int8 unified
    engine's continuation and the JAX engines'."""
    runs = []
    for pkg in both(model):
        uni = pkg.engine(kv_cache_dtype="int8")
        out0 = turn0(pkg, uni)
        conv = PROMPT0 + out0 + EXTRA
        ref = answer(pkg, uni, conv)[0]
        owner = pkg.engine(kv_cache_dtype="int8")
        target = pkg.engine(kv_cache_dtype="int8", prefix_pull_min_tokens=8)
        owner.park_ttl_steps = target.park_ttl_steps = 0
        turn0(pkg, owner)
        target.submit(pkg.req("c@t1", conv, 8, {"kv_source": "OWNER"}))
        pump_pull(target, owner)
        got = collect(target, "c@t1")[0]
        assert got == ref
        assert target.prefix_peer_stats()["pulls_total"] == 1
        run = dict(pull_run(target), tokens=got)
        assert_pristine(pkg, target)
        runs.append((pkg.name, run))
    same_runs(runs)
