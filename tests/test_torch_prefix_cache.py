"""The radix prefix cache, group-prompt block sharing, parking and
preemption of the torch port's engine, against the JAX package's.

* ``RadixPrefixCache``: numpy-seeded sequences of ``insert``, ``match``,
  ``record``, ``evict``, ``evict_one`` and ``flush`` on the port's copy
  and on the reference give equal matches, evictions, allocator calls
  and ``stats()``.
* ``copy_blocks``: bit-identical to the reference's on int8 pools (scales
  included) and on float32 pools.
* The engines, both with the prefix cache on, on the scenarios of the
  reference's own engine tests: a group fill, a multi-turn replay, a
  retried request, park and resume, a weight swap that flushes the cache,
  a weight swap while a group decodes over its shared blocks, and a
  160-token pool that forces preemption.  Token ids are equal,
  logprobs within 1e-4, and the work counters and cache stats equal.
  Every scenario ends with the refcount audit of ``close()`` and a whole
  pool once the parked rows are released and the cache flushed.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.model_api import APIGenerateInput as JaxInput
from areal_tpu.api.model_api import GenerationHyperparameters as JaxGen
from areal_tpu.engine import prefix_cache as jcache
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
from areal_tpu_torch.engine import prefix_cache as tcache
from areal_tpu_torch.engine.inference_server import (
    ContinuousBatchingEngine,
    _Fill,
)
from areal_tpu_torch.engine.sampling import SamplingParams
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 5
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the radix index, op by op against the reference --------------------------


class _Log:
    """Allocator double recording every call the cache makes."""

    def __init__(self):
        self.calls = []

    def acquire(self, blocks):
        self.calls.append(("acquire", list(blocks)))

    def release(self, blocks):
        self.calls.append(("release", list(blocks)))


def _match_fields(m):
    return (list(m.blocks), m.n_tokens, m.tail_block, m.tail_tokens)


@pytest.mark.parametrize("seed", range(6))
def test_radix_cache_matches_reference(seed):
    rng = np.random.default_rng(seed)
    page = int(rng.choice([2, 3, 4]))
    capacity = int(rng.choice([4, 8, 64]))
    min_match = int(rng.choice([1, 1, 3]))
    logs = (_Log(), _Log())
    caches = [
        mod.RadixPrefixCache(page_size=page, capacity_blocks=capacity,
                             acquire=log.acquire, release=log.release,
                             min_match_tokens=min_match)
        for mod, log in zip((jcache, tcache), logs)
    ]
    seqs = [[]]
    next_block = 0
    step = 0
    for _ in range(300):
        step += int(rng.integers(0, 3))
        op = rng.choice(["insert", "match", "match_record", "evict",
                         "evict_one", "flush"], p=[.35, .25, .2, .1, .07, .03])
        if op == "insert":
            # extend a known sequence (prefix overlaps) over a 3-token
            # alphabet (shared full blocks and tails)
            base = seqs[int(rng.integers(len(seqs)))]
            seq = base[: int(rng.integers(0, len(base) + 1))] + rng.integers(
                0, 3, int(rng.integers(1, 3 * page + 2))).tolist()
            seqs.append(seq)
            n_blocks = -(-len(seq) // page) - int(rng.integers(0, 2))
            blocks = list(range(next_block, next_block + n_blocks))
            next_block += n_blocks
            version = caches[0].version - int(rng.random() < 0.1)
            got = [c.insert(seq, blocks, step=step, version=version)
                   for c in caches]
        elif op in ("match", "match_record"):
            base = seqs[int(rng.integers(len(seqs)))]
            seq = base[: int(rng.integers(0, len(base) + 1))] + rng.integers(
                0, 3, int(rng.integers(0, 3))).tolist()
            record = op == "match" and bool(rng.random() < 0.5)
            ms = [c.match(seq, step=step, record=record) for c in caches]
            got = [_match_fields(m) for m in ms]
            if op == "match_record":
                for c, m in zip(caches, ms):
                    c.record(m)
        elif op == "evict":
            n = int(rng.integers(1, 4))
            protect = step if rng.random() < 0.3 else None
            got = [c.evict(n, protect_step=protect) for c in caches]
        elif op == "evict_one":
            got = [c.evict_one() for c in caches]
        else:
            version = None if rng.random() < 0.5 else step + 100
            got = [c.flush(new_version=version) for c in caches]
        assert got[0] == got[1], (op, got)
        assert logs[0].calls == logs[1].calls, op
        assert caches[0].stats() == caches[1].stats(), op
    # the sequence exercised every outcome
    st = caches[1].stats()
    assert st["hits_total"] and st["misses_total"] and st["evictions_total"]
    # the port's held blocks are the references its allocator took
    held = {}
    for kind, blocks in logs[1].calls:
        for b in blocks:
            held[b] = held.get(b, 0) + (1 if kind == "acquire" else -1)
    assert sorted(caches[1].held_blocks()) == sorted(
        b for b, n in held.items() for _ in range(n))


# -- copy_blocks ----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "auto"])
def test_copy_blocks_bit_identical(kv_dtype):
    jcfg = tiny_config(vocab_size=64)
    L, NB, Hkv, BS, hd = jcfg.n_layers, 9, jcfg.n_kv_heads, 4, jcfg.head_dim
    rng = np.random.default_rng(7)
    shape = (L, NB, Hkv, BS, hd)
    if kv_dtype == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.standard_normal(shape[:-1]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)] + [None, None]
    src, dst = np.array([3, 0, 7], np.int32), np.array([5, 8, 1], np.int32)
    jout = jpaged.copy_blocks(
        *(jnp.asarray(p) for p in pools[:2]), jnp.asarray(src),
        jnp.asarray(dst),
        **({} if pools[2] is None else dict(k_scale=jnp.asarray(pools[2]),
                                            v_scale=jnp.asarray(pools[3]))),
    )
    tp = [None if p is None else torch.from_numpy(p.copy()) for p in pools]
    tpaged.copy_blocks(tp[0], tp[1], torch.from_numpy(src).long(),
                       torch.from_numpy(dst).long(), tp[2], tp[3])
    got = [t for t in tp if t is not None]
    assert len(got) == len(jout)
    for a, b in zip(got, jout):
        want = np.asarray(b)
        assert a.numpy().dtype == want.dtype
        assert a.numpy().tobytes() == want.tobytes()
    # the copies landed and nothing else moved
    for a, p in zip(got, pools):
        a = a.numpy()
        assert np.array_equal(a[:, dst], p[:, src])
        keep = np.setdiff1d(np.arange(NB), dst)
        assert np.array_equal(a[:, keep], p[:, keep])


# -- the engines ----------------------------------------------------------------

ENGINE = dict(
    max_batch=4, kv_cache_len=256, chunk_size=4, stop_tokens=(EOS,),
    cache_mode="paged", page_size=8, prefill_chunk_tokens=16,
)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=512)
    trees = [
        jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
        for s in (0, 42)
    ]
    return jcfg, port_config(jcfg), trees


class _Side:
    """One engine and the request type it takes, behind one interface, so
    a scenario drives the JAX engine and the port's the same way."""

    def __init__(self, kind, model, **kw):
        jcfg, cfg, trees = model
        self.kind = kind
        if kind == "jax":
            self.eng = JaxEngine(
                jcfg, jax.tree.map(jnp.asarray, trees[0]),
                sampling=JaxSampling(greedy=True), prefix_cache=True,
                **dict(ENGINE, **kw),
            )
        else:
            self.eng = ContinuousBatchingEngine(
                cfg, params_from_jax(trees[0], cfg, "cpu"),
                sampling=SamplingParams(greedy=True), device="cpu",
                prefix_cache=True, **dict(ENGINE, **kw),
            )
        self._params = [
            jax.tree.map(jnp.asarray, t) if kind == "jax"
            else params_from_jax(t, cfg, "cpu")
            for t in trees
        ]

    def submit(self, qid, prompt, max_new):
        prompt = [int(t) for t in prompt]
        if self.kind == "jax":
            req = JaxInput(qid=qid, prompt_ids=prompt, input_ids=prompt,
                           gconfig=JaxGen(max_new_tokens=max_new, greedy=True))
        else:
            req = APIGenerateInput(
                qid=qid, prompt_ids=prompt, input_ids=prompt,
                gconfig=GenerationHyperparameters(max_new_tokens=max_new))
        self.eng.submit(req)

    def run(self, max_steps=2000):
        for _ in range(max_steps):
            if not self.eng.has_work:
                return
            self.eng.step()
        raise AssertionError("engine did not drain")

    def result(self, qid):
        return self.eng.wait_result(qid, timeout=10)

    def swap(self, i, version):
        self.eng.update_weights(self._params[i], version=version)

    def counters(self):
        e = self.eng
        return dict(
            prefill_tokens_total=e.prefill_tokens_total,
            prefill_calls=e.prefill_calls,
            resumed_total=e.resumed_total,
            preempted_total=e.preempted_total,
            n_parked=e.n_parked,
            free_pool_blocks=e.free_pool_blocks,
            cache=e.prefix_cache_stats(),
        )


def _group_fill(side):
    prompt = list(np.arange(33) % 50 + 6)
    for i in range(4):
        side.submit(f"g-{i}", prompt, 4)
    side.eng._admit_paged()
    fills = side.eng._filling
    # the four requests joined ONE fill
    assert len(fills) == 1 and len(fills[0].targets) == 4
    side.run()
    return [side.result(f"g-{i}") for i in range(4)]


def _multi_turn(side, tag="conv", n_turns=3, user_len=9, max_new=7):
    """Each turn re-sends the whole conversation under a fresh qid."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    conv = list(rng.integers(6, 60, (user_len,)))
    outs = []
    for j in range(n_turns):
        side.submit(f"{tag}@t{j}", conv, max_new)
        side.run()
        out = side.result(f"{tag}@t{j}")
        outs.append(out)
        conv = conv + list(out.output_ids) + list(
            rng.integers(6, 60, (user_len,)))
    return outs


def _retry(side):
    side.eng.park_ttl_steps = 0
    prompt = list(np.arange(20) % 40 + 6)
    side.submit("r0", prompt, 6)
    side.run()
    first = side.result("r0")
    side.eng.step()  # releases the parked row: only the cache can help
    side.submit("r0-retry", prompt, 6)
    side.run()
    return [first, side.result("r0-retry")]


def _park_resume(side):
    prompt = list(np.arange(19) % 37 + 7)
    side.submit("p", prompt, 6)
    side.run()
    outs = [side.result("p")]
    for _ in range(2):
        # the continuation: the same qid, the whole sequence so far
        prompt = prompt + list(outs[-1].output_ids)
        side.submit("p", prompt, 6)
        side.run()
        outs.append(side.result("p"))
    return outs


def _weight_swap(side):
    outs = _multi_turn(side, tag="swap", n_turns=1)
    # a row decoding through the swap: recomputed into its blocks
    side.submit("mid", list(np.arange(30) % 41 + 8), 24)
    for _ in range(4):
        side.eng.step()
    side.swap(1, version=1)
    side.eng.step()  # the swap applies between chunks
    st = side.eng.prefix_cache_stats()
    assert st["flushes_total"] == 1 and st["version"] == 1
    side.run()
    outs.append(side.result("mid"))
    return outs + _multi_turn(side, tag="swap2", n_turns=2)


def _group_swap(side):
    """A weight swap while a group decodes over its shared prompt blocks:
    every member's recompute writes the shared blocks' slots, each from
    one member only."""
    prompt = list(np.arange(35) % 50 + 6)
    for i in range(4):
        side.submit(f"gs-{i}", prompt, 20)
    for _ in range(3):
        side.eng.step()
    assert side.eng.n_decoding == 4
    side.swap(1, version=1)
    side.run()
    return [side.result(f"gs-{i}") for i in range(4)]


def _pressure(side):
    side.eng.park_ttl_steps = 0
    prompts = [list(np.arange(20) % 40 + 6 + i) for i in range(4)]
    outs = []
    for rep in range(2):  # the second wave hits the first wave's cache
        for i, p in enumerate(prompts):
            side.submit(f"w{rep}-{i}", p, 16)
        side.run()
        outs += [side.result(f"w{rep}-{i}") for i in range(4)]
    return outs


def _pressure_group(side):
    """A 160-token pool and a 4-member group sharing a prompt: the group's
    tails and growing rows preempt."""
    side.eng.park_ttl_steps = 0
    prompt = list(np.arange(21) % 40 + 9)
    for i in range(4):
        side.submit(f"pg-{i}", prompt, 48)
    side.run()
    return [side.result(f"pg-{i}") for i in range(4)]


SCENARIOS = {
    "group_fill": (_group_fill, {}),
    "multi_turn": (_multi_turn, {}),
    "retry": (_retry, {}),
    "park_resume": (_park_resume, {}),
    "weight_swap": (_weight_swap, {}),
    # fill chunks of 64 tokens hold two members' recomputes at once
    "group_swap": (_group_swap, dict(prefill_chunk_tokens=64)),
    "pool_pressure": (_pressure, dict(kv_cache_len=128, kv_pool_tokens=160)),
    "pool_pressure_group": (_pressure_group, dict(
        kv_cache_len=128, kv_pool_tokens=160, page_size=16, chunk_size=8)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_jax(model, name):
    fn, kw = SCENARIOS[name]
    ref_side, port_side = _Side("jax", model, **kw), _Side("port", model, **kw)
    ref, got = fn(ref_side), fn(port_side)
    assert [o.output_ids for o in got] == [o.output_ids for o in ref]
    assert [o.no_eos for o in got] == [o.no_eos for o in ref]
    assert [(o.version_start, o.version_end) for o in got] == [
        (o.version_start, o.version_end) for o in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)
    assert port_side.counters() == ref_side.counters()
    eng = port_side.eng
    if name == "group_fill":
        # one prefill of the unique prompt; three copied 33-token tails
        assert eng.prefill_tokens_total == 33 and eng.block_copies_total == 3
    if name in ("multi_turn", "retry"):
        st = eng.prefix_cache_stats()
        assert st["hits_total"] >= 1 and st["cached_tokens_total"] > 0
    if name == "park_resume":
        assert eng.resumed_total == 2 and eng.prefill_tokens_total == 19
    if name.startswith("pool_pressure"):
        assert eng.preempted_total >= 1
    # the refcount audit, then a whole pool once nothing holds blocks
    assert eng.close() == {}
    eng.park_ttl_steps = 0
    eng.step()
    eng._prefix_cache.flush()
    assert eng.n_parked == 0 and eng.close() == {}
    assert eng.free_pool_blocks == eng.n_blocks
    assert (eng._block_ref == 0).all()


def test_leak_audit_sees_a_lost_reference(model):
    """close() counts refcounts against the holders: a reference nobody
    holds, or a block freed while a row still holds it, is reported."""
    side = _Side("port", model)
    _group_fill(side)
    eng = side.eng
    assert eng.n_parked == 4 and eng.close() == {}
    shared = eng._row_blocks[0][0]
    eng._block_ref[shared] += 1  # a reference with no holder
    assert eng.close() == {"kv_blocks": 1}
    eng._block_ref[shared] -= 1
    held = eng._row_blocks[1].pop()  # a holder that forgot its block
    assert eng.close() == {"kv_blocks": 1}
    eng._row_blocks[1].append(held)
    assert eng.close() == {}


def test_store_mask_writes_each_shared_slot_once():
    """Rows sharing full blocks write each of their slots from the first
    sharer in the chunk only; a chunk whose rows write distinct slots
    needs no mask."""
    eng = ContinuousBatchingEngine(
        port_config(tiny_config(vocab_size=64)),
        params_from_jax(jax.device_get(jt.init_params(
            tiny_config(vocab_size=64), jax.random.PRNGKey(0))),
            port_config(tiny_config(vocab_size=64)), "cpu"),
        device="cpu", **dict(ENGINE, kv_cache_len=64),
    )
    toks = list(range(20))
    a = _Fill(key=(), tokens=toks, blocks=[3, 4, 5], targets=[])
    b = _Fill(key=(), tokens=toks, blocks=[3, 4, 6], targets=[])
    c = _Fill(key=(), tokens=toks[:9], blocks=[7, 8], targets=[])
    assert eng._store_mask([(a, 12), (c, 9)]) is None
    store = eng._store_mask([(a, 12), (b, 20), (c, 9)])
    assert store.shape == (3, 20)
    assert store[0, :12].all() and not store[0, 12:].any()
    # b: slots 0-11 were a's; 12-15 are the rest of shared block 4; its
    # own tail block 6 holds 16-19
    assert not store[1, :12].any() and store[1, 12:].all()
    assert store[2, :9].all()
    # a later chunk starting mid-block: a writes 12-19 of blocks 4 and 5
    a.fill_pos, b.fill_pos = 12, 8
    store = eng._store_mask([(a, 8), (b, 12)])
    assert store[0, :8].all()
    assert store[1, :4].all() and not store[1, 4:8].any()
    assert store[1, 8:12].all()
    # a weight swap's recompute stores no slot an earlier chunk stored
    a.fill_pos, b.fill_pos = 0, 0
    written = np.zeros(eng.n_blocks * eng.page_size, bool)
    assert eng._store_mask([(a, 16)], written) is None
    store = eng._store_mask([(b, 20)], written)
    assert not store[0, :16].any() and store[0, 16:].all()
    assert written.sum() == 20


def _fills_hold_the_pool(side):
    """One row decodes while two fills hold the rest of a 10-block pool:
    the row's next page can come only from a fill."""
    side.submit("a", list(np.arange(10) % 40 + 6), 60)
    side.eng.step()
    side.eng.step()
    side.submit("b", list(np.arange(60) % 33 + 7), 20)
    side.submit("c", list(np.arange(44) % 29 + 8), 20)
    side.run()
    return [side.result(q) for q in "abc"]


def test_fill_gives_back_blocks_where_the_reference_raises(model):
    """The reference engine raises when a decoding row needs a block and
    every other block is held by fills (no decoding row to preempt); the
    port gives back the youngest fill's blocks and requeues it, and every
    stream equals that of an engine whose pool holds every row."""
    kw = dict(kv_cache_len=128, page_size=16, kv_pool_tokens=160,
              chunk_size=8, stop_tokens=())
    with pytest.raises(RuntimeError, match="KV pool exhausted"):
        _fills_hold_the_pool(_Side("jax", model, **kw))
    side = _Side("port", model, **kw)
    got = _fills_hold_the_pool(side)
    assert side.eng.aborted_fills_total >= 1
    ref = _fills_hold_the_pool(_Side("port", model, **dict(
        kw, kv_pool_tokens=None)))
    assert [o.output_ids for o in got] == [o.output_ids for o in ref]
    assert [len(o.output_ids) for o in got] == [60, 20, 20]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs,
                                   rtol=TOL, atol=TOL)
    eng = side.eng
    assert eng.close() == {}
    eng.park_ttl_steps = 0
    eng.step()
    eng._prefix_cache.flush()
    assert eng.free_pool_blocks == eng.n_blocks
