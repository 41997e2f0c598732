"""The port's prefix-cache host tier against the JAX package's
(``areal_tpu/engine/prefix_cache.py`` with ``host_bytes_budget``, the
engine's ``prefix_cache_host_bytes``), on the CPU: the radix index's
decisions on one seeded trace of inserts, matches, restores, evictions
and flushes equal the JAX cache's (matches, allocator calls, stats); the
host gather and restore of pool blocks round-trip bit for bit on every
pool dtype, as the JAX helpers do; host bytes are counted exactly, at
the JAX engine's block size; a multi-session replay that spills and
restores gives the tokens of an engine without pressure and of the JAX
engine with the same tier; and a weight swap flushes both tiers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine.prefix_cache import RadixPrefixCache as JaxCache
from areal_tpu.models import paged as jpaged
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.engine.prefix_cache import RadixPrefixCache
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

EOS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the radix index on one trace -----------------------------------------------


class _Alloc:
    """A refcounting allocator that logs every call."""

    def __init__(self):
        self.refs, self.log = {}, []

    def acquire(self, blocks):
        self.log.append(("acquire", list(blocks)))
        for b in blocks:
            self.refs[b] = self.refs.get(b, 0) + 1

    def release(self, blocks):
        self.log.append(("release", list(blocks)))
        for b in blocks:
            self.refs[b] -= 1
            assert self.refs[b] >= 0


def _pair(page=4, capacity=10, host_blocks=6, min_match=2):
    """The two packages' caches with the same settings; each fetch returns
    the blocks' ids as their payload (numpy on one side, torch on the
    other), so a restored payload's identity is checkable."""
    out = []
    for cls, lib in ((JaxCache, np), (RadixPrefixCache, torch)):
        a = _Alloc()
        fetched = []

        def fetch(blocks, lib=lib, fetched=fetched):
            fetched.append(list(blocks))
            ids = (np.asarray(blocks, np.int32) if lib is np
                   else torch.tensor(blocks, dtype=torch.int32))
            return ids + 0, -ids
        c = cls(page_size=page, capacity_blocks=capacity, acquire=a.acquire,
                release=a.release, min_match_tokens=min_match,
                host_bytes_budget=host_blocks * 100, block_bytes=100,
                spill_fetch=fetch)
        out.append((c, a, fetched))
    return out


def _payload_bytes(cache):
    """The bytes of the host payloads a cache's spilled nodes hold, counted
    from the tensors themselves."""
    total, stack = 0, list(cache._root.children.values())
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n.spilled and n.host_kv is not None:
            total += sum(a.numel() * a.element_size() for a in n.host_kv)
    return total


def _match_view(m):
    return (list(m.blocks), m.n_tokens, m.tail_block, m.tail_tokens,
            len(m.restore_nodes), m.restore_tokens, m.pending)


def test_host_tier_decisions_equal_reference_on_a_trace():
    """Inserts of sequences that share prefixes, matches (a requeued one
    too), evictions that spill and trim the host budget, restores gated
    on the next step, re-adoption by an insert, and a flush: every match,
    allocator call, fetch and stat equals the JAX cache's."""
    (jc, ja, jf), (tc, ta, tf) = _pair()
    rng = np.random.default_rng(0)
    base = [rng.integers(0, 9, 40).tolist() for _ in range(4)]
    next_block = [100]

    def blocks_for(n):
        out = list(range(next_block[0], next_block[0] + n))
        next_block[0] += n
        return out

    step = 0
    for it in range(60):
        step += 1
        op = it % 6
        s = base[int(rng.integers(0, 4))]
        n = int(rng.integers(5, len(s)))
        seq = s[:n] + rng.integers(0, 9, int(rng.integers(0, 3))).tolist()
        if op in (0, 3):
            blk = blocks_for(-(-len(seq) // 4))
            for c in (jc, tc):
                c.insert(seq, blk, step=step, version=c.version)
        elif op in (1, 4):
            ms = [c.match(seq, step=step, record=op == 1) for c in (jc, tc)]
            assert _match_view(ms[0]) == _match_view(ms[1]), it
            if ms[0].restore_nodes:
                # the engine's restore: fresh blocks, usable next step
                blk = blocks_for(len(ms[0].restore_nodes))
                pay = [c.begin_restore(m.restore_nodes)
                       for c, m in zip((jc, tc), ms)]
                assert [[int(x) for x in p] for p in pay[0]] == [
                    [int(x) for x in p] for p in pay[1]]
                for a in (ja, ta):
                    a.acquire(blk)
                for c, m in zip((jc, tc), ms):
                    c.complete_restore(m.restore_nodes, blk,
                                       ready_step=step + 1)
        elif op == 2:
            k = int(rng.integers(1, 5))
            assert jc.evict(k, protect_step=step) == tc.evict(
                k, protect_step=step)
        else:
            assert jc.evict_one() == tc.evict_one()
        assert ja.log == ta.log, it
        assert jf == tf, it
        assert jc.stats() == tc.stats(), it
    assert tc.stats()["spilled_blocks_total"] > 0
    assert tc.stats()["restored_blocks_total"] > 0
    assert tc.stats()["host_dropped_blocks_total"] > 0
    held = sorted(tc.held_blocks())
    assert held == sorted(b for b, r in ta.refs.items() for _ in range(r))
    assert _payload_bytes(tc) == 8 * tc.host_blocks_held
    for c in (jc, tc):
        c.flush()
    assert ja.log == ta.log and jc.stats() == tc.stats()
    assert not any(ta.refs.values())
    assert tc.host_bytes_held == 0 and tc.host_blocks_held == 0


# -- the block gather and restore ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_host_gather_and_restore_round_trip(dtype):
    """Blocks gathered to the host and restored elsewhere in the pool come
    back bit for bit (an int8 pool with its scales), the gathered layout
    equals the JAX helper's, and the stacked restore writes the same."""
    jcfg = tiny_config(vocab_size=32, dtype="float32" if dtype == "int8"
                       else dtype)
    cfg = port_config(jcfg)
    kv = "int8" if dtype == "int8" else "auto"
    NB, BS = 10, 4
    tpool = list(tpaged.alloc_kv_pool(cfg, NB, BS, "cpu", kv))
    rng = np.random.default_rng(1)
    for t in tpool:
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape,
                                                  dtype=np.int8)))
        else:
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
                np.float32)).to(t.dtype))
    jpool = [None if t is None else jnp.asarray(t.float().numpy()).astype(
        {torch.int8: jnp.int8, torch.float32: jnp.float32,
         torch.bfloat16: jnp.bfloat16}[t.dtype]) for t in tpool]
    blocks = [3, 7, 1]
    got = tpaged.gather_blocks_host(*tpool[:2], blocks, *tpool[2:])
    want = jpaged.gather_blocks_host(*jpool[:2], blocks, k_scale=jpool[2],
                                     v_scale=jpool[3])
    assert len(got) == len(want) == (4 if kv == "int8" else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    before = [None if t is None else t.clone() for t in tpool]
    payloads = [tuple(a[i].clone() for a in got) for i in range(3)]
    tpaged.restore_blocks_from_host(*tpool[:2], payloads, [0, 9, 5],
                                    *tpool[2:])
    for t, b in zip(tpool, before):
        if t is None:
            continue
        assert torch.equal(t[:, [0, 9, 5]], b[:, blocks])
        rest = [i for i in range(NB) if i not in (0, 9, 5)]
        assert torch.equal(t[:, rest], b[:, rest])
    # the payloads in another order land in the order given
    tpaged.restore_blocks_from_host(*tpool[:2], payloads[::-1], [2, 4, 6],
                                    *tpool[2:])
    for t, b in zip(tpool, before):
        if t is not None:
            assert torch.equal(t[:, [2, 4, 6]], b[:, blocks[::-1]])
    with pytest.raises(ValueError):
        tpaged.restore_blocks_from_host(*tpool[:2], payloads, [0, 1],
                                        *tpool[2:])


# -- the engine -------------------------------------------------------------------


ENGINE = dict(max_batch=4, kv_cache_len=256, chunk_size=4, stop_tokens=(EOS,),
              cache_mode="paged", page_size=8, prefill_chunk_tokens=16)
PRESSURE = dict(kv_pool_tokens=160, prefix_cache_capacity_frac=0.25,
                prefix_cache_host_bytes=1 << 24)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=512)
    trees = [jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
             for s in (0, 42)]
    return jcfg, port_config(jcfg), trees


def _engines(model, **kw):
    from areal_tpu.engine.inference_server import (
        ContinuousBatchingEngine as JaxEngine,
    )
    from areal_tpu.engine.sampling import SamplingParams as JaxSampling
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.engine.sampling import SamplingParams

    jcfg, cfg, trees = model
    settings = dict(ENGINE, **kw)
    port = ContinuousBatchingEngine(
        cfg, params_from_jax(trees[0], cfg, "cpu"), device="cpu",
        sampling=SamplingParams(greedy=True), **settings)
    ref = JaxEngine(jcfg, jax.tree.map(jnp.asarray, trees[0]),
                    sampling=JaxSampling(greedy=True), **settings)
    for e in (port, ref):
        e.park_ttl_steps = 0
    return port, ref


def _req(pkg, qid, prompt, max_new):
    if pkg == "jax":
        from areal_tpu.api.model_api import (
            APIGenerateInput,
            GenerationHyperparameters,
        )
    else:
        from areal_tpu_torch.api.model_api import (
            APIGenerateInput,
            GenerationHyperparameters,
        )
    return APIGenerateInput(
        qid=qid, prompt_ids=prompt, input_ids=prompt,
        gconfig=GenerationHyperparameters(max_new_tokens=max_new,
                                          greedy=True))


def _drain(eng):
    for _ in range(3000):
        if not eng.has_work:
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _replay(eng, pkg, n_sessions=3, turns=2, seed=0, max_new=8):
    """Round-robin multi-session replay under fresh qids (the reference's
    host-tier replay): every turn re-sends the whole conversation."""
    rng = np.random.default_rng(seed)
    convs = [rng.integers(6, 60, 24).tolist() for _ in range(n_sessions)]
    streams = {}
    for t in range(turns):
        for s in range(n_sessions):
            qid = f"s{s}t{t}"
            eng.submit(_req(pkg, qid, convs[s], max_new))
            _drain(eng)
            out = eng.drain_results()[qid]
            streams[(s, t)] = (list(out.output_ids),
                               list(out.output_logprobs))
            convs[s] = (convs[s] + list(out.output_ids)
                        + rng.integers(6, 60, 6).tolist())
    return streams


def _same_streams(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_allclose(a[k][1], b[k][1], rtol=1e-4, atol=1e-4)


def test_spill_restore_replay_identical_to_no_spill(model):
    """A working set that overflows the pool's cache spills to the host and
    is restored: the streams equal those of an engine under no pressure
    (and no host tier), and the JAX engine's with the same tier, whose
    spill, restore and hit counts the port's equal; afterwards both tiers
    drain and the pool is whole."""
    port, ref = _engines(model, **PRESSURE)
    got = _replay(port, "port")
    _same_streams(got, _replay(ref, "jax"))
    st = port.prefix_cache_stats()
    assert st["spilled_blocks_total"] > 0 and st["restored_blocks_total"] > 0
    assert st == ref.prefix_cache_stats()
    assert (port.host_spill_rounds_total, port.host_restore_rounds_total) == (
        ref.host_spill_rounds_total, ref.host_restore_rounds_total)
    assert port.prefill_tokens_total == ref.prefill_tokens_total
    assert port.host_restore_bytes_total > 0
    assert port.host_spill_bytes_total >= port.host_restore_bytes_total
    calm, _ = _engines(model, kv_pool_tokens=2048, prefix_cache=False)
    _same_streams(got, _replay(calm, "port"))
    assert port.close() == {}
    port.step()
    port._prefix_cache.flush()
    assert port.free_pool_blocks == port.n_blocks
    assert (np.asarray(port._block_ref) == 0).all()
    st = port.prefix_cache_stats()
    assert st["host_bytes_held"] == 0 and st["host_blocks_held"] == 0


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_host_bytes_accounting_is_exact(model, kv):
    """A block's host bytes are the pool's real block size (an int8 pool's
    bytes and float32 scales), the JAX engine's too; every payload has
    exactly that many bytes; the tier's count is blocks x block size and
    drains to 0 at a flush."""
    port, ref = _engines(model, kv_cache_dtype=kv, **PRESSURE)
    cache = port._prefix_cache
    assert cache.block_bytes == port._pool_block_bytes() == (
        ref._pool_block_bytes())
    _replay(port, "port", turns=1)
    cache.evict(port.prefix_cache_stats()["blocks_held"])
    st = port.prefix_cache_stats()
    assert st["host_blocks_held"] > 0
    assert st["host_bytes_held"] == st["host_blocks_held"] * cache.block_bytes
    assert _payload_bytes(cache) == st["host_bytes_held"]
    if kv == "int8":
        fp, _ = _engines(model, **PRESSURE)
        assert cache.block_bytes < fp._pool_block_bytes() / 1.8
    cache.flush()
    st = port.prefix_cache_stats()
    assert st["host_bytes_held"] == 0 and st["host_blocks_held"] == 0


def test_weight_swap_flushes_both_tiers(model):
    """After ``update_weights`` neither tier holds anything (no token can
    come from pre-swap KV, host copies included), and the next request
    gives the tokens of the JAX engine after the same swap."""
    jcfg, cfg, trees = model
    port, ref = _engines(model, **PRESSURE)
    for eng, pkg in ((port, "port"), (ref, "jax")):
        _replay(eng, pkg, turns=1)
        eng._prefix_cache.evict(eng.prefix_cache_stats()["blocks_held"])
        assert eng.prefix_cache_stats()["host_blocks_held"] > 0
    port.update_weights(params_from_jax(trees[1], cfg, "cpu"), version=1)
    ref.update_weights(jax.tree.map(jnp.asarray, trees[1]), version=1)
    conv = np.random.default_rng(3).integers(6, 60, 20).tolist()
    outs = []
    for eng, pkg in ((port, "port"), (ref, "jax")):
        eng.step()
        st = eng.prefix_cache_stats()
        assert st["blocks_held"] == 0
        assert st["host_bytes_held"] == 0 and st["host_blocks_held"] == 0
        assert st["flushes_total"] == 1
        eng.submit(_req(pkg, "post", conv, 8))
        _drain(eng)
        outs.append(eng.drain_results()["post"].output_ids)
    assert outs[0] == outs[1]
