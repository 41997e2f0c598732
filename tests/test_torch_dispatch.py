"""The torch port's dispatch table (``engine/dispatch.py``) and the
engine's use of it, mirroring the reference's tests
(tests/engine/test_pipeline_depth.py) on the port: defaults and
overrides, thresholds derived from a measured decode A/B (and equal to
the reference's on the same rows), ``cache_mode="auto"`` resolved by the
table (the dense mode stays refused), and the deep-kernel decision by the
batch's longest live context.  On the CPU both paged kernels' plain
version is the same function, so a wave routed to the deep kernel is
token-identical to one on the default table."""

import jax
import pytest
import torch

from areal_tpu.engine import dispatch as jdispatch
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.engine.dispatch import (
    DISPATCH_NEVER,
    PagedDispatchTable,
    derive_dispatch_table,
    resolve_dispatch_table,
)
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.models.transformer import init_params
from tests.test_torch_engine import (
    _assert_same,
    _port_engine,
    _port_input,
    _prompts,
    _run,
)
from tests.test_torch_model import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_dispatch_table_defaults_reproduce_old_behavior():
    t = PagedDispatchTable()
    assert t.paged_min_cache_len == 2048
    assert t.deep_min_context == DISPATCH_NEVER
    assert resolve_dispatch_table(None, None) == t
    over = resolve_dispatch_table(4096, 8192)
    assert over.paged_min_cache_len == 4096
    assert over.deep_min_context == 8192
    assert over.source == "config"
    # partial override keeps the other default
    part = resolve_dispatch_table(None, 8192)
    assert part.paged_min_cache_len == 2048
    assert part.deep_min_context == 8192
    # the port's constants and defaults are the reference's
    assert DISPATCH_NEVER == jdispatch.DISPATCH_NEVER
    assert t.as_dict() == jdispatch.PagedDispatchTable().as_dict()


BENCH_ROWS = {
    "both_win": {
        2048: {"dense": 4000.0, "paged": 3000.0, "deep": 2900.0},
        8192: {"dense": 1400.0, "paged": 1380.0, "deep": 1500.0},
        16384: {"dense": 700.0, "paged": 760.0, "deep": 900.0},
        32768: {"dense": None, "paged": 400.0, "deep": 520.0},  # dense OOM
    },
    "no_paged_win": {
        2048: {"dense": 4000.0, "paged": 2000.0, "deep": 1900.0},
        8192: {"dense": 1400.0, "paged": 900.0, "deep": 880.0},
    },
    "noisy_island": {
        2048: {"dense": 4000.0, "paged": 3950.0, "deep": None},
        8192: {"dense": 1400.0, "paged": 1000.0, "deep": None},
        16384: {"dense": 700.0, "paged": 760.0, "deep": None},
    },
    "deep_margin": {  # deep within DEEP_MARGIN of standard: no flip
        4096: {"dense": None, "paged": 1000.0, "deep": 1010.0},
        8192: {"dense": None, "paged": 500.0, "deep": 530.0},
    },
    "empty": {},
}


def test_derive_dispatch_table_from_bench_rows():
    t = derive_dispatch_table(BENCH_ROWS["both_win"])
    # paged reaches parity from 8k up (0.95 margin); deep wins from 8k up
    assert t.paged_min_cache_len == 8192
    assert t.deep_min_context == 8192
    assert t.source.startswith("bench(")


def test_derive_dispatch_table_no_paged_win_and_noisy_island():
    # paged never reaches parity: threshold pushed past the measured
    # range, deep stays NEVER
    t = derive_dispatch_table(BENCH_ROWS["no_paged_win"])
    assert t.paged_min_cache_len == 2 * 8192
    assert t.deep_min_context == DISPATCH_NEVER
    # a noisy mid-table dense win must not carve a dense island: the
    # threshold is the start of the winning suffix only
    t = derive_dispatch_table(BENCH_ROWS["noisy_island"])
    assert t.paged_min_cache_len == 16384


@pytest.mark.parametrize("name", sorted(BENCH_ROWS))
def test_derive_dispatch_table_matches_reference(name):
    rows = BENCH_ROWS[name]
    got = derive_dispatch_table(rows).as_dict()
    assert got == jdispatch.derive_dispatch_table(rows).as_dict()


def _tiny():
    cfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    return port_config(cfg), init_params(port_config(cfg), 0,
                                         torch.device("cpu"))


def test_auto_mode_consults_dispatch_table():
    cfg, params = _tiny()
    common = dict(max_batch=2, kv_cache_len=128, chunk_size=4, device="cpu")
    # 128 < the default 2048 threshold: auto resolves to the dense cache
    dense_eng = ContinuousBatchingEngine(cfg, params, cache_mode="auto",
                                         **common)
    assert not dense_eng.paged
    assert tuple(dense_eng.cache.k.shape[1:4]) == (2, cfg.n_kv_heads, 128)
    paged_eng = ContinuousBatchingEngine(
        cfg, params, cache_mode="auto",
        dispatch_table=PagedDispatchTable(
            paged_min_cache_len=64, source="config"
        ),
        page_size=16,
        **common,
    )
    # the measured table moved the crossover: the engine built its pool
    assert paged_eng.k_pool.shape[1] == paged_eng.n_blocks
    assert paged_eng.dispatch_table.paged_min_cache_len == 64
    # an explicit dense mode stays dense whatever the table says
    assert not ContinuousBatchingEngine(
        cfg, params, cache_mode="dense",
        dispatch_table=PagedDispatchTable(paged_min_cache_len=64),
        **common,
    ).paged


class _Row:
    def __init__(self, n, filling=False):
        self.prompt = list(range(n))
        self.generated = []
        self.filling = filling
        self.parked = False


def test_deep_kernel_threshold_is_context_driven():
    """_use_deep_kernel flips on the batch's longest live context (plus
    the un-harvested ring allowance), not on kv_cache_len."""
    cfg, params = _tiny()
    eng = ContinuousBatchingEngine(
        cfg, params, max_batch=2, kv_cache_len=128, chunk_size=4,
        cache_mode="paged", page_size=16, device="cpu",
        dispatch_table=PagedDispatchTable(
            paged_min_cache_len=64, deep_min_context=40, source="config"
        ),
    )
    assert not eng._use_deep_kernel()  # no rows yet
    # a 50-token context row crosses the 40-token deep threshold
    eng.rows[0] = _Row(50)
    assert eng._use_deep_kernel()
    # a long prompt still chunk-filling is not part of the decode batch
    # and must not route the short decoding rows onto the deep kernel
    eng.rows[0] = _Row(50, filling=True)
    assert not eng._use_deep_kernel()
    # the ring allowance: 30 tokens + 1 pending + 3 chunks of 4 in flight
    eng.rows[0] = _Row(30)
    assert not eng._use_deep_kernel()
    eng._ring.extend([None] * 3)
    assert eng._use_deep_kernel()
    eng._ring.clear()
    eng.rows[0] = None


def test_deep_routed_wave_is_token_identical():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = port_config(jcfg)
    prompts = _prompts(jcfg.vocab_size, seed=3)
    base = _port_engine(cfg, tree)
    ref = _run(base, _port_input, prompts, "d")
    assert base.deep_decode_chunks_total == 0
    eng = _port_engine(
        cfg, tree,
        dispatch_table=PagedDispatchTable(
            paged_min_cache_len=64, deep_min_context=8, source="config"
        ),
    )
    got = _run(eng, _port_input, prompts, "d")
    _assert_same(got, ref)
    # prompts reach past 8 tokens: most decode chunks took the deep kernel
    assert 0 < eng.deep_decode_chunks_total <= eng.decode_chunks_total
    assert eng.close() == {}
