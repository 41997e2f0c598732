"""The torch port's deep paged attention and the int8 branch of both paged
kernels (plain versions) against the JAX package's Pallas kernels in
interpret mode (``paged_flash_attention_deep``, and ``paged_flash_attention``
with ``k_scale``/``v_scale``) and its jnp reference, on the same
numpy-seeded inputs, in float32 at 1e-5.

The CUDA kernels run only on a card; chip_smoke.py holds them against the
plain version tested here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.paged_attention import (
    DEEP_BUFFERS,
)
from areal_tpu.ops.paged_attention import (
    paged_flash_attention as jax_paged,
)
from areal_tpu.ops.paged_attention import (
    paged_flash_attention_deep as jax_deep,
)
from areal_tpu.ops.paged_attention import (
    reference_paged_partials as jax_reference,
)
from areal_tpu_torch.ops import paged_attention as tpa

BS = 16
HD = 64
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(lengths, B=None, Q=1, Hq=4, Hkv=2, MB=4, NB=None, L=None,
            seed=0, int8=False):
    """q, pools (layer-stacked when ``L``), scrambled tables and lengths,
    as (jax args, torch args); int8 pools come with positive f32 scales
    [(L,) NB, Hkv, BS]."""
    rng = np.random.default_rng(seed)
    B = B or len(lengths)
    NB = NB or B * MB + 3
    lead = () if L is None else (L,)
    q = rng.standard_normal((B, Q, Hq, HD), np.float32)
    shape = lead + (NB, Hkv, BS, HD)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32)
        scales = (ks, vs)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        scales = ()
    # a scrambled table: logical order != pool order, no duplicates
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    arrays = (q, k, v, tables, lens) + scales
    return arrays


def _jax(fn, arrays, layer=None):
    q, k, v, tables, lens, *scales = (jnp.asarray(a) for a in arrays)
    kw = dict(interpret=True)
    if layer is not None:
        kw["layer"] = jnp.int32(layer)
    if scales:
        kw.update(k_scale=scales[0], v_scale=scales[1])
    return fn(q, k, v, tables, lens, **kw)


def _port(fn, arrays, layer=None):
    q, k, v, tables, lens, *scales = (torch.from_numpy(a) for a in arrays)
    if layer is not None:
        k, v = k[layer], v[layer]
        scales = [s[layer] for s in scales]
    return fn(q, k, v, tables, lens, *scales)


def _check(port, other, lens):
    acc, m, l = (np.asarray(x) for x in port)
    acc_o, m_o, l_o = (np.asarray(x) for x in other)
    valid = lens > 0
    np.testing.assert_allclose(m[valid], m_o[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l[valid], l_o[valid], rtol=TOL, atol=TOL)
    out = acc[valid] / l[valid][..., None]
    out_o = acc_o[valid] / l_o[valid][..., None]
    np.testing.assert_allclose(out, out_o, rtol=TOL, atol=TOL)
    # length-0 rows: acc = 0, l = 0, m = -1e30 exactly, on both sides
    for a, mm, ll in ((acc, m, l), (acc_o, m_o, l_o)):
        assert (a[~valid] == 0).all() and (ll[~valid] == 0).all()
        assert (mm[~valid] == np.float32(-1e30)).all()


# lengths 0, 1, BS-1, BS, BS+1 and a full table (MB * BS)
EDGE_LENGTHS = [0, 1, BS - 1, BS, BS + 1, 4 * BS]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_deep_plain_matches_jax_deep_kernel(int8):
    arrays = _inputs(EDGE_LENGTHS, int8=int8, seed=1)
    port = _port(tpa.paged_flash_attention_deep, arrays)
    _check(port, _jax(jax_deep, arrays), arrays[4])
    _check(port, jax_reference(*(jnp.asarray(a) for a in arrays)),
           arrays[4])


@pytest.mark.parametrize("Q", [1, 5])
def test_int8_plain_matches_jax_paged_kernel(Q):
    # the int8 branch of the standard kernel, at decode and multi-query
    # (prefill-chunk) shapes, GQA r = 2
    arrays = _inputs(EDGE_LENGTHS, Q=Q, int8=True, seed=2)
    port = _port(tpa.paged_flash_attention, arrays)
    _check(port, _jax(jax_paged, arrays), arrays[4])


def test_deep_ring_wraparound():
    # rows spanning more pages than the TPU kernel's ring is deep: the
    # refill path (slot reuse) must still give the right partials
    MB = 2 * DEEP_BUFFERS
    arrays = _inputs([MB * BS, MB * BS - 37], MB=MB, seed=13)
    port = _port(tpa.paged_flash_attention_deep, arrays)
    _check(port, _jax(jax_deep, arrays), arrays[4])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_deep_layered_pool(int8):
    # the port passes a layer's slice of the stacked pool (a view); the
    # JAX kernel picks the layer inside from the stacked pool
    L = 2
    arrays = _inputs([40, 0, 63], MB=4, L=L, int8=int8, seed=12)
    for layer in range(L):
        port = _port(tpa.paged_flash_attention_deep, arrays, layer=layer)
        _check(port, _jax(jax_deep, arrays, layer=layer), arrays[4])


def test_deep_qwen_grouping_multi_query():
    # the slice's GQA grouping (12 query heads over 2 KV heads) at a
    # multi-query chunk, int8 pool
    arrays = _inputs([33, 17], Q=3, Hq=12, Hkv=2, MB=3, int8=True, seed=3)
    port = _port(tpa.paged_flash_attention_deep, arrays)
    _check(port, jax_reference(*(jnp.asarray(a) for a in arrays)),
           arrays[4])
