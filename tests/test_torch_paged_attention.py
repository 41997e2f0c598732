"""The torch port's paged attention (plain version) against the JAX
package's Pallas kernel (interpret mode, as tests/ops/test_paged_attention.py
runs it) and its jnp reference, on the same numpy-seeded inputs.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it
against the plain version tested here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.paged_attention import (
    paged_flash_attention as jax_paged_flash_attention,
)
from areal_tpu.ops.paged_attention import (
    reference_paged_partials as jax_reference_paged_partials,
)
from areal_tpu_torch.ops import paged_attention as tpa

BS = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B=4, Q=1, Hq=8, Hkv=4, MB=4, NB=32, hd=128, seed=0,
            lengths=None, pool_dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Q, Hq, hd), np.float32)
    k = rng.standard_normal((NB, Hkv, BS, hd), np.float32)
    v = rng.standard_normal((NB, Hkv, BS, hd), np.float32)
    if pool_dtype == "bfloat16":
        # round once, so both packages hold identical bf16 values
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    # a scrambled table: logical order != pool order, no duplicates
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray(lengths or [MB * BS] * B, np.int32)
    jx = (
        jnp.asarray(q),
        jnp.asarray(k).astype(pool_dtype),
        jnp.asarray(v).astype(pool_dtype),
        jnp.asarray(tables),
        jnp.asarray(lens),
    )
    tdt = getattr(torch, pool_dtype)
    tx = (
        torch.from_numpy(q),
        torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt),
        torch.from_numpy(tables),
        torch.from_numpy(lens),
    )
    return jx, tx, lens


def _normalized(acc, l, valid):
    acc, l = np.asarray(acc)[valid], np.asarray(l)[valid]
    return acc / l[..., None]


def _check(port, other, lens, tol_out, tol_l):
    acc, m, l = (np.asarray(x) for x in port)
    acc_o, m_o, l_o = (np.asarray(x) for x in other)
    valid = lens > 0
    np.testing.assert_allclose(m[valid], m_o[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l[valid], l_o[valid], rtol=tol_l, atol=tol_l)
    np.testing.assert_allclose(
        _normalized(acc, l, valid), _normalized(acc_o, l_o, valid),
        rtol=tol_out, atol=tol_out,
    )


def _port(tx):
    return tuple(t.numpy() for t in tpa.paged_flash_attention(*tx))


# f32 pools agree at 1e-5; bf16 pools against the interpret-mode kernel
# take the JAX test's own 3e-3 (acc/l) and 2e-3 (l), for the reason given
# there: the kernel's f32 dots over bf16 tiles; against the jnp reference
# (the same f32 math on the same bf16 values) they stay at 1e-5
CASES = [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 3e-3, 2e-3),
]


@pytest.mark.parametrize(
    "lengths",
    [[512, 512, 512, 512], [1, 130, 256, 511], [0, 512, 37, 300]],
)
@pytest.mark.parametrize("pool_dtype,tol_out,tol_l", CASES)
def test_plain_matches_jax_kernel_and_reference(
    lengths, pool_dtype, tol_out, tol_l
):
    jx, tx, lens = _inputs(lengths=lengths, pool_dtype=pool_dtype)
    port = _port(tx)
    _check(port, jax_reference_paged_partials(*jx), lens, 1e-5, 1e-5)
    _check(
        port, jax_paged_flash_attention(*jx, interpret=True), lens,
        tol_out, tol_l,
    )


def test_plain_multi_query_chunk():
    # Q=16 queries per row (chunked prefill's prefix-attention shape),
    # GQA r=2: every query sees the same full prefix
    jx, tx, lens = _inputs(
        B=2, Q=16, Hq=4, Hkv=2, MB=3, NB=8, lengths=[300, 77], seed=2
    )
    port = _port(tx)
    _check(port, jax_reference_paged_partials(*jx), lens, 1e-5, 1e-5)
    _check(port, jax_paged_flash_attention(*jx, interpret=True), lens,
           1e-5, 1e-5)


def test_plain_qwen_grouping():
    # the slice's GQA grouping (12 query heads over 2 KV heads, r=6)
    jx, tx, lens = _inputs(
        B=3, Q=2, Hq=12, Hkv=2, MB=2, NB=8, lengths=[256, 129, 5], seed=3,
        pool_dtype="bfloat16",
    )
    _check(_port(tx), jax_reference_paged_partials(*jx), lens, 1e-5, 1e-5)


def test_empty_rows_are_exact():
    jx, tx, lens = _inputs(lengths=[0, 512, 0, 7], seed=4)
    acc, m, l = _port(tx)
    acc_j, m_j, l_j = (
        np.asarray(x) for x in jax_paged_flash_attention(*jx, interpret=True)
    )
    empty = lens == 0
    for got in ((acc, m, l), (acc_j, m_j, l_j)):
        assert (got[0][empty] == 0).all()
        assert (got[2][empty] == 0).all()
        assert (got[1][empty] == np.float32(-1e30)).all()


def test_gather_matches_jax():
    from areal_tpu.ops.paged_attention import gather_paged_kv

    jx, tx, _ = _inputs(B=2, MB=3, NB=8, seed=5)
    kj, vj = gather_paged_kv(jx[1], jx[2], jx[3][:, :3])
    kt, vt = tpa.gather_paged_kv(tx[1], tx[2], tx[3][:, :3].contiguous())
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
