"""The torch port's ``flash_decode`` (plain version) against the JAX
package's Pallas ``flash_decode`` in interpret mode and its jnp
``reference_decode_partials``, on the same numpy-seeded inputs, with
length-0, partial and full rows; float32 at 1e-5.

The CUDA kernel runs only on a card; chip_smoke.py holds it against the
plain version tested here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from areal_tpu.ops.decode_attention import (
    reference_decode_partials as jax_reference,
)
from areal_tpu_torch.ops import decode_attention as tda

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(lengths, Hq=4, Hkv=2, S=256, hd=64, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, Hq, hd)).astype(dtype)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(dtype)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(dtype)
    return q, k, v, np.asarray(lengths, np.int32)


def _check(port, other, lens):
    acc, m, l = (np.asarray(x) for x in port)
    acc_o, m_o, l_o = (np.asarray(x) for x in other)
    valid = lens > 0
    np.testing.assert_allclose(m[valid], m_o[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l[valid], l_o[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        acc[valid] / l[valid][..., None],
        acc_o[valid] / l_o[valid][..., None], rtol=TOL, atol=TOL,
    )


def _port(arrays):
    return tda.flash_decode(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize(
    "lengths,Hq,Hkv",
    [
        ([0, 1, 255, 256], 4, 2),  # empty, one key, partial, full
        ([77, 0, 130], 12, 2),  # the slice's GQA grouping (r = 6)
        ([200, 3], 4, 4),  # no grouping
    ],
)
def test_plain_matches_jax_kernel_and_reference(lengths, Hq, Hkv):
    arrays = _inputs(lengths, Hq=Hq, Hkv=Hkv)
    port = _port(arrays)
    jx = [jnp.asarray(a) for a in arrays]
    _check(port, jax_reference(*jx), arrays[3])
    _check(port, jax_flash_decode(*jx, interpret=True), arrays[3])


def test_empty_rows_are_exact():
    arrays = _inputs([0, 40, 0])
    acc, m, l = (x.numpy() for x in _port(arrays))
    empty = arrays[3] == 0
    assert (acc[empty] == 0).all() and (l[empty] == 0).all()
    assert (m[empty] == np.float32(-1e30)).all()


def test_long_cache_two_blocks_of_the_kernel():
    # S spans two of the JAX kernel's 256-token blocks; a row ending one
    # past the first block
    arrays = _inputs([257, 512, 511], S=512, seed=4)
    port = _port(arrays)
    _check(port, jax_flash_decode(*(jnp.asarray(a) for a in arrays),
                                  interpret=True), arrays[3])


def test_matches_paged_partials_with_one_page_per_row():
    # the contiguous cache is a pool of B pages of S tokens with the table
    # [[0], [1], ...]: the route the CUDA kernel takes
    from areal_tpu_torch.ops.paged_attention import reference_paged_partials

    q, k, v, lens = (torch.from_numpy(a) for a in _inputs([9, 256, 0]))
    tables = torch.arange(3, dtype=torch.int32)[:, None]
    acc, m, l = tda.flash_decode(q, k, v, lens)
    acc_p, m_p, l_p = reference_paged_partials(q[:, None], k, v, tables, lens)
    _check((acc, m, l), (acc_p[:, 0], m_p[:, 0], l_p[:, 0]), lens.numpy())
