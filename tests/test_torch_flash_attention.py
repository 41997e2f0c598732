"""The port's flash attention (``areal_tpu_torch.ops.flash_attention``) on
the CPU, where it runs its plain version, against the JAX package's
oracle for the Pallas kernel: ``reference_attention`` under
``make_attention_mask``, with gradients from ``jax.grad`` through it.

Layouts come from the JAX package's own ``pad_batch``/``pack_batch``
(several segments per row, padding, T < 128 and T not a multiple of the
kernel's 64-token tile), so the kernel's causal-by-index rule is shown
equal to the reference's causal-by-position mask where the trainer uses
it.  Outputs are compared on real tokens (the reference averages V
uniformly on padding queries, the port gives 0 there; no loss reads
them), gradients everywhere.  Float32 throughout: out to 1e-5, gradients
to 1e-4 (both sides sum the same terms in another order).

Head dim 256 (Gemma) and a sliding window (Mistral) take the same
cases: the window is the reference's ``make_attention_mask(...,
sliding_window)``, which it applies to dense attention and never sends to
its kernel; the port's kernel and plain version apply it by index.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds
them against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.engine import batching as jbatching
from areal_tpu.models import transformer as jt
from areal_tpu_torch.ops import flash_attention as tfa

TOL_OUT = 1e-5
TOL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sample(lens, seed):
    rng = np.random.default_rng(seed)
    return JSample.from_default(
        lens, [f"s{i}" for i in range(len(lens))],
        {"packed_input_ids": rng.integers(1, 50, sum(lens)).astype(np.int32)},
    )


#: layout name -> a function that lays out a JAX PaddedBatch
LAYOUTS = {
    # one sequence per row, right padding, T = 32 bucket (< 128)
    "pad_T32": lambda: jbatching.pad_batch(_sample([5, 17, 32, 9], 0)),
    # packed rows of 50 tokens (not a multiple of 64), several segments
    "pack_T50": lambda: jbatching.pack_batch(
        _sample([20, 13, 7, 30, 11, 4, 25], 1), fixed_len=50
    ),
    # packed rows of 133 tokens: more than two kernel tiles, ragged edge
    "pack_T133": lambda: jbatching.pack_batch(
        _sample([70, 40, 90, 33, 5, 61], 2), fixed_len=133
    ),
}
#: (Hq, Hkv): GQA ratios 1, 2 and 6
HEADS = [(2, 2), (4, 2), (6, 1)]


def _inputs(pb, Hq, Hkv, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    B, T = pb.tokens.shape
    q = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, Hq, hd)).astype(np.float32)
    return q, k, v, do


def _jax_ref(q, k, v, seg, pos, window=None):
    mask = jt.make_attention_mask(seg, pos, seg, pos, window)
    return jt.reference_attention(q, k, v, mask)


#: head dim 256 and sliding-window cases: (layout, Hq, Hkv, hd, window);
#: packed rows of 64 and 200 tokens hold segments longer and shorter than
#: a window of 16
WIDE_LAYOUTS = {
    "pack_T64": lambda: jbatching.pack_batch(
        _sample([40, 9, 15, 30, 3, 21], 4), fixed_len=64
    ),
    "pack_T200": lambda: jbatching.pack_batch(
        _sample([120, 5, 60, 70, 12, 17, 90], 5), fixed_len=200
    ),
}
WIDE_CASES = {
    "hd256": ("pack_T133", 4, 1, 256, None),
    "hd256_pad": ("pad_T32", 2, 2, 256, None),
    "window16_T64": ("pack_T64", 4, 2, 16, 16),
    "window16_T200": ("pack_T200", 6, 1, 16, 16),
    "window16_hd256": ("pack_T200", 2, 1, 256, 16),
    "window1_T64": ("pack_T64", 2, 2, 16, 1),
}


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"Hq{h[0]}_Hkv{h[1]}")
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flash_attention_matches_reference(layout, heads):
    pb = LAYOUTS[layout]()
    q, k, v, do = _inputs(pb, *heads)
    seg, pos = pb.seg_ids, pb.positions
    real = seg != 0
    assert (~real).any() and real.any()

    jout = _jax_ref(*map(jnp.asarray, (q, k, v, seg, pos)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tseg = torch.from_numpy(seg)
    tout = tfa.flash_attention(tq, tk, tv, tseg)
    np.testing.assert_allclose(
        tout.detach().numpy()[real], np.asarray(jout)[real],
        rtol=TOL_OUT, atol=TOL_OUT,
    )
    assert (tout.detach().numpy()[~real] == 0).all()

    # gradients of sum(out * dO) over real queries
    w = do * real[:, :, None, None]

    def jloss(q, k, v):
        return jnp.sum(_jax_ref(q, k, v, jnp.asarray(seg), jnp.asarray(pos)) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (tout * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(j), rtol=TOL_GRAD, atol=TOL_GRAD,
            err_msg=f"d{name}",
        )
    # padding queries get exactly zero gradient
    assert (tq.grad.numpy()[~real] == 0).all()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lse_and_mask_contract(layout):
    """The plain version's logsumexp equals the reference's over the same
    mask on real queries and is +inf on padding queries, and its
    index-causal mask is the reference's position mask."""
    pb = LAYOUTS[layout]()
    q, k, v, _ = _inputs(pb, 4, 2, seed=3)
    seg, pos = pb.seg_ids, pb.positions
    real = seg != 0
    _, lse = tfa.reference_flash_attention(
        *map(torch.from_numpy, (q, k, v, seg)), return_lse=True
    )
    jmask = jt.make_attention_mask(*map(jnp.asarray, (seg, pos, seg, pos)))
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum("bthd,bshd->bhts", q, kr) / np.sqrt(q.shape[-1])
    s = np.where(np.asarray(jmask)[:, None], s, -np.inf)
    ref = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))  # [B,H,T]
    lse_t = lse.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(
        lse_t[real], ref.transpose(0, 2, 1)[real], rtol=1e-5, atol=1e-5
    )
    assert np.isposinf(lse_t[~real]).all()

    # the index-causal rule of the kernel is the reference's mask here
    assert np.array_equal(tfa.attention_mask(torch.from_numpy(seg)).numpy(),
                          np.asarray(jmask))


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_flash_attention_at_head_dim_256_and_with_a_window(case):
    """The plain version at head dim 256 and with a sliding window against
    the reference's dense attention under its windowed mask: out and lse
    on real queries to 1e-5, dq/dk/dv of sum(out * dO) over real queries
    through autograd against ``jax.grad`` to 1e-4."""
    name, Hq, Hkv, hd, window = WIDE_CASES[case]
    pb = {**LAYOUTS, **WIDE_LAYOUTS}[name]()
    q, k, v, do = _inputs(pb, Hq, Hkv, hd=hd, seed=7)
    seg, pos = pb.seg_ids, pb.positions
    real = seg != 0
    assert real.any()
    if window is not None:  # a segment longer than the window
        _, counts = np.unique(seg[real], return_counts=True)
        assert counts.max() > window

    jmask = np.asarray(jt.make_attention_mask(
        *map(jnp.asarray, (seg, pos, seg, pos)), window))
    jout = _jax_ref(*map(jnp.asarray, (q, k, v, seg, pos)), window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tseg = torch.from_numpy(seg)
    tout = tfa.flash_attention(tq, tk, tv, tseg, window=window)
    np.testing.assert_allclose(
        tout.detach().numpy()[real], np.asarray(jout)[real],
        rtol=TOL_OUT, atol=TOL_OUT,
    )
    assert (tout.detach().numpy()[~real] == 0).all()
    assert np.array_equal(tfa.attention_mask(tseg, window).numpy(), jmask)

    _, lse = tfa.reference_flash_attention(
        *map(torch.from_numpy, (q, k, v, seg)), return_lse=True,
        window=window)
    kr = np.repeat(k, Hq // Hkv, axis=2)
    sc = np.einsum("bthd,bshd->bhts", q, kr) / np.sqrt(hd)
    sc = np.where(jmask[:, None], sc, -np.inf)
    ref = np.asarray(jax.nn.logsumexp(jnp.asarray(sc), axis=-1))
    lse_t = lse.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(
        lse_t[real], ref.transpose(0, 2, 1)[real], rtol=TOL_OUT, atol=TOL_OUT
    )

    w = do * real[:, :, None, None]

    def jloss(q, k, v):
        return jnp.sum(_jax_ref(q, k, v, jnp.asarray(seg), jnp.asarray(pos),
                                window) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (tout * torch.from_numpy(w)).sum().backward()
    for g_name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(j), rtol=TOL_GRAD, atol=TOL_GRAD,
            err_msg=f"d{g_name}",
        )


def test_window_argument_is_checked():
    """A window is None or a positive int; anything else is refused
    before any product."""
    q = torch.zeros((1, 8, 2, 16))
    seg = torch.ones((1, 8), dtype=torch.int32)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="window"):
            tfa.flash_attention(q, q, q, seg, window=bad)


def test_kernel_path_refuses_non_cpu_tensors():
    """Off the CPU the wrapper launches the kernel or raises; it never runs
    the plain version, and a refused launch is not counted."""
    meta = dict(device="meta")
    q = torch.empty((1, 64, 12, 128), dtype=torch.bfloat16, **meta)
    k = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16, **meta)
    seg = torch.empty((1, 64), dtype=torch.int32, **meta)
    before = tfa.flash_attention.fwd_launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention(q, k, k, seg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention(q, k, k, seg, window=16)
    assert tfa.flash_attention.fwd_launches == before
