"""The flash-attention backward's design, emulated in plain torch on the
CPU and held against the JAX package's gradients.

The backward kernels (``csrc/flash_attention.cu``) run only on a card; on
it ``chip_smoke.py`` holds them against the plain version.  Here the
arithmetic they are built from is written out in torch and compared with
``jax.grad`` through the reference oracle (``reference_attention`` under
``make_attention_mask``) on packed layouts from the JAX package's own
``pack_batch``:

* dq per query head, ``dq = scale * dS K`` with ``dS = P * (dP - D)``,
  ``P = exp(S - lse)`` on attended pairs and ``D = rowsum(dO * O)``;
* dk and dv as the dk/dv kernel writes them: one float32 partial per
  QUERY head (``dV_h = P^T dO``, ``dK_h = dS^T Q``, unscaled), then the
  reduce kernel's sum over each KV head's group in the fixed order
  ``j = 0, 1, ..., r - 1`` (``dk`` times the scale).

In float32 the emulation meets the parity tests' gradient tolerance
(1e-4).  With P and dS rounded to bf16 before their products, as the
kernels do, it stays within ``chip_smoke.py``'s ``TOL_FA_GRAD`` (2e-2
relative L2) of the reference.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.engine import batching as jbatching
from areal_tpu.models import transformer as jt
from areal_tpu_torch.ops import flash_attention as tfa

TOL_GRAD = 1e-4  # float32 gradients, as tests/test_torch_flash_attention.py
TOL_FA_GRAD = 2e-2  # chip_smoke.py: relative L2 of the kernels' gradients


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layout(lens, fixed_len, seed):
    rng = np.random.default_rng(seed)
    sample = JSample.from_default(
        lens, [f"s{i}" for i in range(len(lens))],
        {"packed_input_ids": rng.integers(1, 50, sum(lens)).astype(np.int32)},
    )
    return jbatching.pack_batch(sample, fixed_len=fixed_len)


def emulate_backward(q, k, v, seg, dout, round_bf16=False):
    """(dq, dk, dv) from the backward kernels' arithmetic, in float32;
    with ``round_bf16``, P and dS are rounded to bf16 before their
    products, as on the card."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    r = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 else (
        lambda x: x)
    mask = tfa.attention_mask(seg)  # [B, T, T]
    out, lse = tfa.reference_flash_attention(q, k, v, seg, return_lse=True)
    D = (dout * out).sum(-1)  # [B, T, Hq]
    dq = torch.zeros_like(q)
    dk_ws = torch.zeros_like(q)  # [B, T, Hq, hd]: one partial per head
    dv_ws = torch.zeros_like(q)
    for h in range(Hq):
        hk = h // r
        s = q[:, :, h] @ k[:, :, hk].transpose(-1, -2) * scale
        p = torch.where(mask, torch.exp(s - lse[:, h, :, None]),
                        torch.zeros_like(s))
        dp = dout[:, :, h] @ v[:, :, hk].transpose(-1, -2)
        ds = p * (dp - D[:, :, h, None])
        dq[:, :, h] = scale * (rnd(ds) @ k[:, :, hk])
        dv_ws[:, :, h] = rnd(p).transpose(-1, -2) @ dout[:, :, h]
        dk_ws[:, :, h] = rnd(ds).transpose(-1, -2) @ q[:, :, h]
    # the reduce kernel: each KV head's r partials in the order j = 0..r-1
    dk = dk_ws[:, :, 0::r].clone()
    dv = dv_ws[:, :, 0::r].clone()
    for j in range(1, r):
        dk += dk_ws[:, :, j::r]
        dv += dv_ws[:, :, j::r]
    return dq, dk * scale, dv


LAYOUTS = {
    # packed rows of 133 tokens: several segments, a ragged edge, padding
    "pack_T133": ([70, 40, 90, 33, 5, 61], 133),
    # packed rows of 50 tokens (below one 64-token tile)
    "pack_T50": ([20, 13, 7, 30, 11, 4, 25], 50),
}
#: (Hq, Hkv): GQA ratios 6, 2 and 6 (the trainer's 12 over 2)
HEADS = [(6, 1), (4, 2), (12, 2)]


@pytest.mark.parametrize("round_bf16", [False, True], ids=["f32", "bf16_p_ds"])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"Hq{h[0]}_Hkv{h[1]}")
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_per_head_partials_summed_in_order_match_jax(layout, heads,
                                                     round_bf16):
    lens, fixed_len = LAYOUTS[layout]
    pb = _layout(lens, fixed_len, seed=len(lens))
    seg, pos = pb.seg_ids, pb.positions
    B, T = seg.shape
    Hq, Hkv = heads
    rng = np.random.default_rng(7)
    q, do = (rng.standard_normal((B, T, Hq, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, Hkv, 16)).astype(np.float32)
            for _ in range(2))
    real = seg != 0
    # the loss reads real queries only (padding queries' dO is zero)
    do = do * real[:, :, None, None]

    def jloss(q, k, v):
        mask = jt.make_attention_mask(*map(jnp.asarray, (seg, pos, seg, pos)))
        return jnp.sum(jt.reference_attention(q, k, v, mask) * do)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = emulate_backward(*map(torch.from_numpy, (q, k, v, seg, do)),
                           round_bf16=round_bf16)
    for name, t, j in zip(("dq", "dk", "dv"), got, jg):
        j = np.asarray(j)
        if round_bf16:
            rel = np.linalg.norm(t.numpy() - j) / np.linalg.norm(j)
            assert rel <= TOL_FA_GRAD, (name, rel)
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=TOL_GRAD,
                                       atol=TOL_GRAD, err_msg=name)
    # padding queries get exactly zero dq, padding keys zero dk and dv
    for t, m in ((got[0], real), (got[1], real), (got[2], real)):
        assert (t.numpy()[~m] == 0).all()
