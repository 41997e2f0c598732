"""The paged kernel's tensor-core prefill entry, on the CPU.

The entry itself runs only on a card (``chip_smoke.py`` holds it against
the plain version there).  Here:

* the wrapper's pure routing functions: which C entry a call runs
  (:func:`paged_entry`) and how many key splits it gets (:func:`n_splits`),
  with the split workspace's shapes, over decode and prefill shapes and
  every pool dtype;
* a plain-torch emulation of the entry's arithmetic, held against the JAX
  package's Pallas kernel (interpret mode, as tests/ops/test_paged_attention.py
  runs it) and its jnp reference on the same numpy-seeded inputs, at the
  tolerances ``chip_smoke.py`` holds the kernel to (``TOL_OUT``, ``TOL_M``,
  ``TOL_L_REL``): bf16 q and K multiplied exactly with f32 sums over 64-key
  tiles, an int8 pool's K scale on each score column and V scale on each
  probability column, the online softmax in the log2 domain, and P split
  into ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)`` for the P.V
  product.  The same emulation with P rounded to bf16 alone must miss
  ``TOL_OUT``: the split is what keeps the reference's f32 precision.
"""

import math

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
from areal_tpu_torch.models.paged import quantize_kv
from areal_tpu_torch.ops import paged_attention as tpa

# chip_smoke.py's kernel-vs-plain tolerances
TOL_OUT = 2e-4
TOL_M = 1e-4
TOL_L_REL = 1e-4
#: keys per ring stage of the prefill entry (kPfKeys)
TILE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- routing ------------------------------------------------------------------

POOLS = (torch.float32, torch.bfloat16, torch.float16, torch.int8)


@pytest.mark.parametrize("pool_dtype", POOLS, ids=str)
@pytest.mark.parametrize("q_dtype", (torch.float32, torch.bfloat16,
                                     torch.float16), ids=str)
@pytest.mark.parametrize("Q", (1, 2, 16, 512))
def test_entry_routing(Q, q_dtype, pool_dtype):
    entry = tpa.paged_entry(Q, q_dtype, pool_dtype)
    tensor_cores = (Q > 1 and q_dtype == torch.bfloat16
                    and pool_dtype in (torch.bfloat16, torch.int8))
    assert entry == (tpa.PREFILL_ENTRY if tensor_cores else tpa.DECODE_ENTRY)
    # decode (one query token per row) never leaves the decode entry
    if Q == 1:
        assert entry == tpa.DECODE_ENTRY


@pytest.mark.parametrize(
    "B,Q,capacity,prefill,want",
    [
        # the main path's prefill chunks: eight rows fill the card alone
        (8, 512, 4096, True, 1),
        # one 512-token chunk over a 32768-token table: 96 tiles, 6 splits
        (1, 512, 32768, True, 6),
        # a short table caps the splits at 1024 keys each
        (1, 512, 2048, True, 2),
        (1, 512, 1024, True, 1),
        # decode keeps the decode entry's rule (one-group tiles, at least
        # 256 keys per split, one wave of two blocks per SM)
        (8, 1, 4096, False, 16),
        (16, 1, 32768, False, 8),
    ],
)
def test_split_counts(B, Q, capacity, prefill, want):
    entry = tpa.PREFILL_ENTRY if prefill else tpa.DECODE_ENTRY
    got = tpa.n_splits(B, Q, 12, 2, capacity, entry=entry)
    assert got == want


def test_split_workspace_shapes():
    shape = (1, 512, 12, 128)
    S = tpa.n_splits(1, 512, 12, 2, 32768, entry=tpa.PREFILL_ENTRY)
    ws, ptrs = tpa.split_workspace(S, shape, torch.device("cpu"))
    assert [tuple(t.shape) for t in ws] == [
        (S, 1, 512, 12, 128), (S, 1, 512, 12), (S, 1, 512, 12)]
    assert all(t.dtype == torch.float32 for t in ws)
    assert all(p == t.data_ptr() for p, t in zip(ptrs, ws))
    ws, ptrs = tpa.split_workspace(1, shape, torch.device("cpu"))
    assert ws == () and ptrs == (None, None, None)


# ---- the entry's arithmetic -------------------------------------------------


def emulate_prefill_entry(q, k_pool, v_pool, tables, lengths, k_scale=None,
                          v_scale=None, split_p=True):
    """The prefill entry's arithmetic in plain torch (float32 on bf16 or
    int8 values): per row and KV head, 64-key tiles in order; scores from
    exact products (bf16 x bf16, or bf16 x int8) with f32 sums, scaled in
    the log2 domain (and by each key's K scale); online softmax with exp2;
    P (times each key's V scale) split into bf16 hi and lo parts for P.V.
    With ``split_p`` false, P is rounded to bf16 alone.  Returns (acc, m,
    l) as the kernel does, m in natural units."""
    B, Q, Hq, hd = q.shape
    Hkv = k_pool.shape[1]
    r = Hq // Hkv
    k, v = tpa.gather_paged_kv(k_pool, v_pool, tables)
    k, v = k.float(), v.float()  # int8 values are exact in bf16 and f32
    quant = k_scale is not None
    if quant:
        ks, vs = (x[..., 0] for x in tpa.gather_paged_kv(
            k_scale[..., None], v_scale[..., None], tables))
    R = Q * r
    # grouped query rows: (token, head-in-group) pairs of each KV head
    qg = q.float().reshape(B, Q, Hkv, r, hd).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, Hkv, R, hd)
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    m2 = torch.full((B, Hkv, R), -1e30)
    l = torch.zeros(B, Hkv, R)
    acc = torch.zeros(B, Hkv, R, hd)
    for b in range(B):
        L = int(lengths[b])
        for t0 in range(0, L, TILE):
            kt, vt = k[b, :, t0:t0 + TILE], v[b, :, t0:t0 + TILE]
            valid = torch.arange(kt.shape[1]) < L - t0
            s = qg[b] @ kt.transpose(-1, -2)  # exact products, f32 sums
            f = ks[b, :, t0:t0 + TILE] * scale_log2 if quant else scale_log2
            s = torch.where(valid, s * (f[:, None, :] if quant else f),
                            torch.tensor(-1e30))
            m_new = torch.maximum(m2[b], s.amax(-1))
            alpha = torch.exp2(m2[b] - m_new)
            p = torch.exp2(s - m_new[..., None])
            l[b] = l[b] * alpha + p.sum(-1)
            m2[b] = m_new
            if quant:
                p = p * vs[b, :, t0:t0 + TILE][:, None, :]
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float() if split_p else 0 * hi
            acc[b] = acc[b] * alpha[..., None] + hi @ vt + lo @ vt
    m = torch.where(m2 == -1e30, m2, m2 * math.log(2))

    def ungroup(x, *tail):
        x = x.reshape(B, Hkv, Q, r, *tail).permute(0, 2, 1, 3, *range(4, 4 + len(tail)))
        return x.reshape(B, Q, Hq, *tail)

    return ungroup(acc, hd), ungroup(m), ungroup(l)


def _prefill_inputs(pool, seed=0, B=3, Q=16, Hq=12, Hkv=2, hd=128, BS=128,
                    MB=4, NB=16, lengths=(0, 300, 512)):
    """bf16-rounded q, and a bf16 pool or an int8 pool with its scales,
    from one numpy seed, as (jax args, jax kwargs, torch args)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Q, Hq, hd)).astype(np.float32)
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    kf = rng.standard_normal((NB, Hkv, BS, hd)).astype(np.float32)
    vf = rng.standard_normal((NB, Hkv, BS, hd)).astype(np.float32)
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    if pool == "int8":
        kq, ksc = quantize_kv(torch.from_numpy(kf))
        vq, vsc = quantize_kv(torch.from_numpy(vf))
        jx = (jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()))
        jkw = dict(k_scale=jnp.asarray(ksc.numpy()),
                   v_scale=jnp.asarray(vsc.numpy()))
        tx = (tq, kq, vq, torch.from_numpy(tables), torch.from_numpy(lens),
              ksc, vsc)
    else:
        kb = np.array(jnp.asarray(kf, jnp.bfloat16).astype(jnp.float32))
        vb = np.array(jnp.asarray(vf, jnp.bfloat16).astype(jnp.float32))
        jx = (jnp.asarray(q), jnp.asarray(kb, jnp.bfloat16),
              jnp.asarray(vb, jnp.bfloat16))
        jkw = {}
        tx = (tq, torch.from_numpy(kb).to(torch.bfloat16),
              torch.from_numpy(vb).to(torch.bfloat16),
              torch.from_numpy(tables), torch.from_numpy(lens), None, None)
    jx = jx + (jnp.asarray(tables), jnp.asarray(lens))
    return jx, jkw, tx, lens


def _errors(got, ref, lens):
    """(max |acc/l - ref|, max |m - ref|, max |l - ref| / max(1, |ref|))
    over rows with a prefix, as chip_smoke.check_partials measures."""
    acc, m, l = (np.asarray(x, np.float64) for x in got)
    acc_r, m_r, l_r = (np.asarray(x, np.float64) for x in ref)
    valid = lens > 0
    out = acc[valid] / l[valid][..., None]
    out_r = acc_r[valid] / l_r[valid][..., None]
    return (float(np.abs(out - out_r).max()),
            float(np.abs(m[valid] - m_r[valid]).max()),
            float((np.abs(l - l_r) / np.maximum(1.0, np.abs(l_r))).max()))


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_split_p_emulation_meets_the_kernel_tolerances(pool):
    jx, jkw, tx, lens = _prefill_inputs(pool)
    got = emulate_prefill_entry(*tx)
    for ref in (jax_reference_paged_partials(*jx, **jkw),
                jax_paged_flash_attention(*jx, interpret=True, **jkw)):
        err_out, err_m, err_l = _errors(got, ref, lens)
        assert err_out <= TOL_OUT and err_m <= TOL_M and err_l <= TOL_L_REL, (
            err_out, err_m, err_l)
    # a row with no prefix is exactly acc = 0, l = 0, m = -1e30
    acc, m, l = got
    empty = torch.from_numpy(lens) == 0
    assert (acc[empty] == 0).all() and (l[empty] == 0).all()
    assert (m[empty] == -1e30).all()


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_bf16_only_p_misses_the_output_tolerance(pool):
    """The negative control: P rounded to bf16 alone (about 8 bits) errs
    past TOL_OUT, so the kernel needs the P_lo product."""
    jx, jkw, tx, lens = _prefill_inputs(pool)
    got = emulate_prefill_entry(*tx, split_p=False)
    err_out, _, _ = _errors(got, jax_reference_paged_partials(*jx, **jkw),
                            lens)
    assert err_out > TOL_OUT


def test_emulation_matches_the_port_plain_version_at_a_page_crossing_tile():
    """Tiles that span pages (BS = 48 is not a multiple of 64) and a
    length that ends inside a tile: the emulation and the port's plain
    version agree."""
    jx, jkw, tx, lens = _prefill_inputs("bfloat16", seed=3, BS=48, MB=6,
                                        NB=24, lengths=(97, 288, 1))
    got = emulate_prefill_entry(*tx)
    ref = tpa.reference_paged_partials(*tx)
    err_out, err_m, err_l = _errors(got, ref, lens)
    assert err_out <= TOL_OUT and err_m <= TOL_M and err_l <= TOL_L_REL


def test_prefill_route_never_falls_back():
    """A prefill-shaped call off the CPU goes to the tensor-core entry,
    which refuses it here (no card); nothing is counted."""
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 16, 4, 2, 128, 4, 64, 2
    meta = dict(device="meta")
    q = torch.empty((B, Q, Hq, hd), dtype=torch.bfloat16, **meta)
    bf = [torch.empty((NB, Hkv, BS, hd), dtype=torch.bfloat16, **meta)
          for _ in range(2)]
    i8 = [torch.empty((NB, Hkv, BS, hd), dtype=torch.int8, **meta)
          for _ in range(2)]
    scales = [torch.empty((NB, Hkv, BS), **meta) for _ in range(2)]
    tables = torch.empty((B, MB), dtype=torch.int32, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    fn = tpa.paged_flash_attention
    for pools, sc in ((bf, ()), (i8, scales)):
        assert tpa.paged_entry(Q, q.dtype, pools[0].dtype) == tpa.PREFILL_ENTRY
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, *pools, tables, lengths, *sc)
    assert fn.launches == fn.int8_launches == fn.prefill_launches == 0


def test_prefill_entry_is_in_the_source():
    from pathlib import Path

    src = (Path(tpa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    assert f"int {tpa.PREFILL_ENTRY}(" in src and f"int {tpa.DECODE_ENTRY}(" in src
    # the products run on wgmma (sm_90a)
    header = (Path(tpa.__file__).resolve().parents[1] / "csrc"
              / "mma_common.cuh").read_text()
    assert "wgmma.mma_async" in header
