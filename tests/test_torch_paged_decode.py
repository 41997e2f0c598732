"""The paged kernel's decode entry (``csrc/paged_attention.cu``
``paged_attention_fwd``), its design emulated on the CPU.

The entry runs only on a card (``chip_smoke.py`` holds it against the
plain version there).  Here:

* the split rule, :func:`n_splits`, as a pure function of shapes: one
  wave of at most 264 blocks, at least 256 keys per split;
* each split's key range from the row's live length: an equal share of
  the live 64-key tiles, the splits past the length empty;
* a plain-torch emulation of the entry's arithmetic: per split, four
  warps of 16 keys per tile, each with its own online softmax in the log2
  domain (an int8 pool's K scale on the score, its V scale on the
  probability), merged across the warps, then the live splits merged in
  split order.  It is held against the JAX package's Pallas kernel
  (interpret mode, as tests/ops/test_paged_attention.py runs it) and its
  jnp reference within ``chip_smoke.py``'s ``TOL_OUT``, ``TOL_M`` and
  ``TOL_L_REL``, on bf16 and int8 pools at lengths 0, 1, BS-1, BS, BS+1
  and full;
* the ticket protocol of the fused merge: whatever order the splits
  finish in, the last one merges in split order, so the result is
  bit-identical, and the counter is back at 0.
"""

import itertools
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
KT = 64  # keys per ring stage (kKeys)
WARPS = 4
WK = KT // WARPS  # keys per warp and stage
NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- splits -------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 2, 8, 16, 64, 300])
@pytest.mark.parametrize("capacity", [256, 4096, 32768])
@pytest.mark.parametrize("heads", [(12, 2), (8, 8), (32, 8)])
def test_split_rule_is_one_wave_of_long_enough_splits(B, capacity, heads):
    Hq, Hkv = heads
    S = tpa.n_splits(B, 1, Hq, Hkv, capacity)
    n_qtiles = -(-Hq // Hkv // 8)
    blocks = S * n_qtiles * Hkv * B
    assert S >= 1
    if S > 1:
        # one wave of two blocks per SM on 132 SMs, >= 256 keys per split
        assert blocks <= 264 and capacity // S >= 256
        # and no more splits would still fit both
        assert (S + 1) * n_qtiles * Hkv * B > 264 or capacity // (S + 1) < 256


def test_split_counts_at_the_main_path_shapes():
    # the 8-row decode shape (a 4096-token table): 16 splits of 256 keys
    assert tpa.n_splits(8, 1, 12, 2, 4096) == 16
    # the recipe's 16 rows of 32768 tokens: 8 splits, 256 blocks
    assert tpa.n_splits(16, 1, 12, 2, 32768) == 8
    # no split once the rows alone fill the wave
    assert tpa.n_splits(200, 1, 12, 2, 32768) == 1


def split_tiles(length, S):
    """The decode entry's split ranges of one row: ``[(t_begin, n), ...]``
    for the S splits (64-key tiles; n = 0 past the live length)."""
    n_tiles = -(-max(0, length) // KT)
    per = -(-n_tiles // S)
    return [(s * per, max(0, min(n_tiles, s * per + per) - s * per))
            for s in range(S)]


@pytest.mark.parametrize("S", [1, 3, 8, 16])
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 255, 256, 257, 1365,
                                    4096])
def test_split_ranges_cover_the_live_tiles_once(length, S):
    ranges = split_tiles(length, S)
    n_tiles = -(-length // KT)
    tiles = [t for t0, n in ranges for t in range(t0, t0 + n)]
    assert tiles == list(range(n_tiles))  # in split order, each once
    live = [s for s, (_, n) in enumerate(ranges) if n > 0]
    assert live == list(range(len(live)))  # live splits come first
    per = -(-n_tiles // S) if n_tiles else 0
    assert len(live) == (-(-n_tiles // per) if per else 0)
    assert max((n for _, n in ranges), default=0) <= max(per, 0)


# ---- the entry's arithmetic ---------------------------------------------------


def split_partials(qg, k, v, ks, vs, t0, n, length, scale_log2):
    """One split's partials (acc [R, hd], m [R] natural units, l [R]) over
    tiles [t0, t0 + n): four warps of 16 keys per tile, each with its own
    log2-domain online softmax, merged at the end."""
    R, hd = qg.shape
    ms, ls, accs = [], [], []
    for w in range(WARPS):
        m = torch.full((R,), NEG)
        l = torch.zeros(R)
        acc = torch.zeros(R, hd)
        for t in range(t0, t0 + n):
            a = t * KT + w * WK
            if a >= length:
                continue
            b = min(a + WK, length)
            f = scale_log2 * (ks[a:b] if ks is not None else 1.0)
            s = (qg @ k[a:b].T) * f  # [R, keys]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            pv = p * vs[a:b] if vs is not None else p
            acc = acc * alpha[:, None] + pv @ v[a:b]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    M = torch.stack(ms).amax(0)
    e = [torch.exp2(mw - M) for mw in ms]
    acc = sum(ac * ew[:, None] for ac, ew in zip(accs, e))
    L = sum(lw * ew for lw, ew in zip(ls, e))
    return acc, M * math.log(2), L


def merge_in_order(parts):
    """The fixed-order merge of the live splits' partials."""
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    L = torch.zeros_like(parts[0][2])
    for a, m, l in parts:
        e = torch.exp(m - M)
        acc = acc + a * e[:, None]
        L = L + l * e
    return acc, M, L


def emulate_decode(q, k_pool, v_pool, tables, lengths, k_scale=None,
                   v_scale=None, S=None):
    """The decode entry's (acc, m, l) for q [B, 1, Hq, hd] (float values),
    with ``S`` splits (default: the wrapper's rule)."""
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    r = Hq // Hkv
    assert Q == 1
    S = S or tpa.n_splits(B, Q, Hq, Hkv, tables.shape[1] * BS)
    kg, vg = (x.float() for x in tpa.gather_paged_kv(k_pool, v_pool, tables))
    quant = k_scale is not None
    if quant:
        ksg, vsg = (x[..., 0] for x in tpa.gather_paged_kv(
            k_scale[..., None], v_scale[..., None], tables))
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    acc = torch.zeros(B, Q, Hq, hd)
    m = torch.full((B, Q, Hq), NEG)
    l = torch.zeros(B, Q, Hq)
    for b in range(B):
        length = min(int(lengths[b]), tables.shape[1] * BS)
        for h in range(Hkv):
            qg = q[b, 0, h * r:(h + 1) * r].float()
            parts = [split_partials(
                qg, kg[b, h], vg[b, h], ksg[b, h] if quant else None,
                vsg[b, h] if quant else None, t0, n, length, scale_log2)
                for t0, n in split_tiles(length, S) if n > 0]
            if not parts:
                continue  # a length-0 row: acc 0, m -1e30, l 0
            a, mm, ll = parts[0] if len(parts) == 1 else merge_in_order(parts)
            acc[b, 0, h * r:(h + 1) * r] = a
            m[b, 0, h * r:(h + 1) * r] = mm
            l[b, 0, h * r:(h + 1) * r] = ll
    return acc, m, l


def _decode_inputs(pool, seed=0, Hq=12, Hkv=2, hd=32, BS=64, MB=16,
                   lengths=(0, 1, 63, 64, 65, 1024)):
    """bf16-rounded q, and a bf16 pool or an int8 pool with its scales,
    from one numpy seed, as (jax args, jax kwargs, torch args, lengths)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    NB = B * MB
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    kf = rng.standard_normal((NB, Hkv, BS, hd)).astype(np.float32)
    vf = rng.standard_normal((NB, Hkv, BS, hd)).astype(np.float32)
    tables = rng.permutation(NB).reshape(B, MB).astype(np.int32)
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


@pytest.mark.parametrize("S", [None, 3])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_split_emulation_meets_the_kernel_tolerances(pool, S):
    jx, jkw, tx, lens = _decode_inputs(pool)
    if S is None:  # the wrapper's rule splits this 1024-key table in 4
        assert tpa.n_splits(len(lens), 1, 12, 2, 16 * 64) == 4
    got = emulate_decode(*tx, S=S)
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


def test_emulation_at_page_crossing_tiles_matches_the_plain_version():
    """Pages of 48 slots (64-key tiles span pages) and lengths that end
    inside a tile: the emulation equals the port's plain version."""
    jx, jkw, tx, lens = _decode_inputs("bfloat16", seed=3, BS=48, MB=6,
                                       lengths=(97, 288, 1, 0, 200))
    got = emulate_decode(*tx, S=3)
    err_out, err_m, err_l = _errors(got, tpa.reference_paged_partials(*tx),
                                    lens)
    assert err_out <= TOL_OUT and err_m <= TOL_M and err_l <= TOL_L_REL


def test_merge_is_one_result_whatever_order_the_splits_finish():
    """The ticket protocol: each split takes a ticket when its partials are
    written; the one that draws the last merges every split in split
    order and resets the counter.  Every finishing order gives the same
    bits; merging in finishing order instead would not."""
    _, _, tx, lens = _decode_inputs("bfloat16", seed=5, lengths=(1024,))
    q, kp, vp, tables, _, _, _ = tx
    kg, vg = (x.float() for x in tpa.gather_paged_kv(kp, vp, tables))
    scale_log2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    qg = q[0, 0, :6].float()
    ranges = split_tiles(1024, 5)
    parts = [split_partials(qg, kg[0, 0], vg[0, 0], None, None, t0, n, 1024,
                            scale_log2) for t0, n in ranges if n > 0]
    n_live = len(parts)
    assert n_live == 4  # 16 tiles over 5 splits: 4 live of 4 tiles each
    results, in_finish_order = [], []
    for order in itertools.permutations(range(n_live)):
        counter = 0
        for s in order:
            ticket, counter = counter, counter + 1
            if ticket == n_live - 1:
                results.append(merge_in_order(parts))
                counter = 0
        assert counter == 0
        in_finish_order.append(merge_in_order([parts[s] for s in order]))
    first = results[0]
    assert all(all(torch.equal(a, b) for a, b in zip(first, r))
               for r in results)
    assert not all(torch.equal(first[0], r[0]) for r in in_finish_order)


def test_decode_route_never_falls_back():
    """A decode call off the CPU goes to the decode entry, which refuses it
    here (no card); nothing is counted and no ticket counter is made."""
    B, Hq, Hkv, hd, NB, BS, MB = 2, 12, 2, 128, 4, 64, 2
    meta = dict(device="meta")
    q = torch.empty((B, 1, Hq, hd), dtype=torch.bfloat16, **meta)
    pools = [torch.empty((NB, Hkv, BS, hd), dtype=torch.bfloat16, **meta)
             for _ in range(2)]
    tables = torch.empty((B, MB), dtype=torch.int32, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    fn = tpa.paged_flash_attention
    before = (fn.launches, fn.int8_launches, len(tpa._TICKETS))
    assert tpa.paged_entry(1, q.dtype, pools[0].dtype) == tpa.DECODE_ENTRY
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(q, *pools, tables, lengths)
    assert (fn.launches, fn.int8_launches, len(tpa._TICKETS)) == before


def test_ticket_counters_are_kept_and_grown_zeroed():
    dev = torch.device("cpu")
    a = tpa.ticket_counters(dev, 123, 16)
    assert a.dtype == torch.int32 and a.numel() == 16 and (a == 0).all()
    assert tpa.ticket_counters(dev, 123, 8) is a  # kept from call to call
    b = tpa.ticket_counters(dev, 123, 64)  # grown, zeroed
    assert b.numel() == 64 and (b == 0).all()
    assert tpa.ticket_counters(dev, 456, 8) is not b  # per stream
    for key in [(dev, 123), (dev, 456)]:
        tpa._TICKETS.pop(key)
