"""The deep paged kernel's tensor-core body (``csrc/paged_attention_deep.cu``
``paged_deep_tc_kernel``, which also serves ``flash_decode``), its design
on the CPU.

The kernel runs only on a card (``chip_smoke.py`` holds it against the
plain version there).  Here:

* a plain-torch emulation of its arithmetic: per split, 64-key tiles with
  four warps of 16 keys each, scores from exact products (bf16 q times
  bf16 K, or times int8 K widened exactly) with f32 sums, an int8 pool's K
  scale on each score and V scale on each probability, a log2-domain
  online softmax per warp, P split into ``P_hi = bf16(P)`` and ``P_lo =
  bf16(P - P_hi)`` for P V, the warps merged, then the live splits merged
  in split order.  It is held against the JAX package's Pallas kernels in
  interpret mode (``paged_flash_attention_deep`` and ``flash_decode``, as
  tests/ops/ runs them) and the jnp and port plain versions within
  ``chip_smoke.py``'s ``TOL_OUT``, ``TOL_M`` and ``TOL_L_REL``, at the
  main path's widths (Hq 12, Hkv 2, hd 128), on bf16 and int8 pools, with
  pages of 256 (the TMA route) and 48 (per-key copies, tiles spanning
  pages), length-0 rows exact, a layered pool, Q > 1 and a contiguous
  cache; P rounded to bf16 alone misses ``TOL_OUT``;
* the register fragments of one warp's 16-key step, lane by lane
  (``ldmatrix`` from the swizzled tile, the int8 widening with its
  permuted head-dim order, ``mma.sync``, ``movmatrix``), on integer data
  where every order of summation is exact: S^T = K Q^T and O^T = V^T P^T
  land where the kernel's epilogue reads them;
* the routes as pure functions: the body from dtypes (bf16 q over bf16 or
  int8 pools to tensor cores, float32 and float16 q to CUDA cores), the
  copy route from page size, row bytes and scale alignment, the main
  path's pool against TMA's limits, and the split rule at the main path's
  shapes.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from areal_tpu.ops.decode_attention import (
    reference_decode_partials as jax_reference_decode_partials,
)
from areal_tpu.ops.paged_attention import (
    paged_flash_attention_deep as jax_deep,
)
from areal_tpu.ops.paged_attention import (
    reference_paged_partials as jax_reference_paged_partials,
)
from areal_tpu_torch.models.config import qwen25_15b_config
from areal_tpu_torch.models.paged import alloc_kv_pool, quantize_kv
from areal_tpu_torch.ops import decode_attention as tda
from areal_tpu_torch.ops import paged_attention as tpa

# chip_smoke.py's kernel-vs-plain tolerances
TOL_OUT = 2e-4
TOL_M = 1e-4
TOL_L_REL = 1e-4
KT = 64  # keys per ring stage (kTcKeys)
WARPS = 4  # consumer warps (kTcWarps)
WK = KT // WARPS  # keys per warp and stage: one mma M (scores) or K (P V)
NEG = -1e30
CSRC = Path(tpa.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the body's arithmetic ----------------------------------------------------


def split_partials(qg, k, v, ks, vs, t0, n, length, scale_log2, split_p):
    """One split's partials (acc [R, hd], m [R] natural units, l [R]) over
    tiles [t0, t0 + n): per warp its 16 keys of each tile with a log2
    online softmax, P V with P split into bf16 hi and lo (or bf16 alone),
    the warps merged at the end.  k and v hold bf16 values or int8
    integers (exact in f32); ks and vs their scales or None."""
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
            s = (qg @ k[a:b].T) * f  # exact products, f32 sums
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            if vs is not None:
                p = p * vs[a:b]
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float() if split_p else 0 * hi
            acc = acc * alpha[:, None] + hi @ v[a:b] + lo @ v[a:b]
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
    """The ticket merge: every live split's partials in split order."""
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    L = torch.zeros_like(parts[0][2])
    for a, m, l in parts:
        e = torch.exp(m - M)
        acc = acc + a * e[:, None]
        L = L + l * e
    return acc, M, L


def split_tiles(length, S):
    """Each split's (first tile, tiles) of one row: an equal share of the
    row's live 64-key tiles."""
    n_tiles = -(-max(0, length) // KT)
    per = -(-n_tiles // S)
    return [(s * per, max(0, min(n_tiles, s * per + per) - s * per))
            for s in range(S)]


def emulate_deep(q, k_pool, v_pool, tables, lengths, k_scale=None,
                 v_scale=None, S=None, split_p=True):
    """The tensor-core body's (acc, m, l) for q [B, Q, Hq, hd] over a pool
    layer [NB, Hkv, BS, hd], with ``S`` splits (default: the wrapper's
    rule).  Query rows are independent, so the 8-row tiles need no
    modelling: each (row, KV head) takes its Q * r grouped rows at once."""
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    r = Hq // Hkv
    MB = tables.shape[1]
    S = S or tpa.n_splits(B, Q, Hq, Hkv, MB * BS, entry=tpa.DEEP_ENTRY)
    kg, vg = (x.float() for x in tpa.gather_paged_kv(k_pool, v_pool, tables))
    quant = k_scale is not None
    if quant:
        ksg, vsg = (x[..., 0] for x in tpa.gather_paged_kv(
            k_scale[..., None], v_scale[..., None], tables))
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    # grouped rows (token, head in group) of each KV head
    qg_all = q.float().reshape(B, Q, Hkv, r, hd).permute(0, 2, 1, 3, 4)
    qg_all = qg_all.reshape(B, Hkv, Q * r, hd)
    acc = torch.zeros(B, Hkv, Q * r, hd)
    m = torch.full((B, Hkv, Q * r), NEG)
    l = torch.zeros(B, Hkv, Q * r)
    for b in range(B):
        length = max(0, min(int(lengths[b]), MB * BS))
        for h in range(Hkv):
            parts = [split_partials(
                qg_all[b, h], kg[b, h], vg[b, h],
                ksg[b, h] if quant else None, vsg[b, h] if quant else None,
                t0, n, length, scale_log2, split_p)
                for t0, n in split_tiles(length, S) if n > 0]
            if not parts:
                continue  # a length-0 row: acc 0, m -1e30, l 0
            acc[b, h], m[b, h], l[b, h] = (
                parts[0] if len(parts) == 1 else merge_in_order(parts))

    def ungroup(x, *tail):
        x = x.reshape(B, Hkv, Q, r, *tail)
        x = x.permute(0, 2, 1, 3, *range(4, 4 + len(tail)))
        return x.reshape(B, Q, Hq, *tail)

    return ungroup(acc, hd), ungroup(m), ungroup(l)


def _pools(pool, rng, shape):
    """bf16-rounded float pools, or int8 pools with their scales, as
    (torch k, torch v, scales or (None, None))."""
    kf = rng.standard_normal(shape).astype(np.float32)
    vf = rng.standard_normal(shape).astype(np.float32)
    if pool == "int8":
        kq, ksc = quantize_kv(torch.from_numpy(kf))
        vq, vsc = quantize_kv(torch.from_numpy(vf))
        return kq, vq, (ksc, vsc)
    return (torch.from_numpy(kf).to(torch.bfloat16),
            torch.from_numpy(vf).to(torch.bfloat16), (None, None))


def _inputs(pool, lengths, seed=0, Q=1, Hq=12, Hkv=2, hd=128, BS=256, MB=2,
            L=None):
    """bf16 q and a (layer-stacked when ``L``) pool behind a scrambled
    table: (torch q, k, v, tables, lengths, k_scale, v_scale)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    NB = B * MB + 1
    q = rng.standard_normal((B, Q, Hq, hd)).astype(np.float32)
    lead = () if L is None else (L,)
    k, v, (ks, vs) = _pools(pool, rng, lead + (NB, Hkv, BS, hd))
    tables = rng.permutation(NB)[: B * MB].reshape(B, MB).astype(np.int32)
    return (torch.from_numpy(q).to(torch.bfloat16), k, v,
            torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32),
            ks, vs)


def _jax_args(tx):
    q, k, v, tables, lengths, ks, vs = tx
    conv = (lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
            if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))
    args = tuple(conv(t) for t in (q, k, v, tables, lengths))
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                    v_scale=jnp.asarray(vs.numpy()))
    return args, kw


def _errors(got, ref, lens):
    """(max |acc/l - ref|, max |m - ref|, max |l - ref| / max(1, |ref|))
    over rows with a prefix, as chip_smoke.check_partials measures."""
    acc, m, l = (np.asarray(x, np.float64) for x in got)
    acc_r, m_r, l_r = (np.asarray(x, np.float64) for x in ref)
    valid = np.asarray(lens) > 0
    out = acc[valid] / l[valid][..., None]
    out_r = acc_r[valid] / l_r[valid][..., None]
    return (float(np.abs(out - out_r).max()),
            float(np.abs(m[valid] - m_r[valid]).max()),
            float((np.abs(l - l_r) / np.maximum(1.0, np.abs(l_r))).max()))


def _assert_close(got, refs, lens):
    for ref in refs:
        err_out, err_m, err_l = _errors(got, ref, lens)
        assert err_out <= TOL_OUT and err_m <= TOL_M and err_l <= TOL_L_REL, (
            err_out, err_m, err_l)
    # a row with no prefix is exactly acc = 0, l = 0, m = -1e30
    acc, m, l = got
    empty = torch.as_tensor(np.asarray(lens)) == 0
    assert (acc[empty] == 0).all() and (l[empty] == 0).all()
    assert (m[empty] == NEG).all()


def _edge_lengths(BS, MB):
    return [0, 1, 63, 64, 65, BS - 1, BS, BS + 1, MB * BS]


@pytest.mark.parametrize("BS,MB", [(256, 2), (48, 6)], ids=["tma", "per-key"])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_emulation_meets_the_kernel_tolerances(pool, BS, MB):
    tx = _inputs(pool, _edge_lengths(BS, MB), seed=1, BS=BS, MB=MB)
    route = tpa.deep_copy_route(BS, 128, tx[1].dtype, tx[5])
    assert route == ("tma" if BS == 256 else "cp.async")
    got = emulate_deep(*tx)
    args, kw = _jax_args(tx)
    _assert_close(got, (jax_deep(*args, interpret=True, **kw),
                        jax_reference_paged_partials(*args, **kw),
                        tpa.reference_paged_partials(*tx)), tx[4])


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_split_counts_do_not_move_the_result_past_the_tolerances(pool, S):
    tx = _inputs(pool, [0, 1, 130, 512, 300], seed=2)
    got = emulate_deep(*tx, S=S)
    _assert_close(got, (tpa.reference_paged_partials(*tx),), tx[4])


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_bf16_only_p_misses_the_output_tolerance(pool):
    """The negative control: P rounded to bf16 alone (8 bits) errs past
    TOL_OUT on short rows, so the body needs the P_lo product."""
    tx = _inputs(pool, [16, 24, 32, 40, 48, 56], seed=3)
    got = emulate_deep(*tx, split_p=False)
    err_out, _, _ = _errors(got, tpa.reference_paged_partials(*tx), tx[4])
    assert err_out > TOL_OUT


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_layered_pool(pool):
    """A layer's slice of the stacked pool (a strided view), against the
    JAX kernel picking the layer inside."""
    L = 2
    tx = _inputs(pool, [300, 0, 63, 512], seed=4, L=L)
    q, k, v, tables, lengths, ks, vs = tx
    args, kw = _jax_args(tx)
    for layer in range(L):
        sl = (q, k[layer], v[layer], tables, lengths,
              None if ks is None else ks[layer],
              None if vs is None else vs[layer])
        got = emulate_deep(*sl)
        ref = jax_deep(*args, layer=jnp.int32(layer), interpret=True, **kw)
        _assert_close(got, (ref, tpa.reference_paged_partials(*sl)), lengths)


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_multi_query_tiles(pool):
    """Q = 4 at GQA 6: 24 grouped rows, three 8-row query tiles."""
    tx = _inputs(pool, [0, 200, 512], seed=5, Q=4)
    got = emulate_deep(*tx)
    args, kw = _jax_args(tx)
    _assert_close(got, (jax_deep(*args, interpret=True, **kw),
                        tpa.reference_paged_partials(*tx)), tx[4])


@pytest.mark.parametrize("S", [512, 200], ids=["tma", "per-key"])
def test_flash_decode_over_a_contiguous_cache(S):
    """flash_decode's cache [B, Hkv, S, hd] as a pool of B pages of S
    tokens behind the table [[0], [1], ...]: the emulation against the
    JAX Pallas kernel (interpret mode) and both plain versions."""
    rng = np.random.default_rng(6)
    B = 5
    q = torch.from_numpy(rng.standard_normal((B, 12, 128)).astype(
        np.float32)).to(torch.bfloat16)
    k, v, _ = _pools("bfloat16", rng, (B, 2, S, 128))
    lengths = torch.tensor([0, 1, 65, S - 1, S], dtype=torch.int32)
    tables = torch.arange(B, dtype=torch.int32)[:, None]
    assert tpa.deep_copy_route(S, 128, k.dtype) == (
        "tma" if S % 64 == 0 else "cp.async")
    acc, m, l = emulate_deep(q[:, None], k, v, tables, lengths)
    got = (acc[:, 0], m[:, 0], l[:, 0])
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    jl = jnp.asarray(lengths.numpy())
    block = 256 if S % 256 == 0 else 40  # the JAX kernel's blocks divide S
    _assert_close(got, (jax_flash_decode(jq, jk, jv, jl, block_size=block,
                                         interpret=True),
                        jax_reference_decode_partials(jq, jk, jv, jl),
                        tda.reference_decode_partials(q, k, v, lengths)),
                  lengths)


# ---- one warp's register fragments, lane by lane ------------------------------


def tile_off(key, byte):
    """The staged tile's swizzled byte offset (csrc tile_off)."""
    return ((byte >> 7) * (KT * 128) + key * 128
            + ((((byte & 127) >> 4) ^ (key & 7)) << 4) + (byte & 15))


def stage(rows):
    """Key rows [64, row_bytes] (uint8) -> the swizzled tile (uint8)."""
    n_keys, nbytes = rows.shape
    tile = np.zeros((nbytes + 127) // 128 * KT * 128, np.uint8)
    for key in range(n_keys):
        for byte in range(nbytes):
            tile[tile_off(key, byte)] = rows[key, byte]
    return tile


def ldmatrix_x4(tile, row_addr, trans=False):
    """Each lane's four 32-bit words (as 4-byte arrays) from four 8x8 b16
    matrices whose 16-byte rows lanes 8j..8j+7 address."""
    out = np.zeros((32, 4, 4), np.uint8)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for j in range(4):
            rows = [row_addr[8 * j + i] for i in range(8)]
            if trans:  # elements (row 2tq, col g) and (row 2tq + 1, col g)
                out[lane, j, :2] = tile[rows[2 * tq] + 2 * g:][:2]
                out[lane, j, 2:] = tile[rows[2 * tq + 1] + 2 * g:][:2]
            else:  # row g, elements 2tq and 2tq + 1
                out[lane, j] = tile[rows[g] + 4 * tq:][:4]
    return out


def widen(words, cross=False):
    """int8 bytes of a word -> bf16 pairs (e0, e1), (e2, e3); or with
    ``cross`` (e0, e2), (e1, e3), as floats."""
    e = words.view(np.int8).astype(np.float32)
    if cross:
        return np.stack([e[..., 0], e[..., 2]], -1), np.stack([e[..., 1], e[..., 3]], -1)
    return e[..., 0:2], e[..., 2:4]


def mma(a, b0, b1):
    """D = A B of one warp's m16n8k16 fragments: a [32, 4, 2], b0/b1
    [32, 2] (pairs of values); returns d [32, 4]."""
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for x in range(2):
            A[g, 2 * tq + x] = a[lane, 0, x]
            A[g + 8, 2 * tq + x] = a[lane, 1, x]
            A[g, 2 * tq + 8 + x] = a[lane, 2, x]
            A[g + 8, 2 * tq + 8 + x] = a[lane, 3, x]
            Bm[2 * tq + x, g] = b0[lane, x]
            Bm[2 * tq + 8 + x, g] = b1[lane, x]
    D = A @ Bm
    d = np.zeros((32, 4))
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        d[lane] = [D[g, 2 * tq], D[g, 2 * tq + 1], D[g + 8, 2 * tq],
                   D[g + 8, 2 * tq + 1]]
    return d


def movmatrix_trans(pairs):
    """The transpose of an 8x8 matrix held as fragments [32, 2]."""
    M = np.zeros((8, 8))
    for lane in range(32):
        M[lane >> 2, 2 * (lane & 3):2 * (lane & 3) + 2] = pairs[lane]
    out = np.zeros((32, 2))
    for lane in range(32):
        out[lane] = M.T[lane >> 2, 2 * (lane & 3):2 * (lane & 3) + 2]
    return out


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("warp", [0, 3])
def test_warp_fragments_land_where_the_epilogue_reads_them(pool, warp):
    """One warp's 16 keys of a stage, hd = 64, through the kernel's
    fragment moves on small integers (every sum exact): S^T = K Q^T and
    O^T = V^T P^T equal the direct products, with the int8 body's permuted
    head-dim order undone by the epilogue's dim mapping."""
    rng = np.random.default_rng(7 + warp)
    hd, KS = 64, 4
    quant = pool == "int8"
    qv = rng.integers(-4, 5, (8, hd)).astype(np.float32)  # 8 grouped rows
    kv = rng.integers(-127, 128, (KT, hd)).astype(np.float32)
    vv = rng.integers(-127, 128, (KT, hd)).astype(np.float32)
    if quant:
        k_rows = kv.astype(np.int8).view(np.uint8)
        v_rows = vv.astype(np.int8).view(np.uint8)
    else:
        k_rows = torch.from_numpy(kv).to(torch.bfloat16).view(torch.uint8).numpy()
        v_rows = torch.from_numpy(vv).to(torch.bfloat16).view(torch.uint8).numpy()
    k_rows = k_rows.reshape(KT, -1)
    v_rows = v_rows.reshape(KT, -1)
    Kt, Vt = stage(k_rows), stage(v_rows)
    k0 = warp * WK
    lanes = np.arange(32)
    a_key = k0 + (lanes & 7) + ((lanes >> 3) & 1) * 8
    a_chunk = lanes >> 4
    v_key = k0 + (lanes & 7) + (lanes >> 4) * 8
    v_chunk = (lanes >> 3) & 1
    g, tq = lanes >> 2, lanes & 3

    def b16(words):  # bf16 words -> value pairs
        return torch.from_numpy(words.copy()).view(torch.bfloat16).float().numpy()

    # Q^T's B fragments (row g): dims (16c + 2tq, +1), (16c + 2tq + 8, +9);
    # int8: (16c + 4tq, +1), (16c + 4tq + 2, +3)
    qf = []
    for c in range(KS):
        d0 = 16 * c + (4 * tq if quant else 2 * tq)
        d1 = d0 + (2 if quant else 8)
        qf.append((np.stack([qv[g, d0], qv[g, d0 + 1]], -1),
                   np.stack([qv[g, d1], qv[g, d1 + 1]], -1)))
    sc = np.zeros((32, 4))
    if quant:
        for c2 in range(KS // 2):
            x = ldmatrix_x4(Kt, [tile_off(a_key[i], (2 * c2 + a_chunk[i]) * 16)
                                 for i in range(32)])
            for step, (lo_j, hi_j) in enumerate(((0, 1), (2, 3))):
                a0, a2 = widen(x[:, lo_j])
                a1, a3 = widen(x[:, hi_j])
                a = np.stack([a0, a1, a2, a3], 1)
                sc += mma(a, *qf[2 * c2 + step])
    else:
        for c in range(KS):
            x = ldmatrix_x4(Kt, [tile_off(a_key[i], (2 * c + a_chunk[i]) * 16)
                                 for i in range(32)])
            a = np.stack([b16(x[:, j]) for j in range(4)], 1)
            sc += mma(a, *qf[c])
    S_T = kv[k0:k0 + WK] @ qv.T  # [16 keys, 8 rows]
    for lane in range(32):
        want = [S_T[g[lane], 2 * tq[lane]], S_T[g[lane], 2 * tq[lane] + 1],
                S_T[g[lane] + 8, 2 * tq[lane]], S_T[g[lane] + 8, 2 * tq[lane] + 1]]
        np.testing.assert_array_equal(sc[lane], want)

    # P (small integers here) from the score fragment's places, turned
    # into P^T's B fragments by movmatrix
    P = rng.integers(0, 3, (WK, 8)).astype(np.float32)  # [keys, rows]
    pa_ = np.stack([P[g, 2 * tq], P[g, 2 * tq + 1]], -1)
    pb_ = np.stack([P[g + 8, 2 * tq], P[g + 8, 2 * tq + 1]], -1)
    b0, b1 = movmatrix_trans(pa_), movmatrix_trans(pb_)
    acc = np.zeros((KS, 32, 4))
    if quant:
        for c2 in range(KS // 2):
            y = ldmatrix_x4(Vt, [tile_off(a_key[i], (2 * c2 + a_chunk[i]) * 16)
                                 for i in range(32)], trans=True)
            for step, (lo_j, hi_j) in enumerate(((0, 1), (2, 3))):
                a0, a1 = widen(y[:, lo_j], cross=True)
                a2, a3 = widen(y[:, hi_j], cross=True)
                acc[2 * c2 + step] += mma(np.stack([a0, a1, a2, a3], 1), b0, b1)
    else:
        for c in range(KS):
            y = ldmatrix_x4(Vt, [tile_off(v_key[i], (2 * c + v_chunk[i]) * 16)
                                 for i in range(32)], trans=True)
            acc[c] += mma(np.stack([b16(y[:, j]) for j in range(4)], 1), b0, b1)
    O_T = vv[k0:k0 + WK].T @ P  # [hd, 8 rows]
    for c in range(KS):
        for lane in range(32):
            d_lo = 16 * c + (2 * g[lane] if quant else g[lane])
            d_hi = d_lo + (1 if quant else 8)
            for x in range(2):
                row = 2 * tq[lane] + x
                assert acc[c, lane, x] == O_T[d_lo, row]
                assert acc[c, lane, 2 + x] == O_T[d_hi, row]


# ---- routes and rules -------------------------------------------------------------

Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)


@pytest.mark.parametrize("pool_dtype", POOL_DTYPES, ids=str)
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=str)
def test_body_follows_the_dtypes(q_dtype, pool_dtype):
    body = tpa.deep_body(q_dtype, pool_dtype)
    tensor_cores = q_dtype == torch.bfloat16 and pool_dtype in (
        torch.bfloat16, torch.int8)
    assert body == ("tensor_cores" if tensor_cores else "cuda_cores")


def test_the_c_entry_routes_by_q_dtype_alone():
    """deep_fwd sends bf16 q (code 1) to the tensor-core body and nothing
    else there: no error path leads to the CUDA-core body."""
    src = (CSRC / "paged_attention_deep.cu").read_text()
    body = src[src.index("cudaError_t deep_fwd("):]
    body = body[:body.index("\n}\n")]
    assert "if (q_dtype == 1) {" in body
    tc = body[body.index("if (q_dtype == 1) {"):body.index("const float scale = ")]
    assert "launch_tc<" in tc and "return" in tc
    assert body.count("paged_deep_kernel<") == 1  # the CUDA-core body, once
    assert f"int {tpa.DEEP_ENTRY}(" in src


@pytest.mark.parametrize(
    "BS,hd,dtype,want",
    [
        (256, 128, torch.bfloat16, "tma"),  # the main path
        (256, 128, torch.int8, "tma"),  # its int8 pool
        (64, 64, torch.bfloat16, "tma"),
        (512, 256, torch.int8, "tma"),
        (48, 128, torch.bfloat16, "cp.async"),  # tiles span pages
        (100, 128, torch.int8, "cp.async"),
        (16, 64, torch.bfloat16, "cp.async"),
        (256, 64, torch.int8, "cp.async"),  # 64-byte rows: half a box
    ],
)
def test_copy_route_follows_page_size_and_row_bytes(BS, hd, dtype, want):
    scale = torch.zeros((4, 2, BS)) if dtype == torch.int8 else None
    assert tpa.deep_copy_route(BS, hd, dtype, scale) == want


def test_misaligned_scale_tiles_take_per_key_copies():
    # scale rows whose head stride is not a whole number of 16 bytes
    scale = torch.zeros((4, 2, 258))[:, :, :256]
    assert scale.stride(1) % 4
    assert tpa.deep_copy_route(256, 128, torch.int8, scale) == "cp.async"


@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_main_path_pool_meets_the_tma_limits(kv_cache_dtype):
    """A layer slice of the recipe's pool (Qwen2.5-1.5B, pages of 256, the
    32768-token KV of 16 rows) as the C entry's tensor map: dims (hd, BS,
    Hkv, NB), byte strides multiples of 16 below 2^40, a box of 128 bytes
    x 64 keys (each box dim at most 256, the inner one the 128-byte
    swizzle span), 16-byte-aligned scale tiles."""
    cfg = qwen25_15b_config()
    BS, NB = 256, 16 * 32768 // 256
    k, _, ks, _ = alloc_kv_pool(cfg, NB, BS, "meta", kv_cache_dtype)
    layer = k[cfg.n_layers - 1]
    item = layer.element_size()
    assert tpa.deep_copy_route(BS, cfg.head_dim, layer.dtype,
                               None if ks is None else ks[0]) == "tma"
    dims = (cfg.head_dim, BS, cfg.n_kv_heads, NB)
    strides = [st * item for st in layer.stride()[2::-1]]  # slot, head, block
    assert all(d <= 2**32 for d in dims)
    assert all(st % 16 == 0 and st < 2**40 for st in strides)
    box = (tpa.TMA_BOX_BYTES // item, tpa.DEEP_TILE_KEYS, 1, 1)
    assert all(1 <= b <= 256 for b in box)
    assert box[0] * item == 128 and BS % box[1] == 0
    assert (cfg.head_dim * item) % tpa.TMA_BOX_BYTES == 0
    if ks is not None:
        assert all(st % 4 == 0 for st in ks[0].stride()[:2])


def test_split_rule_at_the_main_path_shapes():
    rule = tpa.DEEP_ENTRY
    # the recipe's 16 rows of 32768 tokens: 8 splits of 4096 keys, 256
    # blocks (two per SM on 132 SMs)
    assert tpa.n_splits(16, 1, 12, 2, 32768, entry=rule) == 8
    # the 8-row decode shape over a 4096-token table: 8 splits of 512 keys
    assert tpa.n_splits(8, 1, 12, 2, 4096, entry=rule) == 8
    # a prefill-shaped call fills the card with its query tiles alone
    assert tpa.n_splits(8, 512, 12, 2, 4096, entry=rule) == 1
    # one ticket per (row, KV head, 8-row query tile)
    assert tpa.n_tickets(rule, 16, 1, 12, 2) == 32
    assert tpa.n_tickets(rule, 8, 512, 12, 2) == 8 * 2 * 384


@pytest.mark.parametrize("B", [1, 2, 8, 16, 64, 300])
@pytest.mark.parametrize("capacity", [256, 4096, 32768])
def test_split_rule_is_one_wave_of_eight_tile_splits(B, capacity):
    S = tpa.n_splits(B, 1, 12, 2, capacity, entry=tpa.DEEP_ENTRY)
    blocks = S * 2 * B
    assert S >= 1
    if S > 1:
        assert blocks <= 264 and capacity // S >= 8 * KT
        assert (S + 1) * 2 * B > 264 or capacity // (S + 1) < 8 * KT
