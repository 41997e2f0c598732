"""The flash-attention forward's tile design, emulated in plain torch on
the CPU and held against the JAX package's oracle.

The forward kernel (``csrc/flash_attention.cu`` ``fa_fwd_kernel``) runs
only on a card; there ``chip_smoke.py`` holds it against the plain
version.  Here its arithmetic is written out tile by tile and compared
with ``reference_attention`` under ``make_attention_mask`` (as
``tests/test_torch_flash_attention.py`` runs it) on layouts from the JAX
package's own ``pack_batch``:

* 64-row query tiles over 64-key tiles up to the diagonal, skipped where
  the per-32-token segment-range table says the two tiles share no
  segment, unmasked where both lie in one segment below the diagonal;
* scores from bf16 values with f32 sums, an online softmax in the log2
  domain, P rounded to bf16 before the P.V product (the row sum l keeps
  the f32 P), the output rounded to bf16, lse in natural units (+inf on
  padding queries).

It meets ``chip_smoke.py``'s ``TOL_FA_OUT``, ``TOL_FA_OUT_TOKEN`` and
``TOL_FA_LSE``.  The tile walk itself (launch order, skipped and unmasked
tiles) is a pure function, checked against the attention mask.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.engine import batching as jbatching
from areal_tpu.models import transformer as jt
from areal_tpu_torch.ops import flash_attention as tfa

# chip_smoke.py's kernel-vs-plain tolerances for the forward
TOL_FA_OUT = 1e-2  # relative L2 of out over real tokens
TOL_FA_OUT_TOKEN = 2e-2  # the worst real token's relative L2
TOL_FA_LSE = 1e-4  # max |lse - ref| over real tokens
BM = BN = 64  # query rows and keys per tile
RANGE_TILE = 32  # the segment-range table's granularity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the tile walk ------------------------------------------------------------


def seg_ranges(seg_row):
    """[n_rt, 2]: min nonzero and max segment id of each 32-token tile (min
    larger than max when the tile holds no real token)."""
    T = len(seg_row)
    out = []
    for t0 in range(0, T, RANGE_TILE):
        tile = seg_row[t0:t0 + RANGE_TILE]
        nz = tile[tile != 0]
        out.append((int(nz.min()) if len(nz) else 2**31 - 1, int(tile.max())))
    return out


def tile_range(ranges, t0, n):
    lo, hi = 2**31 - 1, 0
    for a, b in ranges[t0:t0 + n]:
        lo, hi = min(lo, a), max(hi, b)
    return lo, hi


def ranges_meet(a, b):
    return a[1] > 0 and b[1] > 0 and a[0] <= b[1] and b[0] <= a[1]


def tile_walk(seg_row):
    """The forward's walk over one row: ``[(qt, [(kt, full), ...]), ...]``
    in launch order (the query tiles with the most keys first).  A key
    tile is visited when its segment range meets the query tile's; it is
    ``full`` (no mask) when it lies below the diagonal and every query and
    key of the two tiles has the query tile's least nonzero segment id."""
    T = len(seg_row)
    ranges = seg_ranges(seg_row)
    n_qt = -(-T // BM)
    walk = []
    for qt in range(n_qt - 1, -1, -1):
        q0 = qt * BM
        qr = tile_range(ranges, q0 // RANGE_TILE, BM // RANGE_TILE)
        segq = np.zeros(BM, np.int64)
        segq[:len(seg_row[q0:q0 + BM])] = seg_row[q0:q0 + BM]
        visits = []
        for kt in range(qt + 1):
            k0 = kt * BN
            if not ranges_meet(qr, tile_range(ranges, k0 // RANGE_TILE,
                                              BN // RANGE_TILE)):
                continue
            segk = np.zeros(BN, np.int64)
            segk[:len(seg_row[k0:k0 + BN])] = seg_row[k0:k0 + BN]
            full = bool((segq == qr[0]).all() and (segk == qr[0]).all()
                        and k0 + BN - 1 <= q0)
            visits.append((kt, full))
        walk.append((qt, visits))
    return walk


def block_order(n_qt, Hq, B):
    """The forward's flattened grid: block id -> (query tile, head, row)."""
    per = Hq * B
    return [(n_qt - 1 - bid // per, bid % per % Hq, bid % per // Hq)
            for bid in range(n_qt * per)]


# ---- the forward's arithmetic -------------------------------------------------


def bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_forward(q, k, v, seg, round_bf16=True):
    """(out [B,T,Hq,hd] f32 holding bf16 values, lse [B,Hq,T]) from the
    forward kernel's tile arithmetic; q, k, v hold bf16 values.  With
    ``round_bf16`` false, neither P nor out is rounded to bf16."""
    rnd = bf16 if round_bf16 else (lambda x: x)
    B, T, Hq, hd = q.shape
    r = Hq // k.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros(B, T, Hq, hd)
    lse = torch.full((B, Hq, T), math.inf)
    for b in range(B):
        seg_row = seg[b].numpy()
        for h in range(Hq):
            hk = h // r
            for qt, visits in tile_walk(seg_row):
                q0 = qt * BM
                qi = torch.arange(q0, q0 + BM)
                sq = torch.zeros(BM, dtype=torch.int64)
                sq[:min(BM, T - q0)] = seg[b, q0:q0 + BM]
                Qt = torch.zeros(BM, hd)
                Qt[:min(BM, T - q0)] = q[b, q0:q0 + BM, h]
                m = torch.full((BM,), -math.inf)
                l = torch.zeros(BM)
                acc = torch.zeros(BM, hd)
                for kt, full in visits:
                    k0 = kt * BN
                    n = min(BN, T - k0)
                    Kt, Vt = torch.zeros(BN, hd), torch.zeros(BN, hd)
                    Kt[:n], Vt[:n] = k[b, k0:k0 + n, hk], v[b, k0:k0 + n, hk]
                    sk = torch.zeros(BN, dtype=torch.int64)
                    sk[:n] = seg[b, k0:k0 + n]
                    s = Qt @ Kt.T  # exact products of bf16 values, f32 sums
                    if full:
                        x = s * scale_log2
                    else:
                        ok = ((sq[:, None] != 0) & (sk[None, :] == sq[:, None])
                              & (k0 + torch.arange(BN)[None, :] <= qi[:, None]))
                        x = torch.where(ok, s * scale_log2,
                                        torch.tensor(-math.inf))
                    m_new = torch.maximum(m, x.amax(-1))
                    live = m_new != -math.inf
                    alpha = torch.where(live, torch.exp2(m - m_new),
                                        torch.ones(()))
                    p = torch.where(live[:, None], torch.exp2(x - m_new[:, None]),
                                    torch.zeros(()))
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + rnd(p) @ Vt
                    m = m_new
                rows = slice(q0, min(T, q0 + BM))
                nr = rows.stop - rows.start
                inv = torch.where(l > 0, 1.0 / l, torch.zeros(()))
                out[b, rows, h] = rnd(acc * inv[:, None])[:nr]
                lse[b, h, rows] = torch.where(
                    l > 0, (m + torch.log2(l)) * math.log(2),
                    torch.tensor(math.inf))[:nr]
    return out, lse


def _layout(lens, fixed_len, seed):
    rng = np.random.default_rng(seed)
    sample = JSample.from_default(
        lens, [f"s{i}" for i in range(len(lens))],
        {"packed_input_ids": rng.integers(1, 50, sum(lens)).astype(np.int32)},
    )
    return jbatching.pack_batch(sample, fixed_len=fixed_len)


#: (segment lengths, row length): several segments per row across tiles;
#: one long segment (unmasked tiles below the diagonal) with padding; a
#: row length that is not a multiple of a tile, with one-token segments
LAYOUTS = {
    "packed": ([70, 150, 80, 33, 90, 40], 300),
    "long": ([250, 120], 256),
    "odd": ([257, 120, 1, 64, 1], 257),
}
HEADS = [(4, 2), (6, 1)]


def _inputs(pb, Hq, Hkv, hd=32, seed=0):
    """bf16-valued float32 q, k, v from one numpy seed."""
    rng = np.random.default_rng(seed)
    B, T = pb.tokens.shape

    def rnd(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    return rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"Hq{h[0]}_Hkv{h[1]}")
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tile_emulation_meets_the_kernel_tolerances(layout, heads):
    lens, fixed_len = LAYOUTS[layout]
    pb = _layout(lens, fixed_len, seed=len(lens))
    seg, pos = pb.seg_ids, pb.positions
    real = seg != 0
    assert real.any() and (~real).any()
    q, k, v = _inputs(pb, *heads)
    mask = jt.make_attention_mask(*map(jnp.asarray, (seg, pos, seg, pos)))
    ref = np.asarray(jt.reference_attention(*map(jnp.asarray, (q, k, v)), mask))
    kr = np.repeat(k, heads[0] // heads[1], axis=2)
    s = np.einsum("bthd,bshd->bhts", q, kr) / np.sqrt(q.shape[-1])
    s = np.where(np.asarray(mask)[:, None], s, -np.inf)
    smax = s.max(-1, keepdims=True)
    with np.errstate(divide="ignore"):  # padding rows attend nothing
        ref_lse = (np.log(np.exp(s - np.where(np.isfinite(smax), smax, 0)).sum(-1))
                   + np.where(np.isfinite(smax[..., 0]), smax[..., 0], 0))

    out, lse = emulate_forward(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(seg))
    d = out.numpy()[real] - ref[real]
    err = np.linalg.norm(d) / np.linalg.norm(ref[real])
    tok = (np.linalg.norm(d.reshape(len(d), -1), axis=1)
           / np.linalg.norm(ref[real].reshape(len(d), -1), axis=1)).max()
    lse_t = lse.numpy().transpose(0, 2, 1)
    err_lse = np.abs(lse_t[real] - ref_lse.transpose(0, 2, 1)[real]).max()
    assert err <= TOL_FA_OUT and tok <= TOL_FA_OUT_TOKEN, (err, tok)
    assert err_lse <= TOL_FA_LSE, err_lse
    # padding queries: out 0, lse +inf
    assert (out.numpy()[~real] == 0).all()
    assert np.isposinf(lse_t[~real]).all()
    # the same walk in float32 (P and out not rounded) equals the port's
    # plain version: skipping and unmasking tiles change nothing
    exact, exact_lse = emulate_forward(*map(torch.from_numpy, (q, k, v)),
                                       torch.from_numpy(seg), round_bf16=False)
    plain, plain_lse = tfa.reference_flash_attention(
        *map(torch.from_numpy, (q, k, v, seg)), return_lse=True)
    np.testing.assert_allclose(exact.numpy()[real], plain.numpy()[real],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(exact_lse.numpy().transpose(0, 2, 1)[real],
                               plain_lse.numpy().transpose(0, 2, 1)[real],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tile_walk_covers_every_attended_pair(layout):
    """Every attended (query, key) pair lies in a visited tile, a skipped
    tile holds none, an unmasked tile holds only attended pairs, and some
    tiles of the long segment are unmasked."""
    lens, fixed_len = LAYOUTS[layout]
    pb = _layout(lens, fixed_len, seed=len(lens))
    mask = tfa.attention_mask(torch.from_numpy(pb.seg_ids)).numpy()
    T = pb.seg_ids.shape[1]
    n_full = 0
    for b, seg_row in enumerate(pb.seg_ids):
        walk = dict(tile_walk(seg_row))
        for qt in range(-(-T // BM)):
            visited = dict(walk[qt])
            for kt in range(-(-T // BN)):
                pairs = mask[b, qt * BM:(qt + 1) * BM, kt * BN:(kt + 1) * BN]
                if kt not in visited:
                    assert not pairs.any(), (b, qt, kt)
                elif visited[kt]:
                    n_full += 1
                    assert pairs.shape == (BM, BN) and pairs.all(), (b, qt, kt)
    if layout == "long":
        assert n_full > 0


def test_launch_order_is_heaviest_first():
    """The flattened grid launches every (query tile, head, row) once, the
    query tiles with the most keys below the diagonal first."""
    n_qt, Hq, B = 5, 3, 2
    order = block_order(n_qt, Hq, B)
    assert sorted(order) == sorted(
        (qt, h, b) for qt in range(n_qt) for h in range(Hq) for b in range(B))
    keys = [qt + 1 for qt, _, _ in order]  # key tiles up to the diagonal
    assert keys == sorted(keys, reverse=True)
    assert order[:Hq * B] == [(n_qt - 1, i % Hq, i // Hq) for i in range(Hq * B)]
