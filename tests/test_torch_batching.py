"""The port's host-side data path (``base/datapack``, ``api/data``,
``engine/batching``) against the JAX package's copies: exact equality of
bins, groups, layouts, segment tables, extras and reorderings, on the
same numpy-seeded samples."""

import numpy as np
import pytest

from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base import datapack as jdp
from areal_tpu.engine import batching as jb
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import datapack as tdp
from areal_tpu_torch.engine import batching as tb


def _lens(n, seed, lo=3, hi=60):
    return np.random.default_rng(seed).integers(lo, hi, n).tolist()


def _data(lens, seed):
    """A PPO-shaped rollout: full-length, transition and scalar keys."""
    rng = np.random.default_rng(seed)
    tot = sum(lens)
    prompt = np.zeros(tot, bool)
    off = 0
    for L in lens:
        prompt[off : off + max(1, L // 3)] = True
        off += L
    return dict(
        packed_input_ids=rng.integers(0, 1000, tot).astype(np.int32),
        prompt_mask=prompt,
        packed_logprobs=rng.standard_normal(tot - len(lens)).astype(np.float32),
        rewards=rng.standard_normal(len(lens)).astype(np.float32),
        seq_no_eos_mask=(rng.random(len(lens)) < 0.5).astype(np.float32),
    )


def _pair(lens, seed=0):
    ids = [f"q{i}" for i in range(len(lens))]
    d = _data(lens, seed)
    return (
        JSample.from_default(lens, ids, {k: v.copy() for k, v in d.items()}),
        SequenceSample.from_default(lens, ids, d),
    )


def _same_batch(j, t):
    for f in ("tokens", "positions", "seg_ids", "seq_lens", "seg_rows",
              "seg_starts", "seg_lens"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.n_real, j.n_segs) == (t.n_real, t.n_segs)
    assert j.extras.keys() == t.extras.keys()
    for k in j.extras:
        assert np.array_equal(j.extras[k], t.extras[k]), k


@pytest.mark.parametrize("n,capacity", [(5, 64), (70, 128), (200, 512)])
def test_ffd_bins_and_groups(n, capacity):
    lens = _lens(n, n)
    # the JAX package's auto path (its native code for n >= 64)
    assert tdp.bin_pack_ffd(lens, capacity) == jdp.bin_pack_ffd(lens, capacity)
    assert tdp.ffd_allocate(lens, capacity, 3) == jdp.ffd_allocate(lens, capacity, 3)
    assert tdp.ffd_allocate(lens, 10**9, 4) == jdp.ffd_allocate(lens, 10**9, 4)
    k = min(4, n)
    assert tdp.partition_balanced(lens[:40], k) == jdp.partition_balanced(lens[:40], k)
    assert tdp.flat2d([[1, 2], [3]]) == jdp.flat2d([[1, 2], [3]])


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(fixed_rows=9, fixed_len=64), dict(fixed_rows=12)],
    ids=["default", "fixed", "rows"],
)
def test_pad_batch(kw):
    js, ts = _pair(_lens(7, 1))
    _same_batch(jb.pad_batch(js, **kw), tb.pad_batch(ts, **kw))


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(fixed_len=128), dict(fixed_rows=6, fixed_len=100, fixed_segs=32),
     dict(fixed_segs=64)],
    ids=["default", "len", "fixed", "segs"],
)
def test_pack_batch(kw):
    js, ts = _pair(_lens(13, 2))
    _same_batch(jb.pack_batch(js, **kw), tb.pack_batch(ts, **kw))


def test_unpack_and_unpad_per_token():
    js, ts = _pair(_lens(9, 3))
    jp, tp = jb.pack_batch(js, fixed_len=128), tb.pack_batch(ts, fixed_len=128)
    out = np.random.default_rng(0).standard_normal(jp.tokens.shape).astype(np.float32)
    for shift in (0, 1):
        assert np.array_equal(
            jb.unpack_per_token(out, jp, shift), tb.unpack_per_token(out, tp, shift)
        )
    jd, td = jb.pad_batch(js), tb.pad_batch(ts)
    out = np.random.default_rng(1).standard_normal(jd.tokens.shape).astype(np.float32)
    for shift in (0, 1):
        assert np.array_equal(
            jb.unpad_per_token(out, jd.seq_lens, jd.n_real, shift),
            tb.unpad_per_token(out, td.seq_lens, td.n_real, shift),
        )
    assert tb.bucket_len(33) == jb.bucket_len(33) and tb.next_pow2(9) == 16


@pytest.mark.parametrize(
    "spec", [dict(n_mbs=1), dict(n_mbs=3), dict(max_tokens_per_mb=90),
             dict(n_mbs=2, max_tokens_per_mb=60)],
    ids=["one", "three", "budget", "both"],
)
def test_split_and_reorder_output(spec):
    js, ts = _pair(_lens(11, 4))
    jm, jf, jbk = js.split(JSpec(**spec))
    tm, tf, tbk = ts.split(MicroBatchSpec(**spec))
    assert np.array_equal(jf, tf) and np.array_equal(jbk, tbk)
    assert [m.ids for m in jm] == [m.ids for m in tm]
    for a, b in zip(jm, tm):
        assert a.seqlens == b.seqlens
        for k in a.keys:
            assert np.array_equal(a.data[k], b.data[k]), k
    # per-token outputs of the reordered batch go back to the original order
    shifted = [[l - 1 for l in ls] for ls in ts.seqlens["packed_input_ids"]]
    x = np.arange(sum(sum(l) for l in shifted), dtype=np.float32)
    assert np.array_equal(
        SequenceSample.reorder_output(x, shifted, tf, tbk),
        JSample.reorder_output(x, shifted, jf, jbk),
    )


def test_update_and_gather():
    js, ts = _pair(_lens(4, 5))
    lens = [l[0] for l in ts.seqlens["packed_input_ids"]]
    adv = np.random.default_rng(0).standard_normal(sum(lens) - 4).astype(np.float32)
    js.update_(JSample.from_default(lens, js.ids, {"advantages": adv}))
    ts.update_(SequenceSample.from_default(lens, ts.ids, {"advantages": adv}))
    assert js.keys == ts.keys and js.seqlens == ts.seqlens
    jg = JSample.gather(js.unpack()[::-1])
    tg = SequenceSample.gather(ts.unpack()[::-1])
    assert jg.ids == tg.ids
    for k in jg.keys:
        assert np.array_equal(jg.data[k], tg.data[k]), k
