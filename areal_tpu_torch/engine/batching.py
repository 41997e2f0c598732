"""Packed SequenceSample <-> device-batch conversion (a numpy copy of
``areal_tpu/engine/batching.py``).

Two layouts of the same :class:`PaddedBatch`:

* :func:`pad_batch`: one sequence per row of a ``[B, T]`` batch with a
  bucketed T.
* :func:`pack_batch`: several sequences per row, laid side by side by
  first-fit-decreasing bin packing under a token budget; per-row
  ``seg_ids`` are numbered 1..k and ``positions`` restart at 0 per
  segment, so the same-segment causal attention mask and RoPE are right
  by construction.

Both carry a segment table (``seg_rows``/``seg_starts``/``seg_lens``, flat
``[S]`` arrays in original sequence order); :func:`unpack_per_token` is
the inverse, restoring the packed 1-D order of per-token outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from areal_tpu_torch.api.data import _SCALAR_KEYS, SequenceSample
from areal_tpu_torch.base import datapack

#: row widths T: the reference's default buckets (it bounds the number of
#: compiled shapes; here it keeps the layouts equal to the reference's)
BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_len(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket")


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass
class PaddedBatch:
    """Device-ready arrays; one OR MORE sequences (segments) per row.

    ``tokens``/``positions``/``seg_ids``: [B, T]; ``seq_lens``: [B] (real
    tokens per row, 0 for padding rows).  ``extras`` holds per-key aligned
    arrays:
      - full-length keys -> [B, T] at each segment's columns
      - transition keys (len L-1) -> [B, T] with entry t = transition
        t->t+1 (each segment's LAST column is always 0)
      - scalar keys -> [n_real] (padded-mode, one segment per row) or
        [S] segment-aligned (packed mode)

    The segment table maps original sequence order to the layout:
    segment ``s`` (the s-th flattened sequence of the sample) occupies
    ``tokens[seg_rows[s], seg_starts[s] : seg_starts[s] + seg_lens[s]]``.
    Arrays are sized [S] (``n_segs`` real entries, zero-padded) so
    stacked micro-batches share one shape; padding entries have ``seg_lens == 0``
    and must be masked (they alias row 0 / column 0).
    """

    tokens: np.ndarray
    positions: np.ndarray
    seg_ids: np.ndarray
    seq_lens: np.ndarray
    extras: Dict[str, np.ndarray]
    n_real: int  # number of real rows
    seg_rows: np.ndarray  # [S] int32
    seg_starts: np.ndarray  # [S] int32
    seg_lens: np.ndarray  # [S] int32 (0 = padding segment)
    n_segs: int  # number of real segments

    @property
    def shape(self):
        return self.tokens.shape

    @property
    def padded_slots(self) -> int:
        """Total [B, T] slots this batch occupies on device."""
        return int(self.tokens.size)


def batch_dict(pb: PaddedBatch) -> Dict[str, np.ndarray]:
    """The batch dict loss and forward functions take: the [B, T] arrays,
    per-row ``seq_lens``, the flat segment table and the extras."""
    return {
        "tokens": pb.tokens,
        "positions": pb.positions,
        "seg_ids": pb.seg_ids,
        "seq_lens": pb.seq_lens,
        "seg_rows": pb.seg_rows,
        "seg_starts": pb.seg_starts,
        "seg_lens": pb.seg_lens,
        **pb.extras,
    }


def _extra_layout(key: str, lens: List[int], tok_lens: List[int]) -> str:
    """Classify an extra key as ``full`` / ``transition`` / ``scalar`` by
    comparing its per-sequence lengths to the token key's.

    The registry of known scalar keys wins first: ``rewards`` et al. stay
    scalars even in a degenerate batch of length-1 sequences.  For unknown
    keys, FULL-length wins over scalar when every sequence has length 1 —
    the old ``all(l == 1)`` heuristic silently laid a genuine per-token
    key out as [B] whenever the batch happened to be all length-1.
    """
    if key in _SCALAR_KEYS:
        if not all(l == 1 for l in lens):
            raise ValueError(
                f"scalar key {key!r} has non-unit lengths {lens[:8]}"
            )
        return "scalar"
    if lens == tok_lens:
        return "full"
    if lens == [l - 1 for l in tok_lens]:
        return "transition"
    if all(l == 1 for l in lens):
        return "scalar"
    raise ValueError(
        f"key {key!r} lengths match neither the token key ({tok_lens[:4]}...)"
        f", its transitions, nor a scalar layout: {lens[:4]}..."
    )


def _layout_batch(
    sample: SequenceSample,
    token_key: str,
    seqlens: List[int],
    placement: List[Tuple[int, int]],  # per-seq (row, start col)
    B: int,
    T: int,
    S: int,
    scalar_per_segment: bool,
) -> PaddedBatch:
    """Shared layout engine for pad_batch/pack_batch: place sequence ``s``
    at ``placement[s]``, build the segment table, and align extras."""
    n = len(seqlens)
    tokens = np.zeros((B, T), np.int32)
    positions = np.zeros((B, T), np.int32)
    seg_ids = np.zeros((B, T), np.int32)
    seq_lens = np.zeros((B,), np.int32)
    seg_rows = np.zeros((S,), np.int32)
    seg_starts = np.zeros((S,), np.int32)
    seg_lens = np.zeros((S,), np.int32)

    offsets = np.concatenate([[0], np.cumsum(seqlens)])
    data = sample.data[token_key]
    next_seg = np.zeros((B,), np.int32)  # per-row running segment number
    for s, L in enumerate(seqlens):
        r, c = placement[s]
        tokens[r, c : c + L] = data[offsets[s] : offsets[s + 1]]
        positions[r, c : c + L] = np.arange(L)
        next_seg[r] += 1
        seg_ids[r, c : c + L] = next_seg[r]
        seq_lens[r] += L
        seg_rows[s], seg_starts[s], seg_lens[s] = r, c, L

    extras: Dict[str, np.ndarray] = {}
    for key in sample.keys:
        if key == token_key or sample.data.get(key) is None:
            continue
        lens = [l for ls in sample.seqlens[key] for l in ls]
        if len(lens) != len(seqlens):
            # a key not aligned per member sequence (e.g. one scalar per
            # GROUP id alongside multi-sequence groups) would land on the
            # wrong segments after flattening — refuse rather than guess
            raise ValueError(
                f"key {key!r} has {len(lens)} sequences but {token_key!r} "
                f"has {len(seqlens)}; per-group keys cannot align with "
                "multi-sequence ids"
            )
        arr = sample.data[key]
        offs = np.concatenate([[0], np.cumsum(lens)])
        layout = _extra_layout(key, lens, seqlens)
        if layout == "scalar":
            out = np.zeros((S if scalar_per_segment else B,), arr.dtype)
            out[:n] = arr[:n]
        else:
            out = np.zeros((B, T), arr.dtype)
            for s in range(n):
                r, c = placement[s]
                Lk = lens[s]  # == seqlens[s], or seqlens[s]-1 (transition):
                # a transition key fills only its L-1 columns, so each
                # segment's last column stays 0 by construction
                out[r, c : c + Lk] = arr[offs[s] : offs[s + 1]]
        extras[key] = out
    return PaddedBatch(
        tokens=tokens,
        positions=positions,
        seg_ids=seg_ids,
        seq_lens=seq_lens,
        extras=extras,
        n_real=int(max((r for r, _ in placement), default=-1)) + 1,
        seg_rows=seg_rows,
        seg_starts=seg_starts,
        seg_lens=seg_lens,
        n_segs=n,
    )


def pad_batch(
    sample: SequenceSample,
    token_key: str = "packed_input_ids",
    fixed_rows: int = 0,
    fixed_len: int = 0,
) -> PaddedBatch:
    """One sequence per row, right padding; extras aligned per class.

    ``fixed_rows``/``fixed_len`` force the output shape (so several
    micro-batches can share one shape and be stacked).
    The segment table is the trivial one (segment s = row s, start 0),
    sized [B] so per-segment gathers line up with per-row [B] arrays.

    Ids holding SEQUENCE GROUPS (e.g. the paired preference dataset packs
    [chosen, rejected, ...] under one id) flatten to one row per member
    sequence, in packed order."""
    seqlens = [l for ls in sample.seqlens[token_key] for l in ls]
    B = len(seqlens)
    T = bucket_len(max(seqlens))
    if fixed_rows:
        assert len(seqlens) <= fixed_rows
        B = fixed_rows
    if fixed_len:
        assert max(seqlens) <= fixed_len
        T = fixed_len
    placement = [(i, 0) for i in range(len(seqlens))]
    return _layout_batch(
        sample, token_key, seqlens, placement, B, T, S=B,
        scalar_per_segment=False,
    )


def pack_batch(
    sample: SequenceSample,
    token_key: str = "packed_input_ids",
    fixed_rows: int = 0,
    fixed_len: int = 0,
    fixed_segs: int = 0,
    bins: Optional[List[List[int]]] = None,
    capacity: int = 0,
) -> PaddedBatch:
    """FFD-bin sequences into multi-segment rows under a token budget.

    Row width T is ``bucket_len(max(capacity, longest sequence))`` (or
    ``fixed_len``); :func:`datapack.bin_pack_ffd` packs
    sequences into rows of at most T tokens, so the padded-slot count
    tracks the TOTAL token count instead of ``n_seqs x max_len``.  Within
    a row, segments are laid out in ascending original-sequence order
    with ``seg_ids`` 1..k and per-segment positions — attention masking
    and RoPE need no layout-specific handling downstream.

    ``fixed_segs`` forces the segment-table capacity S (default: the
    next power of two of the sequence count, bounding shape variety).
    ``bins`` passes precomputed ``bin_pack_ffd(seqlens, T)`` groups so a
    caller that already binned (the engine sizes rows across micro-batches
    first) does not pay the FFD pass twice.
    """
    seqlens = [l for ls in sample.seqlens[token_key] for l in ls]
    max_len = max(seqlens)
    T = fixed_len or bucket_len(max(capacity, max_len))
    assert max_len <= T, (max_len, T)
    if bins is None:
        bins = datapack.bin_pack_ffd(seqlens, T)
    # deterministic layout: rows ordered by their smallest member index,
    # members within a row in ascending original order
    bins = sorted((sorted(b) for b in bins), key=lambda b: b[0])
    n_rows = len(bins)
    B = n_rows
    if fixed_rows:
        assert n_rows <= fixed_rows, (n_rows, fixed_rows)
        B = fixed_rows
    S = fixed_segs or next_pow2(len(seqlens))
    assert len(seqlens) <= S, (len(seqlens), S)

    placement: List[Optional[Tuple[int, int]]] = [None] * len(seqlens)
    for r, members in enumerate(bins):
        col = 0
        for s in members:
            placement[s] = (r, col)
            col += seqlens[s]
        assert col <= T
    return _layout_batch(
        sample, token_key, seqlens, placement, B, T, S=S,
        scalar_per_segment=True,
    )


def unpad_per_token(
    out: np.ndarray,  # [B, T] per-token outputs (full-length alignment)
    seq_lens: np.ndarray,
    n_real: int,
    shift: int = 0,  # 1 for transition-aligned outputs (length L-1)
) -> np.ndarray:
    """Back to packed 1-D concat over real rows (one-sequence-per-row
    layout only; for packed batches use :func:`unpack_per_token`)."""
    parts: List[np.ndarray] = []
    for i in range(n_real):
        L = int(seq_lens[i]) - shift
        parts.append(out[i, :L])
    return np.concatenate(parts, axis=0)


def unpack_per_token(
    out: np.ndarray,  # [B, T] per-token outputs
    pb: PaddedBatch,
    shift: int = 0,  # 1 for transition-aligned outputs (length L-1)
) -> np.ndarray:
    """Segment-table inverse of pad_batch/pack_batch: gather per-token
    outputs back into the packed 1-D concat in ORIGINAL sequence order."""
    parts: List[np.ndarray] = []
    for s in range(pb.n_segs):
        r = int(pb.seg_rows[s])
        c = int(pb.seg_starts[s])
        L = int(pb.seg_lens[s]) - shift
        parts.append(out[r, c : c + L])
    return np.concatenate(parts, axis=0)
