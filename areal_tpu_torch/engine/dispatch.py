"""Dispatch table for the serving engine's KV-cache paths (port of the
table half of ``areal_tpu/engine/dispatch.py``).

The reference engine has three ways to run decode attention: the dense
cache, the standard paged kernel and the deep paged kernel, which streams
its key range through a ring of tiles in flight.  Which one wins is a
measurement on the card, not a constant, so the engine reads two
thresholds from a :class:`PagedDispatchTable`:

* ``paged_min_cache_len``: ``cache_mode="auto"`` resolves to the paged
  pool at or above this ``kv_cache_len``, and to the dense cache below it
  (and for a sliding-window model, which only the dense cache serves);
* ``deep_min_context``: a decode chunk runs the deep kernel once the
  batch's longest live context reaches it.

:func:`derive_dispatch_table` turns a measured decode A/B (tokens/s by
context length) into thresholds; :func:`resolve_dispatch_table` builds
the table from config fields.  The defaults (paged from 2048 tokens, deep
never) leave an unconfigured engine as it was.  The speculative-decode
defaults (:data:`DEFAULT_SPEC_MIN_ACCEPT_RATE`,
:data:`DEFAULT_SPEC_VERIFY_COST`) live here too.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

#: ``cache_mode="auto"`` resolves to the paged pool at or above this
#: ``kv_cache_len``
DEFAULT_PAGED_MIN_CACHE_LEN = 2048

#: a context length no row reaches: the deep kernel stays off until a
#: measurement shows it faster
DISPATCH_NEVER = 1 << 30

#: speculative decoding: the acceptance-rate EMA below which a row's drafts
#: are judged not worth verifying and the row falls back to plain chunked
#: decode (the reference's default, set there for a TPU; no measurement on
#: a card has replaced it)
DEFAULT_SPEC_MIN_ACCEPT_RATE = 0.2

#: the cost of one speculative verify pass in plain-decode-step units: the
#: per-step batch vote dispatches a verify window instead of a decode chunk
#: only when the rows' expected emitted tokens exceed this times the live
#: rows.  The reference's TPU value; ``chip_smoke.py``'s
#: ``serving_features`` phase measures the card's and prints it
#: (``verify_cost_over_decode_step``), and a config may pin it
DEFAULT_SPEC_VERIFY_COST = 2.0


@dataclasses.dataclass(frozen=True)
class PagedDispatchTable:
    """Context-length thresholds ``cache_mode="auto"`` dispatches on."""

    #: dense cache below, paged block pool at/above (by ``kv_cache_len``)
    paged_min_cache_len: int = DEFAULT_PAGED_MIN_CACHE_LEN
    #: standard paged kernel below, deep kernel at/above (by the longest
    #: live context in the batch at dispatch time)
    deep_min_context: int = DISPATCH_NEVER
    #: provenance: "builtin-default" | "config" | "bench(...)"
    source: str = "builtin-default"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: a paged column within this fraction of dense counts as a win (decode
#: A/B cells carry a few percent of run-to-run noise)
PARITY_MARGIN = 0.95

#: the deep kernel must clear the standard kernel by this factor before
#: the table flips to it
DEEP_MARGIN = 1.02


def resolve_dispatch_table(
    paged_min_cache_len: Optional[int] = None,
    deep_min_context: Optional[int] = None,
) -> PagedDispatchTable:
    """Build the engine's table from config fields; ``None`` fields keep
    the builtin defaults (so configs only pin what they measured)."""
    if paged_min_cache_len is None and deep_min_context is None:
        return PagedDispatchTable()
    base = PagedDispatchTable()
    return PagedDispatchTable(
        paged_min_cache_len=(
            base.paged_min_cache_len
            if paged_min_cache_len is None
            else int(paged_min_cache_len)
        ),
        deep_min_context=(
            base.deep_min_context
            if deep_min_context is None
            else int(deep_min_context)
        ),
        source="config",
    )


def derive_dispatch_table(
    rows: Mapping[int, Mapping[str, Optional[float]]],
) -> PagedDispatchTable:
    """Derive thresholds from a measured 3-column decode A/B.

    ``rows`` maps context length -> ``{"dense": tok/s, "paged": tok/s,
    "deep": tok/s}`` with ``None`` for cells that could not run.  A
    threshold is the smallest measured context from which the contender
    wins at EVERY larger measured context too (one noisy mid-table cell
    must not carve an island).  A dense cell that could not run counts
    as a paged win.  If paged never wins, the paged threshold is pushed
    past the measured range (2x the largest context); if deep never beats
    standard paged, deep stays at ``DISPATCH_NEVER``.
    """
    ctxs = sorted(int(c) for c in rows)
    if not ctxs:
        return PagedDispatchTable(source="bench(empty)")

    def cell(ctx, key):
        v = rows[ctx].get(key)
        return float(v) if isinstance(v, (int, float)) else None

    def paged_wins(ctx):
        dense = cell(ctx, "dense")
        best_paged = max(
            (v for v in (cell(ctx, "paged"), cell(ctx, "deep"))
             if v is not None),
            default=None,
        )
        if dense is None:
            return True
        if best_paged is None:
            return False
        return best_paged >= PARITY_MARGIN * dense

    def deep_wins(ctx):
        deep, std = cell(ctx, "deep"), cell(ctx, "paged")
        if deep is None:
            return False
        if std is None:
            return True
        return deep >= DEEP_MARGIN * std

    def suffix_threshold(wins):
        """Smallest ctx such that wins() holds for it and all larger."""
        thr = None
        for ctx in reversed(ctxs):
            if wins(ctx):
                thr = ctx
            else:
                break
        return thr

    paged_thr = suffix_threshold(paged_wins)
    deep_thr = suffix_threshold(deep_wins)
    return PagedDispatchTable(
        paged_min_cache_len=(
            paged_thr if paged_thr is not None else 2 * ctxs[-1]
        ),
        deep_min_context=(
            deep_thr if deep_thr is not None else DISPATCH_NEVER
        ),
        source=f"bench({ctxs[0]}..{ctxs[-1]})",
    )
