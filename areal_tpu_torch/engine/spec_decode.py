"""Self-speculative decoding for the paged serving engine (port of
``areal_tpu/engine/spec_decode.py``).

Each row DRAFTS its own continuation by n-gram lookup over its prompt and
output history (no draft model), then one batched VERIFY pass scores
every draft position at once: a window ``[cur, d_1..d_k]`` per row runs
through :func:`~areal_tpu_torch.models.paged.paged_window_forward` over
the row's cached paged prefix, the chunked prefill's own forward, so on a
card every verify window runs the paged kernel's prefill entry
(``csrc/paged_attention.cu``; the decode entry for float32 and float16)
and its launches also count on ``paged_flash_attention.verify_launches``.

Exactness under GREEDY decode: window position j's logits give the greedy
target ``t_j``; draft ``d_{j+1}`` is accepted iff it equals ``t_j`` and
every earlier draft was accepted; the first mismatch emits the verifier's
own token instead.  A verify step emits between 1 (every draft rejected:
plain decode's progress) and ``max_draft_tokens + 1`` tokens, and the
stream is the plain greedy stream token for token, up to the
arithmetic of two attention entries at near-ties.  The window's KV lands
in the row's own pool blocks; rejected positions leave bytes only past
the row's valid length, which the next write overwrites and neither
attention nor the prefix cache (which indexes only the valid prefix) ever
reads.

Rows keep an acceptance EMA and fall back to plain chunked decode when it
drops below ``min_accept_rate``; rows whose history holds no recurring
n-gram back off their drafting for growing step windows.  All host-side
decisions here are deterministic (dict insertion order, no wall clock).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.engine.dispatch import (
    DEFAULT_SPEC_MIN_ACCEPT_RATE,
    DEFAULT_SPEC_VERIFY_COST,
)
from areal_tpu_torch.engine.sampling import SamplingParams, sample_logits_keyed
from areal_tpu_torch.models import paged
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import _head


@dataclasses.dataclass(frozen=True)
class SpecDecodeParams:
    """Engine-level speculative-decoding settings (resolved from
    ``GenServerConfig.spec_decode`` by :func:`resolve_spec_params`)."""

    enabled: bool = False
    #: most draft tokens proposed per verify step (the window is this + 1,
    #: the pending token first).  Keep it a power of two minus one:
    #: windows bucket to powers of two (``batching.spec_window_bucket``)
    max_draft_tokens: int = 7
    #: n-gram sizes tried for the history lookup, longest first
    ngram_max: int = 3
    ngram_min: int = 1
    #: acceptance-rate EMA below which a row falls back to plain decode
    min_accept_rate: float = DEFAULT_SPEC_MIN_ACCEPT_RATE
    ema_decay: float = 0.9
    #: verifies before the fallback may fire
    warmup_verifies: int = 4
    #: a verify pass's cost in plain decode steps (the batch vote's c)
    verify_cost_over_decode_step: float = DEFAULT_SPEC_VERIFY_COST


def resolve_spec_params(cfg_block) -> Optional[SpecDecodeParams]:
    """Engine params from a ``GenServerConfig.spec_decode`` block (None, or
    a block with ``enabled=False``, gives None); a ``min_accept_rate`` or
    ``verify_cost_over_decode_step`` of None keeps the default of
    ``engine/dispatch.py``."""
    if cfg_block is None or not getattr(cfg_block, "enabled", False):
        return None
    thr = getattr(cfg_block, "min_accept_rate", None)
    cost = getattr(cfg_block, "verify_cost_over_decode_step", None)
    return SpecDecodeParams(
        enabled=True,
        max_draft_tokens=int(cfg_block.max_draft_tokens),
        ngram_max=int(cfg_block.ngram_max),
        ngram_min=int(cfg_block.ngram_min),
        min_accept_rate=(
            DEFAULT_SPEC_MIN_ACCEPT_RATE if thr is None else float(thr)
        ),
        ema_decay=float(cfg_block.ema_decay),
        warmup_verifies=int(cfg_block.warmup_verifies),
        verify_cost_over_decode_step=(
            DEFAULT_SPEC_VERIFY_COST if cost is None else float(cost)
        ),
    )


class SpecRowState:
    """One row's drafting state: an incremental n-gram index over its
    history, and its acceptance bookkeeping.

    The index maps each n-gram (n in ``[ngram_min, ngram_max]``) to the
    latest position it ENDS at, kept up to date as the history grows
    (O(appended tokens) per draft).  Indexing stops one position short of
    the tail, so the tail n-gram's lookup finds a strictly earlier
    occurrence.  The state survives park and resume, preemption and
    weight swaps: none of them rewrites past tokens."""

    __slots__ = (
        "ema", "verifies", "fallback", "miss_streak", "cooldown_until",
        "_index", "_indexed_upto",
    )

    def __init__(self):
        self.ema = 1.0  # optimistic: every row earns its warm-up
        self.verifies = 0
        self.fallback = False
        # draft-miss backoff: a row without a recurring n-gram skips draft
        # attempts for growing step windows
        self.miss_streak = 0
        self.cooldown_until = 0  # an engine step
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {}
        self._indexed_upto = 0

    def wants_draft(self, step_seq: int) -> bool:
        return not self.fallback and step_seq >= self.cooldown_until

    def note_draft_result(self, productive: bool, step_seq: int):
        """``productive``: the attempt led to a verify (a hit, and the batch
        voted for speculation).  A miss and a lost vote back off alike:
        either way the row paid for a draft (and the ring drain drafting
        needs) for nothing."""
        if productive:
            self.miss_streak = 0
            return
        self.miss_streak += 1
        if self.miss_streak >= 2:
            self.cooldown_until = step_seq + min(
                1 << (self.miss_streak - 2), 64
            )

    def draft(self, history: List[int], params: SpecDecodeParams) -> List[int]:
        """Up to ``max_draft_tokens`` continuation tokens for ``history``
        (prompt and generated tokens, the pending one included) by
        longest-n-gram lookup; [] when no n-gram recurs.  The lookup
        chains: after each predicted token the tail n-gram of history plus
        drafts is looked up again, so a near-periodic history fills the
        whole window."""
        n_hist = len(history)
        hi = n_hist - 1  # the tail position is never indexed before lookup
        for pos in range(self._indexed_upto, hi):
            for n in range(params.ngram_min, params.ngram_max + 1):
                if pos + 1 >= n:
                    self._index.setdefault(n, {})[
                        tuple(history[pos - n + 1 : pos + 1])
                    ] = pos
        self._indexed_upto = max(self._indexed_upto, hi)
        virt = None  # history + drafts, built at the first hit
        drafts: List[int] = []
        while len(drafts) < params.max_draft_tokens:
            src = virt if virt is not None else history
            nxt = None
            for n in range(params.ngram_max, params.ngram_min - 1, -1):
                if len(src) < n:
                    continue
                j = self._index.get(n, {}).get(tuple(src[len(src) - n :]))
                if j is not None:
                    nxt = history[j + 1]
                    break
            if nxt is None:
                break
            if virt is None:
                virt = list(history)
            virt.append(nxt)
            drafts.append(nxt)
        return drafts

    def observe(
        self, accepted: int, drafted: int, params: SpecDecodeParams
    ) -> bool:
        """Fold one verify outcome into the EMA; True when it tripped the
        fallback (the caller counts it once)."""
        self.verifies += 1
        frac = accepted / max(drafted, 1)
        d = params.ema_decay
        self.ema = d * self.ema + (1.0 - d) * frac
        if (
            not self.fallback
            and self.verifies >= params.warmup_verifies
            and self.ema < params.min_accept_rate
        ):
            self.fallback = True
            return True
        return False


@torch.no_grad()
def paged_verify_chunk(
    params,
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], updated in place
    v_pool: torch.Tensor,
    cfg: TransformerConfig,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32 valid cache prefix per row
    cur_tokens: torch.Tensor,  # [B] int32 pending token (KV not cached yet)
    draft_tokens: torch.Tensor,  # [B, max_draft] int32, right-padded
    draft_lens: torch.Tensor,  # [B] int32 valid drafts per row
    participants: torch.Tensor,  # [B] bool: rows verifying this step
    active: torch.Tensor,  # [B] bool
    budgets: torch.Tensor,  # [B] int32 remaining new tokens (incl. cur)
    max_draft: int,
    stop_fn: Callable[[torch.Tensor], torch.Tensor],  # tokens -> bool
    sampling: SamplingParams,
    max_len: int,
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
):
    """One batched verify pass over each participating row's window
    ``[cur, d_1..d_k]``: greedy targets, the acceptance chain and the state
    advance, all on the device, with a decode chunk's outputs so it rides
    the engine's ring as one (``out_t``/``out_l``/``emitted`` columns are
    the emitted tokens in order; lengths, cur, active and budgets advance
    for the next dispatch).  Non-participants pass through unchanged.  The
    window KV goes into the rows' own pool blocks, which the engine has
    allocated to cover ``length + max_draft + 1`` (quantized at the
    scatter on an int8 pool); positions at or past ``max_len`` are masked.

    Returns (lengths, out_t [B,C], out_l [B,C], emitted [B,C], cur_tokens,
    active, budgets) with C = ``max_draft + 1``."""
    B = cur_tokens.shape[0]
    C = max_draft + 1
    dev = cur_tokens.device
    window = torch.cat([cur_tokens[:, None], draft_tokens], dim=1)
    act = active & participants
    iot = torch.arange(C, dtype=torch.int32, device=dev)
    valid = (
        act[:, None]
        & (iot[None, :] <= draft_lens[:, None])
        & ((lengths[:, None] + iot[None, :]) < max_len)
    )  # [B, C] positions forwarded and scattered
    x = paged.paged_window_forward(
        params, k_pool, v_pool, cfg, window, lengths, valid, tables,
        k_scale, v_scale, verify=True,
    )
    # greedy targets and their logprobs one window position at a time, so
    # the [B, V] logits never become [B, C, V]
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    tgt, logp = [], []
    for j in range(C):
        logits = _head(params, cfg, x[:, j : j + 1])[:, 0]
        t, lp = sample_logits_keyed(logits.float(), 0, zeros, zeros, sampling)
        tgt.append(t)
        logp.append(lp)
    tgt = torch.stack(tgt, dim=1)  # [B, C] int32
    logp = torch.stack(logp, dim=1)
    # draft j+1 is confirmed iff it equals target j (and all before it)
    match = (window[:, 1:] == tgt[:, :-1]) & valid[:, 1:]
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    chain = torch.cat(
        [ones, torch.cumprod(match.to(torch.int32), dim=1).bool()], dim=1
    )
    stop_t = stop_fn(tgt)
    no_stop_before = torch.cat(
        [ones, torch.cumprod((~stop_t[:, :-1]).to(torch.int32), dim=1).bool()],
        dim=1,
    )  # a stop target ends emission after itself
    emitted = valid & chain & (iot[None, :] < budgets[:, None]) & no_stop_before
    m = emitted.sum(dim=1).to(torch.int32)  # >= 1 per live participant
    new_lengths = lengths + m
    last_tok = torch.gather(
        tgt, 1, torch.clamp(m - 1, min=0).long()[:, None]
    )[:, 0]
    new_cur = torch.where(act & (m > 0), last_tok, cur_tokens)
    new_budgets = budgets - m
    cont = act & ~stop_fn(last_tok) & (new_budgets > 0) & (new_lengths < max_len)
    new_active = torch.where(participants, cont, active)
    out_t = torch.where(emitted, tgt, torch.zeros_like(tgt))
    out_l = torch.where(emitted, logp, torch.zeros_like(logp))
    return new_lengths, out_t, out_l, emitted, new_cur, new_active, new_budgets
