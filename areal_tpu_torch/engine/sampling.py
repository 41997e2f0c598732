"""Token sampling (temperature / top-k / top-p), port of
``areal_tpu/engine/sampling.py``.

The serving engine samples with :func:`sample_logits_keyed`: the draw for
"request r's token at absolute position p" is a pure function of
``(engine seed, request seed, position)``, so a stream does not depend on
chunk size, pipeline depth or the row a request landed in.  The random
numbers come from a counter-based hash of those three values and the
vocabulary index, turned into Gumbel noise (Gumbel-max sampling over the
filtered logits, like the reference).  JAX's and torch's random streams
differ, so sampled tokens match the reference in distribution, not bit
for bit; greedy decoding is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 or >= vocab disables
    greedy: bool = False


def _filtered_logits(
    logits: torch.Tensor,  # [B, V] post-temperature
    params: SamplingParams,
    ban_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply ban + top-k + top-p filters (-inf out the filtered entries).
    Scalars stay Python numbers: a scalar tensor made on the device would
    be a host-to-device copy, which synchronises the stream."""
    neg_inf = float("-inf")
    sample_from = logits
    if ban_mask is not None:
        sample_from = sample_from.masked_fill(ban_mask, neg_inf)
    if params.greedy:
        return sample_from
    filtered = sample_from
    V = logits.shape[-1]
    if params.top_k and params.top_k < V:
        kth = torch.sort(filtered, dim=-1).values[:, V - params.top_k][:, None]
        filtered = filtered.masked_fill(filtered < kth, neg_inf)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(filtered, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cum >= top_p (always keep the first)
        cutoff_mask = cum - probs >= params.top_p
        cutoff_logit = sorted_logits.masked_fill(
            cutoff_mask, float("inf")
        ).amin(dim=-1, keepdim=True)
        filtered = filtered.masked_fill(filtered < cutoff_logit, neg_inf)
    return filtered


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) (a Python int or an
    int64 tensor), without int64 overflow: the product is formed from
    16-bit halves of ``x``."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply; "lowbias32"), on a
    Python int or an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_gumbel(
    seed: int, rows: torch.Tensor, positions: torch.Tensor, vocab: int
) -> torch.Tensor:
    """Gumbel noise ``[B, vocab]`` float32 whose row b is a pure function of
    ``(seed, rows[b], positions[b])``."""
    dev = rows.device
    s = _mix32((seed ^ 0x9E3779B9) & _MASK32)  # a Python int: no device copy
    ka = _mix32((rows.long() & _MASK32) ^ s)
    kb = _mix32(ka ^ (positions.long() & _MASK32))
    kc = _mix32((kb + 0x68E31DA4) & _MASK32)
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    vh = _mix32(_mul32(v, 0x9E3779B9) ^ 0x5BD1E995)
    x = _mix32(((_mix32(vh[None, :] ^ kb[:, None]) + kc[:, None]) & _MASK32))
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_logits_keyed(
    logits: torch.Tensor,  # [B, V] float32
    seed: int,  # ONE fixed seed per engine/run
    rows: torch.Tensor,  # [B] per-request key identity
    positions: torch.Tensor,  # [B] absolute position of the sampled token
    params: SamplingParams,
    ban_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position-keyed sampling.  Returns (tokens [B] int32, logprob of the
    sampled token [B] float32).  The logprob is from the post-temperature
    distribution without top-k/top-p filtering or bans, as the reference
    reports it (the trainer's recompute knows nothing of sampling-time
    filters)."""
    if params.temperature != 1.0:
        logits = logits / max(params.temperature, 1e-5)
    base_logprobs = torch.log_softmax(logits, dim=-1)
    filtered = _filtered_logits(logits, params, ban_mask)
    if params.greedy:
        tokens = torch.argmax(filtered, dim=-1)
    else:
        g = keyed_gumbel(seed, rows, positions, logits.shape[-1])
        tokens = torch.argmax(filtered + g, dim=-1)
    logp = torch.gather(base_logprobs, 1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), logp
