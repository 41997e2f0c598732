"""Memory-lean head losses (port of ``areal_tpu/ops/loss.py``).

For long contexts the [tokens, vocab] logits dominate memory: at a 151936
vocab, one 1024-token chunk of float32 logits is 0.62 GB.  These helpers
compute per-token logprobs, entropy and cross-entropy in chunks of tokens,
each chunk under a checkpoint, so the backward recomputes that chunk's
logits instead of keeping every chunk's alive (the reference's
``jax.checkpoint`` over its chunk scan).  The head product is a plain
``torch.matmul``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_logp_ent(h, w, labels):
    """h [C, D], labels [C] -> (logp [C], entropy [C])."""
    logits = (h @ w).float()  # [C, V]
    lse = torch.logsumexp(logits, dim=-1)
    logp_all = logits - lse[:, None]
    p = torch.exp(logp_all)
    entropy = -torch.sum(p * logp_all, dim=-1)
    logp = torch.gather(logp_all, 1, labels[:, None])[:, 0]
    return logp, entropy


def _chunk_logp(h, w, labels):
    """Logprob only: skips the full-vocab entropy passes."""
    logits = (h @ w).float()  # [C, V]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, labels[:, None])[:, 0]
    logp = tgt - lse
    return logp, torch.zeros_like(logp)


def per_token_logprobs_entropy(
    hidden: torch.Tensor,  # [N, D] hidden states (pre final-head)
    head_w: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [N]
    chunk_size: int = 1024,
    with_entropy: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logprob, entropy) per token, in chunks of ``chunk_size`` tokens;
    differentiable in ``hidden`` and ``head_w``, each chunk's logits
    recomputed in the backward."""
    f = _chunk_logp_ent if with_entropy else _chunk_logp
    labels = labels.long()
    remat = torch.is_grad_enabled()
    logps, ents = [], []
    for c0 in range(0, hidden.shape[0], chunk_size):
        args = (hidden[c0 : c0 + chunk_size], head_w, labels[c0 : c0 + chunk_size])
        lp, ent = checkpoint(f, *args, use_reentrant=False) if remat else f(*args)
        logps.append(lp)
        ents.append(ent)
    return torch.cat(logps), torch.cat(ents)


def masked_cross_entropy(
    hidden: torch.Tensor,  # [N, D]
    head_w: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [N]
    mask: torch.Tensor,  # [N] float/bool
    chunk_size: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL over masked tokens, token count).  Mean = sum/count."""
    logp, _ = per_token_logprobs_entropy(
        hidden, head_w, labels, chunk_size, with_entropy=False
    )
    mask = mask.float()
    return -torch.sum(logp * mask), torch.sum(mask)
