"""Direct Preference Optimization math (port of ``areal_tpu/ops/dpo.py``;
reference: realhf/impl/model/utils/dpo_functional.py:11-34 ``dpo_loss``).

The sigmoid preference loss over (chosen, rejected) pairs of sequence
logprobs, with margin and accuracy statistics.  The packed-batch
interface reduces per-token logprobs to per-pair logratios with a
scatter-add over a fixed pair capacity (the reference's
``jax.ops.segment_sum``), so the batch's composition never reshapes a
dense vector.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def dpo_pair_loss(
    pi_logratios: torch.Tensor,  # [P] sum(logp chosen) - sum(logp rejected)
    ref_logratios: torch.Tensor,  # [P] same under the frozen reference policy
    valid: torch.Tensor,  # [P] bool; False for padding pairs
    beta: float,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss_sum, n_pairs, stats)``: loss per pair ``-logsigmoid(beta *
    (pi_logratio - ref_logratio))``; the statistics are sums, so gradient
    accumulation adds them across micro-batches (``reward_acc_sum`` counts
    the pairs whose implicit reward margin is positive)."""
    validf = valid.float()
    delta = beta * (pi_logratios - ref_logratios)
    losses = -F.logsigmoid(delta) * validf
    n_pairs = validf.sum()
    stats = {
        "margin_sum": torch.where(valid, delta, torch.zeros_like(delta)).sum(),
        "reward_acc_sum": ((delta > 0) & valid).float().sum(),
    }
    return losses.sum(), n_pairs, stats


def pairwise_logratios(
    per_token: torch.Tensor,  # [B, T] transition-aligned per-token values
    sign: torch.Tensor,  # [B, T] +1 chosen / -1 rejected (target-aligned)
    pair_ids: torch.Tensor,  # [B, T] global pair index (target-aligned)
    mask: torch.Tensor,  # [B, T] response-transition mask
    n_pairs: int,  # capacity (a power of two)
) -> torch.Tensor:
    """Per-pair (chosen - rejected) sums of ``per_token`` ``[n_pairs]``."""
    contrib = (per_token * mask * sign).reshape(-1)
    out = torch.zeros(n_pairs, dtype=contrib.dtype, device=contrib.device)
    return out.index_add(0, pair_ids.reshape(-1).long(), contrib)
