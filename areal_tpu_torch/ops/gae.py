"""Generalized Advantage Estimation (port of ``areal_tpu/ops/gae.py``).

The reference runs the reverse recurrence as a ``lax.scan`` over the time
axis of the padded ``[B, T]`` layout; here it is a Python loop over T on
tensors, vectorized across rows.  :func:`gae_packed_numpy` is the
per-row numpy reference the tests hold both against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gae_advantages_returns(
    rewards: torch.Tensor,  # [B, T] reward on transition t -> t+1
    values: torch.Tensor,  # [B, T] value at token t
    bootstrap_values: torch.Tensor,  # [B] value after the last transition
    mask: torch.Tensor,  # [B, T] 1.0 on valid transitions, 0 elsewhere
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked reverse-scan GAE.

    For each row, over valid transitions t (mask==1):
        delta_t = r_t + gamma * V_{t+1} - V_t
        A_t     = delta_t + gamma * lam * A_{t+1}
    Values at masked positions are treated as 0; the value after the final
    valid transition is ``bootstrap_values`` (0 for terminated episodes).
    Returns (advantages, returns) with returns = A + V on valid positions.
    """
    B, T = rewards.shape
    mask = mask.float()
    values = values.float() * mask
    rewards = rewards.float() * mask
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=rewards.device)
    next_values = torch.cat([values[:, 1:], zeros], dim=1)
    next_mask = torch.cat([mask[:, 1:], zeros], dim=1)
    # the LAST valid transition: mask_t == 1 and next_mask == 0
    is_last = mask * (1.0 - next_mask)
    next_values = next_values + is_last * bootstrap_values[:, None].float()
    deltas = rewards + gamma * next_values - values

    adv = torch.zeros((B,), dtype=torch.float32, device=rewards.device)
    cols = [None] * T
    for t in range(T - 1, -1, -1):
        adv = (deltas[:, t] + gamma * lam * adv) * mask[:, t]
        cols[t] = adv
    advantages = torch.stack(cols, dim=1)
    returns = advantages + values
    return advantages * mask, returns * mask


def gae_packed_numpy(rewards, values, bootstrap, mask, gamma, lam):
    """Pure-numpy per-row reference (float64)."""
    B, T = rewards.shape
    advs = np.zeros((B, T), np.float64)
    rets = np.zeros((B, T), np.float64)
    for b in range(B):
        valid = np.nonzero(mask[b])[0]
        if len(valid) == 0:
            continue
        adv = 0.0
        nxt = float(bootstrap[b])
        for t in valid[::-1]:
            delta = rewards[b, t] + gamma * nxt - values[b, t]
            adv = delta + gamma * lam * adv
            advs[b, t] = adv
            rets[b, t] = adv + values[b, t]
            nxt = values[b, t]
    return advs, rets
