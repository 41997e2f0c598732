"""PPO actor loss, reward shaping and KL controllers (port of the actor
half of ``areal_tpu/interfaces/ppo_functional.py``).

Tensor functions work on the padded ``[B, T]`` transition layout (entry t
is the transition predicting token t+1).  The critic's loss is not ported
(critics are not part of the slice).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class KLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current_kl: float, n_steps: int):
        pass


class FixedKLController(KLController):
    pass


class AdaptiveKLController(KLController):
    """arXiv:1909.08593 adaptive controller."""

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        super().__init__(init_kl_coef)
        self.target = target
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int):
        proportional_error = min(max(current_kl / self.target - 1, -0.2), 0.2)
        mult = 1 + proportional_error * n_steps / self.horizon
        self.value *= mult


def actor_loss_fn(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    eps_clip: float,
    loss_mask: torch.Tensor,
    c_clip: Optional[float] = None,
    proximal_logprobs: Optional[torch.Tensor] = None,
    behav_imp_weight_cap: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO-clip policy loss.

    With ``proximal_logprobs`` this is the decoupled objective: the clip
    ratio is taken against the proximal (recomputed) policy, and the
    behavioural importance weight exp(proximal - behavioural) multiplies
    the clipped loss; weights above ``behav_imp_weight_cap`` drop out.
    """
    loss_mask = loss_mask.bool()
    denorm_logprobs = (
        proximal_logprobs if proximal_logprobs is not None else old_logprobs
    )
    count = torch.clamp(loss_mask.sum(), min=1)
    zero = torch.zeros_like(logprobs)

    ratio = torch.where(loss_mask, torch.exp(logprobs - denorm_logprobs), zero)
    clipped_ratio = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + eps_clip)
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    clip_mask = pg_loss1 < pg_loss2
    pg_loss = torch.maximum(pg_loss1, pg_loss2)

    if c_clip is not None:
        assert c_clip > 1.0, c_clip
        pg_loss3 = torch.sign(advantages) * c_clip * advantages
        dual_clip_mask = pg_loss3 < pg_loss
        pg_loss = torch.minimum(pg_loss, pg_loss3)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)

    stat: Dict[str, torch.Tensor] = {}
    if proximal_logprobs is not None:
        behav_kl = proximal_logprobs - old_logprobs
        behav_imp_weight = torch.exp(behav_kl)
        if behav_imp_weight_cap is not None:
            behav_mask = (behav_imp_weight <= behav_imp_weight_cap) & loss_mask
        else:
            behav_mask = loss_mask
        behav_kl = torch.where(behav_mask, behav_kl, zero)
        behav_imp_weight = torch.where(behav_mask, behav_imp_weight, zero)
        pg_loss = pg_loss * behav_imp_weight
        stat["behave_imp_weight"] = behav_imp_weight
        stat["behave_approx_kl"] = behav_kl
        stat["behave_mask"] = behav_mask

    logging_loss = pg_loss
    pg_loss = torch.sum(torch.where(loss_mask, pg_loss, zero)) / count

    stat.update(
        loss=logging_loss,
        importance_weight=ratio,
        approx_kl=torch.where(loss_mask, logprobs - denorm_logprobs, zero),
        clip_mask=clip_mask & loss_mask,
        dual_clip_mask=dual_clip_mask & loss_mask,
    )
    return pg_loss, stat


def shape_rewards(
    kl_ctl: float,
    clip_reward_value: float,
    logprobs: torch.Tensor,  # [B, T] behavioural logprobs on transitions
    ref_logprobs: torch.Tensor,  # [B, T]
    reward_score: torch.Tensor,  # [B] sequence-level task reward
    transition_mask: torch.Tensor,  # [B, T] 1 on valid response transitions
    seq_no_eos_mask: Optional[torch.Tensor] = None,  # [B] 1 if truncated
    mask_no_eos_with_zero: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL-penalty token rewards plus the task reward on the final
    transition.  Returns (kl_rewards, rewards)."""
    transition_mask = transition_mask.float()
    kl_rewards = -kl_ctl * (logprobs - ref_logprobs) * transition_mask
    score = torch.clamp(reward_score, -clip_reward_value, clip_reward_value)
    if mask_no_eos_with_zero and seq_no_eos_mask is not None:
        score = torch.where(
            seq_no_eos_mask.bool(), torch.zeros_like(score), score
        )
    zeros = torch.zeros_like(transition_mask[:, :1])
    next_mask = torch.cat([transition_mask[:, 1:], zeros], dim=1)
    is_last = transition_mask * (1.0 - next_mask)
    rewards = kl_rewards + is_last * score[:, None]
    return kl_rewards, rewards
