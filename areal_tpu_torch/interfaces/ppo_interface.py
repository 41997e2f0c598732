"""The PPO actor and critic interfaces (port of ``PPOActorInterface`` and
``PPOCriticInterface`` in ``areal_tpu/interfaces/ppo_interface.py``; loss
math in :mod:`areal_tpu_torch.interfaces.ppo_functional`).

Data contract (packed SequenceSample keys, lengths per sequence of L tokens):
  packed_input_ids [L]       prompt + response tokens
  prompt_mask      [L]       1 on prompt tokens
  packed_logprobs  [L-1]     behavioural logprobs (from the generation engine)
  packed_ref_logprobs [L-1]  reference-policy logprobs (KL penalty)
  prox_logp        [L-1]     proximal (recomputed) logprobs, decoupled PPO
  values           [L]       critic values (absent when disable_value)
  rewards          [1]       sequence-level task reward
  seq_no_eos_mask  [1]       1 if truncated without EOS

The advantage preparation (reward shaping, GAE, normalisation) is a
small whole-batch pass over host data and runs on the CPU; the forwards
and the train step run on the engine's device.  The statistics come back
in the returned dict and, as in the reference, go to ``stats_tracker``
under ``ppo_actor`` (``ppo_critic`` for the critic).  ``generate`` is
sync PPO's ``actor_gen`` (:func:`areal_tpu_torch.engine.generation.generate_for_sample`).
The router losses of mixture-of-experts models stay out, as those models
do (ROADMAP.md queue 1, item 9).  The interfaces register as
``ppo_actor`` and ``ppo_critic`` in the port's registry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import stats_tracker
from areal_tpu_torch.engine import batching
from areal_tpu_torch.interfaces import ppo_functional
from areal_tpu_torch.models.transformer import head_weight, hidden_states
from areal_tpu_torch.ops.gae import gae_advantages_returns
from areal_tpu_torch.ops.loss import per_token_logprobs_entropy


def _segment_last_gather(values: torch.Tensor, batch: Dict) -> torch.Tensor:
    """[S] value at each segment's last token, via the segment table;
    padding segments (``seg_lens == 0``) alias row 0 / col 0."""
    last = batch["seg_starts"].long() + torch.clamp(batch["seg_lens"].long() - 1, min=0)
    return values[batch["seg_rows"].long(), last]


def _transition_mask(batch: Dict) -> torch.Tensor:
    """[B, T] 1.0 on transitions t->t+1 inside the same real segment."""
    seg = batch["seg_ids"]
    m = (seg[:, 1:] != 0) & (seg[:, :-1] == seg[:, 1:])
    return F.pad(m.float(), (0, 1))


def _response_mask(batch: Dict) -> torch.Tensor:
    """[B, T] 1.0 on transitions whose target token is a response token."""
    m = _transition_mask(batch)
    if "prompt_mask" in batch:
        resp_tgt = ~(batch["prompt_mask"].bool())
        m = m * F.pad(resp_tgt[:, 1:].float(), (0, 1))
    return m


def model_logprobs_fwd(temperature: float = 1.0):
    """fwd_fn producing transition-aligned logprobs [B, T] (col T-1 = 0)."""

    def fn(params, cfg, batch):
        hidden = hidden_states(
            params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
        )
        B, T, D = hidden.shape
        w = head_weight(params, cfg).to(hidden.dtype) / temperature
        # the logprob alone: the same arithmetic as the reference's
        # (logits - lse)[label], without the entropy it discards
        logp, _ = per_token_logprobs_entropy(
            hidden[:, :-1].reshape(-1, D), w,
            batch["tokens"][:, 1:].reshape(-1), with_entropy=False,
        )
        return F.pad(logp.reshape(B, T - 1), (0, 1))

    return fn


def critic_values_fwd(params, cfg, batch):
    """fwd_fn producing per-token values [B, T] (0 on padding)."""
    from areal_tpu_torch.models.transformer import forward

    values = forward(
        params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
    )
    return values * (batch["seg_ids"] != 0)


@dataclasses.dataclass
class PPOActorInterface(model_api.ModelInterface):
    n_minibatches: int = 4
    gconfig: model_api.GenerationHyperparameters = dataclasses.field(
        default_factory=model_api.GenerationHyperparameters
    )

    kl_ctl: float = 0.1
    adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0

    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 5.0
    reward_scaling: float = 1.0
    reward_bias: float = 0.0
    mask_no_eos_with_zero: bool = False

    adv_norm: bool = True
    group_adv_norm: bool = False
    group_size: int = 1

    disable_value: bool = False
    temperature: float = 1.0

    use_decoupled_loss: bool = False
    behav_imp_weight_cap: Optional[float] = None

    token_key: str = "packed_input_ids"

    def __post_init__(self):
        if self.adaptive_kl_ctl:
            self.kl_controller = ppo_functional.AdaptiveKLController(
                self.kl_ctl, self.adaptive_kl_target, self.adaptive_kl_horizon
            )
        else:
            self.kl_controller = ppo_functional.FixedKLController(self.kl_ctl)
        self._loss_fn = functools.partial(_actor_loss, iface=self)

    # -- advantage preparation (whole batch, before the minibatch split) ----

    def _prep_padded(self, batch: Dict, kl_ctl: float):
        """Padded batch (CPU tensors) -> (advantages, returns, loss_mask,
        kl_sum)."""
        trans_mask = _transition_mask(batch)
        loss_mask = _response_mask(batch)
        logp = batch.get("packed_logprobs", torch.zeros_like(trans_mask))
        ref_logp = batch.get("packed_ref_logprobs", logp)
        score = (
            batch["rewards"].float() * self.reward_scaling - self.reward_bias
        )
        no_eos = batch.get("seq_no_eos_mask", torch.zeros_like(score)).float()
        kl_rewards, rewards = ppo_functional.shape_rewards(
            kl_ctl,
            self.max_reward_clip,
            logp,
            ref_logp,
            score,
            loss_mask,
            seq_no_eos_mask=no_eos,
            mask_no_eos_with_zero=self.mask_no_eos_with_zero,
        )
        if "values" in batch and not self.disable_value:
            values = batch["values"].float()
        else:
            values = torch.zeros_like(trans_mask)
        # bootstrap with the value at each sequence's last token iff
        # truncated (a segment-table gather; prep runs on the
        # one-sequence-per-row layout, where [S] == [B])
        bootstrap = _segment_last_gather(values, batch) * no_eos
        adv, ret = gae_advantages_returns(
            rewards, values, bootstrap, trans_mask, self.discount,
            self.gae_lambda,
        )
        kl_sum = torch.sum((logp - ref_logp) * loss_mask)
        return adv, ret, loss_mask, kl_sum

    def _prepare_batch(self, sample: SequenceSample) -> Dict[str, float]:
        """Advantages and returns for the whole batch, amended to the
        sample as packed keys, with advantage normalisation."""
        pb = batching.pad_batch(sample, token_key=self.token_key)
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batching.batch_dict(pb).items()
        }
        adv, ret, loss_mask, kl_sum = self._prep_padded(
            batch, float(self.kl_controller.value)
        )
        adv, ret, loss_mask = (t.numpy() for t in (adv, ret, loss_mask))

        adv_packed = batching.unpad_per_token(adv, pb.seq_lens, pb.n_real, 1)
        ret_packed = batching.unpad_per_token(ret, pb.seq_lens, pb.n_real, 1)
        mask_packed = batching.unpad_per_token(
            loss_mask, pb.seq_lens, pb.n_real, 1
        )

        m = mask_packed > 0
        if self.adv_norm and m.any():
            if self.group_adv_norm and self.group_size > 1:
                seqlens = np.array(
                    [l[0] - 1 for l in sample.seqlens[self.token_key]]
                )
                offsets = np.concatenate([[0], np.cumsum(seqlens)])
                for g0 in range(0, len(seqlens), self.group_size):
                    g1 = min(g0 + self.group_size, len(seqlens))
                    sl = slice(offsets[g0], offsets[g1])
                    gm = m[sl]
                    if gm.any():
                        vals = adv_packed[sl][gm]
                        adv_packed[sl] = (
                            adv_packed[sl] - vals.mean()
                        ) / (vals.std() + 1e-5)
            else:
                vals = adv_packed[m]
                adv_packed = (adv_packed - vals.mean()) / (vals.std() + 1e-5)
            adv_packed = adv_packed * mask_packed

        seqlens_full = [l[0] for l in sample.seqlens[self.token_key]]
        amend = SequenceSample.from_default(
            seqlens_full,
            sample.ids,
            {
                "advantages": adv_packed.astype(np.float32),
                "returns": ret_packed.astype(np.float32),
                "ppo_loss_mask": mask_packed.astype(np.float32),
            },
        )
        sample.update_(amend)
        n_resp = float(m.sum())
        return {
            "kl": float(kl_sum) / max(n_resp, 1),
            "n_response_tokens": n_resp,
            "reward_mean": float(np.mean(sample.data["rewards"])),
        }

    # -- model function calls -----------------------------------------------

    def train_step(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> Dict:
        engine = model.engine
        prep_stats = self._prepare_batch(data)
        mbs, *_ = data.split(MicroBatchSpec(n_mbs=self.n_minibatches))
        all_stats = _aggregate_minibatch_stats(
            engine.train_batch(
                mb, self._loss_fn, mb_spec, token_key=self.token_key
            )
            for mb in mbs
        )
        all_stats["actor_clip_frac"] = all_stats.pop("clip_frac", 0.0)
        self.kl_controller.update(
            prep_stats["kl"], int(prep_stats["n_response_tokens"])
        )
        all_stats.update(prep_stats)
        all_stats["kl_ctl"] = self.kl_controller.value
        model.version.advance(
            model.ft_spec.steps_per_epoch if model.ft_spec else int(1e9)
        )
        with stats_tracker.scope("ppo_actor"):
            stats_tracker.scalar(
                **{
                    k: v
                    for k, v in all_stats.items()
                    if isinstance(v, (int, float))
                }
            )
        return all_stats

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        """Recompute logprobs under the current policy (prox_logp for the
        decoupled loss, else the reference model's ref logprobs)."""
        logp = model.engine.forward_batch(
            data,
            model_logprobs_fwd(self.temperature),
            mb_spec,
            token_key=self.token_key,
            output_shift=1,
        )
        seqlens = [l[0] for l in data.seqlens[self.token_key]]
        key = "prox_logp" if self.use_decoupled_loss else "packed_ref_logprobs"
        return SequenceSample.from_default(
            seqlens, data.ids, {key: logp.astype(np.float32)}
        )

    def generate(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        """Generation on the model's device for sync PPO."""
        from areal_tpu_torch.engine.generation import generate_for_sample

        return generate_for_sample(model, data, self.gconfig)


def _aggregate_minibatch_stats(stats_iter) -> Dict[str, float]:
    """Sum keys (``*_sum``, counts) add across minibatches; the rest are
    token-weighted means.  ``clip_frac``/``entropy``/``approx_kl`` come
    from the accumulated sums."""
    sums: Dict[str, float] = {}
    weighted: Dict[str, float] = {}
    total_tokens = 0.0
    for stats in stats_iter:
        toks = stats.get("n_tokens", 1.0)
        total_tokens += toks
        for k, v in stats.items():
            if k.endswith("_sum") or k in ("n_tokens", "n_mbs"):
                sums[k] = sums.get(k, 0.0) + v
            else:
                weighted[k] = weighted.get(k, 0.0) + v * toks
    out = {k: v / max(total_tokens, 1e-8) for k, v in weighted.items()}
    out.update(sums)
    denom = max(total_tokens, 1e-8)
    if "clip_count_sum" in out:
        out["clip_frac"] = out.pop("clip_count_sum") / denom
    if "entropy_sum" in out:
        out["entropy"] = out["entropy_sum"] / denom
    if "approx_kl_sum" in out:
        out["approx_kl"] = out["approx_kl_sum"] / denom
    return out


def _actor_loss(params, cfg, batch, iface: PPOActorInterface):
    hidden = hidden_states(
        params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
    )
    B, T, D = hidden.shape
    w = head_weight(params, cfg).to(hidden.dtype) / iface.temperature
    new_logp, entropy = per_token_logprobs_entropy(
        hidden[:, :-1].reshape(-1, D), w, batch["tokens"][:, 1:].reshape(-1)
    )
    new_logp = F.pad(new_logp.reshape(B, T - 1), (0, 1))
    loss_mask = batch["ppo_loss_mask"]
    old_logp = batch["packed_logprobs"]
    prox = batch.get("prox_logp") if iface.use_decoupled_loss else None
    loss, stat = ppo_functional.actor_loss_fn(
        new_logp.float(),
        old_logp.float(),
        batch["advantages"].float(),
        iface.eps_clip,
        loss_mask,
        c_clip=iface.c_clip,
        proximal_logprobs=prox.float() if prox is not None else None,
        behav_imp_weight_cap=iface.behav_imp_weight_cap,
    )
    count = torch.clamp(torch.sum(loss_mask), min=1.0)
    mask_b = loss_mask.bool()
    # raw sums only: train_batch adds them across micro-batches and
    # train_step across minibatches; fractions are derived at the end
    stats = {
        "clip_count_sum": torch.sum(stat["clip_mask"]),
        "approx_kl_sum": torch.sum(stat["approx_kl"]),
        "entropy_sum": torch.sum(
            F.pad(entropy.reshape(B, T - 1), (0, 1)) * loss_mask
        ),
        "adv_sum": torch.sum(
            torch.where(mask_b, batch["advantages"], torch.zeros_like(loss_mask))
        ),
    }
    # the engine divides gradients by the summed denominators
    return loss * count, count, stats


@dataclasses.dataclass
class PPOCriticInterface(model_api.ModelInterface):
    n_minibatches: int = 4
    value_eps_clip: float = 0.2
    value_loss_type: str = "mse"
    kl_ctl: float = 0.1
    discount: float = 1.0
    gae_lambda: float = 1.0
    max_reward_clip: float = 5.0
    mask_no_eos_with_zero: bool = False
    token_key: str = "packed_input_ids"

    def __post_init__(self):
        # the actor's advantage preparation, with the values kept
        self._prep = PPOActorInterface(
            kl_ctl=self.kl_ctl,
            discount=self.discount,
            gae_lambda=self.gae_lambda,
            max_reward_clip=self.max_reward_clip,
            mask_no_eos_with_zero=self.mask_no_eos_with_zero,
            adv_norm=False,
            token_key=self.token_key,
        )
        self._loss_fn = functools.partial(_critic_loss, iface=self)

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        values = model.engine.forward_batch(
            data, critic_values_fwd, mb_spec, token_key=self.token_key,
            output_shift=0,
        )
        seqlens = [l[0] for l in data.seqlens[self.token_key]]
        return SequenceSample.from_default(
            seqlens, data.ids, {"values": values.astype(np.float32)}
        )

    def train_step(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> Dict:
        engine = model.engine
        if "returns" not in data.keys:
            self._prep._prepare_batch(data)
        mbs, *_ = data.split(MicroBatchSpec(n_mbs=self.n_minibatches))
        all_stats = _aggregate_minibatch_stats(
            engine.train_batch(
                mb, self._loss_fn, mb_spec, token_key=self.token_key
            )
            for mb in mbs
        )
        all_stats["value_clip_frac"] = all_stats.pop("clip_frac", 0.0)
        model.version.advance(
            model.ft_spec.steps_per_epoch if model.ft_spec else int(1e9)
        )
        with stats_tracker.scope("ppo_critic"):
            stats_tracker.scalar(
                **{
                    k: v
                    for k, v in all_stats.items()
                    if isinstance(v, (int, float))
                }
            )
        return all_stats


def _critic_loss(params, cfg, batch, iface: PPOCriticInterface):
    hidden = hidden_states(
        params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
    )
    w = params["value_head"]["w"].to(hidden.dtype)
    values = (hidden @ w)[..., 0].float()
    values = values * (batch["seg_ids"] != 0)
    loss_mask = batch["ppo_loss_mask"]
    old_values = batch.get("values", torch.zeros_like(values)).float()
    loss, stat = ppo_functional.critic_loss_fn(
        values,
        old_values,
        batch["returns"].float(),
        iface.value_eps_clip,
        loss_mask,
        loss_fn_type=iface.value_loss_type,
    )
    count = torch.clamp(torch.sum(loss_mask), min=1.0)
    stats = {"clip_count_sum": torch.sum(stat["clip_mask"])}
    return loss * count, count, stats


model_api.register_interface("ppo_actor", PPOActorInterface)
model_api.register_interface("ppo_critic", PPOCriticInterface)
