"""Reward-model training interface: pairwise Bradley-Terry on a critic
head (port of ``areal_tpu/interfaces/rm_interface.py``).

A sequence's score is the critic's value at its last token; the loss of
a (chosen, rejected) pair is ``-logsigmoid(score_chosen -
score_rejected)``.  The sequences of each sample id alternate [chosen,
rejected, ...] (the paired dataset's packing order), so every sequence
gets a sign (+1 chosen, -1 rejected) and a global pair index, and the
loss sums each pair's signed scores by that index.  Pairs never straddle
micro-batches, since ``SequenceSample.split`` keeps ids whole.

``inference`` gives one ``rewards`` value per sequence, which makes a
trained scorer the PPO graph's reward MFC (``reward_source="model"``).
The interface registers as ``rw_train``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import stats_tracker
from areal_tpu_torch.engine.batching import next_pow2
from areal_tpu_torch.interfaces.ppo_interface import (
    _segment_last_gather,
    critic_values_fwd,
)
from areal_tpu_torch.models.transformer import forward


def pair_loss(
    margins: torch.Tensor,  # [P] score_chosen - score_rejected
    valid: torch.Tensor,  # [P] bool; False for padding pairs
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss_sum, n_pairs, stats)`` of ``-logsigmoid(margin)`` over the
    valid pairs (the reference's ``ops/dpo.py dpo_pair_loss`` at beta 1
    without a reference model); the stats are raw sums, which
    micro-batches add."""
    validf = valid.float()
    stats = {
        "margin_sum": torch.sum(torch.where(valid, margins,
                                            torch.zeros_like(margins))),
        "reward_acc_sum": torch.sum((margins > 0) & valid),
    }
    return torch.sum(-F.logsigmoid(margins) * validf), torch.sum(validf), stats


def amend_pairing(data: SequenceSample, token_key: str) -> SequenceSample:
    """Attach per-token ``dpo_sign`` (+1 chosen, -1 rejected) and
    ``dpo_pair`` (the global pair index); the sequences alternate
    [chosen, rejected, ...] within each sample id."""
    groups = data.seqlens[token_key]
    sign_parts, pair_parts = [], []
    seq_idx = 0
    for ls in groups:
        assert len(ls) % 2 == 0, f"a paired id holds an odd sequence count: {ls}"
        for L in ls:
            sign_parts.append(np.full(L, 1 if seq_idx % 2 == 0 else -1, np.int32))
            pair_parts.append(np.full(L, seq_idx // 2, np.int32))
            seq_idx += 1
    amend = SequenceSample(
        keys={"dpo_sign", "dpo_pair"},
        trailing_shapes={"dpo_sign": (), "dpo_pair": ()},
        dtypes={
            "dpo_sign": np.dtype(np.int32),
            "dpo_pair": np.dtype(np.int32),
        },
        ids=data.ids,
        seqlens={"dpo_sign": groups, "dpo_pair": groups},
        data={
            "dpo_sign": np.concatenate(sign_parts),
            "dpo_pair": np.concatenate(pair_parts),
        },
    )
    data.update_(amend)
    return data


def rm_pairwise_loss_fn(n_pairs: int):
    """Engine loss function: Bradley-Terry over the (chosen, rejected)
    last-token scores; ``n_pairs`` bounds the pair indices."""

    def fn(params, cfg, batch):
        assert cfg.is_critic, "reward-model training needs a critic-head model"
        values = forward(
            params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
        ).float()  # [B, T]
        # a row may hold several segments: each sequence's last token is
        # found through the segment table; sign and pair are constant over
        # a segment, so its first token gives them
        rows = batch["seg_rows"].long()
        starts = batch["seg_starts"].long()
        score = _segment_last_gather(values, batch)  # [S]
        real = batch["seg_lens"] > 0  # padding segments alias (0, 0)
        sign = batch["dpo_sign"][rows, starts].float() * real
        pair = batch["dpo_pair"][rows, starts].long()
        zeros = torch.zeros((n_pairs,), dtype=torch.float32, device=values.device)
        pair_margin = zeros.index_add(0, pair, score * sign)
        members = zeros.index_add(0, pair, real.float())
        valid = members >= 2  # both members of the pair are here
        loss_sum, n_valid, stats = pair_loss(pair_margin, valid)
        stats["score_abs_sum"] = torch.sum(torch.abs(score) * real)
        stats["n_seqs"] = torch.sum(real.float())
        return loss_sum, n_valid, stats

    return fn


@dataclasses.dataclass
class RewardModelInterface(model_api.ModelInterface):
    token_key: str = "packed_input_ids"

    def train_step(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> Dict:
        data = amend_pairing(data, self.token_key)
        n_seqs = sum(len(ls) for ls in data.seqlens[self.token_key])
        cap = next_pow2(max(1, n_seqs // 2))
        stats = model.engine.train_batch(
            data, rm_pairwise_loss_fn(cap), mb_spec, token_key=self.token_key
        )
        model.version.advance(
            model.ft_spec.steps_per_epoch if model.ft_spec else int(1e9)
        )
        n_pairs = max(stats.get("n_tokens", 1.0), 1.0)
        with stats_tracker.scope("rm"):
            stats_tracker.scalar(
                loss=stats["loss"],
                margin=stats.get("margin_sum", 0.0) / n_pairs,
                pair_acc=stats.get("reward_acc_sum", 0.0) / n_pairs,
                grad_norm=stats["grad_norm"],
                n_pairs=n_pairs,
            )
        return stats

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        """One reward per sequence: the scorer's value at its last token."""
        values = model.engine.forward_batch(
            data, critic_values_fwd, mb_spec, token_key=self.token_key
        )
        lens = [l for ls in data.seqlens[self.token_key] for l in ls]
        ends = np.cumsum(lens) - 1
        scores = np.asarray(values[ends], np.float32)
        group_sizes = [len(ls) for ls in data.seqlens[self.token_key]]
        return SequenceSample(
            keys={"rewards"},
            trailing_shapes={"rewards": ()},
            dtypes={"rewards": np.dtype(np.float32)},
            ids=data.ids,
            seqlens={"rewards": [[1] * g for g in group_sizes]},
            data={"rewards": scores},
        )

    def evaluate(self, model: model_api.Model, eval_dataloader) -> Dict:
        """Held-out pair accuracy: the share of (chosen, rejected) pairs
        the scorer orders right, over batches of up to 64 samples."""
        if eval_dataloader is None:
            return {}
        correct = total = 0
        buf = []

        def flush():
            nonlocal correct, total
            if not buf:
                return
            batch = SequenceSample.gather(buf)
            buf.clear()
            # the even/odd pairing below needs every group even-sized: an
            # odd one would shift chosen and rejected for every later prompt
            assert all(
                len(ls) % 2 == 0 for ls in batch.seqlens[self.token_key]
            ), "reward-model eval data has an odd-sized answer group"
            rewards = self.inference(model, batch, MicroBatchSpec()).data[
                "rewards"
            ]
            chosen, rejected = rewards[0::2], rewards[1::2]
            correct += int((chosen > rejected).sum())
            total += len(chosen)

        for sample in eval_dataloader:
            buf.append(sample)
            if len(buf) >= 64:
                flush()
        flush()
        return {
            "eval_pair_acc": correct / max(total, 1),
            "eval_pairs": float(total),
        }

    def save(self, model: model_api.Model, save_dir: str):
        model.engine.save_hf(
            save_dir, model.backend_name or "llama", model.tokenizer
        )


model_api.register_interface("rw_train", RewardModelInterface)
