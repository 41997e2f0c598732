"""DPO interface (port of ``areal_tpu/interfaces/dpo_interface.py``).

Trains an actor on (chosen, rejected) preference pairs from the paired
dataset (``data/rw_paired_dataset.py`` packs each prompt's answers as
[pos1, neg1, pos2, neg2, ...]).  A frozen reference model's per-token
logprobs arrive as a data key (the ``ref_inf`` MFC, through
:meth:`DPOInterface.inference`), the actor recomputes its own inside the
loss, and both reduce to per-pair logratios (``ops/dpo.py``).

The pairing is the per-token ``dpo_sign`` (+1 chosen, -1 rejected) and
``dpo_pair`` (the global pair index) keys that
:func:`~areal_tpu_torch.interfaces.rm_interface.amend_pairing` attaches on
the host.  ``SequenceSample.split`` keeps a sample id's sequences
together, so a pair never straddles micro-batches.  The router losses of
mixture-of-experts models stay out, as those models do (ROADMAP.md queue
1, item 9).  The interface registers as ``dpo``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import stats_tracker
from areal_tpu_torch.engine.batching import next_pow2
from areal_tpu_torch.interfaces.ppo_interface import (
    _response_mask,
    model_logprobs_fwd,
)
from areal_tpu_torch.interfaces.rm_interface import amend_pairing
from areal_tpu_torch.models.transformer import head_weight, hidden_states
from areal_tpu_torch.ops.dpo import dpo_pair_loss, pairwise_logratios
from areal_tpu_torch.ops.loss import per_token_logprobs_entropy


def dpo_loss_fn(beta: float, n_pairs: int):
    """Engine loss function of DPO; ``n_pairs`` is the pair capacity (a
    power of two at least the batch's pair count)."""

    def fn(params, cfg, batch):
        hidden = hidden_states(
            params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
        )
        B, T, D = hidden.shape
        w = head_weight(params, cfg).to(hidden.dtype)
        logp, _ = per_token_logprobs_entropy(
            hidden[:, :-1].reshape(-1, D), w,
            batch["tokens"][:, 1:].reshape(-1), with_entropy=False,
        )
        logp = F.pad(logp.reshape(B, T - 1).float(), (0, 1))
        mask = _response_mask(batch)

        # sign and pair are constant over a segment; align them to each
        # transition's target (the labels' shift).  In a packed row the
        # shift drags segment k+1's first sign onto segment k's last
        # column, which ``mask`` (same-segment transitions only) zeroes
        def tgt(a):
            return F.pad(a[:, 1:], (0, 1))

        sign = tgt(batch["dpo_sign"]).float()
        pair = tgt(batch["dpo_pair"]).long()
        ref_logp = batch["packed_ref_logprobs"].float()
        pi_lr = pairwise_logratios(logp, sign, pair, mask, n_pairs)
        ref_lr = pairwise_logratios(ref_logp, sign, pair, mask, n_pairs)
        # a pair is live where any of its response transitions is here
        tokens_per_pair = pairwise_logratios(
            torch.ones_like(mask), sign.abs(), pair, mask, n_pairs
        )
        return dpo_pair_loss(pi_lr, ref_lr, tokens_per_pair > 0, beta)

    return fn


@dataclasses.dataclass
class DPOInterface(model_api.ModelInterface):
    beta: float = 0.1
    token_key: str = "packed_input_ids"

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        """The frozen reference's per-token logprobs of the packed batch
        (``packed_ref_logprobs``, ``L - 1`` per sequence)."""
        lps = model.engine.forward_batch(
            data, model_logprobs_fwd(1.0), mb_spec,
            token_key=self.token_key, output_shift=1,
        )
        lr_groups = [[l - 1 for l in ls] for ls in data.seqlens[self.token_key]]
        return SequenceSample(
            keys={"packed_ref_logprobs"},
            trailing_shapes={"packed_ref_logprobs": ()},
            dtypes={"packed_ref_logprobs": np.dtype(np.float32)},
            ids=data.ids,
            seqlens={"packed_ref_logprobs": lr_groups},
            data={"packed_ref_logprobs": np.asarray(lps, np.float32)},
        )

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
            data, dpo_loss_fn(self.beta, cap), mb_spec, token_key=self.token_key
        )
        model.version.advance(
            model.ft_spec.steps_per_epoch if model.ft_spec else int(1e9)
        )
        n_pairs = max(stats.get("n_tokens", 1.0), 1.0)  # the denominator
        with stats_tracker.scope("dpo"):
            stats_tracker.scalar(
                loss=stats["loss"],
                margin=stats.get("margin_sum", 0.0) / n_pairs,
                reward_acc=stats.get("reward_acc_sum", 0.0) / n_pairs,
                grad_norm=stats["grad_norm"],
                n_pairs=n_pairs,
            )
        return stats

    def save(self, model: model_api.Model, save_dir: str):
        model.engine.save_hf(
            save_dir, model.backend_name or "llama", model.tokenizer
        )


model_api.register_interface("dpo", DPOInterface)
