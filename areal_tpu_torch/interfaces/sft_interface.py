"""SFT interface: packed cross-entropy training and evaluation with the
prompt masked out (port of ``areal_tpu/interfaces/sft_interface.py``;
reference: realhf/impl/model/interface/sft_interface.py:86).

The loss is a sum over transitions with its token count as the
denominator, and the engine divides the summed gradient by the summed
count, so a step's numbers do not depend on how its batch splits into
micro-batches.  The router losses of mixture-of-experts models stay out,
as those models do (``models/config.py`` refuses them; ROADMAP.md queue
1, item 9).  The interface registers as ``sft``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import stats_tracker
from areal_tpu_torch.models.transformer import head_weight, hidden_states
from areal_tpu_torch.ops.loss import masked_cross_entropy


def sft_loss_fn(params, cfg, batch):
    """``(loss_sum, token_count, stats)``: the label of a token is the
    next one.  A transition counts only when both tokens are in the same
    non-pad segment (so, in a row that packs several sequences, the step
    from one sequence into the next drops out as padding does) and its
    target is not a prompt token."""
    hidden = hidden_states(
        params, cfg, batch["tokens"], batch["positions"], batch["seg_ids"]
    )
    B, T, D = hidden.shape
    w = head_weight(params, cfg).to(hidden.dtype)
    labels = batch["tokens"][:, 1:]
    h = hidden[:, :-1].reshape(-1, D)
    seg = batch["seg_ids"]
    valid = (seg[:, 1:] != 0) & (seg[:, :-1] == seg[:, 1:])
    if "prompt_mask" in batch:
        valid &= ~batch["prompt_mask"][:, 1:].bool()
    loss_sum, count = masked_cross_entropy(
        h, w, labels.reshape(-1), valid.reshape(-1)
    )
    return loss_sum, count, {"nll_sum": loss_sum.detach(), "n_valid_tokens": count}


def _eval_nll(params, cfg, batch):
    loss_sum, count, _ = sft_loss_fn(params, cfg, batch)
    return loss_sum, count


@dataclasses.dataclass
class SFTInterface(model_api.ModelInterface):
    token_key: str = "packed_input_ids"

    def train_step(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> Dict:
        stats = model.engine.train_batch(
            data, sft_loss_fn, mb_spec, token_key=self.token_key
        )
        model.version.advance(
            model.ft_spec.steps_per_epoch if model.ft_spec else int(1e9)
        )
        with stats_tracker.scope("sft"):
            stats_tracker.scalar(
                loss=stats["loss"],
                grad_norm=stats["grad_norm"],
                n_tokens=stats["n_tokens"],
            )
        return stats

    def evaluate(self, model: model_api.Model, eval_dataloader) -> Dict:
        """Token-mean NLL over the evaluation data (one sample at a time,
        each laid out as the engine lays out a micro-batch)."""
        engine = model.engine
        total_nll = total_tokens = 0.0
        for sample in eval_dataloader:
            mbs, *_ = sample.split(MicroBatchSpec())
            for mb in mbs:
                batch = engine._device_batch(engine._pad(mb, self.token_key))
                with torch.no_grad():
                    nll, cnt = _eval_nll(engine.params, engine.model_cfg, batch)
                total_nll += float(nll)
                total_tokens += float(cnt)
        return {
            "eval_nll": total_nll / max(total_tokens, 1),
            "eval_tokens": total_tokens,
        }

    def save(self, model: model_api.Model, save_dir: str):
        model.engine.save_hf(
            save_dir, model.backend_name or "llama", model.tokenizer
        )


model_api.register_interface("sft", SFTInterface)
