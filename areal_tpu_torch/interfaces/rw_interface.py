"""Rule-based reward interface (port of
``areal_tpu/interfaces/rw_interface.py``; reference:
realhf/impl/model/interface/math_rw_interface.py ``MultiTaskRewardInterface``
:181): decode each generated answer, score it with the verifier its task
names (:mod:`areal_tpu_torch.verifiers.dispatch`) and emit one reward per
sequence.  Math answers are checked by the local final-answer verifier;
code answers raise, as the dispatch does (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import logging_, stats_tracker
from areal_tpu_torch.verifiers.dispatch import verify_batch

logger = logging_.getLogger("rw_interface")


@dataclasses.dataclass
class MultiTaskRewardInterface(model_api.ModelInterface):
    token_key: str = "packed_input_ids"
    group_size: int = 1
    check_verifier_status: bool = False
    rw_type: str = "sparse"

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        tok = model.tokenizer
        assert tok is not None, "reward interface needs a tokenizer"
        # host-side over the packed 1-D varlen layout — unaffected by the
        # engine's device-batch packing (which only changes [B, T] layout)
        seqlens = [l[0] for l in data.seqlens[self.token_key]]
        offsets = np.concatenate([[0], np.cumsum(seqlens)])
        packed = data.data[self.token_key]
        pmask = data.data.get("prompt_mask")

        texts: List[str] = []
        for i in range(data.bs):
            seq = packed[offsets[i] : offsets[i + 1]]
            if pmask is not None:
                pm = pmask[offsets[i] : offsets[i + 1]]
                seq = seq[~pm.astype(bool)]
            texts.append(tok.decode(seq, skip_special_tokens=True))

        solutions = data.metadata.get("solutions")
        tasks = data.metadata.get("task") or ["math"] * data.bs
        input_outputs = data.metadata.get("input_output") or [None] * data.bs
        if solutions is None and all(t == "math" for t in tasks):
            logger.warning("no solutions metadata; rewards are all 0")
            rewards = [0.0] * data.bs
        else:
            solutions = solutions or [[]] * data.bs
            timeouts = data.metadata.get("timeout") or [None] * data.bs
            problems = [
                {
                    "query_id": str(data.ids[i]),
                    "solutions": solutions[i],
                    "input_output": input_outputs[i],
                    **(
                        {"timeout": timeouts[i]}
                        if timeouts[i] is not None
                        else {}
                    ),
                }
                for i in range(data.bs)
            ]
            rewards = verify_batch(tasks, texts, problems)

        with stats_tracker.scope("reward"):
            stats_tracker.scalar(
                task_reward=float(np.mean(rewards)),
                n_sequences=data.bs,
            )
        return SequenceSample.from_default(
            seqlens,
            data.ids,
            {"rewards": np.asarray(rewards, np.float32)},
        )

    def mock(self, type_, model, data):
        return self.inference(model, data, MicroBatchSpec())


model_api.register_interface("rw_math", MultiTaskRewardInterface)
