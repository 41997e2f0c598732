"""SFT dataset: packed prompt+answer with a prompt mask
(reference: realhf/impl/dataset/prompt_answer_dataset.py).

The port's copy of ``areal_tpu/data/prompt_answer_dataset.py``, its
imports renamed to ``areal_tpu_torch``.  ``pad_to_max_length`` pads on
the right itself, so the tokenizer's ``padding_side`` (which
:mod:`prompt_dataset` sets to "left" on a shared tokenizer) does not reach
its tokens: the reference's copy, which lets the tokenizer pad, would put
left padding under its prompt mask.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch.utils.data

from areal_tpu_torch.api import dataset_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("prompt_answer_dataset")


class PromptAnswerDataset(torch.utils.data.Dataset):
    """Each row has "prompt" and "answer"; __getitem__ yields the packed
    concatenation plus ``prompt_mask`` (1 on prompt tokens, 0 on answer) used
    by the SFT loss to mask out prompt positions."""

    def __init__(
        self,
        util: dataset_api.DatasetUtility,
        max_length: int,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
        pad_to_max_length: bool = False,
    ):
        self.util = util
        self.max_length = max_length
        data = dataset_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder
        )
        self.ids = [str(d["id"]) for d in data]
        tok = util.tokenizer
        seqs = [d["prompt"] + d["answer"] + tok.eos_token for d in data]
        prompt_encodings = tok(
            [d["prompt"] for d in data],
            padding=False,
            truncation=True,
            max_length=max_length,
            return_attention_mask=False,
        )
        seq_encodings = tok(
            seqs,
            padding=False,
            truncation=True,
            max_length=max_length,
            return_attention_mask=False,
        )
        self.prompt_lens = [len(x) for x in prompt_encodings["input_ids"]]
        self.tokens: List[List[int]] = seq_encodings["input_ids"]
        if pad_to_max_length:
            # padded on the right whatever the tokenizer's padding_side (a
            # shared tokenizer that the prompt dataset set to "left" would
            # put the padding under the prompt mask)
            self.tokens = [
                t + [tok.pad_token_id] * (max_length - len(t))
                for t in self.tokens
            ]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> SequenceSample:
        tokens = np.array(self.tokens[idx], dtype=np.int32)
        prompt_mask = np.zeros(len(tokens), dtype=bool)
        plen = min(self.prompt_lens[idx], len(tokens))
        prompt_mask[:plen] = True
        return SequenceSample.from_default(
            seqlens=[len(tokens)],
            ids=[self.ids[idx]],
            data={
                "packed_input_ids": tokens,
                "prompt_mask": prompt_mask,
            },
        )


dataset_api.register_dataset("prompt_answer", PromptAnswerDataset)
