"""Reward-model paired dataset (reference: realhf/impl/dataset/rw_paired_dataset.py).

Each row has "prompt", "pos_answers", "neg_answers"; a row yields one id with
2*n_pairs sequences packed as [pos1, neg1, pos2, neg2, ...] under the key
``packed_input_ids`` with ``group_factor`` metadata for loss averaging.

The port's copy of ``areal_tpu/data/rw_paired_dataset.py``, its imports
renamed to ``areal_tpu_torch``; like the prompt-answer dataset it encodes
without padding, so the tokenizer's ``padding_side`` does not matter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch.utils.data

from areal_tpu_torch.api import dataset_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("rw_paired_dataset")


class RewardModelingPairedDataset(torch.utils.data.Dataset):
    def __init__(
        self,
        util: dataset_api.DatasetUtility,
        max_length: int,
        max_pairs_per_prompt: int = 2,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.util = util
        data = dataset_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder
        )
        tok = util.tokenizer
        self.ids = [str(d["id"]) for d in data]
        self.token_groups: List[List[List[int]]] = []
        self.prompt_lens: List[List[int]] = []  # per sequence, same order
        for d in data:
            pairs = list(zip(d["pos_answers"], d["neg_answers"]))[
                :max_pairs_per_prompt
            ]
            p_ids = tok(
                d["prompt"], padding=False, return_attention_mask=False
            )["input_ids"]
            group, plens = [], []
            for pos, neg in pairs:
                for ans in (pos, neg):
                    enc = tok(
                        d["prompt"] + ans + tok.eos_token,
                        truncation=True,
                        max_length=max_length,
                        padding=False,
                        return_attention_mask=False,
                    )
                    ids = enc["input_ids"]
                    group.append(ids)
                    # prompt span = longest common prefix with the bare
                    # prompt encoding: a BPE merge across the prompt/answer
                    # boundary shortens the prefix, and the merged token is
                    # then counted as RESPONSE (trained, not masked) — so
                    # downstream losses never depend on the two pair
                    # members tokenizing the boundary identically
                    n = 0
                    while (
                        n < len(p_ids)
                        and n < len(ids)
                        and ids[n] == p_ids[n]
                    ):
                        n += 1
                    plens.append(n)
            self.token_groups.append(group)
            self.prompt_lens.append(plens)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> SequenceSample:
        group = self.token_groups[idx]
        packed = np.concatenate([np.array(g, dtype=np.int32) for g in group])
        n_pairs = len(group) // 2
        lens = [[len(g) for g in group]]
        pmask = np.concatenate(
            [
                (np.arange(len(g)) < plen)
                for g, plen in zip(group, self.prompt_lens[idx])
            ]
        ).astype(bool)
        return SequenceSample(
            keys={"packed_input_ids", "prompt_mask"},
            trailing_shapes={"packed_input_ids": (), "prompt_mask": ()},
            dtypes={
                "packed_input_ids": np.dtype(np.int32),
                "prompt_mask": np.dtype(bool),
            },
            ids=[self.ids[idx]],
            seqlens={"packed_input_ids": lens, "prompt_mask": lens},
            data={"packed_input_ids": packed, "prompt_mask": pmask},
            metadata={"group_factor": [1 / n_pairs]},
        )


dataset_api.register_dataset("rw_pair", RewardModelingPairedDataset)
