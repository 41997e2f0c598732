"""Plain prompt dataset for PPO (reference: realhf/impl/dataset/prompt_dataset.py).

The port's copy of ``areal_tpu/data/prompt_dataset.py``, its imports
renamed to ``areal_tpu_torch``.  As there, it sets ``padding_side =
"left"`` on the tokenizer it is given (a shared one included).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch.utils.data

from areal_tpu_torch.api import dataset_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("prompt_dataset")


class PromptDataset(torch.utils.data.Dataset):
    def __init__(
        self,
        util: dataset_api.DatasetUtility,
        max_length: Optional[int] = None,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
    ):
        self.util = util
        data = dataset_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder
        )
        self.ids = [str(d["id"]) for d in data]
        util.tokenizer.padding_side = "left"
        encodings = util.tokenizer(
            [d["prompt"] for d in data],
            truncation=True,
            max_length=max_length,
            padding=False,
            return_attention_mask=False,
        )
        self.prompt_tokens: List[List[int]] = encodings["input_ids"]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> SequenceSample:
        tokens = np.array(self.prompt_tokens[idx], dtype=np.int32)
        return SequenceSample.from_default(
            seqlens=[len(tokens)],
            ids=[self.ids[idx]],
            data={"packed_prompts": tokens},
        )


dataset_api.register_dataset("prompt", PromptDataset)
