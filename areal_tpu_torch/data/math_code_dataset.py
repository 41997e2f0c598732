"""Math/code prompt dataset with dynamic eval-score filtering
(reference: realhf/impl/dataset/math_code_dataset.py:90 ``MATHCodePromptDataset``,
``load_metadata`` :56).

Dataset rows are jsonl dicts with keys: ``query_id``, ``prompt``, ``task``
("math" | "stem" | "code"), plus task-specific fields (``solutions`` for
math, ``input_output`` testcases for code).

The port's copy of ``areal_tpu/data/math_code_dataset.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch.utils.data

from areal_tpu_torch.api import dataset_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("math_code_dataset")


def check_math_metadata_entries(data: Dict) -> Dict:
    assert data["task"] in ("math", "stem")
    assert "query_id" in data
    data["query_id"] = str(data["query_id"])
    assert isinstance(data["prompt"], str)
    assert isinstance(data["solutions"], list)
    for sol in data["solutions"]:
        assert isinstance(sol, str)
    return data


def check_code_metadata_entries(data: Dict) -> Dict:
    assert data["task"] == "code"
    assert "query_id" in data
    data["query_id"] = str(data["query_id"])
    if "problem_id" not in data:
        data["problem_id"] = data["query_id"]
    assert isinstance(data["prompt"], str)
    input_output = json.loads(data["input_output"])
    assert len(input_output["inputs"]) == len(input_output["outputs"])
    return data


def load_metadata(path: str) -> Tuple[Dict[str, Dict], Dict[str, int]]:
    """Validate and index a math/code jsonl by query_id."""
    assert str(path).endswith(".jsonl"), path
    with open(path) as f:
        data = [json.loads(line) for line in f if line.strip()]
    id2info: Dict[str, Dict] = {}
    omit_cnt: Dict[str, int] = defaultdict(int)
    task_cnt: Dict[str, int] = defaultdict(int)
    for d in data:
        try:
            if "task" not in d:
                d["task"] = "math"
            if d["task"] in ("math", "stem"):
                d = check_math_metadata_entries(d)
            elif d["task"] == "code":
                d = check_code_metadata_entries(d)
            else:
                raise ValueError(f"unknown task {d['task']}")
        except Exception:
            omit_cnt[d.get("task", "?")] += 1
            continue
        id2info[d["query_id"]] = d
        task_cnt[d["task"]] += 1
    if omit_cnt:
        logger.warning("omitted invalid rows: %s", dict(omit_cnt))
    return id2info, dict(task_cnt)


class MATHCodePromptDataset(torch.utils.data.Dataset):
    """Tokenized prompts; supports dynamic filtering: prompts whose running
    eval score exceeds a threshold are dropped from future epochs
    (reference's ``dataset_filter_threshold`` mechanism)."""

    def __init__(
        self,
        util: dataset_api.DatasetUtility,
        max_length: Optional[int] = None,
        dataset_path: Optional[str] = None,
        dataset_builder: Optional[Callable[[], List[Dict]]] = None,
        filter_threshold: float = 1e4,
        max_filter_percentage: float = 0.0,
    ):
        self.util = util
        self.max_length = max_length
        data = dataset_api.load_shuffle_split_dataset(
            util, dataset_path, dataset_builder
        )
        self.tasks_ids = [d["task"] for d in data]
        self.ids = [str(d["query_id"]) for d in data]
        self.solutions = [d.get("solutions", []) for d in data]
        self.input_outputs = [d.get("input_output") for d in data]
        self.timeouts = [d.get("timeout") for d in data]
        util.tokenizer.padding_side = "left"
        encodings = util.tokenizer(
            [d["prompt"] for d in data],
            truncation=True,
            max_length=max_length,
            padding=False,
            return_attention_mask=False,
        )
        self.prompt_tokens: List[List[int]] = encodings["input_ids"]
        self.filter_threshold = filter_threshold
        self.max_filter_percentage = max_filter_percentage
        self.active_indices = list(range(len(self.ids)))
        logger.info(
            "MATHCodePromptDataset: %d prompts on dp_rank %d",
            len(self.ids),
            util.dp_rank,
        )

    def __len__(self):
        return len(self.active_indices)

    def __getitem__(self, idx: int) -> SequenceSample:
        i = self.active_indices[idx]
        tokens = np.array(self.prompt_tokens[i], dtype=np.int32)
        return SequenceSample.from_default(
            seqlens=[len(tokens)],
            ids=[self.ids[i]],
            data={"packed_prompts": tokens},
            metadata={
                "task": [self.tasks_ids[i]],
                "solutions": [self.solutions[i]],
                "input_output": [self.input_outputs[i]],
                "timeout": [self.timeouts[i]],
            },
        )

    def filter(self, eval_scores: Dict[str, float]):
        """Drop prompts whose eval score >= threshold (up to a max fraction),
        matching the reference's in-training dataset pruning."""
        id2idx = {self.ids[i]: i for i in self.active_indices}
        candidates = [
            (score, qid)
            for qid, score in eval_scores.items()
            if qid in id2idx and score >= self.filter_threshold
        ]
        candidates.sort(reverse=True)
        max_remove = int(len(self.active_indices) * self.max_filter_percentage)
        to_remove = {qid for _, qid in candidates[:max_remove]}
        if to_remove:
            self.active_indices = [
                i for i in self.active_indices if self.ids[i] not in to_remove
            ]
            logger.info(
                "filtered %d prompts; %d remain",
                len(to_remove),
                len(self.active_indices),
            )


dataset_api.register_dataset("math_code_prompt", MATHCodePromptDataset)
