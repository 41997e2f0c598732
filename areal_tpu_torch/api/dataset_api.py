"""Dataset utilities and registry (copy of ``areal_tpu/api/dataset_api.py``:
``DatasetUtility``, ``load_shuffle_split_dataset``, ``make_dataset``,
``load_hf_tokenizer``, ``SequenceSampleDataLoader``).

Datasets are host-side torch ``Dataset``s yielding numpy-backed
``SequenceSample`` objects; the engines pad at their boundary.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch.utils.data

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("dataset_api")


def load_hf_tokenizer(
    model_name_or_path: str,
    fast_tokenizer: bool = True,
    padding_side: Optional[str] = None,
):
    import transformers

    kwargs = {}
    if padding_side is not None:
        kwargs["padding_side"] = padding_side
    tokenizer = transformers.AutoTokenizer.from_pretrained(
        model_name_or_path,
        use_fast=fast_tokenizer,
        trust_remote_code=True,
        **kwargs,
    )
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token_id = tokenizer.eos_token_id
    return tokenizer


@dataclasses.dataclass
class DatasetUtility:
    """Per-DP-shard dataset context: this worker's rank/world_size determine
    which slice of the dataset it owns."""

    seed: int
    dp_rank: int
    world_size: int
    tokenizer: Any

    def __post_init__(self):
        if self.tokenizer is not None and self.tokenizer.pad_token_id is None:
            raise ValueError("tokenizer must have a pad token id")


def load_shuffle_split_dataset(
    util: DatasetUtility,
    dataset_path: Optional[str] = None,
    dataset_builder: Optional[Callable[[], List[Dict]]] = None,
) -> List[Dict]:
    """Load a json/jsonl list-of-dicts, deterministically shuffle, and return
    this DP rank's contiguous shard."""
    if dataset_path is not None:
        if dataset_path.endswith(".jsonl"):
            with open(dataset_path) as f:
                data = [json.loads(line) for line in f if line.strip()]
        elif dataset_path.endswith(".json"):
            with open(dataset_path) as f:
                data = json.load(f)
        else:
            raise NotImplementedError(f"unknown dataset format: {dataset_path}")
    else:
        assert dataset_builder is not None
        data = dataset_builder()

    # Assign stable unique ids if absent.
    for i, d in enumerate(data):
        if "id" not in d:
            d["id"] = d.get("query_id", str(i))

    rng = np.random.RandomState(util.seed)
    indices = np.arange(len(data))
    rng.shuffle(indices)
    # contiguous per-rank shard of the shuffled order
    shards = np.array_split(indices, util.world_size)
    shard = shards[util.dp_rank]
    return [data[int(i)] for i in shard]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_DATASETS: Dict[str, Callable] = {}


def register_dataset(name: str, cls: Callable):
    if name in _DATASETS:
        raise KeyError(f"dataset {name} already registered")
    _DATASETS[name] = cls


def make_dataset(
    cfg,
    seed: int,
    dp_rank: int,
    world_size: int,
    tokenizer_or_path: Any,
) -> torch.utils.data.Dataset:
    """``cfg`` is a DatasetAbstraction (type_ + args) or a plain name."""
    from areal_tpu_torch.api.config import DatasetAbstraction

    if isinstance(cfg, str):
        cfg = DatasetAbstraction(type_=cfg)
    if isinstance(tokenizer_or_path, str):
        tokenizer = load_hf_tokenizer(tokenizer_or_path)
    else:
        tokenizer = tokenizer_or_path
    util = DatasetUtility(
        seed=seed, dp_rank=dp_rank, world_size=world_size, tokenizer=tokenizer
    )
    return _DATASETS[cfg.type_](util=util, **cfg.args)


def gather_sequence_samples(samples):
    """Default collate: list of SequenceSample -> one gathered batch."""
    from areal_tpu_torch.api.data import SequenceSample

    return SequenceSample.gather(samples)


class SequenceSampleDataLoader(torch.utils.data.DataLoader):
    """DataLoader yielding gathered SequenceSample batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        g = torch.Generator()
        g.manual_seed(seed)
        super().__init__(
            dataset,
            batch_size=batch_size,
            shuffle=shuffle,
            generator=g,
            collate_fn=gather_sequence_samples,
            num_workers=0,
        )
