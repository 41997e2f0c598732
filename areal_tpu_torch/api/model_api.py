"""Generation request/response dataclasses, and the model bundle and
algorithm-interface base the trainer path uses (port of those parts of
``areal_tpu/api/model_api.py``).  Nothing registers at import: the
reference's interface and backend registries are not ported."""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class GenerationHyperparameters:
    n: int = 1  # group size (answers per prompt)
    max_new_tokens: int = 16384
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = int(1e8)
    temperature: float = 1.0
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)

    def new(self, **kwargs) -> "GenerationHyperparameters":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class APIGenerateInput:
    """One generation call on an inference server."""

    qid: str
    prompt_ids: List[int]
    input_ids: List[int]  # prompt + previously generated (continuation)
    gconfig: GenerationHyperparameters
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    return_logprob: bool = True
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class APIGenerateOutput:
    """Server reply."""

    qid: str
    prompt_ids: List[int]
    input_ids: List[int]
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_eos: bool = True
    version_start: int = -1
    version_end: int = -1
    latency: float = 0.0

    @classmethod
    def from_input(cls, inp: APIGenerateInput) -> "APIGenerateOutput":
        return cls(
            qid=inp.qid, prompt_ids=inp.prompt_ids, input_ids=inp.input_ids
        )

    @property
    def gen_len(self):
        return len(self.output_ids)


@dataclasses.dataclass
class FinetuneSpec:
    total_train_epochs: int
    dataset_size: int
    train_batch_size: int

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.dataset_size // self.train_batch_size)

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * self.steps_per_epoch

    def is_new_epoch(self, version) -> bool:
        return version.epoch_step == 0


@dataclasses.dataclass
class ModelVersionSteps:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def advance(self, steps_per_epoch: int):
        self.global_step += 1
        self.epoch_step += 1
        if self.epoch_step >= steps_per_epoch:
            self.epoch += 1
            self.epoch_step = 0


@dataclasses.dataclass
class Model:
    """A named model: its engine (a
    :class:`~areal_tpu_torch.engine.train_engine.TrainEngine`), tokenizer
    and version counters."""

    name: Any
    engine: Any
    tokenizer: Any = None
    version: ModelVersionSteps = dataclasses.field(
        default_factory=ModelVersionSteps
    )
    ft_spec: Optional[FinetuneSpec] = None


class ModelInterface(abc.ABC):
    """Algorithm interface: handlers that consume and produce
    ``SequenceSample``s."""

    def save(self, model: Model, save_dir: str):
        pass

    def evaluate(self, model: Model, eval_dataloader) -> Dict:
        return {}

    def inference(self, model: Model, data, mb_spec):
        raise NotImplementedError()

    def generate(self, model: Model, data, mb_spec):
        raise NotImplementedError()

    def train_step(self, model: Model, data, mb_spec):
        raise NotImplementedError()
