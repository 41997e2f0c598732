"""Generation request/response dataclasses (port of the three in
``areal_tpu/api/model_api.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


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
