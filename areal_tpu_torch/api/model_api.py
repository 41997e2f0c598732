"""Model, interface and backend abstractions and their registries (copy of
``areal_tpu/api/model_api.py``).

Two differences: :class:`APIGenerateOutput` carries the weight version of
every output token (``output_versions``; the port's engine reports them),
and :class:`Model` has no device mesh (``mesh`` stays ``None``: the port
trains and serves on one device).  The port's interfaces and backends
register here, in the port's own registries.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.config import (
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("model_api")


# ---------------------------------------------------------------------------
# Generation hyperparameters & request/response dataclasses
# ---------------------------------------------------------------------------


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
class GenReqMeta:
    """Metadata for routing a generation request (reference :46)."""

    qid: str
    prompt_len: int
    group_size: int
    new_token_budget: int
    predicted_new_tokens: Optional[int] = None
    previous_server_url: str = ""
    previous_version: int = -1


@dataclasses.dataclass
class APIGenerateInput:
    """One generation call on an inference server (reference :63)."""

    qid: str
    prompt_ids: List[int]
    input_ids: List[int]  # prompt + previously generated (continuation)
    gconfig: GenerationHyperparameters
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    return_logprob: bool = True
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class APIGenerateOutput:
    """Server reply (reference :88)."""

    qid: str
    prompt_ids: List[int]
    input_ids: List[int]
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_eos: bool = True
    version_start: int = -1
    version_end: int = -1
    latency: float = 0.0
    # the weight version each output token was sampled under (one entry
    # per ``output_ids`` entry; the JAX package reports only the first
    # and last, ``version_start`` and ``version_end``)
    output_versions: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_input(cls, inp: APIGenerateInput) -> "APIGenerateOutput":
        return cls(qid=inp.qid, prompt_ids=inp.prompt_ids, input_ids=inp.input_ids)

    @property
    def gen_len(self):
        return len(self.output_ids)


@dataclasses.dataclass
class BundledGenerationOutputs:
    """A full group (n answers) for one prompt (reference :180)."""

    qid: str
    prompt_ids: List[int]
    seqs: List[List[int]]  # prompt + answer, per group member
    logprobs: List[List[float]]  # packed logprobs per seq (len = seqlen - 1)
    no_eos: List[bool]
    version_start: List[int]
    version_end: List[int]

    @classmethod
    def from_api_outputs(
        cls, outputs: List[APIGenerateOutput]
    ) -> "BundledGenerationOutputs":
        o0 = outputs[0]
        return cls(
            qid=o0.qid,
            prompt_ids=o0.prompt_ids,
            seqs=[o.prompt_ids + o.output_ids for o in outputs],
            logprobs=[
                [0.0] * (len(o.prompt_ids) - 1) + list(o.output_logprobs)
                for o in outputs
            ],
            no_eos=[o.no_eos for o in outputs],
            version_start=[o.version_start for o in outputs],
            version_end=[o.version_end for o in outputs],
        )


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


# ---------------------------------------------------------------------------
# Model bundle + version
# ---------------------------------------------------------------------------


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
    """A named model: config + engine + tokenizer + version counters
    (reference :652 bundles module/tokenizer/device)."""

    name: ModelName
    engine: Any  # TrainEngine (set by backend initialize)
    tokenizer: Any = None
    mesh: Any = None  # always None: one device
    version: ModelVersionSteps = dataclasses.field(
        default_factory=ModelVersionSteps
    )
    ft_spec: Optional[FinetuneSpec] = None
    backend_name: str = ""
    # set by make_model, consumed by backend initialize
    model_cfg: Any = None
    init_params: Any = None


class ModelBackend(abc.ABC):
    """Wraps a raw model into a trainable/servable engine (reference :699)."""

    @abc.abstractmethod
    def _initialize(self, model: Model, spec: FinetuneSpec) -> Model: ...

    def initialize(self, model: Model, spec: FinetuneSpec) -> Model:
        model = self._initialize(model, spec)
        model.ft_spec = spec
        return model

    def save(self, model: Model, save_dir: str):
        raise NotImplementedError()

    def load(self, model: Model, load_dir: str):
        raise NotImplementedError()


class ModelInterface(abc.ABC):
    """Algorithm interface: stateless handlers executed on model workers
    (reference :759).  All methods consume/produce SequenceSample."""

    def save(self, model: Model, save_dir: str):
        pass

    def evaluate(self, model: Model, eval_dataloader) -> Dict:
        return {}

    def inference(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample | None:
        raise NotImplementedError()

    def generate(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample | None:
        raise NotImplementedError()

    def train_step(
        self, model: Model, data: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict | List[Dict]:
        raise NotImplementedError()

    # master-side filtering hook (dataset pruning by eval scores)
    def mock(self, type_: str, model: Model, data: SequenceSample):
        raise NotImplementedError()


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_MODEL_INTERFACES: Dict[str, Callable[..., ModelInterface]] = {}
_MODEL_BACKENDS: Dict[str, Callable[..., ModelBackend]] = {}


def register_interface(name: str, cls):
    if name in _MODEL_INTERFACES:
        raise KeyError(f"interface {name} already registered")
    _MODEL_INTERFACES[name] = cls


def register_backend(name: str, cls):
    if name in _MODEL_BACKENDS:
        raise KeyError(f"backend {name} already registered")
    _MODEL_BACKENDS[name] = cls


def make_interface(cfg: ModelInterfaceAbstraction) -> ModelInterface:
    if isinstance(cfg, str):
        cfg = ModelInterfaceAbstraction(cfg)
    return _MODEL_INTERFACES[cfg.type_](**cfg.args)


def make_backend(cfg: ModelBackendAbstraction) -> ModelBackend:
    if isinstance(cfg, str):
        cfg = ModelBackendAbstraction(cfg)
    return _MODEL_BACKENDS[cfg.type_](**cfg.args)
