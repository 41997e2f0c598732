"""Model factory and train/inference backends (port of
``areal_tpu/engine/backend.py``).

A backend turns a raw (config, params) bundle from :func:`make_model` into
an engine with ``train_batch``/``forward_batch``: both are the port's
one-device :class:`~areal_tpu_torch.engine.train_engine.TrainEngine` (the
inference variant has no optimizer state).  They register under the
reference's names (``train``, ``inference``, ``null``) in the port's own
registry (``api/model_api``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelAbstraction, ModelName
from areal_tpu_torch.base.device import DeviceLike
from areal_tpu_torch.engine.inference_server import _not_ported
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models.config import TransformerConfig, tiny_config


def make_model(
    cfg: ModelAbstraction,
    name: Optional[ModelName],
    mesh=None,
    tokenizer=None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> model_api.Model:
    """An uninitialised model bundle: ``model_cfg`` and ``init_params``
    set, no engine.

    Abstraction types:

    - ``random``: args ``{config: dict | TransformerConfig, seed?}``, or
      ``tiny_config`` keyword arguments: parameters drawn from ``seed``
      (default 0) by :func:`areal_tpu_torch.models.transformer.init_params`
      in ``dtype`` (default: the model dtype; ``torch.float32`` for a
      trainer's master weights) on ``device`` (default ``cuda``).  The
      draws are made in float32 either way, so a server and a trainer
      built from one seed hold the same weights up to the cast.  The draws
      are torch's, not JAX's: the same seed gives other weights than the
      JAX package's factory.
    - ``null``: no parameters (a tokenizer-only bundle).

    ``hf`` (an HF checkpoint dir) is not ported yet (item 6), nor are
    meshes (item 10)."""
    if mesh is not None:
        raise _not_ported("models on a device mesh (mesh)", item=10)
    if cfg.type_ == "null":
        model = model_api.Model(name=name, engine=None, tokenizer=tokenizer)
        model.model_cfg = tiny_config()
        return model
    if cfg.type_ == "hf":
        raise _not_ported("HF checkpoint models (type_='hf')", item=6)
    if cfg.type_ != "random":
        raise ValueError(f"unknown model abstraction {cfg.type_}")
    from areal_tpu_torch.models.transformer import init_params

    args = dict(cfg.args)
    seed = args.pop("seed", 0)
    conf = args.pop("config", None)
    if isinstance(conf, TransformerConfig):
        model_cfg = conf
    elif conf is not None:
        model_cfg = TransformerConfig(**conf)
    else:
        model_cfg = tiny_config(**args)
    model = model_api.Model(
        name=name, engine=None, tokenizer=tokenizer, backend_name="llama"
    )
    model.model_cfg = model_cfg
    model.init_params = init_params(model_cfg, seed, device, dtype=dtype)
    return model


@dataclasses.dataclass
class TrainBackend(model_api.ModelBackend):
    """The train engine with AdamW (reference: megatron.py:561).

    ``device`` is the engine's device (None = ``cuda``); the model worker
    sets it from its config."""

    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )
    pack_sequences: bool = True
    #: segment-packing row budget above the longest sequence; the port
    #: packs each micro-batch into rows of its longest sequence, so only
    #: 0 is accepted
    pack_capacity: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.pack_capacity:
            raise NotImplementedError(
                "pack_capacity > 0 is not ported; rows hold the longest "
                "sequence of their micro-batch"
            )

    def _initialize(self, model, spec):
        model.engine = TrainEngine(
            model.model_cfg,
            model.mesh,
            model.init_params,
            optimizer_cfg=self.optimizer,
            total_train_steps=max(1, spec.total_train_steps),
            pack_sequences=self.pack_sequences,
            device=self.device,
        )
        model.init_params = None
        return model

    def save(self, model, save_dir: str):
        model.engine.save_train_state(os.path.join(save_dir, "train_state"))

    def load(self, model, load_dir: str):
        model.engine.load_train_state(os.path.join(load_dir, "train_state"))


@dataclasses.dataclass
class InferenceBackend(model_api.ModelBackend):
    """The engine without optimizer state (reference: inference.py:230)."""

    pack_sequences: bool = True
    pack_capacity: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.pack_capacity:
            raise NotImplementedError(
                "pack_capacity > 0 is not ported; rows hold the longest "
                "sequence of their micro-batch"
            )

    def _initialize(self, model, spec):
        model.engine = TrainEngine(
            model.model_cfg,
            model.mesh,
            model.init_params,
            optimizer_cfg=None,
            pack_sequences=self.pack_sequences,
            device=self.device,
        )
        model.init_params = None
        return model


@dataclasses.dataclass
class NullBackend(model_api.ModelBackend):
    """No-op backend for engine-less roles (a rule-based reward)."""

    device: Optional[str] = None

    def _initialize(self, model, spec):
        return model


model_api.register_backend("train", TrainBackend)
model_api.register_backend("inference", InferenceBackend)
model_api.register_backend("null", NullBackend)
