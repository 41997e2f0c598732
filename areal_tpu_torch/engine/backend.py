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
from areal_tpu_torch.base.device import DeviceLike, resolve_device
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
    set, no engine.  ``dtype`` is the storage of the parameters:
    ``torch.float32`` for a trainer's master weights, None for a server's
    (the model dtype, norm scales in float32; ``convert.serving_params``).

    Abstraction types:

    - ``hf``: args ``{path, is_critic?, dtype?}`` plus any
      :class:`TransformerConfig` field as a post-load override; an HF
      checkpoint directory read by
      :func:`areal_tpu_torch.models.hf.load_hf_model` onto ``device``
      (default ``cuda``).  Unknown keys raise before the checkpoint is
      read; so does a model that the flash kernel cannot train on a card
      (a sliding window, or Gemma's head_dim of 256).
      ``backend_name`` is the family's name.
    - ``random``: args ``{config: dict | TransformerConfig, seed?,
      is_critic?}``, or ``tiny_config`` keyword arguments: parameters
      drawn from ``seed``
      (default 0) by :func:`areal_tpu_torch.models.transformer.init_params`
      in ``dtype`` on ``device`` (default ``cuda``).  The draws are made in
      float32 either way, so a server and a trainer built from one seed
      hold the same weights up to the cast.  The draws are torch's, not
      JAX's: the same seed gives other weights than the JAX package's
      factory.
    - ``null``: no parameters (a tokenizer-only bundle).

    Meshes are not ported (item 10)."""
    if mesh is not None:
        raise _not_ported("models on a device mesh (mesh)", item=10)
    if cfg.type_ == "null":
        model = model_api.Model(name=name, engine=None, tokenizer=tokenizer)
        model.model_cfg = tiny_config()
        return model
    if cfg.type_ == "hf":
        model_cfg, params, backend_name = _load_hf(cfg.args, device, dtype)
    elif cfg.type_ == "random":
        from areal_tpu_torch.models.transformer import init_params

        args = dict(cfg.args)
        seed = args.pop("seed", 0)
        conf = args.pop("config", None)
        is_critic = args.pop("is_critic", False)
        if isinstance(conf, TransformerConfig):
            model_cfg = conf
        elif conf is not None:
            model_cfg = TransformerConfig(**conf)
        else:
            model_cfg = tiny_config(**args)
        if is_critic:
            # also beside a ``config`` dict, which the JAX package's
            # factory reads without it (its critic twin of such an actor
            # gets an LM head)
            model_cfg = dataclasses.replace(
                model_cfg, is_critic=True, tied_embedding=False)
        params = init_params(model_cfg, seed, device, dtype=dtype)
        backend_name = "llama"
    else:
        raise ValueError(f"unknown model abstraction {cfg.type_}")
    model = model_api.Model(
        name=name, engine=None, tokenizer=tokenizer, backend_name=backend_name
    )
    model.model_cfg = model_cfg
    model.init_params = params
    return model


def _load_hf(args, device: DeviceLike, dtype: Optional[torch.dtype]):
    """(config, params, family name) of an ``hf`` abstraction."""
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.hf.registry import load_hf_config, load_hf_model

    # every TransformerConfig field is a post-load override; unknown keys
    # are typos and must fail BEFORE the multi-GB checkpoint read
    cfg_fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    load_keys = ("path", "is_critic", "dtype")
    unknown = set(args) - cfg_fields - set(load_keys)
    if unknown:
        raise ValueError(
            f"unknown hf model args {sorted(unknown)}; valid: path, "
            f"is_critic, dtype, or any TransformerConfig field"
        )
    device = resolve_device(device)
    post = {k: v for k, v in args.items() if k not in load_keys}
    family, hf_cfg, _ = load_hf_config(args["path"])
    # the overrides are checked (TransformerConfig.__post_init__) before
    # the read too
    hf_cfg = dataclasses.replace(hf_cfg, **post)
    model_cfg, params = load_hf_model(
        args["path"], is_critic=args.get("is_critic", False),
        dtype=args.get("dtype"), device=device,
    )
    if post:
        model_cfg = dataclasses.replace(model_cfg, **post)
    if dtype != torch.float32:
        params = serving_params(params, model_cfg)
    return model_cfg, params, family.name


@dataclasses.dataclass
class TrainBackend(model_api.ModelBackend):
    """The train engine with its optimizer (reference: megatron.py:561).

    ``device`` is the engine's device (None = ``cuda``); the model worker
    sets it from its config."""

    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )
    pack_sequences: bool = True
    #: segment-packing row budget: rows of bucket_len(max(pack_capacity,
    #: the longest sequence)) tokens (0 = the longest sequence's bucket)
    pack_capacity: int = 0
    device: Optional[str] = None

    def _initialize(self, model, spec):
        model.engine = TrainEngine(
            model.model_cfg,
            model.mesh,
            model.init_params,
            optimizer_cfg=self.optimizer,
            total_train_steps=max(1, spec.total_train_steps),
            pack_sequences=self.pack_sequences,
            device=self.device,
            pack_capacity=self.pack_capacity,
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

    def _initialize(self, model, spec):
        model.engine = TrainEngine(
            model.model_cfg,
            model.mesh,
            model.init_params,
            optimizer_cfg=None,
            pack_sequences=self.pack_sequences,
            device=self.device,
            pack_capacity=self.pack_capacity,
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
