"""Model factory (the ``make_model`` part of ``areal_tpu/engine/backend.py``).

The train/inference backends that wrap a model bundle into a
``TrainEngine`` are not ported yet (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

from typing import Optional

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelAbstraction, ModelName
from areal_tpu_torch.base.device import DeviceLike
from areal_tpu_torch.engine.inference_server import _not_ported
from areal_tpu_torch.models.config import TransformerConfig, tiny_config


def make_model(
    cfg: ModelAbstraction,
    name: Optional[ModelName],
    mesh=None,
    tokenizer=None,
    device: DeviceLike = None,
) -> model_api.Model:
    """An uninitialised model bundle: ``model_cfg`` and ``init_params``
    set, no engine.

    Abstraction types:

    - ``random``: args ``{config: dict | TransformerConfig, seed?}``, or
      ``tiny_config`` keyword arguments: parameters drawn from ``seed``
      (default 0) by :func:`areal_tpu_torch.models.transformer.init_params`
      in the model dtype on ``device`` (default ``cuda``).  The draws are
      torch's, not JAX's: the same seed gives other weights than the JAX
      package's factory.
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
    model.init_params = init_params(model_cfg, seed, device)
    return model
