"""Carry a reference param tree across to the port.

:func:`params_from_jax` takes the tree that
``areal_tpu.models.transformer.init_params`` (or an HF import) produces,
already turned into numpy arrays by the caller (``jax.device_get``), and
returns the port's parameters: the layer-stacked ``params["layers"]``
becomes a list of per-layer dictionaries, and every leaf keeps its own
dtype (float32 for the reference's master parameters, which is what the
trainer needs).  :func:`serving_params` turns such a tree into a copy in
the types the reference serves with (see :mod:`.transformer`).  This
module never imports JAX; only numpy arrays cross the boundary.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import Params, torch_dtype

#: leaf names the reference multiplies in float32 (norm scales/biases)
_F32_LEAVES = ("scale", "bias")


def serving_dtype(name: str, cfg: TransformerConfig) -> torch.dtype:
    """The storage dtype of leaf ``name`` for serving."""
    return torch.float32 if name in _F32_LEAVES else torch_dtype(cfg.dtype)


def serving_params(tree, cfg: TransformerConfig, device=None, name: str = ""):
    """A copy of a parameter tree (e.g. the trainer's float32 master
    weights) in the serving storage types, on ``device`` (default: where
    each leaf is).  Every leaf is copied, also one already in its serving
    type and place: the trainer updates its weights in place, and a served
    version must not change under the engine."""
    if isinstance(tree, dict):
        return {k: serving_params(v, cfg, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [serving_params(v, cfg, device, name) for v in tree]
    return tree.detach().to(device=device, dtype=serving_dtype(name, cfg),
                             copy=True)


def _leaf(arr, device) -> torch.Tensor:
    dt = torch_dtype(str(np.asarray(arr).dtype))
    # a float32 copy: bf16 arrays arrive as ml_dtypes scalars torch cannot
    # take, and device_get results are read-only
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    return t.to(device=device, dtype=dt)


def _convert(tree: Dict[str, Any], device) -> Params:
    return {
        k: _convert(v, device) if isinstance(v, dict) else _leaf(v, device)
        for k, v in tree.items()
    }


def _unstack(tree: Dict[str, Any], layer: int) -> Dict[str, Any]:
    return {
        k: (_unstack(v, layer) if isinstance(v, dict) else np.asarray(v)[layer])
        for k, v in tree.items()
    }


def params_from_jax(
    np_tree: Dict[str, Any],
    cfg: TransformerConfig,
    device: DeviceLike = None,
) -> Params:
    """The port's parameters from a reference param tree of numpy arrays
    (layer-stacked ``layers`` leaves ``[L, ...]``), on ``device`` (default
    ``cuda``), each leaf in its own dtype; for serving, pass the result
    through :func:`serving_params`."""
    device = resolve_device(device)
    if "value_head" in np_tree:
        raise NotImplementedError("critic (value-head) models are not ported")
    out: Params = {
        k: _convert(v, device)
        for k, v in np_tree.items()
        if k != "layers"
    }
    out["layers"] = [
        _convert(_unstack(np_tree["layers"], l), device)
        for l in range(cfg.n_layers)
    ]
    return out
