"""Carry a reference param tree across to the port.

:func:`params_from_jax` takes the tree that
``areal_tpu.models.transformer.init_params`` (or an HF import) produces,
already turned into numpy arrays by the caller (``jax.device_get``), and
returns the port's parameters: the layer-stacked ``params["layers"]``
becomes a list of per-layer dictionaries, and each leaf is stored in the
type the reference computes with (see :mod:`.transformer`).  This module
never imports JAX; only numpy arrays cross the boundary.
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


def _leaf(name: str, arr, cfg: TransformerConfig, device) -> torch.Tensor:
    # a float32 copy: bf16 arrays arrive as ml_dtypes scalars torch cannot
    # take, and device_get results are read-only
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    dt = torch.float32 if name in _F32_LEAVES else torch_dtype(cfg.dtype)
    return t.to(device=device, dtype=dt)


def _convert(tree: Dict[str, Any], cfg, device) -> Params:
    return {
        k: (
            _convert(v, cfg, device)
            if isinstance(v, dict)
            else _leaf(k, v, cfg, device)
        )
        for k, v in tree.items()
    }


def _unstack(tree: Dict[str, Any], layer: int) -> Dict[str, Any]:
    return {
        k: (_unstack(v, layer) if isinstance(v, dict) else np.asarray(v)[layer])
        for k, v in tree.items()
    }


def params_from_jax(
    np_tree: Dict[str, Any], cfg: TransformerConfig, device: DeviceLike = None
) -> Params:
    """The port's parameters from a reference param tree of numpy arrays
    (layer-stacked ``layers`` leaves ``[L, ...]``), on ``device`` (default
    ``cuda``)."""
    device = resolve_device(device)
    if "value_head" in np_tree:
        raise NotImplementedError("critic (value-head) models are not ported")
    out: Params = {
        k: _convert(v, cfg, device)
        for k, v in np_tree.items()
        if k != "layers"
    }
    out["layers"] = [
        _convert(_unstack(np_tree["layers"], l), cfg, device)
        for l in range(cfg.n_layers)
    ]
    return out
