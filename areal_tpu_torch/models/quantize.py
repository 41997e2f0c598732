"""int8 serving-weight quantization, per-output-channel absmax (port of
``areal_tpu/models/quantize.py``).

Every matmul weight (attention q/k/v/o, the MLP's gate/up/down, an untied
``lm_head``) is stored as an ``int8`` tensor plus one float32 symmetric
absmax scale per output channel (the weight's last axis: a ``[D, F]``
weight carries an ``[F]`` scale).  Norms, biases and embeddings stay at
the model dtype.  In the tree a quantized leaf replaces its ``w`` entry
with ``qw`` (int8) and ``scale`` (float32) beside any bias, so the tree
flattens to the same "/"-joined key paths the snapshot manifest speaks.

The trainer publishes this tree next to every full-precision snapshot
(``engine/checkpoint.py save_quantized_params``), and an engine built with
``serving_weight_dtype="int8"`` serves from it: every projection reads its
weight through :func:`leaf_weight`, which dequantizes ``qw * scale`` at
use in float32 and casts to the activation dtype, so the product itself is
the full-precision path's and the only error is storage rounding.  The
reference computes the same dequantize-then-matmul outside any Pallas
kernel; on a card it is one elementwise pass and one ``torch.matmul`` per
projection and step (a fused int8-weight GEMM is later work, ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

#: storage bits per quantized weight element (the metrics gauge)
STORAGE_BITS = 8

#: projection names whose "w" leaves quantize
_PROJ_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


def quantizable(keys: Tuple[str, ...]) -> bool:
    """True iff the leaf at key path ``keys`` is a matmul weight the int8
    serving format quantizes.  Everything else (norms, biases,
    embeddings, the critic value head) stays at the model dtype."""
    if (
        len(keys) >= 3
        and keys[-1] == "w"
        and keys[-2] in _PROJ_NAMES
        and ("attn" in keys or "mlp" in keys)
    ):
        return True
    if keys == ("lm_head", "w"):
        return True
    # MoE expert stacks are bare [L, E, D, F] leaves named gate/up/down
    if len(keys) >= 2 and keys[-2] == "experts" and keys[-1] in _PROJ_NAMES:
        return True
    return False


@torch.no_grad()
def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(qw int8, scale f32)`` with one symmetric absmax scale per output
    channel: the scale's shape is ``w.shape`` without the input axis
    (``-2``).  An all-zero channel gets a tiny scale, so the divide is
    finite and dequantizes back to exact zeros."""
    w32 = w.detach().to(torch.float32)
    absmax = torch.amax(torch.abs(w32), dim=-2)
    # a true division on every device: a CUDA tensor divided by a Python
    # number is multiplied by its reciprocal, which can round otherwise
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(
        torch.round(w32 / scale.unsqueeze(-2)), -127, 127
    ).to(torch.int8)
    return q, scale


def dequant_weight(qw: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``qw * scale`` at use: the product in float32 (the scale's dtype),
    cast to the activation ``dtype`` after, as the reference does."""
    return (qw.to(torch.float32) * scale.to(torch.float32).unsqueeze(-2)).to(
        dtype
    )


def is_quant_leaf(p) -> bool:
    """True for a quantized projection dict (``qw``/``scale``)."""
    return isinstance(p, dict) and "qw" in p


def leaf_weight(p, dtype) -> torch.Tensor:
    """The weight of a projection leaf in the compute ``dtype``, whether the
    leaf is a tensor, a ``{"w": ...}`` dict or a quantized ``{"qw",
    "scale"}`` dict: the one accessor through which every forward serves
    both formats."""
    if isinstance(p, dict):
        if "qw" in p:
            return dequant_weight(p["qw"], p["scale"], dtype)
        p = p["w"]
    return p.to(dtype)


def _transform(tree, quant_fn, other_fn, prefix=()):
    """Structure-preserving walk that rewrites quantizable weights: a
    ``{"w": ...}`` projection's weight entry is replaced in its parent dict
    by what ``quant_fn`` returns (so ``qw``/``scale`` sit next to a bias);
    bare expert-stack leaves are replaced in place.  Lists (the port's
    per-layer list) keep their indices as keys."""
    if isinstance(tree, (list, tuple)):
        return [
            _transform(v, quant_fn, other_fn, prefix + (str(i),))
            for i, v in enumerate(tree)
        ]
    out = {}
    for k, v in tree.items():
        kp = prefix + (str(k),)
        if isinstance(v, (dict, list, tuple)):
            out[k] = _transform(v, quant_fn, other_fn, kp)
        elif quantizable(kp):
            rep = quant_fn(kp, v)
            if k == "w":
                out.update(rep)
            else:
                out[k] = rep
        else:
            out[k] = other_fn(kp, v)
    return out


def quantize_param_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The int8 serving tree of a full-precision parameter tree:
    quantizable weights become ``qw``/``scale`` pairs, everything else is
    the original leaf (the same tensor, no copy)."""

    def quant(keys, leaf):
        qw, scale = quantize_weight(leaf)
        return {"qw": qw, "scale": scale}

    return _transform(params, quant, lambda keys, leaf: leaf)


def quant_tree_struct(params: Dict[str, Any]) -> Dict[str, Any]:
    """The int8 serving tree's layout as tensors on the ``meta`` device
    (shape and dtype, no data), from a tree of full-precision tensors."""

    def quant(keys, leaf):
        shape = tuple(leaf.shape)
        return {
            "qw": torch.empty(shape, dtype=torch.int8, device="meta"),
            "scale": torch.empty(
                shape[:-2] + shape[-1:], dtype=torch.float32, device="meta"
            ),
        }

    def other(keys, leaf):
        return torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")

    return _transform(params, quant, other)


def is_quantized_tree(params) -> bool:
    """True iff the tree holds at least one quantized projection."""
    if isinstance(params, (list, tuple)):
        return any(is_quantized_tree(v) for v in params)
    if not isinstance(params, dict):
        return False
    return "qw" in params or any(is_quantized_tree(v) for v in params.values())


def quantized_leaf_count(params) -> int:
    """Number of projections stored as ``qw``/``scale`` in the tree (0 for
    a full-precision tree)."""
    if isinstance(params, (list, tuple)):
        return sum(quantized_leaf_count(v) for v in params)
    if not isinstance(params, dict):
        return 0
    if "qw" in params:
        return 1
    return sum(quantized_leaf_count(v) for v in params.values())


def tree_bytes(params) -> int:
    """Total leaf bytes of a parameter tree."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return int(params.numel() * params.element_size())
