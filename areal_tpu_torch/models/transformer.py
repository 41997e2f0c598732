"""Transformer building blocks of the serving forward (port of the pieces
of ``areal_tpu/models/transformer.py`` that the paged forwards use).

Parameters are plain dictionaries of tensors, laid out like the
reference's param tree except that the per-layer parameters are a Python
list of per-layer dictionaries (``params["layers"][l]``) instead of
arrays stacked along a leading layer axis: the forwards loop over layers
in Python where the reference scans.  Matrices keep the reference's
``[in, out]`` orientation, so ``y @ w`` is the same product on both
sides.

Storage types follow what the reference computes with: matrices, biases
and embeddings are stored in the model dtype (the reference casts them to
the activation dtype at use), norm scales stay float32 (the reference
multiplies in float32).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.models.config import TransformerConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
    }[name]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(
    cfg: TransformerConfig, seed: int, device: DeviceLike = None
) -> Params:
    """Random parameters from ``seed``, with the reference's init scheme
    (``init_params`` there: uniform in +-1/sqrt(fan_in), zero biases, unit
    norm scales).  The draws are torch's, not JAX's; to compute the same
    function as a JAX model, convert its tree with
    :func:`areal_tpu_torch.models.convert.params_from_jax`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = torch_dtype(cfg.dtype)
    D, Fd, V = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    Hq, Hkv, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape):
        bound = 1.0 / math.sqrt(shape[0])
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.uniform_(-bound, bound, generator=gen)
        return w.to(dt)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def norm(n):
        p = {"scale": torch.ones((n,), dtype=torch.float32, device=device)}
        if cfg.norm_type == "layer":
            p["bias"] = torch.zeros((n,), dtype=torch.float32, device=device)
        return p

    layers: List[Params] = []
    for _ in range(cfg.n_layers):
        attn: Params = {
            "q": {"w": dense((D, Hq * hd))},
            "k": {"w": dense((D, Hkv * hd))},
            "v": {"w": dense((D, Hkv * hd))},
            "o": {"w": dense((Hq * hd, D))},
        }
        if cfg.use_attention_bias:
            attn["q"]["b"] = zeros(Hq * hd)
            attn["k"]["b"] = zeros(Hkv * hd)
            attn["v"]["b"] = zeros(Hkv * hd)
        if cfg.use_qk_norm:
            attn["q_norm"] = {"scale": torch.ones(hd, device=device)}
            attn["k_norm"] = {"scale": torch.ones(hd, device=device)}
        mlp: Params = {"gate": {"w": dense((D, Fd))}, "down": {"w": dense((Fd, D))}}
        if cfg.gated_mlp:
            mlp["up"] = {"w": dense((D, Fd))}
        if cfg.use_mlp_bias:
            mlp["gate"]["b"] = zeros(Fd)
            if cfg.gated_mlp:
                mlp["up"]["b"] = zeros(Fd)
            mlp["down"]["b"] = zeros(D)
        layers.append(
            {"attn_norm": norm(D), "attn": attn, "mlp_norm": norm(D), "mlp": mlp}
        )
    params: Params = {
        "embed": {"weight": dense((V, D))},
        "layers": layers,
        "final_norm": norm(D),
    }
    if cfg.abs_position_embedding:
        params["pos_embed"] = {
            "weight": dense((cfg.max_position_embeddings, D))
        }
    if not cfg.tied_embedding:
        params["lm_head"] = {"w": dense((D, V))}
    return params


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "rms":
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.norm_eps)
        out = x * p["scale"].float()
    else:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        out = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(dt)


def _head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    # per-head RMSNorm over head_dim (qwen3)
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_tables(
    positions: torch.Tensor, base: float, head_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, T, 1, hd/2] float32, computed once per forward and
    shared by every layer."""
    half = head_dim // 2
    freqs = 1.0 / (
        base
        ** (
            torch.arange(0, half, dtype=torch.float32, device=positions.device)
            / half
        )
    )
    angles = positions[..., None].float() * freqs  # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary embedding with precomputed tables. x: [B, T, H, hd]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _proj(p: Params, y: torch.Tensor) -> torch.Tensor:
    out = y @ p["w"].to(y.dtype)
    if "b" in p:
        out = out + p["b"].to(y.dtype)
    return out


def _attn_qkv(
    cfg: TransformerConfig,
    lp: Params,
    h: torch.Tensor,
    positions: torch.Tensor,
    rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]],
):
    """q/k/v head math: projection + qk-norm + rope.  Returns q
    [B, T, Hq, hd], k and v [B, T, Hkv, hd]."""
    B, T, _ = h.shape
    q = _proj(lp["attn"]["q"], h).reshape(B, T, cfg.n_q_heads, cfg.head_dim)
    k = _proj(lp["attn"]["k"], h).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(lp["attn"]["v"], h).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = _head_norm(q, lp["attn"]["q_norm"]["scale"], cfg.norm_eps)
        k = _head_norm(k, lp["attn"]["k_norm"]["scale"], cfg.norm_eps)
    if not cfg.abs_position_embedding:
        if rope_cs is None:
            rope_cs = rope_tables(positions, cfg.rotary_base, cfg.head_dim)
        q = rope_apply(q, *rope_cs)
        k = rope_apply(k, *rope_cs)
    return q, k, v


def _mlp_block(cfg: TransformerConfig, lp: Params, h: torch.Tensor):
    """Dense MLP block (the post-attention half of every layer)."""
    gate = _activation(_proj(lp["mlp"]["gate"], h), cfg.activation)
    if cfg.gated_mlp:
        gate = gate * _proj(lp["mlp"]["up"], h)
    return _proj(lp["mlp"]["down"], gate)


def _embed(params: Params, cfg: TransformerConfig, tokens, positions):
    x = params["embed"]["weight"].to(torch_dtype(cfg.dtype))[tokens]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    if cfg.abs_position_embedding:
        x = x + params["pos_embed"]["weight"].to(x.dtype)[positions]
    return x


def _head(params: Params, cfg: TransformerConfig, x: torch.Tensor):
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tied_embedding:
        # x @ embed.T without materializing the transpose
        logits = F.linear(x, params["embed"]["weight"].to(x.dtype))
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    return logits.to(torch_dtype(cfg.logits_dtype))
