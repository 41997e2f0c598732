"""Transformer forwards (port of ``areal_tpu/models/transformer.py``): the
building blocks the paged serving forwards use, and the training forward
over packed ``[B, T]`` rows (:func:`forward`, :func:`hidden_states`,
:func:`logprobs_of_labels`), whose attention goes through
:func:`areal_tpu_torch.ops.flash_attention.flash_attention`.

Parameters are plain dictionaries of tensors, laid out like the
reference's param tree except that the per-layer parameters are a Python
list of per-layer dictionaries (``params["layers"][l]``) instead of
arrays stacked along a leading layer axis: the forwards loop over layers
in Python where the reference scans.  Matrices keep the reference's
``[in, out]`` orientation, so ``y @ w`` is the same product on both
sides.

Storage types: for serving, matrices, biases and embeddings are stored
in the model dtype (the reference casts them to the activation dtype at
use) and norm scales stay float32 (the reference multiplies in float32).
For training every leaf is float32, as the reference keeps its master
parameters (``init_params(..., dtype=torch.float32)`` or
``params_from_jax`` of a reference tree); the forwards cast each matrix to
the activation dtype at use, so gradients reach the float32 leaves.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    cfg: TransformerConfig,
    seed: int,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random parameters from ``seed``, with the reference's init scheme
    (``init_params`` there: uniform in +-1/sqrt(fan_in), zero biases, unit
    norm scales).  Matrices, biases and embeddings are stored in ``dtype``
    (default: the model dtype, for serving; ``torch.float32`` for the
    trainer's master weights); the draws are made in float32 either way, so
    the two storages hold the same weights up to the cast.  The draws are
    torch's, not JAX's; to compute the same function as a JAX model,
    convert its tree with
    :func:`areal_tpu_torch.models.convert.params_from_jax`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = dtype or torch_dtype(cfg.dtype)
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


# ---------------------------------------------------------------------------
# Training forward over packed [B, T] rows
# ---------------------------------------------------------------------------


def make_attention_mask(
    seg_q: torch.Tensor,
    pos_q: torch.Tensor,
    seg_kv: torch.Tensor,
    pos_kv: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """[B, Tq, Tkv] bool mask: same segment, causal by position, non-pad;
    optional sliding window (the reference's mask; the training forward
    never builds it, the flash kernel applies the same rule by index)."""
    same = seg_q[:, :, None] == seg_kv[:, None, :]
    causal = pos_q[:, :, None] >= pos_kv[:, None, :]
    valid = (seg_q[:, :, None] != 0) & (seg_kv[:, None, :] != 0)
    mask = same & causal & valid
    if sliding_window is not None:
        mask &= pos_q[:, :, None] - pos_kv[:, None, :] < sliding_window
    return mask


def reference_attention(q, k, v, mask, logits_dtype=torch.float32):
    """Attention under an explicit mask: q [B,T,Hq,hd], k/v [B,S,Hkv,hd],
    mask [B,T,S] (the reference's ``reference_attention``: masked rows
    average V uniformly)."""
    B, T, Hq, hd = q.shape
    rep = Hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum(
        "bthd,bshd->bhts", q.to(logits_dtype), k.to(logits_dtype)
    ) / math.sqrt(hd)
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def _attention_dispatch(q, k, v, cfg: TransformerConfig, seg_ids):
    """Self-attention of the training forward: always the flash kernel's
    wrapper (the CUDA kernel on a card, its plain version on the CPU)."""
    from areal_tpu_torch.ops.flash_attention import flash_attention

    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported to the training forward"
        )
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), seg_ids
    )


def _layer(cfg: TransformerConfig, x, lp: Params, seg_ids, rope_cs):
    """One transformer block of the training forward (no KV cache)."""
    B, T, _ = x.shape
    h = _norm(x, lp["attn_norm"], cfg)
    q, k, v = _attn_qkv(cfg, lp, h, None, rope_cs)
    attn = _attention_dispatch(q, k, v, cfg, seg_ids)
    x = x + _proj(lp["attn"]["o"], attn.reshape(B, T, cfg.q_dim))
    h = _norm(x, lp["mlp_norm"], cfg)
    return x + _mlp_block(cfg, lp, h)


def _run_layers(params: Params, cfg: TransformerConfig, x, positions, seg_ids):
    """The layers in order (the reference's ``lax.scan``); with
    ``cfg.remat`` each layer is checkpointed, so the backward recomputes
    it (the reference's default ``jax.checkpoint`` policy)."""
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(
                _layer, cfg, x, lp, seg_ids, rope_cs, use_reentrant=False
            )
        else:
            x = _layer(cfg, x, lp, seg_ids, rope_cs)
    return x


def forward(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int (within-segment positions)
    seg_ids: torch.Tensor,  # [B, T] int32, 0 = padding
) -> torch.Tensor:
    """Full forward over a packed padded batch: logits [B, T, V]."""
    x = _embed(params, cfg, tokens, positions)
    x = _run_layers(params, cfg, x, positions, seg_ids)
    return _head(params, cfg, x)


def hidden_states(
    params: Params, cfg: TransformerConfig, tokens, positions, seg_ids
) -> torch.Tensor:
    """Final-norm hidden states [B, T, D] (pre-head), for chunked losses."""
    x = _embed(params, cfg, tokens, positions)
    x = _run_layers(params, cfg, x, positions, seg_ids)
    return _norm(x, params["final_norm"], cfg)


def head_weight(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    """[D, V] output head weight (tied or untied), in its storage dtype."""
    if cfg.tied_embedding:
        return params["embed"]["weight"].T
    return params["lm_head"]["w"]


def logprobs_of_labels(
    params: Params, cfg: TransformerConfig, tokens, positions, seg_ids,
    chunk: int = 1024,
) -> torch.Tensor:
    """log p(tokens[t+1] | tokens[<=t]) [B, T-1], the head computed in
    chunks of ``chunk`` tokens so full-vocab logits never materialize."""
    x = hidden_states(params, cfg, tokens, positions, seg_ids)
    w = head_weight(params, cfg).to(x.dtype)
    labels = tokens[:, 1:].long()
    hs = x[:, :-1]
    out = []
    for c0 in range(0, hs.shape[1], chunk):
        logits = (hs[:, c0 : c0 + chunk] @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, c0 : c0 + chunk, None]
        out.append(torch.gather(logits, -1, lab)[..., 0] - lse)
    return torch.cat(out, dim=1)
