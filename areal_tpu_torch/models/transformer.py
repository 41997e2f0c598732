"""Transformer forwards (port of ``areal_tpu/models/transformer.py``): the
building blocks the paged serving forwards use, and the training forward
over packed ``[B, T]`` rows (:func:`forward`, :func:`hidden_states`,
:func:`logprobs_of_labels`), whose attention goes through
:func:`areal_tpu_torch.ops.flash_attention.flash_attention`, and the
dense KV cache of sync PPO's generation (:class:`KVCache`,
:func:`prefill`, :func:`decode_step`), whose decode attention on a card
goes through :func:`areal_tpu_torch.ops.decode_attention.flash_decode`.

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

import dataclasses
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
    if cfg.is_critic:
        params["value_head"] = {"w": dense((D, 1))}
    elif not cfg.tied_embedding:
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
    """Logits ``[..., V]``, or a critic's values ``[...]``, in
    ``cfg.logits_dtype``."""
    x = _norm(x, params["final_norm"], cfg)
    if cfg.is_critic:
        values = x @ params["value_head"]["w"].to(x.dtype)
        return values[..., 0].to(torch_dtype(cfg.logits_dtype))
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
    builds it only for a sliding-window model on the CPU, the flash kernel
    applies the rule without a window by index)."""
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


def _attention_dispatch(q, k, v, cfg: TransformerConfig, seg_ids, mask):
    """Self-attention of the training forward: the flash kernel's wrapper
    (the CUDA kernel on a card, its plain version on the CPU), or, for a
    sliding-window model on the CPU, masked dense attention under ``mask``
    (the reference's semantics: it never sends a window to its flash
    kernel)."""
    from areal_tpu_torch.ops.flash_attention import flash_attention

    if cfg.sliding_window is not None:
        return reference_attention(q, k, v, mask)
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), seg_ids
    )


def _layer(cfg: TransformerConfig, x, lp: Params, seg_ids, rope_cs, mask):
    """One transformer block of the training forward (no KV cache)."""
    B, T, _ = x.shape
    h = _norm(x, lp["attn_norm"], cfg)
    q, k, v = _attn_qkv(cfg, lp, h, None, rope_cs)
    attn = _attention_dispatch(q, k, v, cfg, seg_ids, mask)
    x = x + _proj(lp["attn"]["o"], attn.reshape(B, T, cfg.q_dim))
    h = _norm(x, lp["mlp_norm"], cfg)
    return x + _mlp_block(cfg, lp, h)


def _run_layers(params: Params, cfg: TransformerConfig, x, positions, seg_ids):
    """The layers in order (the reference's ``lax.scan``); with
    ``cfg.remat`` each layer runs under ``cfg.remat_policy``
    (``models/remat.py``), which decides what its backward recomputes."""
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    mask = None
    if cfg.sliding_window is not None:
        if x.is_cuda:
            # the dense [B, T, T] path would stand in for the kernel
            raise NotImplementedError(
                f"sliding_window {cfg.sliding_window} on a card: the flash "
                "kernel has no window (ROADMAP.md section 2, 'window in the "
                "flash kernel's index mask')"
            )
        mask = make_attention_mask(
            seg_ids, positions, seg_ids, positions, cfg.sliding_window
        )
    layer = _layer
    if cfg.remat and torch.is_grad_enabled():
        from areal_tpu_torch.models.remat import policy_for

        layer = policy_for(cfg.remat_policy)
    for lp in params["layers"]:
        x = layer(cfg, x, lp, seg_ids, rope_cs, mask)
    return x


def forward(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int (within-segment positions)
    seg_ids: torch.Tensor,  # [B, T] int32, 0 = padding
) -> torch.Tensor:
    """Full forward over a packed padded batch: logits [B, T, V] (values
    [B, T] for a critic)."""
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


# ---------------------------------------------------------------------------
# Dense KV cache: prefill and step decode (sync PPO's generation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Decode-time KV cache, stacked over layers (the reference's
    ``KVCache``).

    ``k``/``v`` ``[L, B, Hkv, S, hd]`` are head-major, so ``k[l]`` is the
    ``[B, Hkv, S, hd]`` layout :func:`~areal_tpu_torch.ops.decode_attention.flash_decode`
    reads; ``lengths`` ``[B]`` int32 are the rows' lengths (the next
    token's slot).  :func:`prefill` and :func:`decode_step` write the
    tensors in place and return a cache over the same tensors.  ``empty``
    is a host-side flag, True only for a cache from :meth:`zeros` that
    nothing has written yet: a card prefills only such a cache, whose
    attention is then plain causal self-attention over the prompt."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    empty: bool = False

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, max_len: int,
              device: DeviceLike = None):
        """An empty cache in the model dtype."""
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        dt = torch_dtype(cfg.dtype)
        return cls(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            empty=True,
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def cache_attention(q, k, v, mask):
    """Attention over a KV cache in its head-major layout, GQA-grouped (the
    reference's ``cache_attention``): q ``[B,T,Hq,hd]``, k/v
    ``[B,Hkv,S,hd]``, mask ``[B,T,S]`` -> ``[B,T,Hq,hd]``; scores and
    softmax in float32, the probabilities cast to v's dtype for the
    product.  The plain path of :func:`prefill` and :func:`decode_step`
    on the CPU."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    scores = torch.einsum(
        "btkrd,bksd->bkrts", qg.float(), k.to(qg.dtype).float()
    ) / math.sqrt(hd)
    scores = torch.where(
        mask[:, None, None], scores, torch.full_like(scores, -1e30)
    )
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrts,bksd->btkrd", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, hd)


def _refuse_window_on_card(cfg: TransformerConfig, x: torch.Tensor, what):
    if cfg.sliding_window is not None and x.device.type != "cpu":
        raise NotImplementedError(
            f"{what} with sliding_window {cfg.sliding_window} on a card: "
            "the flash kernels have no window (ROADMAP.md section 2, "
            "'window in the flash kernel's index mask')"
        )


def _write_cache_rows(cache_l: torch.Tensor, new: torch.Tensor, start):
    """Write ``new`` ``[B, T, Hkv, hd]`` into ``cache_l`` ``[B, Hkv, S, hd]``
    at each row's slots ``start[b] + [0, T)``, the start clamped so the
    slots fit (``lax.dynamic_update_slice``'s rule)."""
    B, T = new.shape[:2]
    S = cache_l.shape[2]
    start = torch.clamp(start.long(), max=S - T)
    slots = start[:, None] + torch.arange(T, device=new.device)  # [B, T]
    rows = torch.arange(B, device=new.device)[:, None]
    # cache_l[rows, :, slots] has the advanced dims first: [B, T, Hkv, hd]
    cache_l[rows, :, slots] = new.to(cache_l.dtype)


def flash_decode_attention(q, k, v, attended):
    """One query per row, q ``[B, 1, Hq, hd]``, over each row's cache slots
    ``[0, attended)`` of k/v ``[B, Hkv, S, hd]`` through
    :func:`~areal_tpu_torch.ops.decode_attention.flash_decode` (the kernel
    off the CPU, its plain version on it), its partials normalised:
    ``[B, 1, Hq, hd]`` in q's dtype.  :func:`decode_step`'s attention on a
    card; the same function as :func:`cache_attention` under the mask
    ``slot < attended``."""
    from areal_tpu_torch.ops.decode_attention import flash_decode

    acc, _, lsum = flash_decode(q[:, 0].contiguous(), k, v, attended)
    return (acc / lsum[..., None]).to(q.dtype)[:, None]


def prefill(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] absolute positions
    seg_ids: torch.Tensor,  # [B, T] 1 real, 0 right padding
    cache: KVCache,
    last_pos: Optional[torch.Tensor] = None,  # [B] each row's last token
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompts through the model, writing their keys and values at
    each row's ``lengths``; returns ``(logits [B, T, V], cache)``, or
    ``[B, 1, V]`` logits of each row's ``last_pos`` when it is given (full
    logits at a 152k vocabulary are gigabytes nobody reads).

    Slot s holds the token at absolute position s; a real query at
    position p attends slots ``<= p`` (the reference's mask).  On the CPU
    that is the plain :func:`cache_attention`.  Off the CPU only an empty
    cache (:meth:`KVCache.zeros`) is prefilled, and its attention is causal
    self-attention over the prompt, which the flash kernel computes
    (padding queries give 0 where the reference averages; their keys and
    values lie beyond each row's length and are never attended).  A
    non-empty cache and a sliding window are refused there."""
    B, T = tokens.shape
    S = cache.max_len
    x = _embed(params, cfg, tokens, positions)
    on_cpu = x.device.type == "cpu"
    _refuse_window_on_card(cfg, x, "prefill")
    if not on_cpu and not cache.empty:
        raise NotImplementedError(
            "prefill into a non-empty KV cache on a card: only the dense "
            "generation server sends one, and it is not ported (ROADMAP.md "
            "queue 1, item 8)"
        )
    mask = None
    if on_cpu:
        kv_pos = torch.arange(S, device=x.device)[None, None, :]
        mask = (kv_pos <= positions[:, :, None]) & (seg_ids != 0)[:, :, None]
        if cfg.sliding_window is not None:
            mask &= positions[:, :, None] - kv_pos < cfg.sliding_window
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    seg32 = seg_ids.to(torch.int32)
    for l, lp in enumerate(params["layers"]):
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _attn_qkv(cfg, lp, h, positions, rope_cs)
        _write_cache_rows(cache.k[l], k, cache.lengths)
        _write_cache_rows(cache.v[l], v, cache.lengths)
        if on_cpu:
            attn = cache_attention(q, cache.k[l], cache.v[l], mask)
        else:
            from areal_tpu_torch.ops.flash_attention import flash_attention

            attn = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), seg32
            )
        x = x + _proj(lp["attn"]["o"], attn.reshape(B, T, cfg.q_dim))
        h = _norm(x, lp["mlp_norm"], cfg)
        x = x + _mlp_block(cfg, lp, h)
    lengths = cache.lengths + (seg_ids != 0).sum(dim=1).to(torch.int32)
    if last_pos is not None:
        idx = last_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return _head(params, cfg, x), KVCache(cache.k, cache.v, lengths)


def decode_step(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B] the next token of each row
    cache: KVCache,
    active: Optional[torch.Tensor] = None,  # [B] bool
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every row: each token's keys and values go to
    slot ``lengths`` and its query attends slots ``[0, lengths]``; returns
    ``(logits [B, V], cache)``, the lengths of ``active`` rows advanced
    (an inactive row's write lies beyond its length and is overwritten by
    its next one).

    On the CPU the attention is the plain :func:`cache_attention`; off the
    CPU it launches ``flash_decode`` (the hand-written kernel) on the
    layer's cache ``[B, Hkv, S, hd]`` with lengths + 1 and normalises its
    partials, ``acc / l``, or raises; a sliding window is refused there."""
    B = tokens.shape[0]
    S = cache.max_len
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    positions = cache.lengths[:, None].long()  # [B, 1]
    x = _embed(params, cfg, tokens[:, None].long(), positions)
    on_cpu = x.device.type == "cpu"
    _refuse_window_on_card(cfg, x, "decode_step")
    if on_cpu:
        kv_pos = torch.arange(S, device=x.device)[None, :]
        mask = kv_pos <= positions
        if cfg.sliding_window is not None:
            mask &= positions - kv_pos < cfg.sliding_window
        mask = mask[:, None, :]  # [B, 1, S]
    else:
        attended = cache.lengths + 1
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    rows = torch.arange(B, device=x.device)
    slot = cache.lengths.long()
    for l, lp in enumerate(params["layers"]):
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _attn_qkv(cfg, lp, h, positions, rope_cs)
        # cache.k[l][rows, :, slot] is [B, Hkv, hd]
        cache.k[l][rows, :, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[l][rows, :, slot] = v[:, 0].to(cache.v.dtype)
        if on_cpu:
            attn = cache_attention(q, cache.k[l], cache.v[l], mask)
        else:
            attn = flash_decode_attention(q, cache.k[l], cache.v[l], attended)
        x = x + _proj(lp["attn"]["o"], attn.reshape(B, 1, cfg.q_dim))
        h = _norm(x, lp["mlp_norm"], cfg)
        x = x + _mlp_block(cfg, lp, h)
    lengths = cache.lengths + active.to(torch.int32)
    return _head(params, cfg, x)[:, 0], KVCache(cache.k, cache.v, lengths)
