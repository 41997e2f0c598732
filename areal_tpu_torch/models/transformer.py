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
from areal_tpu_torch.models import quantize
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
    # one accessor for both formats: a {"w"} weight, or an int8 serving
    # weight {"qw", "scale"} dequantized at use (models/quantize.py); the
    # bias sits beside either
    out = y @ quantize.leaf_weight(p, y.dtype)
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
        logits = x @ quantize.leaf_weight(params["lm_head"], x.dtype)
    return logits.to(torch_dtype(cfg.logits_dtype))


# ---------------------------------------------------------------------------
# Training forward over packed [B, T] rows
# ---------------------------------------------------------------------------


def _attention_dispatch(q, k, v, cfg: TransformerConfig, seg_ids):
    """Self-attention of the training forward: the flash kernel's wrapper
    (the CUDA kernel on a card, its plain version on the CPU), with the
    model's sliding window if it has one.  The reference masks dense
    attention for a window instead (it never sends one to its kernel): the
    same function, which on a card would need a [B, T, T] mask."""
    from areal_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), seg_ids,
        window=cfg.sliding_window,
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
    ``cfg.remat`` each layer runs under ``cfg.remat_policy``
    (``models/remat.py``), which decides what its backward recomputes."""
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    layer = _layer
    if cfg.remat and torch.is_grad_enabled():
        from areal_tpu_torch.models.remat import policy_for

        layer = policy_for(cfg.remat_policy)
    for lp in params["layers"]:
        x = layer(cfg, x, lp, seg_ids, rope_cs)
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


def window_decode_attention(q, k, v, lengths, window: int):
    """One query per row at position ``lengths`` (its key and value
    already in slot ``lengths``), q ``[B, 1, Hq, hd]``, over the slots
    ``[max(0, p - window + 1), p]`` of k/v ``[B, Hkv, S, hd]``: each row's
    last ``window`` slots (rounded up to 128, at most S) gathered newest
    first (:func:`_window_gather`), so they are the prefix ``[0, min(p + 1,
    window))`` that :func:`flash_decode_attention` reads.  :func:`decode_step`'s
    attention on a card for a sliding-window model; the same function as
    :func:`cache_attention` under the reference's windowed mask."""
    G = min(-(-window // 128) * 128, k.shape[2])
    wk, wv = _window_gather(KVCache(k[None], v[None], lengths), lengths + 1, G)
    return flash_decode_attention(q, wk[0], wv[0],
                                  torch.clamp(lengths + 1, max=window))


def merge_window_partials(acc, m_main, l_main, qg, wk_l, wv_l, mask_win,
                          scale: float) -> torch.Tensor:
    """One decode query per row over its main cache and its chunk's window:
    the main cache's un-normalised partials ``acc [B,Hkv,r,hd]``, ``m``,
    ``l`` ``[B,Hkv,r]`` (from a kernel, or its plain version) merged online
    with the scores of ``qg [B,Hkv,r,hd]`` against the window keys ``wk_l``
    ``[W,B,Hkv,hd]`` under ``mask_win [B,1,1,W]``; float32 ``[B,Hkv,r,hd]``
    normalised attention."""
    s_win = torch.einsum("bkrd,wbkd->bkrw", qg.float(), wk_l.float()) * scale
    s_win = torch.where(mask_win, s_win, torch.full_like(s_win, -1e30))
    m_tot = torch.maximum(m_main, s_win.amax(dim=-1))
    p_win = torch.exp(s_win - m_tot[..., None])
    alpha = torch.exp(m_main - m_tot)
    num = acc * alpha[..., None] + torch.einsum(
        "bkrw,wbkd->bkrd", p_win, wv_l.float()
    )
    den = l_main * alpha + p_win.sum(dim=-1)
    return num / den.clamp_min(1e-30)[..., None]


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
    self-attention over the prompt, windowed for a sliding-window model,
    which the flash kernel computes (padding queries give 0 where the
    reference averages; their keys and values lie beyond each row's length
    and are never attended).  A non-empty cache is refused there."""
    B, T = tokens.shape
    S = cache.max_len
    x = _embed(params, cfg, tokens, positions)
    on_cpu = x.device.type == "cpu"
    if not on_cpu and not cache.empty:
        raise NotImplementedError(
            "prefill into a non-empty KV cache on a card: no caller sends "
            "one (the dense engine prefills an empty cache of its own and "
            "copies it into its rows)"
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
                q.contiguous(), k.contiguous(), v.contiguous(), seg32,
                window=cfg.sliding_window,
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
    partials, ``acc / l``, or raises.  A sliding-window model's query at
    position p reads slots ``[max(0, p - window + 1), p]``, which
    :func:`window_decode_attention` gathers for ``flash_decode``."""
    B = tokens.shape[0]
    S = cache.max_len
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    positions = cache.lengths[:, None].long()  # [B, 1]
    x = _embed(params, cfg, tokens[:, None].long(), positions)
    on_cpu = x.device.type == "cpu"
    win = cfg.sliding_window
    if on_cpu:
        kv_pos = torch.arange(S, device=x.device)[None, :]
        mask = kv_pos <= positions
        if win is not None:
            mask &= positions - kv_pos < win
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
        elif win is None:
            attn = flash_decode_attention(q, cache.k[l], cache.v[l], attended)
        else:
            attn = window_decode_attention(q, cache.k[l], cache.v[l],
                                           cache.lengths, win)
        x = x + _proj(lp["attn"]["o"], attn.reshape(B, 1, cfg.q_dim))
        h = _norm(x, lp["mlp_norm"], cfg)
        x = x + _mlp_block(cfg, lp, h)
    lengths = cache.lengths + active.to(torch.int32)
    return _head(params, cfg, x)[:, 0], KVCache(cache.k, cache.v, lengths)


def _window_gather(cache: KVCache, base_lens, G: int):
    """Each row's last ``G`` cache slots below its length, newest first:
    ``[L, B, Hkv, G, hd]`` k and v, buffer slot t holding cache slot
    ``base - 1 - t`` (clamped to 0 past the row's start; those slots lie
    beyond every read length).  Newest-first puts the slots a window
    query may read at the front, so each step's read is the prefix
    ``[0, attended)`` that ``flash_decode`` takes."""
    B = base_lens.shape[0]
    t = torch.arange(G, device=base_lens.device)
    idx = torch.clamp(base_lens.long()[:, None] - 1 - t[None, :], min=0)
    rows = torch.arange(B, device=base_lens.device)[:, None]

    def g(c):
        # c[:, rows, :, idx] is [B, G, L, Hkv, hd]
        return c[:, rows, :, idx].permute(2, 0, 3, 1, 4).contiguous()

    return g(cache.k), g(cache.v)


@torch.no_grad()
def decode_chunk(
    params: Params,
    cfg: TransformerConfig,
    cache: KVCache,
    cur_tokens: torch.Tensor,  # [B] int32 pending token (KV not cached yet)
    active: torch.Tensor,  # [B] bool
    budgets: torch.Tensor,  # [B] int32 remaining new tokens (incl. cur)
    chunk_size: int,
    sample_fn,  # (logits f32 [B,V], positions [B], row_seeds [B])
    stop_fn,  # tokens [B] -> [B] bool
    attn_len: Optional[int] = None,
    row_seeds: Optional[torch.Tensor] = None,  # [B] per-request sampler keys
):
    """Generate up to ``chunk_size`` tokens for every active row over the
    dense cache (the reference's ``decode_chunk``): in-chunk KV goes to a
    ``[L, W, B, Hkv, hd]`` window, each step's query attends the main
    cache's frozen prefix ``[0, base)`` and the window jointly, and the
    window merges into the cache slots once per chunk.

    The main cache's partials come from
    :func:`~areal_tpu_torch.ops.decode_attention.flash_decode` (the kernel
    on a card, its plain version on the CPU), merged online with the
    window's (:func:`merge_window_partials`).  ``attn_len`` is the engine's
    bound on every row's length through the chunk (the reference's
    bucketed prefix); the kernel walks only each row's valid keys, so it
    decides only the window-gather route below.

    A sliding-window model (``chunk_size <= sliding_window``, checked)
    reads each row's last ``Ww`` cache slots, gathered once per chunk
    newest first (:func:`_window_gather`; ``Ww`` the window rounded up to
    128 and capped at ``attn_len``): the slots a query at position p may
    read, ``[max(0, p - window + 1), base)``, are then the buffer's prefix
    ``[0, min(base, base + window - 1 - p))``, a length that falls by one
    each step, and ``flash_decode`` reads that prefix.

    Returns (cache, out_t [B,W], out_l [B,W], emitted [B,W], cur_tokens,
    active, budgets); the cache's tensors are written in place."""
    from areal_tpu_torch.models.paged import _scatter_slots_
    from areal_tpu_torch.ops.decode_attention import flash_decode

    win = cfg.sliding_window
    if win is not None and chunk_size > win:
        raise ValueError(
            "chunked decode requires chunk_size <= sliding_window "
            f"({chunk_size} > {win}); in-chunk KV must stay inside every "
            "query's attention window"
        )
    B = cur_tokens.shape[0]
    S = cache.max_len
    Sa = S if attn_len is None else min(attn_len, S)
    W = chunk_size
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    r = cfg.n_q_heads // Hkv
    dev = cur_tokens.device
    if row_seeds is None:
        row_seeds = torch.zeros_like(cur_tokens)
    base_lens = cache.lengths  # frozen: the main cache's valid prefix
    scale = 1.0 / math.sqrt(hd)
    if win is not None:
        Ww = -(-min(win, Sa) // 128) * 128
        attn_k, attn_v = _window_gather(cache, base_lens, min(Ww, Sa))
    else:
        attn_k, attn_v = cache.k, cache.v
    wk = torch.zeros((L, W, B, Hkv, hd), dtype=cache.k.dtype, device=dev)
    wv = torch.zeros_like(wk)
    wvalid = torch.zeros((W, B), dtype=torch.bool, device=dev)
    out_t = torch.zeros((B, W), dtype=torch.int32, device=dev)
    out_l = torch.zeros((B, W), dtype=torch.float32, device=dev)
    emitted = torch.zeros((B, W), dtype=torch.bool, device=dev)
    zero = torch.zeros_like(base_lens)
    lengths_, cur = base_lens, cur_tokens
    for i in range(W):
        positions = lengths_[:, None]
        x = _embed(params, cfg, cur[:, None].long(), positions)
        rope_cs = (
            None
            if cfg.abs_position_embedding
            else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
        )
        wvalid[i] = active
        mask_win = wvalid.T[:, None, None, :]  # [B, 1, 1, W]
        if win is None:
            read = base_lens
        else:
            read = torch.clamp(
                torch.minimum(base_lens, base_lens + (win - 1) - lengths_),
                min=0,
            )
        read = torch.where(active, read, zero).to(torch.int32).contiguous()
        for l, lp in enumerate(params["layers"]):
            h = _norm(x, lp["attn_norm"], cfg)
            q, k, v = _attn_qkv(cfg, lp, h, positions, rope_cs)
            wk[l, i] = k[:, 0].to(wk.dtype)
            wv[l, i] = v[:, 0].to(wv.dtype)
            acc, m_main, l_main = flash_decode(
                q[:, 0].contiguous(), attn_k[l], attn_v[l], read
            )
            attn = merge_window_partials(
                acc.reshape(B, Hkv, r, hd), m_main.reshape(B, Hkv, r),
                l_main.reshape(B, Hkv, r), q.reshape(B, Hkv, r, hd),
                wk[l], wv[l], mask_win, scale,
            ).to(x.dtype)
            x = x + _proj(lp["attn"]["o"], attn.reshape(B, 1, cfg.q_dim))
            h2 = _norm(x, lp["mlp_norm"], cfg)
            x = x + _mlp_block(cfg, lp, h2)
        logits = _head(params, cfg, x)[:, 0]
        tok, logp = sample_fn(logits.float(), lengths_ + 1, row_seeds)
        tok = torch.where(active, tok, torch.zeros_like(tok))
        out_t[:, i] = tok
        out_l[:, i] = torch.where(active, logp, torch.zeros_like(logp))
        emitted[:, i] = active
        step = active.to(torch.int32)
        lengths_ = lengths_ + step
        budgets = budgets - step
        active = active & ~stop_fn(tok) & (budgets > 0) & (lengths_ < S)
        cur = tok
    # merge the window into the rows' cache slots: one scatter per chunk
    # (the cache [L, B, Hkv, S, hd] read as a pool of B blocks of S slots)
    wvi = wvalid.to(torch.int32)
    offs = base_lens[None, :] + torch.cumsum(wvi, dim=0) - wvi  # [W, B]
    b_idx = torch.arange(B, device=dev)[None, :].expand(W, B)
    for c, w in ((cache.k, wk), (cache.v, wv)):
        _scatter_slots_(c, b_idx, offs, w.permute(1, 2, 0, 3, 4), wvalid)
    new_cache = KVCache(cache.k, cache.v, lengths_)
    return new_cache, out_t, out_l, emitted, cur, active, budgets
