"""Paged-KV forward paths: chunked prefill and chunked decode over a block
pool (port of ``areal_tpu/models/paged.py``).

* The KV pool is ``[L, NB, Hkv, BS, hd]`` (page-major: one page is one
  contiguous extent); NB fixed-size blocks shared by all rows, a row's
  cache being the ordered block list in its table row ``[MB]``.
* :func:`paged_fill_chunk` runs one chunk of prompt prefill for a batch of
  filling rows: in-chunk causal self-attention merged online with the
  paged kernel's partials over each row's already-cached prefix.
* :func:`paged_decode_chunk` generates ``chunk_size`` tokens for every
  active row, keeping in-chunk KV in a small contiguous window and
  merging the window into the pool once per chunk; ``deep_kernel`` runs
  its prefix attention through the deep paged kernel.

**int8 KV storage** (``kv_cache_dtype="int8"``): the pools hold int8 and
float32 scale pools ``[L, NB, Hkv, BS]`` sit beside them, one absmax
scale per (block, head, slot), so a write quantizes just the values it
scatters.  Writes quantize at the scatter (:func:`quantize_kv`); reads
dequantize right after the gather (both kernels and their plain version
multiply by the scales before the attention dots), so the error is
storage rounding only.  The functions below take optional
``k_scale``/``v_scale`` (None for fp pools) and update them in place with
the pools.

Unlike the reference, whose functions take the pools as donated jit
arguments and return new ones, these functions update the pools IN PLACE
(PyTorch tensors are mutable; this saves a pool-sized copy per call).
The reference's layer ``scan`` is a Python loop over
``params["layers"]``, and each layer's prefix attention passes the
layer's pool slice ``k_pool[l]`` (a view, no copy) to the kernel.
:func:`copy_blocks` copies whole blocks inside the pool (the prefix
cache's and a sampling group's copy-on-write tails), scales included.
:func:`gather_blocks_host` and :func:`restore_blocks_from_host` move
whole blocks (scales included) between the pool and host memory for the
prefix cache's host tier: pinned buffers and asynchronous copies on a
card.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    Params,
    _attn_qkv,
    _embed,
    _head,
    _mlp_block,
    _norm,
    _proj,
    merge_window_partials,
    rope_tables,
    torch_dtype,
)
from areal_tpu_torch.ops.paged_attention import (
    paged_flash_attention,
    paged_flash_attention_deep,
)

_NEG_INF = -1e30


#: int8 symmetric absmax range (-128 is never produced, so quantize and
#: dequantize are symmetric)
KV_QUANT_MAX = 127.0

def alloc_kv_pool(
    cfg: TransformerConfig,
    n_blocks: int,
    block_size: int,
    device,
    kv_cache_dtype: str = "auto",
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Allocate the paged KV storage ``(k_pool, v_pool, k_scale,
    v_scale)``, page-major ``[L, NB, Hkv, BS, hd]`` (scales ``[L, NB, Hkv,
    BS]``).  ``"auto"`` keeps model-dtype pools (scales None);
    ``"int8"`` allocates int8 pools plus float32 scale pools ``[L, NB,
    Hkv, BS]``, so a cached token-head costs ``2 * (hd + 4)`` bytes instead
    of ``2 * hd * itemsize``."""
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    if kv_cache_dtype == "auto":
        dtype = dtype or torch_dtype(cfg.dtype)
        return (
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            None,
            None,
        )
    if kv_cache_dtype != "int8":
        raise ValueError(
            f"kv_cache_dtype must be 'auto' or 'int8', got {kv_cache_dtype!r}"
        )
    return (
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    )


def kv_pool_layout_bytes(
    cfg: TransformerConfig,
    n_blocks: int,
    block_size: int,
    kv_cache_dtype: str = "auto",
    dtype=None,
) -> Tuple[int, int]:
    """``(pool_bytes, scale_bytes)`` that :func:`alloc_kv_pool` with the
    same arguments allocates, by arithmetic alone; ``scale_bytes`` is 0
    for fp pools."""
    n = cfg.n_layers * n_blocks * cfg.n_kv_heads * block_size * cfg.head_dim
    if kv_cache_dtype == "int8":
        # k + v int8 data, k + v float32 scale pools [L, NB, Hkv, BS]
        return 2 * n, 2 * (n // cfg.head_dim) * 4
    itemsize = (dtype or torch_dtype(cfg.dtype)).itemsize
    return 2 * n * itemsize, 0


@torch.no_grad()
def copy_blocks(
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], updated in place
    v_pool: torch.Tensor,
    src: torch.Tensor,  # [n] pool block ids to copy from
    dst: torch.Tensor,  # [n] distinct pool block ids to copy into
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
):
    """Copy whole blocks ``[:, src] -> [:, dst]`` over every layer: a
    sampling group's tail block (its members' generated tokens diverge
    inside it) and a prefix-cache tail match (the donor may still append
    to it) are copied, not shared.  An int8 pool copies the scale slices
    with the bytes, so a copied tail carries its donor's exact
    quantization.  Plain indexed copies, as the reference's."""
    for pool in (k_pool, v_pool, k_scale, v_scale):
        if pool is not None:
            pool[:, dst] = pool[:, src]


def _pool_parts(k_pool, v_pool, k_scale=None, v_scale=None):
    """The pool's storage tensors: ``(k, v)``, with the scale pools after
    them for an int8 pool."""
    return (k_pool, v_pool) if k_scale is None else (
        k_pool, v_pool, k_scale, v_scale
    )


@torch.no_grad()
def gather_blocks_host(
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd]
    v_pool: torch.Tensor,
    blocks: Sequence[int],
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Copy whole pool blocks to host memory in one batch: host tensors
    indexed ``[i] -> blocks[i]``, ``(k [n, L, Hkv, BS, hd], v)`` for an fp
    pool and ``(k, v, k_scale [n, L, Hkv, BS], v_scale)`` for an int8 pool,
    whose bytes and scales travel together so a round trip through
    :func:`restore_blocks_from_host` is bit-identical.  On a card the
    gather lands in pinned buffers by asynchronous copies, which this
    waits for (the caller reads the bytes at once).  The reference pads
    the batch to a power of two to reuse compiled shapes; nothing here
    compiles, so it does not."""
    parts = _pool_parts(k_pool, v_pool, k_scale, v_scale)
    dev = k_pool.device
    idx = torch.as_tensor(list(blocks), dtype=torch.long)
    if dev.type != "cuda":
        return tuple(p[:, idx].transpose(0, 1).contiguous() for p in parts)
    idx = idx.pin_memory().to(dev, non_blocking=True)
    out = []
    for p in parts:
        g = p[:, idx].transpose(0, 1)
        host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
        host.copy_(g, non_blocking=True)
        out.append(host)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return tuple(out)


def restore_blocks_from_host(
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], written in place
    v_pool: torch.Tensor,
    payloads: Sequence[Tuple[torch.Tensor, ...]],
    dst: Sequence[int],
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Scatter per-block host payloads (one tuple per destination block, as
    :func:`gather_blocks_host` produced them) into pool blocks ``dst`` in
    one batch: on a card one asynchronous host-to-device copy per
    component from pinned memory and one indexed write, both enqueued on
    the current stream, so the restore runs under the work already queued
    and whatever reads the pool later is ordered after it."""
    if len(payloads) != len(dst) or not payloads:
        raise ValueError(
            f"{len(payloads)} payloads for {len(dst)} destination blocks"
        )
    stacked = tuple(
        torch.stack([p[c] for p in payloads], dim=0)
        for c in range(len(payloads[0]))
    )
    _restore_stacked(
        _pool_parts(k_pool, v_pool, k_scale, v_scale), stacked, dst
    )


@torch.no_grad()
def _restore_stacked(parts, components, dst):
    """The restore's tail (the reference's ``_restore_padded``): each
    stacked host component, indexed ``[i] -> dst[i]``, goes to the pool's
    device (pinned, non-blocking, on the current stream) and into its
    pool tensor at blocks ``dst``."""
    if len(components) != len(parts):
        raise ValueError(
            f"{len(components)} payload components for a pool of "
            f"{len(parts)} tensors"
        )
    dev = parts[0].device
    idx = torch.as_tensor(list(dst), dtype=torch.long)
    cuda = dev.type == "cuda"
    if cuda:
        idx = idx.pin_memory().to(dev, non_blocking=True)
    for pool, c in zip(parts, components):
        if c.dtype != pool.dtype or tuple(c.shape[1:]) != (
            pool.shape[:1] + pool.shape[2:]
        ):
            raise ValueError(
                f"payload {c.dtype} {tuple(c.shape)} does not fit pool "
                f"{pool.dtype} {tuple(pool.shape)}"
            )
        src = c.pin_memory().to(dev, non_blocking=True) if cuda else c
        pool[:, idx] = src.transpose(0, 1)


def quantize_kv(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization over the trailing head_dim axis:
    ``(int8 values, float32 scales)``, the scales shaped like ``vals``
    without its last axis.  Bit-identical to the reference: a true
    division by ``max(scale, 1e-30)`` and rounding half to even.  An
    all-zero vector quantizes to zeros with scale 0.  A subnormal scale
    is flushed to 0, as XLA does on the reference's devices (its int8
    values are 0 either way)."""
    v32 = vals.float()
    scale = v32.abs().amax(dim=-1) / KV_QUANT_MAX
    scale = torch.where(
        scale >= torch.finfo(torch.float32).tiny, scale, torch.zeros_like(scale)
    )
    q = v32 / scale.clamp_min(1e-30)[..., None]
    q = torch.round(q).clamp(-KV_QUANT_MAX, KV_QUANT_MAX).to(torch.int8)
    return q, scale


def _prefix_partials(q, k_pool, v_pool, tables, lengths, layer: int,
                     deep: bool = False, k_scale=None, v_scale=None,
                     verify: bool = False):
    """Paged-attention partials over each row's cached prefix of layer
    ``layer``, through the deep kernel when ``deep``.  ``q`` is [B, Q, Hq,
    hd]; int8 pools pass their scale pools; ``verify`` marks a speculative
    verify window's call (counted apart by the kernel's wrapper).  Returns
    (acc, m, l)."""
    scales = () if k_scale is None else (k_scale[layer], v_scale[layer])
    args = (q.contiguous(), k_pool[layer], v_pool[layer], tables, lengths,
            *scales)
    if deep:
        return paged_flash_attention_deep(*args)
    return paged_flash_attention(*args, verify=verify)


def _scatter_slots_(pool, pid, off, vals, valid, slot_axis: int = -2):
    """``pool[..., pid, :, off, ...] = vals`` over the ``[NB, Hkv, BS]``
    axes of ``pool`` (the slot axis at ``slot_axis``: -2 for a KV pool
    ``[.., NB, Hkv, BS, hd]``, -1 for a scale pool ``[.., NB, Hkv, BS]``),
    for the entries where ``valid``; the others are dropped (the reference
    scatters them out of range with ``mode="drop"``, which torch has no
    counterpart of).

    The mask is applied without reading it on the host, so a CUDA caller
    does not synchronise: every invalid entry is pointed at the first
    valid entry's slot with that entry's value (a duplicate write of the
    same bytes), or, when no entry is valid, at its own slot with the
    value already there (a no-op write)."""
    lead = (slice(None),) * (pool.dim() + slot_axis - 2)
    n = pid.numel()
    vals = vals.reshape(n, *vals.shape[pid.dim():])
    pid, off, valid = pid.reshape(n), off.reshape(n), valid.reshape(n)
    # first valid entry (entry 0 if none), kept as a 1-element index
    j = torch.argmax(valid.to(torch.int32)).reshape(1)
    pid_j, off_j = pid[j], off[j]
    fill = torch.where(
        valid.any(), vals[j], pool[lead + (pid_j, slice(None), off_j)]
    )
    vmask = valid.reshape(n, *([1] * (vals.dim() - 1)))
    pool[lead + (
        torch.where(valid, pid, pid_j).long(),
        slice(None),
        torch.where(valid, off, off_j).long(),
    )] = torch.where(vmask, vals, fill)


def _store_kv_(k_pool, v_pool, k_scale, v_scale, pid, off, k, v, valid):
    """Scatter KV values ``k``/``v`` (entries ``pid``/``off``, each with
    trailing ``[.., Hkv, hd]``) into the pools where ``valid``; an int8
    pool stores them quantized and their scales through the same
    coordinates."""
    if k_scale is None:
        _scatter_slots_(k_pool, pid, off, k.to(k_pool.dtype), valid)
        _scatter_slots_(v_pool, pid, off, v.to(v_pool.dtype), valid)
        return
    for pool, scales, vals in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
        qv, sc = quantize_kv(vals)
        _scatter_slots_(pool, pid, off, qv, valid)
        _scatter_slots_(scales, pid, off, sc, valid, slot_axis=-1)


def paged_window_forward(
    params: Params,
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], updated in place
    v_pool: torch.Tensor,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [F, C] window tokens (right-padded)
    starts: torch.Tensor,  # [F] int32 tokens already cached per row
    valid: torch.Tensor,  # [F, C] bool: positions to compute + scatter
    tables: torch.Tensor,  # [F, MB] int32 pool block ids
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,  # [F, C] bool, default ``valid``
    verify: bool = False,
) -> torch.Tensor:
    """Forward a token window for F rows over their cached paged prefixes:
    in-window causal self-attention merged online with the paged
    kernel's partials over ``[0, start)``; the window KV is scattered into
    the rows' pool blocks at the positions of ``store`` (a subset of
    ``valid``; the others are computed but dropped).  On an int8 pool
    the window KV is computed in model dtype and quantized at the
    scatter.  ``verify`` marks a speculative verify window
    (``engine/spec_decode.py``), whose kernel launches the wrapper also
    counts on ``verify_launches``.  Returns the final hidden states
    ``x [F, C, D]`` (pre-head)."""
    F, C = tokens.shape
    L, NB, Hkv, BS, hd = k_pool.shape
    r = cfg.n_q_heads // Hkv
    dev = tokens.device
    iot = torch.arange(C, dtype=torch.int32, device=dev)
    positions = starts[:, None] + iot[None, :]
    # masked rows stream zero prefix blocks
    read_lens = torch.where(valid[:, 0], starts, torch.zeros_like(starts))
    x = _embed(params, cfg, tokens, positions)
    rope_cs = (
        None
        if cfg.abs_position_embedding
        else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
    )
    mask_chunk = (
        valid[:, None, :] & valid[:, :, None] & (iot[:, None] >= iot[None, :])
    )  # [F, Cq, Ckv] causal
    pid_log = torch.clamp(positions // BS, 0, tables.shape[1] - 1)
    pid = torch.gather(tables, 1, pid_log.long())
    off = positions % BS
    scale = 1.0 / math.sqrt(hd)
    for l, lp in enumerate(params["layers"]):
        h = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _attn_qkv(cfg, lp, h, positions, rope_cs)
        acc_p, m_p, l_p = _prefix_partials(
            q, k_pool, v_pool, tables, read_lens, l,
            k_scale=k_scale, v_scale=v_scale, verify=verify,
        )
        qg = q.reshape(F, C, Hkv, r, hd)
        s_c = torch.einsum("fikrd,fjkd->fkrij", qg.float(), k.float()) * scale
        s_c = torch.where(
            mask_chunk[:, None, None, :, :], s_c, torch.full_like(s_c, _NEG_INF)
        )  # [F, Hkv, r, Cq, Ckv]
        accp = acc_p.reshape(F, C, Hkv, r, hd).permute(0, 2, 3, 1, 4)
        mp = m_p.reshape(F, C, Hkv, r).permute(0, 2, 3, 1)
        lpp = l_p.reshape(F, C, Hkv, r).permute(0, 2, 3, 1)
        # online merge of prefix partials with the in-chunk scores
        m_tot = torch.maximum(mp, s_c.amax(dim=-1))
        p_c = torch.exp(s_c - m_tot[..., None])
        alpha = torch.exp(mp - m_tot)
        num = accp * alpha[..., None] + torch.einsum(
            "fkrij,fjkd->fkrid", p_c, v.float()
        )
        den = lpp * alpha + p_c.sum(dim=-1)
        attn = (num / den.clamp_min(1e-30)[..., None]).to(x.dtype)
        attn = attn.permute(0, 3, 1, 2, 4).reshape(F, C, cfg.n_q_heads * hd)
        x = x + _proj(lp["attn"]["o"], attn)
        h2 = _norm(x, lp["mlp_norm"], cfg)
        x = x + _mlp_block(cfg, lp, h2)
        # the chunk's KV lands in the pool after this layer's prefix read
        _store_kv_(
            k_pool[l], v_pool[l],
            None if k_scale is None else k_scale[l],
            None if v_scale is None else v_scale[l],
            pid, off, k, v, valid if store is None else store,
        )
    return x


@torch.no_grad()
def paged_fill_chunk(
    params: Params,
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], updated in place
    v_pool: torch.Tensor,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [F, C] this chunk's tokens (right-padded)
    starts: torch.Tensor,  # [F] int32 tokens already cached per row
    chunk_lens: torch.Tensor,  # [F] int32 valid tokens in this chunk
    tables: torch.Tensor,  # [F, MB] int32 pool block ids
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,  # [F, C] bool
) -> torch.Tensor:
    """One prefill chunk for F filling rows: each row's chunk tokens attend
    causally within the chunk and over the row's cached prefix
    ``[0, start)``; the chunk KV is scattered into the rows' pool blocks
    (the engine allocated blocks covering ``start + chunk_len``); an int8
    pool quantizes at the scatter and lands the scales beside it.
    ``store`` (default: every valid position) drops the scatter of the
    other positions: rows that share a block write each of its slots from
    one row only, since which of several writes of one slot lands is
    unspecified on CUDA.  Returns the logits ``[F, V]`` at each row's
    last valid chunk position."""
    F, C = tokens.shape
    valid = (
        torch.arange(C, device=tokens.device)[None, :] < chunk_lens[:, None]
    )
    x = paged_window_forward(
        params, k_pool, v_pool, cfg, tokens, starts, valid, tables,
        k_scale, v_scale, store,
    )
    last_idx = torch.clamp(chunk_lens - 1, min=0).long()
    x_last = x[torch.arange(F, device=x.device), last_idx][:, None]
    return _head(params, cfg, x_last)[:, 0]


SampleFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[torch.Tensor, torch.Tensor],
]


@torch.no_grad()
def paged_decode_chunk(
    params: Params,
    k_pool: torch.Tensor,  # [L, NB, Hkv, BS, hd], updated in place
    v_pool: torch.Tensor,
    cfg: TransformerConfig,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32 valid cache prefix per row
    cur_tokens: torch.Tensor,  # [B] int32 pending token (KV not cached yet)
    active: torch.Tensor,  # [B] bool
    budgets: torch.Tensor,  # [B] int32 remaining new tokens (incl. cur)
    chunk_size: int,
    sample_fn: SampleFn,  # (logits f32 [B,V], positions [B], row_seeds [B])
    stop_fn: Callable[[torch.Tensor], torch.Tensor],  # tokens -> [B] bool
    max_len: int,
    row_seeds: torch.Tensor,  # [B] per-request sampler keys
    deep_kernel: bool = False,
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Hkv, BS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
):
    """Generate up to ``chunk_size`` tokens for all active rows on the
    device, over the paged pool.

    In-chunk KV goes to a ``[L, W, B, Hkv, hd]`` window, always in model
    dtype (so in-chunk attention pays no quantization error on an int8
    pool); prefix attention streams each row's valid blocks through the
    paged kernel, or the deep paged kernel when ``deep_kernel`` (rows
    inactive at the chunk's start read zero blocks); the window merges
    into the pool blocks once per chunk through the block tables,
    quantized there on an int8 pool.  The engine guarantees that every
    active row's table covers ``length + chunk_size`` slots.  Nothing here
    reads a device value on the host.

    Returns (lengths, out_t [B,W], out_l [B,W], emitted [B,W], cur_tokens,
    active, budgets)."""
    if cfg.sliding_window is not None:
        raise ValueError("paged decode serves global-attention models")
    B = cur_tokens.shape[0]
    W = chunk_size
    L, NB, Hkv, BS, hd = k_pool.shape
    r = cfg.n_q_heads // Hkv
    dev = cur_tokens.device
    base_lens = lengths  # frozen: pool-resident prefix per row
    read_lens = torch.where(active, base_lens, torch.zeros_like(base_lens))
    scale = 1.0 / math.sqrt(hd)
    win_dtype = torch_dtype(cfg.dtype) if k_scale is not None else k_pool.dtype
    wk = torch.zeros((L, W, B, Hkv, hd), dtype=win_dtype, device=dev)
    wv = torch.zeros_like(wk)
    wvalid = torch.zeros((W, B), dtype=torch.bool, device=dev)
    out_t = torch.zeros((B, W), dtype=torch.int32, device=dev)
    out_l = torch.zeros((B, W), dtype=torch.float32, device=dev)
    emitted = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lengths_, cur = base_lens, cur_tokens
    for i in range(W):
        positions = lengths_[:, None]
        x = _embed(params, cfg, cur[:, None], positions)
        rope_cs = (
            None
            if cfg.abs_position_embedding
            else rope_tables(positions, cfg.rotary_base, cfg.head_dim)
        )
        wvalid[i] = active
        mask_win = wvalid.T[:, None, None, :]  # [B, 1, 1, W]
        for l, lp in enumerate(params["layers"]):
            h = _norm(x, lp["attn_norm"], cfg)
            q, k, v = _attn_qkv(cfg, lp, h, positions, rope_cs)
            wk[l, i] = k[:, 0]
            wv[l, i] = v[:, 0]
            acc, m_main, l_main = _prefix_partials(
                q, k_pool, v_pool, tables, read_lens, l, deep=deep_kernel,
                k_scale=k_scale, v_scale=v_scale,
            )
            attn = merge_window_partials(
                acc.reshape(B, Hkv, r, hd), m_main.reshape(B, Hkv, r),
                l_main.reshape(B, Hkv, r), q.reshape(B, Hkv, r, hd),
                wk[l], wv[l], mask_win, scale,
            ).to(x.dtype)
            attn = attn.reshape(B, 1, cfg.n_q_heads * hd)
            x = x + _proj(lp["attn"]["o"], attn)
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
        active = active & ~stop_fn(tok) & (budgets > 0) & (lengths_ < max_len)
        cur = tok

    # merge the window into pool blocks: one scatter per chunk
    wvi = wvalid.to(torch.int32)
    offs = base_lens[None, :] + torch.cumsum(wvi, dim=0) - wvi  # [W, B]
    pid_log = torch.clamp(offs // BS, 0, tables.shape[1] - 1).long()
    b_idx = torch.arange(B, device=dev)[None, :].expand(W, B)
    pid = tables[b_idx, pid_log]  # [W, B]
    off = offs % BS
    # window [L, W, B, Hkv, hd] -> per entry [W, B, L, Hkv, hd]
    _store_kv_(
        k_pool, v_pool, k_scale, v_scale, pid, off,
        wk.permute(1, 2, 0, 3, 4), wv.permute(1, 2, 0, 3, 4), wvalid,
    )
    return lengths_, out_t, out_l, emitted, cur, active, budgets
