"""Rematerialisation policies of the training forward (port of
``areal_tpu/models/remat.py``'s policy table and :func:`policy_for`).

The reference names tensors inside a layer (``q_proj``/``k_proj``/
``v_proj``, ``attn_out``, ``mlp_out``) and hands ``jax.checkpoint`` a
policy that saves some of them.  Here a layer runs as explicit segments
whose boundaries are those tensors, and a policy decides which segments
are checkpointed (recomputed in the backward) and which boundaries are
kept:

  name         kept per layer                        recomputed in the backward
  ----------   -----------------------------------   ---------------------------
  none         the layer input                       the whole layer
  attn_out     + attn_out                            the attention block (the
                                                     flash forward included) and
                                                     the MLP half, separately
  mlp          + attn_out and the MLP block's input  each block, never across
                                                     one (the same bytes as the
                                                     reference's attn_out +
                                                     mlp_out: their sum is the
                                                     next layer's input)
  qkv_attn     + q, k, v, attn_out and the flash     norm, projections and rope
               kernel's logsumexp                    of q/k/v; the MLP half; no
                                                     flash forward
  offload_qkv  as qkv_attn, with q, k, v, attn_out   as qkv_attn, plus the copies
               and the logsumexp in pinned host      back to the card
               memory
  dots         + every matmul output (the q/k/v,     everything else: norms,
               o, gate, up and down projections')    rope, the attention (the
                                                     flash forward included),
                                                     the MLP's activation

The attention itself is always the flash kernel's autograd function
(``ops/flash_attention.py``): a policy only decides whether that function
runs inside a checkpointed segment (then the backward runs its forward
again) or outside one (then it keeps its own output and logsumexp).
``torch.utils.checkpoint``'s selective policies see aten operators only,
not a kernel launched through ctypes, so none decides about the flash
kernel's output.  ``dots`` alone is one: it keeps the matrix products
(``aten.mm``), and the flash forward, not one of them, runs again in the
backward, as under the reference's ``dots_with_no_batch_dims_saveable``.

The reference's ``compile_train_step`` / ``memory_summary`` (XLA's
ahead-of-time memory analysis of one step) have no torch counterpart;
a step's ``torch.cuda.max_memory_allocated`` measures the same thing on
the card (ROADMAP.md, the benchmark's list).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

#: the policies, ordered roughly by device-activation footprint (smallest
#: first), as in the reference's table
POLICY_NAMES: Tuple[str, ...] = (
    "none", "offload_qkv", "attn_out", "mlp", "qkv_attn", "dots",
)


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _OffloadSaved(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks that move every CUDA tensor saved in their
    scope to pinned host memory (one copy per storage) and back at its
    use in the backward; ``keep`` stays on the card.  CPU tensors pass
    through.  The copy out runs on a side stream, after the work that
    made the tensor, so the rest of the layer's forward goes on meanwhile;
    the host waits for the copies when the scope ends, since until then
    the allocator holds their sources, and the copy back waits for them
    too."""

    def __init__(self, keep):
        keep_ptrs = {t.data_ptr() for t in keep}
        # the source stays referenced while the scope lasts, so no tensor
        # saved later in it can take its address
        cache: Dict[tuple, tuple] = {}

        def pack(t):
            if not t.is_cuda or t.data_ptr() in keep_ptrs:
                return t
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in cache:
                side = _side_stream(t.device)
                src = t.reshape(-1)
                side.wait_stream(torch.cuda.current_stream(t.device))
                host = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
                with torch.cuda.stream(side):
                    host.copy_(src, non_blocking=True)
                # the allocator must not hand src's memory out before
                # the copy has read it
                src.record_stream(side)
                done = torch.cuda.Event()
                done.record(side)
                cache[key] = (src, host, done)
            _, host, done = cache[key]
            return t.device, host, done, t.shape

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            device, host, done, shape = packed
            torch.cuda.current_stream(device).wait_event(done)
            return host.to(device, non_blocking=True).view(shape)

        super().__init__(pack, unpack)
        self._copies = cache

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for _, _, done in self._copies.values():
            done.synchronize()
        # autograd keeps the pack hook, so its cache, until the backward
        # frees what was saved: without this the sources stay on the card
        self._copies.clear()


def _tf():
    # late import: the transformer imports this module
    from areal_tpu_torch.models import transformer

    return transformer


# -- the layer's segments ------------------------------------------------------


def _qkv(cfg, lp, rope_cs, x):
    """norm, projections, qk-norm and rope: q, k, v."""
    tf = _tf()
    h = tf._norm(x, lp["attn_norm"], cfg)
    return tf._attn_qkv(cfg, lp, h, None, rope_cs)


def _attn(cfg, seg_ids, q, k, v):
    """The attention (the flash kernel's autograd function): attn_out."""
    B, T = q.shape[:2]
    out = _tf()._attention_dispatch(q, k, v, cfg, seg_ids)
    return out.reshape(B, T, cfg.q_dim)


def _attn_block(cfg, lp, seg_ids, rope_cs, x):
    return _attn(cfg, seg_ids, *_qkv(cfg, lp, rope_cs, x))


def _o_proj(lp, x, attn_out):
    """The output projection and residual: the MLP block's input."""
    return x + _tf()._proj(lp["attn"]["o"], attn_out)


def _mlp(cfg, lp, x2):
    tf = _tf()
    return tf._mlp_block(cfg, lp, tf._norm(x2, lp["mlp_norm"], cfg))


def _post(cfg, lp, x, attn_out):
    x2 = _o_proj(lp, x, attn_out)
    return x2 + _mlp(cfg, lp, x2)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


# -- the policies ----------------------------------------------------------------


def _layer_none(cfg, x, lp, seg_ids, rope_cs):
    return _ckpt(functools.partial(_tf()._layer, cfg), x, lp, seg_ids, rope_cs)


def _layer_attn_out(cfg, x, lp, seg_ids, rope_cs):
    a = _ckpt(functools.partial(_attn_block, cfg, lp, seg_ids, rope_cs), x)
    return _ckpt(functools.partial(_post, cfg, lp), x, a)


def _layer_mlp(cfg, x, lp, seg_ids, rope_cs):
    a = _ckpt(functools.partial(_attn_block, cfg, lp, seg_ids, rope_cs), x)
    x2 = _ckpt(functools.partial(_o_proj, lp), x, a)
    return x2 + _ckpt(functools.partial(_mlp, cfg, lp), x2)


def _layer_qkv_attn(cfg, x, lp, seg_ids, rope_cs):
    q, k, v = _ckpt(functools.partial(_qkv, cfg, lp, rope_cs), x)
    a = _attn(cfg, seg_ids, q, k, v)
    return _ckpt(functools.partial(_post, cfg, lp), x, a)


def _layer_offload_qkv(cfg, x, lp, seg_ids, rope_cs):
    q, k, v = _ckpt(functools.partial(_qkv, cfg, lp, rope_cs), x)
    with _OffloadSaved(keep=(x, seg_ids)):
        a = _attn(cfg, seg_ids, q, k, v)
        # the reentrant form saves its inputs through the hooks (the other
        # form would hold attn_out on the card for its recompute)
        return checkpoint(functools.partial(_post, cfg, lp), x, a,
                          use_reentrant=True)


#: the products that ``dots`` keeps: a matrix product without batch
#: dimensions, as the reference's ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_dots(cfg, x, lp, seg_ids, rope_cs):
    # a selective checkpoint sees aten operators only: the flash kernel,
    # launched through ctypes, is not one, so it runs again in the
    # backward as the reference's does (neither policy saves attention)
    return checkpoint(
        functools.partial(_tf()._layer, cfg), x, lp, seg_ids, rope_cs,
        use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))


_LAYERS: Dict[str, Callable] = {
    "none": _layer_none,
    "offload_qkv": _layer_offload_qkv,
    "attn_out": _layer_attn_out,
    "mlp": _layer_mlp,
    "qkv_attn": _layer_qkv_attn,
    "dots": _layer_dots,
}
assert tuple(_LAYERS) == POLICY_NAMES


def policy_for(name: str) -> Callable:
    """The layer function of a policy: ``(cfg, x, lp, seg_ids, rope_cs)
    -> y``."""
    try:
        return _LAYERS[name]
    except KeyError:
        raise ValueError(
            f"unknown remat_policy {name!r} (valid: {POLICY_NAMES})"
        ) from None
