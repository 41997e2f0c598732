"""Causal, segment-masked flash attention over packed rows (port of
``areal_tpu/ops/flash_attention.py``).

:func:`flash_attention` ``(q [B,T,Hq,hd], k/v [B,T,Hkv,hd], seg_ids [B,T]
int32) -> [B,T,Hq,hd]``: query i attends key j iff ``seg[i] == seg[j] !=
0`` and ``j <= i`` (causal by index within the row, which equals the
reference's position-causal mask on the layouts ``pad_batch`` and
``pack_batch`` build: contiguous segments whose positions rise from 0),
with scale ``1/sqrt(hd)``.  A padding query (seg 0) gets output 0 and
zero gradients; the reference's ``reference_attention`` averages V
uniformly there instead, which no loss ever reads.

On CUDA tensors it launches the hand-written Hopper kernels
(``csrc/flash_attention.cu``: forward, ``dq`` and ``dk/dv`` backward,
replacing the Pallas TPU kernel that ``areal_tpu/ops/flash_attention.py:36``
calls), as a ``torch.autograd.Function`` that saves ``q, k, v, out, lse``,
or raises; it never falls back.  The backward writes each query head's
dk/dv to float32 workspaces ``[B, T, Hq, hd]`` (allocated here) and sums
each KV head's group of them in a fixed order, so it is bit-for-bit
repeatable.  On CPU tensors it runs the plain
version, :func:`reference_flash_attention` (mask plus softmax in float32),
with autograd through it.  What bounds the kernels on an H100 and what
their design does about it is written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from areal_tpu_torch.ops import _build

#: head dims the kernels are built for
HEAD_DIMS = (64, 128)
#: token granularity of the kernel's segment-range workspace
_RANGE_TILE = 32
#: the backward's kernels, as bits of the C entry's ``parts`` (a backward
#: call runs them all; one bit runs that kernel alone, for timing)
BWD_PARTS = {"D": 1, "dq": 2, "dkdv": 4, "reduce": 8}
_BWD_ALL = 15


def attention_mask(seg_ids: torch.Tensor) -> torch.Tensor:
    """[B, T, T] bool: query i attends key j (same nonzero segment, j <= i)."""
    T = seg_ids.shape[1]
    idx = torch.arange(T, device=seg_ids.device)
    same = (seg_ids[:, :, None] == seg_ids[:, None, :]) & (
        seg_ids[:, :, None] != 0
    )
    return same & (idx[:, None] >= idx[None, :])


def reference_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_ids: torch.Tensor,
    return_lse: bool = False,
):
    """Plain PyTorch version of :func:`flash_attention` (same contract),
    computed in float32 and returned in q's dtype; with ``return_lse`` also
    the logsumexp ``[B, Hq, T]`` float32 (``+inf`` on padding queries)."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    r = Hq // Hkv
    mask = attention_mask(seg_ids)[:, None, None]  # [B, 1, 1, T, T]
    qg = q.float().reshape(B, T, Hkv, r, hd)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k.float()) / math.sqrt(hd)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1) * mask  # padding queries: all zero
    out = torch.einsum("bgrts,bsgd->btgrd", p, v.float())
    out = out.reshape(B, T, Hq, hd).to(q.dtype)
    if not return_lse:
        return out
    real = mask.any(dim=-1)
    lse = torch.where(
        real, torch.logsumexp(s, dim=-1), torch.full_like(s[..., 0], math.inf)
    )
    return out, lse.reshape(B, Hq, T)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library's C entry points (built at the first call)."""
    cdll = _build.load_library("flash_attention").cdll
    fwd = cdll.flash_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = cdll.flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    err = cdll.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, bwd, err


def _check(q, k, v, seg_ids):
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention's kernels run on CUDA tensors; got a "
            f"{q.device.type} tensor (only CPU tensors take the plain version)"
        )
    for name, t in (("k", k), ("v", v), ("seg_ids", seg_ids)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B,T,Hq,hd] and k, v [B,T,Hkv,hd]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, T, Hq, hd = q.shape
    if k.shape[:2] != (B, T) or k.shape[3] != hd or Hq % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (kernels build {HEAD_DIMS})")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernels take "
            "bfloat16"
        )
    if seg_ids.dtype != torch.int32 or tuple(seg_ids.shape) != (B, T):
        raise ValueError(
            f"seg_ids must be int32 [B={B}, T={T}]; got {seg_ids.dtype} "
            f"{tuple(seg_ids.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("seg_ids", seg_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"flash_attention {what} kernel launch failed: "
            f"{_kernels()[2](rc).decode()}"
        )


def _launch_fwd(q, k, v, seg_ids):
    _check(q, k, v, seg_ids)
    fwd = _kernels()[0]
    B, T, Hq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    ranges = torch.empty(
        (B, -(-T // _RANGE_TILE), 2), dtype=torch.int32, device=q.device
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
        ranges.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, Hq, k.shape[2], hd, stream,
    )
    _raise_on(rc, "forward")
    flash_attention.fwd_launches += 1
    return out, lse, ranges


def _launch_bwd(q, k, v, seg_ids, ranges, out, lse, dout, parts=_BWD_ALL):
    bwd = _kernels()[1]
    dout = dout.contiguous()
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not fit q")
    B, T, Hq, hd = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    D = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    # each query head's dk/dv partials, f32; every row is written before
    # it is read, so they are not cleared
    dk_ws = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv_ws = torch.empty_like(dk_ws)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
        ranges.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        D.data_ptr(), dk_ws.data_ptr(), dv_ws.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, Hq, k.shape[2], hd, parts, stream,
    )
    _raise_on(rc, "backward")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_ids):
        out, lse, ranges = _launch_fwd(q, k, v, seg_ids)
        ctx.save_for_backward(q, k, v, seg_ids, ranges, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_ids, ranges, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, seg_ids, ranges, out, lse, dout)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, seg_ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse [B, Hq, T] f32)`` without autograd: the forward kernel's
    two outputs (plain version on CPU tensors)."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, seg_ids, return_lse=True)
    out, lse, _ = _launch_fwd(q, k, v, seg_ids)
    return out, lse


def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    seg_ids: torch.Tensor,  # [B, T] int32, 0 = padding
) -> torch.Tensor:
    """Causal, segment-masked attention, differentiable in q, k and v (see
    the module docstring).  CPU tensors take the plain version; any other
    device launches the CUDA kernels or raises."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, seg_ids)
    return _FlashAttention.apply(q, k, v, seg_ids)


#: kernel launches since the counts were last set to 0: one forward launch
#: per forward call, one backward launch (the D, dq, dk/dv and reduce
#: kernels) per backward call; the plain version and failed launches do
#: not count
flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0
