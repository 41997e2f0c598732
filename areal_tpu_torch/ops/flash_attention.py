"""Causal, segment-masked flash attention over packed rows, with an
optional sliding window (port of ``areal_tpu/ops/flash_attention.py``).

:func:`flash_attention` ``(q [B,T,Hq,hd], k/v [B,T,Hkv,hd], seg_ids [B,T]
int32, window=None) -> [B,T,Hq,hd]``: query i attends key j iff ``seg[i]
== seg[j] != 0``, ``j <= i`` and, with a ``window``, ``i - j < window``
(causal and windowed by index within the row, which equals the
reference's position masks, ``pos_q >= pos_kv`` and ``pos_q - pos_kv <
window``, on the layouts ``pad_batch`` and ``pack_batch`` build:
contiguous segments whose positions rise from 0), with scale
``1/sqrt(hd)``, at head dims 64, 128 and 256.  A padding query (seg 0)
gets output 0 and zero gradients; the reference's
``reference_attention`` averages V uniformly there instead, which no
loss ever reads.  The reference sends no window to its kernel (it masks
dense attention for a sliding-window model); the port computes that
function in its kernel, since the dense ``[B, T, T]`` path does not fit
a card at the family's lengths.

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
HEAD_DIMS = (64, 128, 256)
#: token granularity of the kernel's segment-range workspace
_RANGE_TILE = 32
#: the backward's kernels, as bits of the C entry's ``parts`` (a backward
#: call runs them all; one bit runs that kernel alone, for timing)
BWD_PARTS = {"D": 1, "dq": 2, "dkdv": 4, "reduce": 8}
_BWD_ALL = 15


def attention_mask(seg_ids: torch.Tensor, window=None) -> torch.Tensor:
    """[B, T, T] bool: query i attends key j (same nonzero segment, j <= i
    and, with a ``window``, i - j < window)."""
    T = seg_ids.shape[1]
    idx = torch.arange(T, device=seg_ids.device)
    same = (seg_ids[:, :, None] == seg_ids[:, None, :]) & (
        seg_ids[:, :, None] != 0
    )
    dist = idx[:, None] - idx[None, :]
    ok = dist >= 0
    if window is not None:
        ok = ok & (dist < window)
    return same & ok


def reference_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_ids: torch.Tensor,
    return_lse: bool = False,
    window=None,
):
    """Plain PyTorch version of :func:`flash_attention` (same contract),
    computed in float32 and returned in q's dtype; with ``return_lse`` also
    the logsumexp ``[B, Hq, T]`` float32 (``+inf`` on padding queries)."""
    _check_window(window)
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    r = Hq // Hkv
    mask = attention_mask(seg_ids, window)[:, None, None]  # [B, 1, 1, T, T]
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
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = cdll.flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    err = cdll.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, bwd, err


def _check_window(window):
    if window is not None and (
        isinstance(window, bool) or not isinstance(window, int) or window < 1
    ):
        raise ValueError(f"window must be None or a positive int; got {window!r}")


def _check(q, k, v, seg_ids, window):
    _check_window(window)
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


def _launch_fwd(q, k, v, seg_ids, window=None):
    _check(q, k, v, seg_ids, window)
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
        B, T, Hq, k.shape[2], hd, window or 0, stream,
    )
    _raise_on(rc, "forward")
    flash_attention.fwd_launches += 1
    return out, lse, ranges


def _launch_bwd(q, k, v, seg_ids, ranges, out, lse, dout, window=None,
                parts=_BWD_ALL):
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
        dk.data_ptr(), dv.data_ptr(), B, T, Hq, k.shape[2], hd, window or 0,
        parts, stream,
    )
    _raise_on(rc, "backward")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_ids, window):
        out, lse, ranges = _launch_fwd(q, k, v, seg_ids, window)
        ctx.save_for_backward(q, k, v, seg_ids, ranges, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_ids, ranges, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, seg_ids, ranges, out, lse, dout,
                                 ctx.window)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q, k, v, seg_ids, window=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse [B, Hq, T] f32)`` without autograd: the forward kernel's
    two outputs (plain version on CPU tensors)."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, seg_ids, return_lse=True,
                                         window=window)
    out, lse, _ = _launch_fwd(q, k, v, seg_ids, window)
    return out, lse


def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    v: torch.Tensor,  # [B, T, Hkv, hd]
    seg_ids: torch.Tensor,  # [B, T] int32, 0 = padding
    window=None,  # sliding window in keys (query i sees i - window < j)
) -> torch.Tensor:
    """Causal, segment-masked attention, windowed when ``window`` is an
    int, differentiable in q, k and v (see the module docstring).  CPU
    tensors take the plain version; any other device launches the CUDA
    kernels or raises."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, seg_ids, window=window)
    return _FlashAttention.apply(q, k, v, seg_ids, window)


#: kernel launches since the counts were last set to 0: one forward launch
#: per forward call, one backward launch (the D, dq, dk/dv and reduce
#: kernels) per backward call; the plain version and failed launches do
#: not count
flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0
