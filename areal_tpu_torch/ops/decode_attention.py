"""Flash-decode attention over a contiguous per-row KV cache (port of
``areal_tpu/ops/decode_attention.py``).

:func:`flash_decode` returns the un-normalised online-softmax partials
``(acc [B,Hq,hd] f32, m [B,Hq] f32, l [B,Hq] f32)`` of one query token
per row over the row's cache prefix ``[0, length)`` of a head-major cache
``k``/``v`` ``[B, Hkv, S, hd]``; rows with ``length == 0`` give ``acc=0,
l=0, m=-1e30``, as the paged functions do.

A contiguous cache is a pool of B pages of S tokens read through the
table ``[[0], [1], ...]``, so on CUDA tensors the function launches the
deep paged kernel through its ``flash_decode_fwd`` entry point
(``csrc/paged_attention_deep.cu``, which replaces the Pallas TPU kernel
``flash_decode`` at ``areal_tpu/ops/decode_attention.py:150``) with the
cache's strides, or raises; that kernel walks only each row's valid keys,
whatever S is.  A bf16 cache runs its tensor-core body, copied by TMA
when S is a multiple of 64 (the tensor map (hd, S, Hkv, B)).  On CPU tensors it runs the plain version,
:func:`reference_decode_partials`.  Sync PPO's generation calls it: every
``models/transformer.py decode_step`` on a card attends each layer's
dense cache through it (``flash_decode_attention``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import paged_attention as pa

_NEG_INF = -1e30


def reference_decode_partials(q, k, v, lengths):
    """Plain PyTorch version of :func:`flash_decode` (same contract),
    computed in float32."""
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    r = Hq // Hkv
    qg = q.reshape(B, Hkv, r, hd).float()
    s = torch.einsum("bkrd,bksd->bkrs", qg, k.float()) / math.sqrt(hd)
    mask = (
        torch.arange(S, device=q.device)[None, None, None, :]
        < lengths.to(q.device)[:, None, None, None]
    )
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrs,bksd->bkrd", p, v.float())
    return acc.reshape(B, Hq, hd), m.reshape(B, Hq), l.reshape(B, Hq)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's ``flash_decode_fwd`` entry point and its
    error-string function (the library is built at the first call)."""
    cdll = _build.load_library("paged_attention_deep").cdll
    fn = cdll.flash_decode_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12  # q, k, v, tables, lengths, acc, m, l, 3 ws, tickets
        + [ctypes.c_int] * 6  # B, Hq, Hkv, hd, S, n_splits
        + [ctypes.c_longlong] * 3  # cache row/head/slot strides
        + [ctypes.c_int, ctypes.c_void_p]  # dtype code, stream
    )
    fn.restype = ctypes.c_int
    err = cdll.paged_attention_deep_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(q, k, v, lengths):
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_decode's kernel runs on CUDA tensors; got a "
            f"{q.device.type} tensor (only CPU tensors take the plain version)"
        )
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B,Hq,hd] and k/v [B,Hkv,S,hd]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    # the cache as a pool of B pages of S tokens, page b holding row b
    tables = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    pa.check_args(q[:, None], k, v, tables, lengths, None, None)
    fn, err_str = _kernel()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, hd), **f32)
    m = torch.empty((B, Hq), **f32)
    l = torch.empty((B, Hq), **f32)
    n = pa.n_splits(B, 1, Hq, Hkv, S, entry=pa.DEEP_ENTRY)
    ws, ws_ptrs = pa.split_workspace(n, (B, Hq, hd), q.device)
    sb, sh, ss, _ = k.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = pa.ticket_counters(
        q.device, stream, pa.n_tickets(pa.DEEP_ENTRY, B, 1, Hq, Hkv))
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *ws_ptrs, tickets.data_ptr(), B, Hq, Hkv, hd, S, n, sb, sh, ss,
        pa.DTYPE_CODES[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: {err_str(rc).decode()}")
    flash_decode.launches += 1
    return acc, m, l


def flash_decode(
    q: torch.Tensor,  # [B, Hq, hd]
    k: torch.Tensor,  # [B, Hkv, S, hd]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 valid cache prefix per row
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised online-softmax partials of one query token per row
    over its cache prefix (see the module docstring).  CPU tensors take
    the plain version; any other device launches the CUDA kernel or
    raises."""
    if q.device.type == "cpu":
        return reference_decode_partials(q, k, v, lengths)
    return _launch(q, k, v, lengths)


#: kernel launches since the count was last set to 0 (the plain version,
#: and failed launches, do not count)
flash_decode.launches = 0
