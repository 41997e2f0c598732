"""Paged flash attention over a block-pool KV cache (port of
``areal_tpu/ops/paged_attention.py``).

:func:`paged_flash_attention` returns the un-normalised online-softmax
partials ``(acc [B,Q,Hq,hd] f32, m [B,Q,Hq] f32, l [B,Q,Hq] f32)`` of Q
query tokens per row over the row's whole cached prefix ``[0, length)``,
read through its block table; rows with ``length == 0`` give ``acc=0,
l=0, m=-1e30``.  The caller merges them online with attention over KV
not in the pool yet.

On CUDA tensors it launches the hand-written Hopper kernel
(``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``paged_flash_attention`` at ``areal_tpu/ops/paged_attention.py:201``)
or raises; it never falls back.  On CPU tensors it runs the plain
version, :func:`reference_paged_partials`, a straight port of the
reference's jnp ``reference_paged_partials``.  What bounds the kernel on
an H100 and what its design does about it is written at the top of the
CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from areal_tpu_torch.ops import _build

_NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)
#: SMs of an H100 SXM; the split heuristic aims for two blocks per SM
_TARGET_BLOCKS = 2 * 132
#: fewest keys a KV split should own (4 warps x 4 tiles of 32 keys)
_MIN_KEYS_PER_SPLIT = 512
_ROWS_PER_BLOCK = 8  # kRows in the CUDA source


def gather_paged_kv(
    k_pool: torch.Tensor,  # [NB, Hkv, BS, hd]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize per-row dense KV ``[B, Hkv, MB*BS, hd]`` from the pool
    (the plain version's gather; the kernel never does this)."""

    def g(pool):
        x = pool[tables.long()]  # [B, MB, Hkv, BS, hd]
        B, MB, Hkv, BS, hd = x.shape
        return x.transpose(1, 2).reshape(B, Hkv, MB * BS, hd)

    return g(k_pool), g(v_pool)


def reference_paged_partials(q, k_pool, v_pool, tables, lengths):
    """Plain PyTorch version of :func:`paged_flash_attention` (same
    contract), computed in float32."""
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    r = Hq // Hkv
    k, v = gather_paged_kv(k_pool, v_pool, tables)  # [B, Hkv, S, hd]
    S = k.shape[2]
    qg = q.reshape(B, Q, Hkv, r, hd).float()
    s = torch.einsum("bqkrd,bksd->bqkrs", qg, k.float()) / math.sqrt(hd)
    mask = (
        torch.arange(S, device=q.device)[None, None, None, None, :]
        < lengths.to(q.device)[:, None, None, None, None]
    )
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkrs,bksd->bqkrd", p, v.float())
    return (
        acc.reshape(B, Q, Hq, hd),
        m.reshape(B, Q, Hq),
        l.reshape(B, Q, Hq),
    )


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point and error-string function (the
    library is built at the first call)."""
    cdll = _build.load_library("paged_attention").cdll
    fn = cdll.paged_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 11  # q, k, v, tables, lengths, acc, m, l, 3 ws
        + [ctypes.c_int] * 9  # B, Q, Hq, Hkv, hd, BS, MB, NB, n_splits
        + [ctypes.c_longlong] * 3  # pool block/head/slot strides
        + [ctypes.c_int, ctypes.c_void_p]  # dtype code, stream
    )
    fn.restype = ctypes.c_int
    err = cdll.paged_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _n_splits(B: int, Q: int, Hq: int, Hkv: int, capacity: int) -> int:
    """KV splits per (row, head, query tile): enough blocks to cover the
    card when the grid is small (decode), none when it is large (prefill
    chunks).  Decided from shapes only, so no device value is read."""
    n_qtiles = -(-(Q * (Hq // Hkv)) // _ROWS_PER_BLOCK)
    base = n_qtiles * Hkv * B
    want = -(-_TARGET_BLOCKS // base)
    return max(1, min(want, capacity // _MIN_KEYS_PER_SPLIT))


def _check(q, k_pool, v_pool, tables, lengths):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [B,Q,Hq,hd] and the pools [NB,Hkv,BS,hd]; got "
            f"{tuple(q.shape)} and {tuple(k_pool.shape)}"
        )
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, hd_p = k_pool.shape
    if v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride():
        raise ValueError("k_pool and v_pool differ in shape or strides")
    if hd_p != hd or Hq % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(k_pool.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (kernel builds {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"q/pool dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: the "
            "kernel takes one of float32, bfloat16, float16 for all three"
        )
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be int32 [B={B}, MB]; got {tables.dtype} {tuple(tables.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be int32 [B={B}]; got {lengths.dtype} {tuple(lengths.shape)}")
    if not (q.is_contiguous() and tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, tables and lengths must be contiguous")
    if k_pool.stride(3) != 1:
        raise ValueError("the pools' head_dim axis must be contiguous")
    # 16-byte vector loads: every page row starts on a 16-byte boundary
    vec = 16 // k_pool.element_size()
    if any(s % vec for s in k_pool.stride()[:3]) or any(
        t.data_ptr() % 16 for t in (q, k_pool, v_pool)
    ):
        raise ValueError("q and pool rows must be 16-byte aligned")


def _launch(q, k_pool, v_pool, tables, lengths):
    if q.device.type != "cuda":
        raise RuntimeError(
            f"paged_flash_attention's kernel runs on CUDA tensors; got a "
            f"{q.device.type} tensor (only CPU tensors take the plain version)"
        )
    _check(q, k_pool, v_pool, tables, lengths)
    fn, err_str = _kernel()
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    MB = tables.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Q, Hq, hd), **f32)
    m = torch.empty((B, Q, Hq), **f32)
    l = torch.empty((B, Q, Hq), **f32)
    S = _n_splits(B, Q, Hq, Hkv, MB * BS)
    if S > 1:
        acc_ws = torch.empty((S, B, Q, Hq, hd), **f32)
        m_ws = torch.empty((S, B, Q, Hq), **f32)
        l_ws = torch.empty((S, B, Q, Hq), **f32)
        ws = (acc_ws.data_ptr(), m_ws.data_ptr(), l_ws.data_ptr())
    else:
        ws = (None, None, None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sb, sh, ss, _ = k_pool.stride()
    rc = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), *ws,
        B, Q, Hq, Hkv, hd, BS, MB, NB, S, sb, sh, ss,
        _DTYPE_CODES[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: {err_str(rc).decode()}"
        )
    paged_flash_attention.launches += 1
    return acc, m, l


def paged_flash_attention(
    q: torch.Tensor,  # [B, Q, Hq, hd]
    k_pool: torch.Tensor,  # [NB, Hkv, BS, hd] (a layer slice of the pool)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised online-softmax partials over paged KV (see the module
    docstring).  CPU tensors take the plain version; any other device
    launches the CUDA kernel or raises."""
    if q.device.type == "cpu":
        return reference_paged_partials(q, k_pool, v_pool, tables, lengths)
    return _launch(q, k_pool, v_pool, tables, lengths)


#: kernel launches since the count was last set to 0 (the plain version,
#: and failed launches, do not count)
paged_flash_attention.launches = 0
