"""Paged flash attention over a block-pool KV cache (port of
``areal_tpu/ops/paged_attention.py``).

:func:`paged_flash_attention` returns the un-normalised online-softmax
partials ``(acc [B,Q,Hq,hd] f32, m [B,Q,Hq] f32, l [B,Q,Hq] f32)`` of Q
query tokens per row over the row's whole cached prefix ``[0, length)``,
read through its block table; rows with ``length == 0`` give ``acc=0,
l=0, m=-1e30``.  The caller merges them online with attention over KV
not in the pool yet.  :func:`paged_flash_attention_deep` computes the
same function with a kernel that keeps several key tiles in flight; the
engine picks it for long contexts.

An int8 pool comes with float32 scales ``k_scale``/``v_scale`` ``[NB,
Hkv, BS]`` (one per block, head and slot): a key's K scale multiplies its
scores and its V scale its values, so the result is the float32
attention over the dequantized pool either way.

On CUDA tensors each function launches its hand-written Hopper kernel
(``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``paged_flash_attention`` at ``areal_tpu/ops/paged_attention.py:201``,
and ``csrc/paged_attention_deep.cu``, which replaces
``paged_flash_attention_deep`` at :463) or raises; it never falls back.
:func:`paged_flash_attention` has two entries in its source, picked by
:func:`paged_entry` from shapes and dtypes alone: a prefill chunk (more
than one query token per row, bf16 q over a bf16 or int8 pool) runs on
the tensor cores, everything else (decode, fp32/fp16) on CUDA cores.
:func:`paged_flash_attention_deep` has two bodies, picked by
:func:`deep_body` from dtypes alone: bf16 q over a bf16 or int8 pool on
the tensor cores (its copies by TMA or per-key ``cp.async``,
:func:`deep_copy_route`), float32 and float16 q on CUDA cores.
On CPU tensors both run the plain version,
:func:`reference_paged_partials`, a straight port of the reference's jnp
``reference_paged_partials``.  What bounds each kernel on an H100 and
what its design does about it is written at the top of its CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops import _build

_NEG_INF = -1e30

#: dtype codes of the C interfaces (q; pools add int8)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POOL_CODES = {**DTYPE_CODES, torch.int8: 3}
_HEAD_DIMS = (64, 128, 256)
#: the C entry points of csrc/paged_attention.cu and csrc/paged_attention_deep.cu
DECODE_ENTRY = "paged_attention_fwd"
PREFILL_ENTRY = "paged_attention_prefill_fwd"
DEEP_ENTRY = "paged_attention_deep_fwd"
#: how each entry splits a row's keys over blocks: (grouped query rows per
#: block, blocks to aim for, fewest keys a split should own, whether the
#: grid must stay within the blocks that fit on the card at once).  An
#: H100 SXM has 132 SMs.  The decode and deep kernels' shared memory allows
#: two blocks per SM, so a grid one block larger than 264 would run a
#: second wave for that block.  The decode entry's splits own at least four
#: 64-key tiles (a ring of three or four stages keeps them all in flight).
#: The deep kernel's tensor-core body keeps 3 (bf16) or 6 (int8) 64-key
#: stages of its 8-row tiles in flight (about 100 KB of ring per block,
#: two blocks per SM) and merges its splits in the last one, with no
#: second launch.  Its splits own at least eight tiles: at the 8-row
#: decode shape on an H100, 8 splits of 512 keys took 0.0150 / 0.0152 ms
#: (bf16 / int8) against 0.0155-0.0157 / 0.0154-0.0155 ms for 16 splits
#: of 256 keys in one call, and 0.0148 / 0.0151 ms against 0.0174 /
#: 0.0196 ms for 4 splits of 1024 keys in another, timed in turns
#: (`areal_tpu_torch/tools/variant_ab.py` at commits 47325d5 and eafb37d;
#: at 16 x 32768 all three rules give 8 splits).  The prefill entry aims
#: for two waves of two blocks per SM, so unequal splits even out, of at
#: least 16 tiles each.
_SPLIT_RULES = {
    DECODE_ENTRY: (8, 2 * 132, 256, True),
    PREFILL_ENTRY: (64, 4 * 132, 1024, False),
    DEEP_ENTRY: (8, 2 * 132, 512, True),
}
#: the entries whose split merge takes a ticket per (row, KV head, query
#: tile) from ``ticket_counters``
TICKET_ENTRIES = (DECODE_ENTRY, DEEP_ENTRY)
#: keys per stage of the deep kernel's tensor-core body, and the bytes of
#: one TMA box's row
DEEP_TILE_KEYS = 64
TMA_BOX_BYTES = 128

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


def reference_paged_partials(
    q, k_pool, v_pool, tables, lengths, k_scale=None, v_scale=None
):
    """Plain PyTorch version of :func:`paged_flash_attention` and
    :func:`paged_flash_attention_deep` (same contract), computed in
    float32.  ``k_scale``/``v_scale`` ([NB, Hkv, BS]) mark an int8 pool:
    the gathered pages are multiplied by their per-(head, slot) scales
    right after the block gather, as in the reference."""
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    r = Hq // Hkv
    k, v = gather_paged_kv(k_pool, v_pool, tables)  # [B, Hkv, S, hd]
    k, v = k.float(), v.float()
    if k_scale is not None:
        ks, vs = gather_paged_kv(
            k_scale[..., None], v_scale[..., None], tables
        )  # [B, Hkv, S, 1]
        k = k * ks
        v = v * vs
    S = k.shape[2]
    qg = q.reshape(B, Q, Hkv, r, hd).float()
    s = torch.einsum("bqkrd,bksd->bqkrs", qg, k) / math.sqrt(hd)
    mask = (
        torch.arange(S, device=q.device)[None, None, None, None, :]
        < lengths.to(q.device)[:, None, None, None, None]
    )
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bqkrs,bksd->bqkrd", p, v)
    return (
        acc.reshape(B, Q, Hq, hd),
        m.reshape(B, Q, Hq),
        l.reshape(B, Q, Hq),
    )


@functools.lru_cache(maxsize=None)
def kernel_entry(library: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<library>.cu`` (the library is
    built at the first call) and its error-string function.  Every paged
    entry point takes the arguments of ``paged_attention_fwd``; the decode
    and deep entries also their ticket counters, after the workspace."""
    cdll = _build.load_library(library).cdll
    fn = getattr(cdll, symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * 13  # q, k, v, k/v scale, tables, lengths, acc, m, l, 3 ws
        + [ctypes.c_void_p] * (symbol in TICKET_ENTRIES)  # ticket counters
        + [ctypes.c_int] * 9  # B, Q, Hq, Hkv, hd, BS, MB, NB, n_splits
        + [ctypes.c_longlong] * 5  # pool block/head/slot, scale block/head strides
        + [ctypes.c_int] * 2  # q dtype, pool dtype codes
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    err = getattr(cdll, f"{library}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def paged_entry(Q: int, q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """The C entry of ``csrc/paged_attention.cu`` that a call runs: the
    tensor-core prefill entry for more than one query token per row with
    bf16 q over a bf16 or int8 pool, else the decode entry.  Decided from
    shapes and dtypes only."""
    if Q > 1 and q_dtype == torch.bfloat16 and pool_dtype in (
        torch.bfloat16, torch.int8
    ):
        return PREFILL_ENTRY
    return DECODE_ENTRY


def deep_body(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """Which body of ``csrc/paged_attention_deep.cu`` a deep call runs:
    ``"tensor_cores"`` for bf16 q over a bf16 or int8 pool (``mma.sync``
    products), else ``"cuda_cores"`` (float32 and float16 q).  Decided
    from the dtypes only, as the C entry's ``deep_fwd`` does; no failure
    ever leads to the CUDA-core body."""
    if q_dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16,
                                                    torch.int8):
        return "tensor_cores"
    return "cuda_cores"


def deep_copy_route(BS: int, hd: int, pool_dtype: torch.dtype,
                    k_scale: Optional[torch.Tensor] = None) -> str:
    """How the deep kernel's tensor-core body copies a call's tiles into
    shared memory (``tma_route`` in ``csrc/paged_attention_deep.cu`` states
    the same rule): ``"tma"`` (box copies of 64 keys x 128 bytes through a
    tensor map, and bulk copies of the scales) when a page holds whole
    64-key tiles, a row is a whole number of 128-byte boxes and an int8
    pool's scale tiles are 16-byte aligned; else ``"cp.async"`` (one
    16-byte copy per piece of each key row, its page looked up per key
    unless a page holds whole tiles).  Shapes and strides only."""
    item = torch.empty((), dtype=pool_dtype).element_size()
    if BS % DEEP_TILE_KEYS or (hd * item) % TMA_BOX_BYTES:
        return "cp.async"
    if k_scale is not None and (
        k_scale.data_ptr() % 16 or any(st % 4 for st in k_scale.stride()[:2])
    ):
        return "cp.async"
    return "tma"


def n_splits(B: int, Q: int, Hq: int, Hkv: int, capacity: int,
             entry: str = DECODE_ENTRY) -> int:
    """KV splits per (row, KV head, query tile) for the C entry ``entry``
    (its rule in ``_SPLIT_RULES``): enough blocks to cover the card when
    the grid is small (decode, or a prefill chunk over one long row), none
    when it is large, and never fewer keys per split than the entry's
    least.  A row's split owns an equal share of the row's live tiles, so
    a split past the live length has nothing to do.  Decided from shapes
    only, so no device value is read."""
    rows, target, min_keys, one_wave = _SPLIT_RULES[entry]
    n_qtiles = -(-(Q * (Hq // Hkv)) // rows)
    base = n_qtiles * Hkv * B
    want = target // base if one_wave else -(-target // base)
    return max(1, min(want, capacity // min_keys))


def split_workspace(S: int, shape, device):
    """The key-split workspace (acc, m, l) for ``S`` splits of outputs
    ``shape`` = (..., hd): its tensors and their pointers (null pointers
    and no tensors when ``S == 1``).  The caller keeps the tensors alive
    until the launch is enqueued."""
    if S <= 1:
        return (), (None, None, None)
    f32 = dict(dtype=torch.float32, device=device)
    ws = (
        torch.empty((S, *shape), **f32),
        torch.empty((S, *shape[:-1]), **f32),
        torch.empty((S, *shape[:-1]), **f32),
    )
    return ws, tuple(t.data_ptr() for t in ws)


def check_args(q, k_pool, v_pool, tables, lengths, k_scale, v_scale):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and t.device != dev:
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
    if q.dtype not in DTYPE_CODES:
        raise ValueError(
            f"q is {q.dtype}: the kernel takes float32, bfloat16 or float16"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError(
                f"q/pool dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}: an "
                "fp pool has q's dtype (an int8 pool comes with scales)"
            )
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError(
                f"scales were given, so the pools must be int8; got "
                f"{k_pool.dtype}/{v_pool.dtype}"
            )
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, Hkv, BS):
                raise ValueError(
                    f"{name} must be float32 [NB={NB}, Hkv={Hkv}, BS={BS}]; "
                    f"got {t.dtype} {tuple(t.shape)}"
                )
        if v_scale.stride() != k_scale.stride() or k_scale.stride(2) != 1:
            raise ValueError("k_scale and v_scale need equal strides and "
                             "contiguous slots")
    if tables.dtype != torch.int32 or tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be int32 [B={B}, MB]; got {tables.dtype} {tuple(tables.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be int32 [B={B}]; got {lengths.dtype} {tuple(lengths.shape)}")
    if not (q.is_contiguous() and tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, tables and lengths must be contiguous")
    if k_pool.stride(3) != 1:
        raise ValueError("the pools' head_dim axis must be contiguous")
    # 16-byte vector loads and copies: every page row starts on a 16-byte
    # boundary (a 128-element int8 row is 128 bytes)
    vec = 16 // k_pool.element_size()
    if any(s % vec for s in k_pool.stride()[:3]) or any(
        t.data_ptr() % 16 for t in (q, k_pool, v_pool)
    ):
        raise ValueError("q and pool rows must be 16-byte aligned")


#: the ticket counters of the decode and deep entries, one int32 per (row,
#: KV head, query tile), by (device, stream): zero between calls (the
#: kernels reset the ones they use), grown when a call needs more; calls
#: on one stream run in turn, so the two entries share them
_TICKETS: dict = {}


def ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters for the decode and deep
    entries' calls on ``stream`` of ``device``, kept from call to call.  A larger
    set replaces a smaller one; the kernels still queued on the stream
    finish with the old set before the allocator hands its memory out
    again."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def n_tickets(symbol: str, B: int, Q: int, Hq: int, Hkv: int) -> int:
    """Ticket counters a call of the entry ``symbol`` uses: one per (row,
    KV head, query tile of the entry's grouped rows)."""
    rows = _SPLIT_RULES[symbol][0]
    return B * Hkv * -(-(Q * (Hq // Hkv)) // rows)


def launch_paged(library, symbol, counter, q, k_pool, v_pool, tables,
                 lengths, k_scale=None, v_scale=None):
    """Check the arguments, launch the paged kernel ``symbol`` of
    ``library`` on the current stream and count the launch on
    ``counter`` (``int8_launches`` for an int8 pool, else ``launches``;
    a launch of the prefill entry also on ``prefill_launches``).  Raises
    on anything the kernel does not take, and when the launch fails."""
    if q.device.type != "cuda":
        raise RuntimeError(
            f"{counter.__name__}'s kernel runs on CUDA tensors; got a "
            f"{q.device.type} tensor (only CPU tensors take the plain version)"
        )
    check_args(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
    fn, err_str = kernel_entry(library, symbol)
    B, Q, Hq, hd = q.shape
    NB, Hkv, BS, _ = k_pool.shape
    MB = tables.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Q, Hq, hd), **f32)
    m = torch.empty((B, Q, Hq), **f32)
    l = torch.empty((B, Q, Hq), **f32)
    S = n_splits(B, Q, Hq, Hkv, MB * BS, entry=symbol)
    ws, ws_ptrs = split_workspace(S, (B, Q, Hq, hd), q.device)
    quant = k_scale is not None
    ssb, ssh = k_scale.stride()[:2] if quant else (0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = ()
    if symbol in TICKET_ENTRIES:
        tickets = (ticket_counters(
            q.device, stream, n_tickets(symbol, B, Q, Hq, Hkv)).data_ptr(),)
    sb, sh, ss, _ = k_pool.stride()
    rc = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), *ws_ptrs, *tickets,
        B, Q, Hq, Hkv, hd, BS, MB, NB, S, sb, sh, ss, ssb, ssh,
        DTYPE_CODES[q.dtype], POOL_CODES[k_pool.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: {err_str(rc).decode()}")
    if quant:
        counter.int8_launches += 1
    else:
        counter.launches += 1
    if symbol == PREFILL_ENTRY:
        counter.prefill_launches += 1
    return acc, m, l


def paged_flash_attention(
    q: torch.Tensor,  # [B, Q, Hq, hd]
    k_pool: torch.Tensor,  # [NB, Hkv, BS, hd] (a layer slice of the pool)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32
    k_scale: Optional[torch.Tensor] = None,  # [NB, Hkv, BS] f32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised online-softmax partials over paged KV (see the module
    docstring).  CPU tensors take the plain version; any other device
    launches the CUDA kernel or raises."""
    if q.device.type == "cpu":
        return reference_paged_partials(
            q, k_pool, v_pool, tables, lengths, k_scale, v_scale
        )
    return launch_paged(
        "paged_attention", paged_entry(q.shape[1], q.dtype, k_pool.dtype),
        paged_flash_attention, q, k_pool, v_pool, tables, lengths, k_scale,
        v_scale,
    )


def paged_flash_attention_deep(
    q: torch.Tensor,  # [B, Q, Hq, hd]
    k_pool: torch.Tensor,  # [NB, Hkv, BS, hd] (a layer slice of the pool)
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32
    k_scale: Optional[torch.Tensor] = None,  # [NB, Hkv, BS] f32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The deep variant of :func:`paged_flash_attention`: the same
    contract, from a kernel that streams each block's key range through a
    ring of tiles in flight (``csrc/paged_attention_deep.cu``, which
    replaces ``paged_flash_attention_deep`` at
    ``areal_tpu/ops/paged_attention.py:463``; its body by
    :func:`deep_body`).  The engine picks it by its dispatch table's
    ``deep_min_context``.  CPU tensors take the plain version,
    :func:`reference_paged_partials`."""
    if q.device.type == "cpu":
        return reference_paged_partials(
            q, k_pool, v_pool, tables, lengths, k_scale, v_scale
        )
    return launch_paged(
        "paged_attention_deep", DEEP_ENTRY, paged_flash_attention_deep, q,
        k_pool, v_pool, tables, lengths, k_scale, v_scale,
    )


#: kernel launches since the counts were last set to 0, over fp pools
#: (``launches``) and int8 pools (``int8_launches``), and of those the
#: prefill entry's (``prefill_launches``, either pool); the plain version,
#: and failed launches, do not count
paged_flash_attention.launches = 0
paged_flash_attention.int8_launches = 0
paged_flash_attention.prefill_launches = 0
paged_flash_attention_deep.launches = 0
paged_flash_attention_deep.int8_launches = 0
