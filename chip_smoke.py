"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

or, to also time the paged kernels' decode calls (the standard decode
entry, the deep kernel and ``flash_decode``) and the flash-attention
forward of a parent tree against this one in the same run, with a tree
unpacked from ``git archive`` of the parent commit (each side runs
``areal_tpu_torch/tools/kernel_ab.py`` in its own process, in turns
parent, change, change, parent)::

    python3 chip_smoke.py --parent PATH

It builds the port's CUDA kernels from ``areal_tpu_torch/csrc`` (into
``areal_tpu_torch/_build/``, one nvcc per source, in parallel), then, at
the full width and depth of the Qwen2.5-1.5B architecture (random weights
from a seed, float32 master weights and their bf16 serving copy):

1. holds the paged-attention kernels against their plain PyTorch version
   at the serving paths' shapes: the standard kernel on bf16 and int8
   pools at decode and prefill-chunk shapes (a prefill chunk runs its
   tensor-core entry: 8 rows of Q=512, and one row of Q=512 after a
   31000-token prefix), the deep kernel on both
   pools at the prefill-chunk shape and at decode over 16 rows of up to
   32768 tokens (lengths 0, 1, BS-1, BS, BS+1, full and between; each
   deep call logs the body it runs, tensor cores or CUDA cores, and its
   copy route), the decode entry and the deep kernel on float32 and
   float16 q and pools, and ``flash_decode`` over a contiguous 16 x 32768
   cache beside ``scaled_dot_product_attention`` on the same rows (its
   backend logged); repeats every call
   (a decode call with key splits among them) and requires the repeat
   bit-identical; times the decode entry L2-cold (cycling over enough pool
   layers that the bytes it reads between two calls on one layer exceed
   twice the L2); times the standard and deep kernels at decode for
   contexts 4096-32768 and at the 8-row shape, and prints the dispatch
   threshold those times support;
2. serves requests through ``ContinuousBatchingEngine`` (a greedy wave of
   8 requests, resubmission, weight swaps, a sampled wave at two pipeline
   depths, chunked prefill, and profiles of one decode chunk and of one
   prefill chunk after a short and after a 31000-token prefix);
3. serves the async-PPO recipe's configuration (16 rows, 32768-token KV,
   a wave of 12 prompts of 1024 tokens and 4 of 8000-31000) in three
   arms: a bf16 pool on the default dispatch table, a bf16 pool routing
   decode chunks past 8192 tokens to the deep kernel, and an int8 pool
   with that table; checks each arm's kernel launches against the
   dispatched work, its leak audit and its logprobs against the trainer
   forward, and serves a deliberately broken int8 arm (V scales doubled)
   that the gate must fail;
4. holds the flash-attention forward and backward kernels against their
   plain version on packed, long and ragged rows (T from 32 to 16384, not
   always a multiple of a tile), with a bit-identical repeat of the
   backward, and times them on the packed and long rows beside
   ``torch.nn.functional.scaled_dot_product_attention`` as a yardstick,
   the backward also by part (D, dq, dk/dv with its reduction);
5. runs one async-PPO trainer iteration on the greedy wave's rollout
   through ``PPOActorInterface`` (actor_inf, then three actor_train steps
   with AdamW), with the recipe's settings but ``max_tokens_per_mb=2048``
   (so a minibatch accumulates over micro-batches), lr 1e-4 and no
   warm-up (so three steps move the bf16-cast weights), then swaps the
   trained weights into a serving engine and checks its logprobs against
   the trainer's.  Deliberately broken trainer forwards (controls) show
   that the logprob gate would fail them.

Every phase raises on failure, so the script exits non-zero.  It exits
non-zero without printing a result when no CUDA card is present, or when
the ``areal_tpu_torch`` package is not beside it.

Output, in order: the card (``nvidia-smi`` name and power limit), the
builds, each phase's comparisons, throughput and checks, then on the last
three lines the card again, one ``{"kernels": [...]}`` JSON line, and the
final ``{"ok": true, "device": {...}}`` JSON line.

All float32 matrix products here run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``), so the plain
versions are exact float32 references.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 0
PAGE_SIZE = 256
MAX_BATCH = 8
KV_CACHE_LEN = 4096
PREFILL_CHUNK = 512
CHUNK_SIZE = 16
PIPELINE_DEPTH = 2
NEW_TOKENS = 128
#: prompt lengths of the 8 requests: spread over 300-3000 tokens, crossing
#: page (256) and prefill-chunk (512) boundaries
PROMPT_LENS = (300, 3000, 777, 1536, 513, 2049, 1023, 2600)

#: the long-context serving phase: the async-PPO recipe's generation
#: settings (training/configs/async_ppo.yaml: gen_max_concurrent_batch 16,
#: gen_kv_cache_len 32768), 12 prompts at the recipe's prompt cap and 4
#: long ones (91288 prompt tokens), 64 new tokens each
LONG_MAX_BATCH = 16
LONG_KV_CACHE_LEN = 32768
LONG_PROMPT_LENS = (1024,) * 12 + (8000, 16000, 24000, 31000)
LONG_NEW_TOKENS = 64
#: the deep-kernel threshold of arms B and C
DEEP_MIN_CONTEXT = 8192
#: (arm, kv_cache_dtype, deep_min_context); None keeps the default table
LONG_ARMS = (("A", "auto", None), ("B", "auto", DEEP_MIN_CONTEXT),
             ("C", "int8", DEEP_MIN_CONTEXT))
#: prompts of the broken int8 control wave (32 new tokens each)
LONG_CONTROL_LENS = (1024,) * 4 + (8000, 16000)
#: contexts at which the standard and deep kernels are timed at decode
DISPATCH_CONTEXTS = (4096, 8192, 16384, 32768)
#: the cached prefix of the long prefill-chunk shape (the long wave's
#: largest prompt is 31000 tokens)
LONG_PREFILL_PREFIX = 31000

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel-vs-plain tolerances: both sides compute in float32 from the
# same bf16 inputs and differ only in summation order
TOL_OUT = 2e-4  # max |acc/l - ref| (outputs are O(1) averages of V rows)
TOL_M = 1e-4  # max |m - ref| (scores are O(1) after the 1/sqrt(hd) scale)
TOL_L_REL = 1e-4  # max |l - ref| / max(1, |ref|)
#: relative L2 distance allowed between chunked and one-chunk prefill
#: logits: bf16 activations round at other places when the prefix is read
#: back from the pool through the kernel instead of attended in-chunk
TOL_CHUNKED_LOGITS = 3e-2
#: mean and max |serving logprob - trainer recompute| allowed over the
#: generated tokens of one rollout at the same weights.  The two bf16
#: forwards round at other places (chunked paged prefill and the f32 paged
#: kernel against one packed pass through the flash kernel, which rounds P
#: to bf16).  Set on an H100 between the sound readings (largest: mean
#: 1.2e-3, max 3.9e-3) and the weakest broken control, the trainer forward
#: without RoPE (mean 9.4e-3, max 2.2e-2): each gate is 2.2-3.1x from
#: both.  The random init gives near-uniform logits (the tied embedding's
#: entries are uniform in +-1/sqrt(151936), so logits have a standard
#: deviation near 0.06), so a fault moves logprobs by hundredths.
TOL_PROX_MEAN = 3e-3
TOL_PROX_MAX = 1e-2
#: the same gate for the long-context arm served from an int8 pool, whose
#: storage rounding adds to the bf16 roundings.  Read on an H100: the int8
#: arm mean 5.7e-4, max 3.9e-3 (the bf16 arms 4.7e-4, 3.9e-3); a
#: deliberately broken int8 arm (V dequantized at twice its scale) mean
#: 1.3e-2, max 4.1e-2.  Each limit is 2.6-5.3x above the int8 reading and
#: 4.1-4.4x below the control's; the script serves the control and fails
#: if this gate does not see it
TOL_INT8_MEAN = 3e-3
TOL_INT8_MAX = 1e-2

# flash-attention kernel vs plain version.  The kernels multiply bf16
# operands on the tensor cores with f32 accumulation and round P and dS to
# bf16 before their products (as the TPU kernel does); the plain version
# is f32 throughout on the same bf16 inputs.
#: relative L2 distance of out over real tokens: out is stored in bf16
#: (relative rounding error up to 2^-9), and P is rounded to bf16 before
#: the P.V product.  Read on an H100: 1.8e-3 to 2.1e-3 on every layout
TOL_FA_OUT = 1e-2
#: the largest relative L2 distance of one real token's out [Hq, hd]: an
#: error confined to a few tokens or a tile edge shows here, not in the
#: distance over all tokens.  Read on an H100: 2.2e-3 to 2.5e-3
TOL_FA_OUT_TOKEN = 2e-2
#: max |lse - ref|: f32 softmax statistics over f32-accumulated scores
TOL_FA_LSE = 1e-4
#: relative L2 distance of dq, dk, dv (bf16 internals; the verify notes'
#: ~2e-2 for gradients)
TOL_FA_GRAD = 2e-2
#: the flash phase's layouts: (name, B, T, segment lengths per row).  The
#: first two are timed for the kernels line; the others cover T below one
#: 64-token tile, T not a multiple of a tile, segments of one token and
#: rows that end in padding.
FLASH_LAYOUTS = (
    ("packed", 2, 4096, ((1000, 2000, 1096), (3128,))),
    ("long", 1, 16384, ((16384,),)),
    ("ragged", 2, 200, ((50, 100), (33,))),
    ("short", 1, 32, ((32,),)),
    ("odd", 2, 257, ((257,), (120, 1, 64))),
    ("mid", 2, 1000, ((999,), (1, 500, 300))),
)
#: layouts whose times go into the kernels line
FLASH_TIMED = ("packed", "long")

#: the async-PPO recipe's actor settings (training/configs/async_ppo.yaml)
PPO_RECIPE = dict(
    n_minibatches=4, kl_ctl=0.0, disable_value=True, use_decoupled_loss=True,
    behav_imp_weight_cap=5.0,
)
#: the recipe has 32768; with 2048, three of the four minibatches of the
#: 12822-token rollout accumulate over two micro-batches each (at 4096 every
#: minibatch fits in one)
MAX_TOKENS_PER_MB = 2048
#: the recipe's lr is 1e-6 with a warm-up that gives lr 0 on the first
#: step; 1e-4 without warm-up moves the bf16-cast weights in three steps
TRAIN_LR = 1e-4
TRAIN_STEPS = 3


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, device) -> float:
    """Mean device milliseconds per call of ``fn``: ``kernel_ab.time_ms``
    (CUDA events around calls enqueued behind a sleep kernel)."""
    from areal_tpu_torch.tools import kernel_ab

    return kernel_ab.time_ms(fn, iters, device)


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------


def paged_inputs(B, Q, Hq, Hkv, hd, BS, MB, lengths, device, dtype,
                 n_layers, seed, int8=False):
    """q [B,Q,Hq,hd], pools [n_layers, NB, Hkv, BS, hd] (NB = B*MB) with a
    scrambled table [B, MB] and the given lengths: (q, k_pool, v_pool,
    k_scale, v_scale, tables, lengths).  With ``int8`` the random pools
    are quantized as the engine stores them, with their scale pools
    [n_layers, NB, Hkv, BS]; otherwise the scales are None."""
    import torch

    from areal_tpu_torch.models.paged import quantize_kv

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    NB = B * MB
    q = torch.randn((B, Q, Hq, hd), generator=g, device=device).to(dtype)
    pools = []
    for _ in range(2):
        pool = torch.empty((n_layers, NB, Hkv, BS, hd), dtype=dtype,
                           device=device)
        for layer in pool:  # one layer at a time: bounded f32 temporaries
            layer.copy_(torch.randn(layer.shape, generator=g, device=device))
        pools.append(pool)
    scales = [None, None]
    if int8:
        for i, pool in enumerate(pools):
            qp = torch.empty(pool.shape, dtype=torch.int8, device=device)
            sc = torch.empty(pool.shape[:-1], dtype=torch.float32,
                             device=device)
            for layer in range(n_layers):
                qp[layer], sc[layer] = quantize_kv(pool[layer])
            pools[i], scales[i] = qp, sc
    perm = torch.randperm(NB, generator=g, device=device)
    tables = perm.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (q, pools[0], pools[1], scales[0], scales[1], tables, lens)


def bound(q, lengths, Hkv, hd, pool_item=None, scale_item=0):
    """(bytes ms, operations ms) for one call: bytes that must move (q,
    the valid K/V prefix with its scales, tables and lengths read once;
    acc, m, l written once) over HBM rate, vs the attention arithmetic
    over the bf16 tensor-core rate.  ``pool_item`` is the pool's element
    size (q's by default); ``scale_item`` the bytes of one slot's scale
    (4 for an int8 pool)."""
    B, Q, Hq, _ = q.shape
    tot = int(lengths.clamp(min=0).sum())
    item = q.element_size()
    pool_item = pool_item or item
    nbytes = (
        q.numel() * item
        + tot * Hkv * 2 * (hd * pool_item + scale_item)
        + B * 4 * 2
        + B * Q * Hq * (hd + 2) * 4
    )
    flops = 4.0 * tot * Q * Hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return t_bytes, t_ops


def check_partials(what, got, ref, lens):
    """Kernel partials (acc, m, l) against the plain version's; raises past
    TOL_OUT / TOL_M / TOL_L_REL or when a length-0 row is not exactly
    acc = 0, l = 0, m = -1e30.  Returns the largest absolute error of
    acc/l and m."""
    import torch

    acc, m, l = got
    acc_r, m_r, l_r = ref
    valid = lens > 0
    out = acc[valid] / l[valid][..., None]
    out_r = acc_r[valid] / l_r[valid][..., None]
    err_out = float((out - out_r).abs().max())
    err_m = float((m[valid] - m_r[valid]).abs().max())
    err_l = float(((l - l_r).abs() / l_r.abs().clamp(min=1.0)).max())
    empty = ~valid
    empty_ok = bool(
        (acc[empty] == 0).all() and (l[empty] == 0).all()
        and (m[empty] == -1e30).all()
    )
    finite = bool(torch.isfinite(acc).all() and torch.isfinite(l).all())
    log(f"kernel {what}: max err acc/l={err_out:.3e} m={err_m:.3e} "
        f"l(rel)={err_l:.3e} empty-rows-exact={empty_ok}")
    if not (finite and empty_ok and err_out <= TOL_OUT and err_m <= TOL_M
            and err_l <= TOL_L_REL):
        raise AssertionError(
            f"{what} disagrees with its plain version: acc/l {err_out} (tol "
            f"{TOL_OUT}), m {err_m} (tol {TOL_M}), l {err_l} (tol "
            f"{TOL_L_REL}), empty rows exact {empty_ok}, finite {finite}"
        )
    return max(err_out, err_m)


def kernel_case(name, fn, inputs, device, *, time_lengths=None,
                timing_iters=20):
    """``fn`` (a paged kernel's wrapper) against the plain version on
    ``inputs`` from :func:`paged_inputs`, and again on the same inputs
    (bit-identical), then timed with its plain version at
    ``time_lengths`` (default: the compared lengths).  Timed launches
    cycle through the pool's layers: the callers give the decode shapes
    enough layers that the bytes read between two calls on one layer
    exceed twice the L2 (``kernel_ab.cold_layers``).  Returns the
    measurements."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs, tables, lens = inputs
    n_layers = kp.shape[0]
    B, Q, Hq, hd = q.shape
    _, NB, Hkv, BS, _ = kp.shape

    def call(f, i, lengths):
        sc = () if ks is None else (ks[i], vs[i])
        return f(q, kp[i], vp[i], tables, lengths, *sc)

    got = call(fn, 0, lens)
    again = call(fn, 0, lens)
    ref = call(pa.reference_paged_partials, 0, lens)
    _sync(device)
    pool = "int8" if ks is not None else str(kp.dtype).removeprefix("torch.")
    err = check_partials(
        f"{name}: B={B} Q={Q} Hq={Hq} Hkv={Hkv} hd={hd} BS={BS} "
        f"MB={tables.shape[1]} {pool} pool, lengths={lens.tolist()}",
        got, ref, lens)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: a repeated call differs")
    log(f"kernel {name}: repeated call bit-identical, {n_layers} pool layers "
        f"timed in turn")
    if fn is pa.paged_flash_attention_deep:
        log(f"kernel {name}: {deep_route(q, kp, ks)}")
    tl = lens if time_lengths is None else time_lengths
    layer = [0]

    def timed(f):
        def run():
            i = layer[0] = (layer[0] + 1) % n_layers
            call(f, i, tl)
        return run

    ms = time_ms(timed(fn), timing_iters, device)
    plain_ms = time_ms(timed(pa.reference_paged_partials),
                       max(2, timing_iters // 10), device)
    t_bytes, t_ops = bound(q, tl, Hkv, hd, kp.element_size(),
                           4 if ks is not None else 0)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} (bytes / 3.35 TB/s: {t_bytes:.5f} "
        f"ms; operations / 989 TFLOP/s: {t_ops:.5f} ms) at lengths "
        f"{tl.tolist()}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=f"B={B} Q={Q} Hq={Hq} Hkv={Hkv} hd={hd} {pool} pool, "
                      f"{int(tl.sum())} cached tokens")


def deep_route(q, k_pool, k_scale=None):
    """Which body of the deep kernel a call on these tensors runs, and its
    copy route (``deep_body``, ``deep_copy_route``: dtypes and shapes
    only), as a phrase for the log."""
    from areal_tpu_torch.ops import paged_attention as pa

    body = pa.deep_body(q.dtype, k_pool.dtype)
    if body == "cuda_cores":
        return "deep kernel body cuda_cores"
    BS, hd = k_pool.shape[-2:]
    route = pa.deep_copy_route(
        BS, hd, k_pool.dtype, None if k_scale is None else k_scale[0])
    return f"deep kernel body tensor_cores, {route} copies"


def compare_kernel(name, B, Q, lengths, device, *, fn=None, int8=False,
                   Hq=12, Hkv=2, hd=128, BS=PAGE_SIZE,
                   MB=KV_CACHE_LEN // PAGE_SIZE, n_layers=4, timing_iters=20):
    """A paged kernel (``fn``, default the standard one) against its plain
    version on one shape of a bf16 (or, with ``int8``, int8) pool, then
    timed; returns the measurements."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    inputs = paged_inputs(B, Q, Hq, Hkv, hd, BS, MB, lengths, device,
                          torch.bfloat16, n_layers, SEED, int8=int8)
    return kernel_case(name, fn or pa.paged_flash_attention, inputs, device,
                       timing_iters=timing_iters)


def kernel_phase(device, *, BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE,
                 Q_prefill=PREFILL_CHUNK, long_prefix=LONG_PREFILL_PREFIX,
                 long_MB=LONG_KV_CACHE_LEN // PAGE_SIZE, timing_iters=20,
                 **shape):
    """The standard paged kernel at decode (Q=1, B=8) and prefill-chunk
    (Q=prefill chunk, its tensor-core entry) shapes, with lengths 0, 1,
    BS-1, BS, BS+1, a full table and two in between, and at one prefill
    chunk after a ``long_prefix``-token prefix; bf16 pools, then the int8
    branch; then the deep kernel (bf16 and int8 pools) at the
    prefill-chunk and decode shapes.  The decode shape is timed L2-cold."""
    from areal_tpu_torch.ops import paged_attention as pa
    from areal_tpu_torch.tools.kernel_ab import cold_layers, touched_bytes

    lengths = [0, 1, BS - 1, BS, BS + 1, MB * BS, (MB * BS) // 3,
               (MB * BS * 3) // 4]
    kw = dict(BS=BS, MB=MB, timing_iters=timing_iters, **shape)
    long_kw = dict(kw, MB=long_MB)
    # decode is timed L2-cold: one call reads ~10 MB (bf16), which the L2
    # holds, so it cycles over enough layers of pool
    cold = {int8: dict(kw, n_layers=cold_layers(touched_bytes(
        lengths, shape.get("Hkv", 2), shape.get("hd", 128), 1 if int8 else 2,
        4 if int8 else 0))) for int8 in (False, True)}
    out = {}
    for int8 in (False, True):
        tag = "int8 " if int8 else ""
        key = tag.replace(" ", "_")
        out[f"{key}decode"] = compare_kernel(
            f"{tag}decode", len(lengths), 1, lengths, device, int8=int8,
            **cold[int8])
        # the prefill calls must run the tensor-core entry
        pa.paged_flash_attention.prefill_launches = 0
        out[f"{key}prefill"] = compare_kernel(
            f"{tag}prefill", len(lengths), Q_prefill, lengths, device,
            int8=int8, **kw)
        out[f"{key}prefill_long"] = compare_kernel(
            f"{tag}prefill after {long_prefix} tokens", 1, Q_prefill,
            [long_prefix], device, int8=int8, **long_kw)
        if pa.paged_flash_attention.prefill_launches == 0:
            raise AssertionError(f"{tag}prefill calls did not run the "
                                 "tensor-core prefill entry")
    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        out[f"deep{tag}_prefill"] = compare_kernel(
            f"deep{' int8' if int8 else ''} prefill", len(lengths), Q_prefill,
            lengths, device, fn=pa.paged_flash_attention_deep, int8=int8,
            **kw)
        out[f"deep{tag}_decode"] = compare_kernel(
            f"deep{' int8' if int8 else ''} decode", len(lengths), 1, lengths,
            device, fn=pa.paged_flash_attention_deep, int8=int8,
            **cold[int8])
        std = out[f"{'int8_' if int8 else ''}decode"]["ms"]
        deep = out[f"deep{tag}_decode"]["ms"]
        log(f"dispatch timing {'int8' if int8 else 'bf16'} pool, the "
            f"{len(lengths)}-row decode shape (lengths {lengths}): standard "
            f"{std:.4f} ms, deep {deep:.4f} ms (deep/standard "
            f"{deep / std:.3f})")
    return out


def decode_dtype_checks(device, *, BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE,
                        Hq=12, Hkv=2, hd=128):
    """The decode entry and the deep kernel (its CUDA-core body) on the
    q/pool types off the main path (float32 and float16, one query token
    per row, and float32 with four, which takes tiles of 8 grouped rows)
    against the plain version, with a repeated call bit-identical."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    lengths = [0, 1, BS - 1, BS, BS + 1, MB * BS, (MB * BS) // 3,
               (MB * BS * 3) // 4]
    for dtype, Q in ((torch.float32, 1), (torch.float16, 1),
                     (torch.float32, 4)):
        q, kp, vp, _, _, tables, lens = paged_inputs(
            len(lengths), Q, Hq, Hkv, hd, BS, MB, lengths, device, dtype, 1,
            SEED + 5)
        if pa.paged_entry(Q, dtype, dtype) != pa.DECODE_ENTRY:
            raise AssertionError(f"{dtype} Q={Q} left the decode entry")
        if pa.deep_body(dtype, dtype) != "cuda_cores":
            raise AssertionError(f"{dtype} left the deep CUDA-core body")
        ref = pa.reference_paged_partials(q, kp[0], vp[0], tables, lens)
        for what, fn in (("decode entry", pa.paged_flash_attention),
                         ("deep kernel", pa.paged_flash_attention_deep)):
            got = fn(q, kp[0], vp[0], tables, lens)
            again = fn(q, kp[0], vp[0], tables, lens)
            _sync(device)
            check_partials(f"{what}, {dtype} q and pool, Q={Q}", got, ref,
                           lens)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what} {dtype} Q={Q}: a repeated "
                                     "call differs")
        log(f"kernel deep kernel, {dtype} q and pool: "
            f"{deep_route(q, kp)}")


def long_kernel_phase(device, *, B=16, MB=None, BS=PAGE_SIZE,
                      contexts=None, timing_iters=20, n_layers=4):
    """The long-context serving shapes: the standard and deep kernels at
    decode (B rows, Q=1) over contexts up to ``MB * BS`` tokens, bf16 and
    int8 pools, each compared with the plain version at lengths 0, 1,
    BS-1, BS, BS+1, full and mixed, then timed on B full rows at every
    context of ``contexts``; the threshold those times support, as
    ``derive_dispatch_table`` reads them; and ``flash_decode`` over a
    contiguous cache of the full length, compared at mixed lengths and
    timed on full rows."""
    import torch

    from areal_tpu_torch.engine.dispatch import (
        DISPATCH_NEVER,
        derive_dispatch_table,
    )
    from areal_tpu_torch.ops import paged_attention as pa

    MB = MB or LONG_KV_CACHE_LEN // BS
    S = MB * BS
    contexts = contexts or DISPATCH_CONTEXTS
    lengths = ([0, 1, BS - 1, BS, BS + 1, S, S - 1, S // 2 + 3]
               + [S * (i + 1) // (B - 8) for i in range(B - 8)])
    assert len(lengths) == B
    full = torch.full((B,), S, dtype=torch.int32, device=device)
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        inputs = paged_inputs(B, 1, 12, 2, 128, BS, MB, lengths, device,
                              torch.bfloat16, n_layers, SEED + 7, int8=int8)
        for name, fn in (("standard", pa.paged_flash_attention),
                         ("deep", pa.paged_flash_attention_deep)):
            out[f"{name}_{tag}"] = kernel_case(
                f"{name} decode {tag}", fn, inputs, device, time_lengths=full,
                timing_iters=timing_iters)
        q, kp, vp, ks, vs, tables, _ = inputs
        rows = {}
        for ctx in contexts:
            mb = -(-ctx // BS)
            tab = tables[:, :mb].contiguous()
            lens = torch.full((B,), ctx, dtype=torch.int32, device=device)
            times = {}
            for name, fn in (("paged", pa.paged_flash_attention),
                             ("deep", pa.paged_flash_attention_deep)):
                layer = [0]

                def run(fn=fn):
                    i = layer[0] = (layer[0] + 1) % n_layers
                    sc = () if ks is None else (ks[i], vs[i])
                    fn(q, kp[i], vp[i], tab, lens, *sc)

                times[name] = time_ms(run, timing_iters, device)
            t_bytes, _ = bound(q, lens, 2, 128, kp.element_size(),
                               4 if int8 else 0)
            log(f"dispatch timing {tag} pool, {B} rows x {ctx} tokens: "
                f"standard {times['paged']:.4f} ms, deep {times['deep']:.4f} "
                f"ms (deep/standard {times['deep'] / times['paged']:.3f}); "
                f"bound {t_bytes:.5f} ms (bytes)")
            rows[ctx] = {"dense": None, "paged": 1.0 / times["paged"],
                         "deep": 1.0 / times["deep"]}
        table = derive_dispatch_table(rows)
        thr = table.deep_min_context
        log(f"dispatch timing {tag} pool: the times support deep_min_context="
            f"{'never' if thr == DISPATCH_NEVER else thr} "
            f"(derive_dispatch_table over calls per ms)")
        del inputs, q, kp, vp, ks, vs, tables
        torch.cuda.empty_cache()
    out["flash_decode"] = flash_decode_case(
        device, B=B, S=S, lengths=lengths, timing_iters=timing_iters,
        n_layers=n_layers)
    return out


def flash_decode_case(device, *, B, S, lengths, timing_iters, n_layers,
                      Hq=12, Hkv=2, hd=128):
    """``flash_decode`` against its plain version over a contiguous bf16
    cache [B, Hkv, S, hd] at ``lengths``, then timed on full rows beside
    ``scaled_dot_product_attention`` of the same query over the same rows
    (a normalised output in place of the partials; the yardstick only)."""
    import torch

    from areal_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=device)
    g.manual_seed(SEED + 9)
    q = torch.randn((B, Hq, hd), generator=g, device=device).to(torch.bfloat16)
    caches = []
    for _ in range(2):
        c = torch.empty((n_layers, B, Hkv, S, hd), dtype=torch.bfloat16,
                        device=device)
        for layer in c:
            layer.copy_(torch.randn(layer.shape, generator=g, device=device))
        caches.append(c)
    k, v = caches
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    got = da.flash_decode(q, k[0], v[0], lens)
    ref = da.reference_decode_partials(q, k[0], v[0], lens)
    _sync(device)
    err = check_partials(
        f"flash_decode: B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} bf16 cache, "
        f"lengths={lengths}", got, ref, lens)
    full = torch.full((B,), S, dtype=torch.int32, device=device)
    layer = [0]

    def timed(f):
        def run():
            i = layer[0] = (layer[0] + 1) % n_layers
            f(q, k[i], v[i], full)
        return run

    ms = time_ms(timed(da.flash_decode), timing_iters, device)
    plain_ms = time_ms(timed(da.reference_decode_partials),
                       max(2, timing_iters // 10), device)
    qs = q[:, :, None]  # [B, Hq, 1, hd]

    def sdpa(q_, k_, v_, _):
        return torch.nn.functional.scaled_dot_product_attention(
            qs, k_, v_, enable_gqa=True)

    library_ms = time_ms(timed(sdpa), timing_iters, device)
    log(f"kernel flash_decode: SDPA's device kernels for one call: "
        f"{sdpa_kernels(lambda: sdpa(q, k[0], v[0], full), device)}")
    t_bytes, t_ops = bound(q[:, None], full, Hkv, hd)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel flash_decode: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} ({B} "
        f"full rows of {S} tokens); "
        f"{deep_route(q, k[0])} (the cache is a pool of {B} pages of {S})")
    del caches, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                shape=f"B={B} Hq={Hq} Hkv={Hkv} hd={hd} S={S} bf16 cache, "
                      f"{B * S} cached tokens")


def sdpa_kernels(fn, device) -> str:
    """The device kernels one call of ``fn`` launches (``torch.profiler``
    device rows; the backend SDPA chose shows in their names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return "not measured (no card)"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0) > 0})
    return ", ".join(names) if names else "not measured (no device rows)"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def make_prompts(vocab: int, lens, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def requests(prompts, max_new, tag):
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )

    return [
        APIGenerateInput(
            qid=f"{tag}-{i}", prompt_ids=p, input_ids=p,
            gconfig=GenerationHyperparameters(max_new_tokens=max_new),
        )
        for i, p in enumerate(prompts)
    ]


def serve(eng, reqs, max_steps=100000):
    """Submit ``reqs`` and step the engine until it drains; returns (results
    in request order, wall seconds)."""
    import torch

    tik = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise AssertionError("engine did not drain")
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - tik
    res = eng.drain_results()
    out = [res.pop(r.qid) for r in reqs]
    if res:
        raise AssertionError(f"unexpected results {sorted(res)}")
    return out, secs


def check_outputs(outs, cfg, max_new, what):
    for o in outs:
        n = len(o.output_ids)
        if not (1 <= n <= max_new) or len(o.output_logprobs) != n:
            raise AssertionError(f"{what} {o.qid}: {n} tokens / "
                                 f"{len(o.output_logprobs)} logprobs")
        if not all(0 <= t < cfg.vocab_size for t in o.output_ids):
            raise AssertionError(f"{what} {o.qid}: token out of vocabulary")
        if not all(math.isfinite(x) and x <= 0 for x in o.output_logprobs):
            raise AssertionError(f"{what} {o.qid}: bad logprob")


def build_engine(cfg, params, device, sampling, **kw):
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )

    settings = dict(
        max_batch=MAX_BATCH, kv_cache_len=KV_CACHE_LEN,
        chunk_size=CHUNK_SIZE, cache_mode="paged", page_size=PAGE_SIZE,
        prefill_chunk_tokens=PREFILL_CHUNK, pipeline_depth=PIPELINE_DEPTH,
        seed=SEED,
    )
    settings.update(kw)
    return ContinuousBatchingEngine(
        cfg, params, sampling=sampling, device=device, **settings
    )


def engine_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                 new_tokens=NEW_TOKENS, card="", **engine_kw):
    """The main path: a greedy wave of ``new_tokens`` per request, with the
    kernel's launch count set to 0 just before it and read just after."""
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.ops.paged_attention import paged_flash_attention

    eng = build_engine(cfg, params, device, SamplingParams(greedy=True),
                       **engine_kw)
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED)
    # warm-up (library handles, allocator), not timed
    serve(eng, requests([p[:64] for p in prompts[:2]], 4, "warm"))
    # prefill throughput: a wave that stops after each request's first token
    p0 = eng.prefill_tokens_total
    _, prefill_secs = serve(eng, requests(prompts, 1, "prefill"))
    prefill_tps = (eng.prefill_tokens_total - p0) / prefill_secs

    # the main path
    f0, d0 = eng.prefill_calls, eng.decode_chunks_total
    t0 = eng.decode_tokens_total
    paged_flash_attention.launches = 0
    paged_flash_attention.prefill_launches = 0
    outs, secs = serve(eng, requests(prompts, new_tokens, "greedy"))
    launches = paged_flash_attention.launches
    prefill_launches = paged_flash_attention.prefill_launches
    fills, chunks = eng.prefill_calls - f0, eng.decode_chunks_total - d0
    expected = cfg.n_layers * (fills + chunks * eng.chunk_size)
    check_outputs(outs, cfg, new_tokens, "greedy")
    dec_tok = eng.decode_tokens_total - t0
    decode_tps = dec_tok / (secs - prefill_secs)
    log(f"engine greedy wave: {len(outs)} requests, prompts {list(prompt_lens)}, "
        f"{sum(len(o.output_ids) for o in outs)} new tokens in {secs:.2f} s; "
        f"{fills} fill chunks + {chunks} decode chunks of {eng.chunk_size} "
        f"steps x {cfg.n_layers} layers = {expected} kernel launches "
        f"expected, {launches} counted, {prefill_launches} of them on the "
        f"prefill entry (expected {cfg.n_layers * fills})")
    if (launches != expected or launches == 0
            or prefill_launches != cfg.n_layers * fills):
        raise AssertionError(
            f"paged_flash_attention launched {launches} times on the main "
            f"path ({prefill_launches} prefill-entry); the engine dispatched "
            f"work for {expected} ({cfg.n_layers * fills} fill-chunk calls)"
        )
    log(f"engine throughput on {card}: prefill {prefill_tps:.1f} tok/s (prompt tokens "
        f"of a first-token-only wave / its wall time {prefill_secs:.2f} s); "
        f"decode {decode_tps:.1f} tok/s ({dec_tok} decode-chunk tokens / "
        f"the greedy wave's wall time less the first-token wave's)")

    # resubmitting the same greedy wave gives the identical streams
    again, _ = serve(eng, requests(prompts, new_tokens, "greedy"))
    if [o.output_ids for o in again] != [o.output_ids for o in outs]:
        raise AssertionError("a resubmitted greedy wave changed its tokens")
    log("engine check: resubmitted greedy wave gives identical tokens")

    # update_weights changes the output and stamps the new version
    short = requests([p[:200] for p in prompts[:2]], 16, "swap")
    before, _ = serve(eng, short)
    perturbed = _perturbed(params, SEED + 3)
    eng.update_weights(perturbed, version=1)
    after, _ = serve(eng, short)
    if [o.output_ids for o in after] == [o.output_ids for o in before]:
        raise AssertionError("update_weights did not change the output")
    if any(o.version_start != 1 or o.version_end != 1 for o in after):
        raise AssertionError("update_weights did not stamp version 1")
    eng.update_weights(params, version=2)
    restored, _ = serve(eng, short)
    if [o.output_ids for o in restored] != [o.output_ids for o in before]:
        raise AssertionError("restoring the weights did not restore output")
    log("engine check: update_weights changes the output, stamps the "
        "version, and restoring the weights restores it")
    leaked = eng.close()
    if leaked or eng.free_pool_blocks != eng.n_blocks:
        raise AssertionError(f"leaked pool blocks: {leaked}, free "
                             f"{eng.free_pool_blocks}/{eng.n_blocks}")
    log("engine check: close() reports no leaked blocks")
    return dict(launches=launches, prefill_launches=prefill_launches,
                prefill_tps=prefill_tps, decode_tps=decode_tps, outs=outs)


def sampled_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                  new_tokens=NEW_TOKENS, **engine_kw):
    """A second wave sampled at temperature 1, twice, at two pipeline
    depths: the position-keyed streams must agree."""
    from areal_tpu_torch.engine.sampling import SamplingParams

    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 1)
    streams = []
    for depth in (PIPELINE_DEPTH, 1):
        kw = dict(engine_kw, pipeline_depth=depth)
        eng = build_engine(cfg, params, device,
                           SamplingParams(temperature=1.0), **kw)
        outs, secs = serve(eng, requests(prompts, new_tokens, "sampled"))
        check_outputs(outs, cfg, new_tokens, "sampled")
        if eng.close():
            raise AssertionError("sampled engine leaked pool blocks")
        streams.append([o.output_ids for o in outs])
        log(f"engine sampled wave (temperature 1, pipeline depth {depth}): "
            f"{sum(len(s) for s in streams[-1])} tokens in {secs:.2f} s")
    if streams[0] != streams[1]:
        raise AssertionError("sampled streams differ across pipeline depths")
    log("engine check: sampled streams identical across pipeline depths")


def chunked_prefill_phase(cfg, params, device, *, prompt_len=1500,
                          chunk=PREFILL_CHUNK, BS=PAGE_SIZE):
    """The same prompt's final logits with chunked prefill (later chunks
    read the cached pages through the kernel) and one-chunk prefill (which
    reads none)."""
    import torch

    from areal_tpu_torch.models import paged

    prompt = make_prompts(cfg.vocab_size, [prompt_len], SEED + 2)[0]
    MB = -(-prompt_len // BS)
    tables = torch.arange(MB, dtype=torch.int32, device=device)[None]
    i32 = dict(dtype=torch.int32, device=device)

    def prefill(chunk_len):
        kp, vp, _, _ = paged.alloc_kv_pool(cfg, MB, BS, device)
        for s in range(0, prompt_len, chunk_len):
            n = min(chunk_len, prompt_len - s)
            logits = paged.paged_fill_chunk(
                params, kp, vp, cfg,
                torch.tensor([prompt[s:s + n]], **i32),
                torch.tensor([s], **i32), torch.tensor([n], **i32), tables,
            )
        return logits[0].float()

    a, b = prefill(chunk), prefill(prompt_len)
    rel = float((a - b).norm() / b.norm())
    same_top = bool(a.argmax() == b.argmax())
    log(f"engine check: chunked ({chunk}) vs one-chunk prefill of "
        f"{prompt_len} tokens: relative L2 logit difference {rel:.3e} "
        f"(tolerance {TOL_CHUNKED_LOGITS}), same argmax {same_top}")
    if not (math.isfinite(rel) and rel <= TOL_CHUNKED_LOGITS):
        raise AssertionError("chunked and one-chunk prefill disagree")


def device_seconds(prof, names):
    """(device busy seconds, seconds in kernels whose name contains one of
    ``names``) of a ``torch.profiler`` run.  Only device-side rows
    (kernels, copies) count, as torch's own table sums them: a CPU op's row
    repeats the time of the kernels it launched, so summing every row would
    count most device time twice."""
    from torch.autograd import DeviceType

    busy = part = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(
            ev, "is_user_annotation", False
        ):
            continue
        us = ev.self_device_time_total
        busy += us
        if any(n in ev.key for n in names):
            part += us
    return busy / 1e6, part / 1e6


def top_device_rows(prof, n):
    """The ``n`` device-side rows of a ``torch.profiler`` run with the most
    time: [(seconds, calls, name cut to 60 characters)]."""
    from torch.autograd import DeviceType

    rows = [
        (ev.self_device_time_total / 1e6, ev.count, ev.key[:60])
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False)
    ]
    return sorted(rows, reverse=True)[:n]


def anatomy(fn, label, top=0):
    """Host enqueue time, wall time and device busy time of one call of
    ``fn`` (warmed up), and the paged kernel's share of the device time
    (both of its entries and the split merge).  Device time is the sum of
    the kernels' and copies' own time in a ``torch.profiler`` trace of a
    second call; idle share is one minus device time over the unprofiled
    wall time.  With ``top``, also the ``top`` device rows with the most
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tik = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - tik
    torch.cuda.synchronize()
    wall = time.perf_counter() - tik
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    busy, kern = device_seconds(
        prof, ("paged_decode_kernel", "paged_prefill_kernel",
               "combine_splits_kernel"))
    if busy > 0:
        dev = (f"device busy {busy * 1e3:.2f} ms (idle share "
               f"{1 - busy / wall:.3f}), paged kernel "
               f"{kern * 1e3:.2f} ms = {kern / busy:.3f} of device time")
    else:
        dev = "device time not measured (the profiler saw no device events)"
    log(f"anatomy {label}: host enqueue {enqueue * 1e3:.2f} ms, wall "
        f"{wall * 1e3:.2f} ms; {dev}")
    for sec, calls, name in top_device_rows(prof, top):
        log(f"anatomy {label} device time: {sec * 1e3:.3f} ms in {calls} "
            f"calls of {name}")
    return wall


def anatomy_phase(cfg, params, device, *, lens=PROMPT_LENS,
                  long_prefix=LONG_PREFILL_PREFIX):
    """Where a decode chunk's and a prefill chunk's time goes, outside the
    engine: one decode chunk (8 rows at the prompt lengths, all active,
    ``CHUNK_SIZE`` steps) and one prefill chunk (one row,
    ``PREFILL_CHUNK`` tokens after a 2560-token cached prefix, and after a
    ``long_prefix``-token prefix read through a table over the whole
    pool), over a pool of random KV."""
    import torch

    from areal_tpu_torch.engine.sampling import (
        SamplingParams,
        sample_logits_keyed,
    )
    from areal_tpu_torch.models import paged

    B, MB = len(lens), KV_CACHE_LEN // PAGE_SIZE
    kp, vp, _, _ = paged.alloc_kv_pool(cfg, B * MB, PAGE_SIZE, device)
    kp.normal_()
    vp.normal_()
    i32 = dict(dtype=torch.int32, device=device)
    tables = torch.arange(B * MB, **i32).reshape(B, MB)
    lengths = torch.tensor(lens, **i32)
    greedy = SamplingParams(greedy=True)

    def decode():
        paged.paged_decode_chunk(
            params, kp, vp, cfg, tables, lengths, torch.zeros(B, **i32),
            torch.ones(B, dtype=torch.bool, device=device),
            torch.full((B,), 1 << 20, **i32), CHUNK_SIZE,
            lambda lg, pos, sd: sample_logits_keyed(lg, SEED, sd, pos, greedy),
            lambda tok: tok < 0, KV_CACHE_LEN, torch.arange(B, **i32),
        )

    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_CHUNK), **i32)

    def fill():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([2560], **i32),
            torch.tensor([PREFILL_CHUNK], **i32), tables[:1],
        )

    wall = anatomy(decode, f"decode chunk ({B} rows x {CHUNK_SIZE} steps)")
    log(f"anatomy: decode at batch {B} runs {B * CHUNK_SIZE / wall:.1f} tok/s "
        f"({wall / CHUNK_SIZE * 1e3:.2f} ms per step)")
    wall = anatomy(fill, f"prefill chunk ({PREFILL_CHUNK} tokens)")
    log(f"anatomy: prefill chunk runs {PREFILL_CHUNK / wall:.1f} tok/s")

    def fill_long():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([long_prefix], **i32),
            torch.tensor([PREFILL_CHUNK], **i32),
            torch.arange(B * MB, **i32)[None],
        )

    wall = anatomy(fill_long, f"prefill chunk ({PREFILL_CHUNK} tokens after "
                   f"{long_prefix})", top=8)
    log(f"anatomy: prefill chunk after {long_prefix} tokens runs "
        f"{PREFILL_CHUNK / wall:.1f} tok/s")


# ---------------------------------------------------------------------------
# flash attention: kernels vs plain version
# ---------------------------------------------------------------------------


def flash_inputs(B, T, rows, device, Hq=12, Hkv=2, hd=128, seed=SEED):
    """bf16 q [B,T,Hq,hd], k/v [B,T,Hkv,hd], dO like q, and int32 seg_ids
    [B,T] with the given segment lengths per row (the rest padding)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    seg = torch.zeros((B, T), dtype=torch.int32)
    for b, lens in enumerate(rows):
        c = 0
        for i, L in enumerate(lens):
            seg[b, c:c + L] = i + 1
            c += L
    return (rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd),
            rnd(B, T, Hq, hd), seg.to(device))


def plain_flash(q, k, v, seg, dout=None):
    """The plain version, one query head at a time (at T = 16384 a whole
    [B, Hq, T, T] score tensor and its backward would not fit): (out, lse)
    and, with ``dout``, float32 (dq, dk, dv) by autograd."""
    import torch

    from areal_tpu_torch.ops.flash_attention import reference_flash_attention

    B, T, Hq, hd = q.shape
    r = Hq // k.shape[2]
    outs, lses = [], []
    grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in (q, k, v)] if dout is not None else None
    for h in range(Hq):
        g = h // r
        args = [t[:, :, i:i + 1].float() for t, i in ((q, h), (k, g), (v, g))]
        with torch.set_grad_enabled(dout is not None):
            if dout is not None:
                for a in args:
                    a.requires_grad_(True)
            out, lse = reference_flash_attention(*args, seg, return_lse=True)
            if dout is not None:
                out.backward(dout[:, :, h:h + 1].float())
                grads[0][:, :, h] = args[0].grad[:, :, 0]
                grads[1][:, :, g] += args[1].grad[:, :, 0]
                grads[2][:, :, g] += args[2].grad[:, :, 0]
        outs.append(out.detach())
        lses.append(lse.detach())
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1), grads


def flash_bound(q, k, seg, backward: bool):
    """(bytes ms, operations ms) of one forward or backward call at this
    data: the causal pairs inside segments (what the function attends)
    times 4 (forward: QK^T, PV) or 10 (backward: QK^T recomputed, dO V^T,
    P^T dO, dS^T Q, dS K) flops per head-dim element per query head, over
    989 TFLOP/s; and each input read once and each output written once,
    over 3.35 TB/s."""
    import torch

    B, T, Hq, hd = q.shape
    pairs = 0
    for b in range(B):
        _, counts = torch.unique_consecutive(seg[b][seg[b] != 0],
                                             return_counts=True)
        pairs += int((counts * (counts + 1) // 2).sum())
    item = q.element_size()
    qb, kb = q.numel() * item, k.numel() * item
    lse_b, seg_b = B * Hq * T * 4, seg.numel() * 4
    if backward:  # q, k, v, out, dout, lse, seg in; dq, dk, dv out
        nbytes = 3 * qb + 2 * kb + lse_b + seg_b + qb + 2 * kb
        flops = 10.0 * pairs * Hq * hd
    else:  # q, k, v, seg in; out, lse out
        nbytes = qb + 2 * kb + seg_b + qb + lse_b
        flops = 4.0 * pairs * Hq * hd
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare_flash(name, B, T, rows, device, timing_iters=10, timed=True):
    """Forward and backward kernels vs the plain version on one layout;
    returns {"fwd": {...}, "bwd": {...}} measurements (with ``timed``
    false, the largest absolute errors alone)."""
    import torch
    import torch.nn.functional as F

    from areal_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, seg = flash_inputs(B, T, rows, device)
    real = seg != 0
    out, lse = fa.flash_attention_with_lse(q, k, v, seg)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qs, ks, vs, seg).backward(dout)
    grads = [t.grad for t in (qs, ks, vs)]
    # the backward again: bit-identical (no atomics)
    qs2, ks2, vs2 = (t.clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qs2, ks2, vs2, seg).backward(dout)
    repeat = all(torch.equal(a, b.grad) for a, b in zip(grads, (qs2, ks2, vs2)))
    ref_out, ref_lse, ref_grads = plain_flash(q, k, v, seg, dout)
    _sync(device)

    d_out = (out.float() - ref_out)[real]
    err_out = float(d_out.norm() / ref_out[real].norm())
    err_tok = float((d_out.flatten(1).norm(dim=1)
                     / ref_out[real].flatten(1).norm(dim=1)).max())
    abs_fwd = max(float(d_out.abs().max()),
                  float((lse - ref_lse).transpose(1, 2)[real].abs().max()))
    abs_bwd = max(float((a.float() - b).abs().max())
                  for a, b in zip(grads, ref_grads))
    err_lse = float((lse - ref_lse).transpose(1, 2)[real].abs().max())
    pad_ok = bool((out[~real] == 0).all()) and bool(
        torch.isposinf(lse.transpose(1, 2)[~real]).all())
    err_g = [_rel_l2(a, b) for a, b in zip(grads, ref_grads)]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    log(f"flash {name}: B={B} T={T} segments {[list(r) for r in rows]}: out "
        f"rel L2 {err_out:.3e} (tol {TOL_FA_OUT}), worst token's rel L2 "
        f"{err_tok:.3e} (tol {TOL_FA_OUT_TOKEN}), lse {err_lse:.3e} "
        f"(tol {TOL_FA_LSE}), dq/dk/dv rel L2 "
        f"{' '.join(f'{e:.3e}' for e in err_g)} (tol {TOL_FA_GRAD}), padding "
        f"exact {pad_ok}, repeat backward bit-identical {repeat}")
    if not (finite and pad_ok and repeat and err_out <= TOL_FA_OUT
            and err_tok <= TOL_FA_OUT_TOKEN and err_lse <= TOL_FA_LSE
            and max(err_g) <= TOL_FA_GRAD):
        raise AssertionError(f"flash_attention ({name}) disagrees with its "
                             "plain version")
    if not timed:
        return {"fwd": dict(max_abs_err=abs_fwd),
                "bwd": dict(max_abs_err=abs_bwd)}

    # timings: kernels, plain version, and SDPA with the same mask
    mask = fa.attention_mask(seg)[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(*a):
        return F.scaled_dot_product_attention(*a, attn_mask=mask,
                                              enable_gqa=True)

    def bwd_timer(fwd):
        """ms of the backward alone, replayed on a retained graph."""
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fwd(*ins)
        g = dout if o.shape == dout.shape else dout.transpose(1, 2)
        return lambda: o.backward(g, retain_graph=True)

    res = {}
    ms_f = time_ms(lambda: fa.flash_attention_with_lse(q, k, v, seg),
                   timing_iters, device)
    ms_b = time_ms(bwd_timer(lambda *a: fa.flash_attention(*a, seg)),
                   timing_iters, device)
    # the backward's kernels one at a time, on the forward's outputs
    _, lse_k, ranges = fa._launch_fwd(q, k, v, seg)
    parts = {
        part: time_ms(lambda bit=bit: fa._launch_bwd(
            q, k, v, seg, ranges, out, lse_k, dout, parts=bit),
            timing_iters, device)
        for part, bit in fa.BWD_PARTS.items()
    }
    log(f"flash {name} bwd by kernel (ms per call): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f}")
    plain_f = time_ms(lambda: plain_flash(q, k, v, seg), 2, device)
    plain_fb = time_ms(lambda: plain_flash(q, k, v, seg, dout), 2, device)
    try:
        lib_f = time_ms(lambda: sdpa(qt, kt, vt), timing_iters, device)
        lib_b = time_ms(bwd_timer(lambda a, b, c: sdpa(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2))),
            timing_iters, device)
    except (torch.OutOfMemoryError, TypeError) as e:  # the yardstick only
        log(f"flash {name}: SDPA yardstick failed ({e}); library_ms null")
        lib_f = lib_b = None
    for kind, ms, plain_ms, lib_ms, err in (
        ("fwd", ms_f, plain_f, lib_f, abs_fwd),
        ("bwd", ms_b, max(plain_fb - plain_f, 0.0), lib_b, abs_bwd),
    ):
        t_bytes, t_ops = flash_bound(q, k, seg, kind == "bwd")
        bound_ms = max(t_bytes, t_ops)
        res[kind] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms,
            shape=f"B={B} T={T} Hq=12 Hkv=2 hd=128 bf16 segments "
                  f"{[list(r) for r in rows]}",
            **({"parts_ms": parts} if kind == "bwd" else {}),
        )
        log(f"flash {name} {kind}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{bound_ms:.5f} ms by {res[kind]['bound_by']} (bytes / 3.35 TB/s: "
            f"{t_bytes:.5f} ms; operations / 989 TFLOP/s: {t_ops:.5f} ms); "
            f"kernel at {bound_ms / ms:.3f} of its bound")
    log(f"flash {name}: plain backward ms = plain forward+backward "
        f"{plain_fb:.4f} ms less plain forward {plain_f:.4f} ms")
    return res


def flash_phase(device, layouts=FLASH_LAYOUTS, timing_iters=10):
    return {name: compare_flash(name, B, T, rows, device, timing_iters,
                                timed=name in FLASH_TIMED)
            for name, B, T, rows in layouts}


# ---------------------------------------------------------------------------
# the trainer: one async-PPO iteration
# ---------------------------------------------------------------------------


def rollout_sample(outs, seed):
    """The greedy wave's output as the trainer's rollout: prompt + output
    tokens, the prompt mask, the engine's logprobs as behaviour logprobs
    (0 on prompt transitions), a reward per sequence drawn from ``seed``,
    and the no-EOS flags."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    rng = np.random.default_rng(seed)
    seqs = [list(o.prompt_ids) + list(o.output_ids) for o in outs]
    data = dict(
        packed_input_ids=np.concatenate(seqs).astype(np.int32),
        prompt_mask=np.concatenate([
            np.r_[np.ones(len(o.prompt_ids), bool), np.zeros(len(o.output_ids), bool)]
            for o in outs]),
        packed_logprobs=np.concatenate([
            np.r_[np.zeros(len(o.prompt_ids) - 1), o.output_logprobs]
            for o in outs]).astype(np.float32),
        rewards=rng.standard_normal(len(outs)).astype(np.float32),
        seq_no_eos_mask=np.array([float(o.no_eos) for o in outs], np.float32),
    )
    return SequenceSample.from_default(
        [len(s) for s in seqs], [o.qid for o in outs], data)


def _response_gap(sample, logp):
    """(mean, max) |logp - behaviour logprob| over response transitions
    (those whose target token is not a prompt token)."""
    import numpy as np

    lens = [l[0] for l in sample.seqlens["packed_input_ids"]]
    starts = np.cumsum([0] + lens[:-1])
    pm = sample.data["prompt_mask"]
    resp = np.concatenate([~pm[s + 1:s + L] for s, L in zip(starts, lens)])
    d = np.abs(logp - sample.data["packed_logprobs"])[resp]
    return float(d.mean()), float(d.max())


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _device_profile(fn):
    """One call of ``fn`` under ``torch.profiler``, device activity only:
    (its result, device busy seconds, seconds in the flash kernels, the
    top device rows).  Tracing still slows the host, so the call's wall
    time is not a step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy, flash = device_seconds(prof, ("fa_", "seg_ranges_kernel"))
    top = top_device_rows(prof, 8)
    return out, busy, flash, top


def train_phase(cfg, master, serving0, device, outs, card, *, lr=TRAIN_LR,
                steps=TRAIN_STEPS, max_tokens_per_mb=MAX_TOKENS_PER_MB,
                serve_kw=None):
    """One async-PPO trainer iteration at the recipe's settings through
    ``PPOActorInterface``: actor_inf, then ``steps`` actor_train steps,
    with the flash kernels' launch counts set to 0 before and read after
    each; then the trained weights go back, through ``update_weights``, to
    a serving engine built on the version-0 serving weights ``serving0``.
    The trainer updates ``master`` in place."""
    import dataclasses

    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model_api import FinetuneSpec, Model
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.train_engine import TrainEngine, tree_leaves
    from areal_tpu_torch.interfaces.ppo_interface import (
        PPOActorInterface,
        model_logprobs_fwd,
    )
    from areal_tpu_torch.ops.flash_attention import flash_attention as fa
    from areal_tpu_torch.system.flops_counter import train_flops

    tcfg = dataclasses.replace(cfg, remat=True)
    sample = rollout_sample(outs, SEED + 5)
    lens = [l[0] for l in sample.seqlens["packed_input_ids"]]
    engine = TrainEngine(
        tcfg, None, master,
        OptimizerConfig(lr=lr, warmup_steps_proportion=0.0), 100,
        pack_sequences=True, device=device,
    )
    model = Model("actor", engine, ft_spec=FinetuneSpec(1, len(lens), len(lens)))
    iface = PPOActorInterface(**PPO_RECIPE)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=max_tokens_per_mb)
    L = cfg.n_layers
    log(f"train: rollout of {len(lens)} sequences, {sum(lens)} tokens "
        f"(lengths {lens}); TrainEngine float32 master weights + AdamW (lr "
        f"{lr}, no warm-up), remat, packing, {PPO_RECIPE}, "
        f"max_tokens_per_mb={max_tokens_per_mb}")

    # actor_inf: prox_logp at version 0
    fa.fwd_launches = fa.bwd_launches = 0
    tik = time.perf_counter()
    prox = iface.inference(model, sample, mb_spec)
    inf_s = time.perf_counter() - tik
    n_inf = engine.last_forward_mbs
    counts = (fa.fwd_launches, fa.bwd_launches)
    expected = (L * n_inf if device.type == "cuda" else 0, 0)
    log(f"train actor_inf: {n_inf} micro-batches in {inf_s:.2f} s; flash "
        f"launches fwd/bwd {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"actor_inf launched {counts}")
    mean, mx = _response_gap(sample, prox.data["prox_logp"])
    log(f"train check: version-0 |prox_logp - serving logprobs| over response "
        f"tokens: mean {mean:.3e} (tol {TOL_PROX_MEAN}), max {mx:.3e} (tol "
        f"{TOL_PROX_MAX})")
    if not (mean <= TOL_PROX_MEAN and mx <= TOL_PROX_MAX):
        raise AssertionError("trainer and serving logprobs disagree at version 0")
    # controls: faults of the trainer forward the gate must see, each read
    # against the same version-0 serving logprobs
    fwd = model_logprobs_fwd()
    controls = {
        "no RoPE (positions all 0)": lambda p, c, b: fwd(
            p, c, dict(b, positions=torch.zeros_like(b["positions"]))),
        "temperature 1.1": model_logprobs_fwd(1.1),
    }
    gaps = {name: _response_gap(sample, engine.forward_batch(
        sample, fn, mb_spec, output_shift=1)) for name, fn in controls.items()}
    sample.update_(prox)
    launches = dict(fwd=counts[0], bwd=counts[1])

    probe = [t for t in tree_leaves(engine.params) if t.dim() == 2][:4]
    before = [t.detach().to(torch.bfloat16).clone() for t in probe]
    step_stats = []
    cuda = device.type == "cuda"
    for step in range(steps):
        fa.fwd_launches = fa.bwd_launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        profiled = cuda and step == steps - 1 and steps > 1
        tik = time.perf_counter()
        if profiled:
            st, busy, flash_s, top = _device_profile(
                lambda: iface.train_step(model, sample, mb_spec))
        else:
            st = iface.train_step(model, sample, mb_spec)
            _sync(device)
        wall = time.perf_counter() - tik
        counts = (fa.fwd_launches, fa.bwd_launches)
        n = int(st["n_mbs"])
        # the kernels launch on CUDA tensors only (plain version on the CPU)
        expected = (2 * L * n, L * n) if cuda else (0, 0)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        finite = all(math.isfinite(st[k]) for k in ("loss", "grad_norm"))
        line = (f"train actor_train step {step + 1}: {n} micro-batches over "
                f"{PPO_RECIPE['n_minibatches']} minibatches, loss {st['loss']:.6e}, "
                f"grad_norm {st['grad_norm']:.6e}, clip frac "
                f"{st['actor_clip_frac']:.4e}, approx_kl {st['approx_kl']:.4e}, "
                f"entropy {st['entropy']:.4e}; flash launches fwd/bwd {counts}, "
                f"expected {expected}; wall {wall:.3f} s, peak memory "
                f"{peak:.2f} GiB, padding share of the last minibatch's "
                f"[B, T] slots {engine.last_padding_frac:.3f}")
        if profiled:
            # idle share against the previous (unprofiled) step's wall time:
            # the same work, without the profiler's host overhead
            line += (f"; profiled (wall not a step time): device busy "
                     f"{busy:.3f} s (idle share {1 - busy / step_stats[-1]['wall']:.3f} "
                     f"of step {step}'s wall), flash kernels {flash_s:.3f} s = "
                     f"{flash_s / busy:.3f} of device time")
        log(line)
        if profiled:
            for sec, calls, name in top:
                log(f"train step {step + 1} device time: {sec:.4f} s in {calls} "
                    f"calls of {name}")
        if counts != expected or not finite:
            raise AssertionError(f"train step {step + 1}: launches {counts} "
                                 f"(expected {expected}), finite {finite}")
        launches["fwd"] += counts[0]
        launches["bwd"] += counts[1]
        step_stats.append(dict(wall=wall, peak=peak, n_mbs=n,
                               **({"busy": busy, "flash": flash_s} if profiled else {})))
    moved = [float((t.detach().to(torch.bfloat16) != b).float().mean())
             for t, b in zip(probe, before)]
    log(f"train check: share of bf16-cast weights moved in {len(probe)} "
        f"matrices after {steps} steps: {[f'{m:.3f}' for m in moved]}")
    if not all(m > 0 for m in moved):
        raise AssertionError("training did not move the weights")
    gaps[f"weights {steps} steps on"] = _response_gap(
        sample, engine.forward_batch(sample, fwd, mb_spec, output_shift=1))
    timed = step_stats[1] if steps > 2 else step_stats[-1]
    tok_s = sum(lens) / timed["wall"]
    mfu = train_flops(tcfg, lens) / timed["wall"] / BF16_FLOPS
    log(f"train throughput on {card}: step {2 if steps > 2 else steps} "
        f"{timed['wall']:.3f} s, {tok_s:.1f} trained tokens/s, MFU {mfu:.4f} "
        f"(train_flops {train_flops(tcfg, lens):.4e} / step time / 989 "
        f"TFLOP/s), peak memory {timed['peak']:.2f} GiB; actor_inf "
        f"{sum(lens) / inf_s:.1f} tokens/s")

    # close the loop: the trained weights served, its logprobs recomputed
    eng = build_engine(cfg, serving0, device, SamplingParams(greedy=True),
                       **(serve_kw or {}))
    eng.update_weights(engine.params, version=steps)
    prompt = make_prompts(cfg.vocab_size, [300], SEED + 6)
    (o,), _ = serve(eng, requests(prompt, 32, "trained"))
    if o.version_start != steps:
        raise AssertionError("update_weights did not stamp the trained version")
    one = rollout_sample([o], SEED)
    logp = engine.forward_batch(one, model_logprobs_fwd(), mb_spec,
                                output_shift=1)
    mean2, mx2 = _response_gap(one, logp)
    log(f"train check: after update_weights, |trainer logprobs - serving "
        f"logprobs| over {len(o.output_ids)} generated tokens: mean "
        f"{mean2:.3e}, max {mx2:.3e} (tol {TOL_PROX_MEAN}, {TOL_PROX_MAX})")
    if not (mean2 <= TOL_PROX_MEAN and mx2 <= TOL_PROX_MAX):
        raise AssertionError("served trained weights disagree with the trainer")
    if eng.close():
        raise AssertionError("the trained-weights engine leaked pool blocks")
    for name, (cm, cx) in gaps.items():
        log(f"train control: trainer forward with {name} against the "
            f"version-0 serving logprobs: mean {cm:.3e}, max {cx:.3e} (the "
            f"gate fails it at mean > {TOL_PROX_MEAN} or max > {TOL_PROX_MAX})")
    unseen = [n for n, (cm, cx) in gaps.items()
              if cm <= TOL_PROX_MEAN and cx <= TOL_PROX_MAX]
    if unseen:
        raise AssertionError(f"the logprob gate does not see: {unseen}")
    return dict(launches=launches, step_s=timed["wall"], tok_s=tok_s, mfu=mfu,
                peak_gib=timed["peak"], steps=step_stats)


def _gap_gate(what, gap, tol_mean, tol_max):
    mean, mx = gap
    ok = mean <= tol_mean and mx <= tol_max
    log(f"long check: {what}: |trainer logprobs - serving logprobs| over "
        f"response tokens: mean {mean:.3e} (tol {tol_mean}), max {mx:.3e} "
        f"(tol {tol_max}){'' if ok else ' FAILS'}")
    return ok


def _first_divergence(a, b):
    """(agreeing positions, index of the first differing position or
    None) of two token lists."""
    same = sum(x == y for x, y in zip(a, b))
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if first is None and len(a) != len(b):
        first = min(len(a), len(b))
    return same, first


def long_context_phase(cfg, master, params, device, card, *,
                       prompt_lens=LONG_PROMPT_LENS, new_tokens=LONG_NEW_TOKENS,
                       arms=LONG_ARMS, max_batch=LONG_MAX_BATCH,
                       kv_cache_len=LONG_KV_CACHE_LEN, control_lens=None):
    """The recipe's serving configuration (``max_batch=16``,
    ``kv_cache_len=32768``) over a greedy wave of ``prompt_lens``, in the
    arms of ``arms``: A, a bf16 pool on the default dispatch table; B, the
    same with ``deep_min_context=8192``; C, an int8 pool with that table.
    In every arm: prefill and decode tokens/s, the pool's bytes, the
    kernels' launch counts against the dispatched work (counts set to 0
    just before the wave, read just after), zero leaked blocks, and the
    logprobs of the arm's tokens against the trainer forward of the
    version-0 master weights ``master`` on the same tokens.  Then a broken
    int8 arm (V dequantized at twice its scale) on a shorter wave, which
    the int8 gate must fail, and the tokens of B and C against A's."""
    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.engine.dispatch import resolve_dispatch_table
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.ppo_interface import model_logprobs_fwd
    from areal_tpu_torch.models import paged
    from areal_tpu_torch.ops.paged_attention import (
        paged_flash_attention as std,
    )
    from areal_tpu_torch.ops.paged_attention import (
        paged_flash_attention_deep as deep,
    )

    L = cfg.n_layers
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 11)
    # forward only: no optimizer state; the tree is shared, not copied
    trainer = TrainEngine(cfg, None, master, device=device)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=kv_cache_len)

    def gap_of(outs):
        sample = rollout_sample(outs, SEED)
        logp = trainer.forward_batch(sample, model_logprobs_fwd(), mb_spec,
                                     output_shift=1)
        return _response_gap(sample, logp)

    def engine(kv_dtype, deep_min):
        return build_engine(
            cfg, params, device, SamplingParams(greedy=True),
            max_batch=max_batch, kv_cache_len=kv_cache_len,
            kv_cache_dtype=kv_dtype,
            dispatch_table=resolve_dispatch_table(None, deep_min),
        )

    log(f"long: {len(prompts)} requests, prompts {list(prompt_lens)} "
        f"({sum(prompt_lens)} tokens), {new_tokens} new tokens each; "
        f"max_batch={max_batch}, kv_cache_len={kv_cache_len}, page "
        f"{PAGE_SIZE}, prefill chunk {PREFILL_CHUNK}, chunk {CHUNK_SIZE}, "
        f"pipeline depth {PIPELINE_DEPTH}")
    results = {}
    for name, kv_dtype, deep_min in arms:
        eng = engine(kv_dtype, deep_min)
        int8 = kv_dtype == "int8"
        pool_bytes = eng.kv_pool_bytes + eng.kv_scale_bytes
        pool_gib = pool_bytes / 2**30
        p0 = eng.prefill_tokens_total
        _, prefill_secs = serve(eng, requests(prompts, 1, f"{name}-first"))
        prefill_tps = (eng.prefill_tokens_total - p0) / prefill_secs

        f0, d0 = eng.prefill_calls, eng.decode_chunks_total
        dd0, t0 = eng.deep_decode_chunks_total, eng.decode_tokens_total
        for fn in (std, deep):
            fn.launches = fn.int8_launches = 0
        std.prefill_launches = 0
        outs, secs = serve(eng, requests(prompts, new_tokens, f"{name}-greedy"))
        counts = {f"{fn.__name__}.{k}": getattr(fn, k)
                  for fn in (std, deep) for k in ("launches", "int8_launches")}
        counts[f"{std.__name__}.prefill_launches"] = std.prefill_launches
        fills = eng.prefill_calls - f0
        chunks = eng.decode_chunks_total - d0
        deep_chunks = eng.deep_decode_chunks_total - dd0
        dec_tok = eng.decode_tokens_total - t0
        decode_tps = dec_tok / (secs - prefill_secs)
        check_outputs(outs, cfg, new_tokens, f"long {name}")
        key = "int8_launches" if int8 else "launches"
        other = "launches" if int8 else "int8_launches"
        got_std, got_deep = getattr(std, key), getattr(deep, key)
        want_std = L * (fills + eng.chunk_size * (chunks - deep_chunks))
        want_deep = L * eng.chunk_size * deep_chunks
        log(f"long {name} ({kv_dtype} pool, {pool_bytes} bytes = "
            f"{pool_gib:.2f} GiB, "
            f"deep_min_context={eng.dispatch_table.deep_min_context}): "
            f"{sum(len(o.output_ids) for o in outs)} new tokens in {secs:.2f} s; "
            f"{fills} fill chunks, {chunks} decode chunks ({deep_chunks} deep); "
            f"launches {counts}; expected standard {want_std} ({L * fills} "
            f"on the prefill entry), deep {want_deep}")
        log(f"long {name} throughput on {card}: prefill {prefill_tps:.1f} "
            f"tok/s (first-token wave, {prefill_secs:.2f} s), decode "
            f"{decode_tps:.1f} tok/s ({dec_tok} decode-chunk tokens)")
        decode_launches = (got_std - L * fills) + got_deep
        if (got_std != want_std or got_deep != want_deep
                or decode_launches != L * eng.chunk_size * chunks
                or getattr(std, other) or getattr(deep, other)
                or got_std == 0 or std.prefill_launches != L * fills):
            raise AssertionError(f"long {name}: kernel launches {counts} do "
                                 f"not match the dispatched work")
        if (deep_chunks > 0) != (deep_min is not None):
            raise AssertionError(f"long {name}: {deep_chunks} deep decode "
                                 "chunks")
        if deep_chunks:
            q_like = torch.empty((), dtype=getattr(torch, cfg.dtype))
            log(f"long {name}: its {deep_chunks} deep decode chunks ran the "
                f"{deep_route(q_like, eng.k_pool[0], eng.k_scale)}")
        leaked = eng.close()
        if leaked or eng.free_pool_blocks != eng.n_blocks:
            raise AssertionError(f"long {name}: leaked pool blocks {leaked}")
        del eng
        torch.cuda.empty_cache()
        gap = gap_of(outs)
        tol = (TOL_INT8_MEAN, TOL_INT8_MAX) if int8 else (
            TOL_PROX_MEAN, TOL_PROX_MAX)
        if not _gap_gate(f"arm {name}", gap, *tol):
            raise AssertionError(f"long {name}: serving and trainer "
                                 "logprobs disagree")
        results[name] = dict(
            outs=outs, prefill_tps=prefill_tps, decode_tps=decode_tps,
            gap=gap, pool_bytes=pool_bytes, fills=fills, chunks=chunks,
            deep_chunks=deep_chunks,
            launches=dict(std=got_std, deep=got_deep,
                          prefill=std.prefill_launches),
            int8=int8, secs=secs, prefill_secs=prefill_secs,
        )
        log(f"long {name}: leak check and logprob gate pass; done at "
            f"{secs + prefill_secs:.1f} s of serving")

    # the broken control: an int8 arm whose reads dequantize V at twice
    # its scale, on a shorter wave
    control = LONG_CONTROL_LENS if control_lens is None else control_lens
    real = paged._prefix_partials

    def broken(q, k_pool, v_pool, tables, lengths, layer, deep=False,
               k_scale=None, v_scale=None):
        return real(q, k_pool, v_pool, tables, lengths, layer, deep=deep,
                    k_scale=k_scale, v_scale=v_scale * 2)

    eng = engine("int8", DEEP_MIN_CONTEXT)
    paged._prefix_partials = broken
    try:
        bad, _ = serve(eng, requests(
            make_prompts(cfg.vocab_size, control, SEED + 12), 32, "control"))
    finally:
        paged._prefix_partials = real
    if eng.close():
        raise AssertionError("the control engine leaked pool blocks")
    del eng
    torch.cuda.empty_cache()
    cgap = gap_of(bad)
    if _gap_gate(f"control (int8 pool, V dequantized at 2x its scale, "
                 f"prompts {control})", cgap, TOL_INT8_MEAN, TOL_INT8_MAX):
        raise AssertionError("the int8 logprob gate does not see V scales "
                             "off by 2x")
    results["control_gap"] = cgap

    if "A" in results:
        ref = results["A"]["outs"]
        for name in ("B", "C"):
            if name not in results:
                continue
            pairs = [_first_divergence(a.output_ids, b.output_ids)
                     for a, b in zip(ref, results[name]["outs"])]
            agree = sum(s for s, _ in pairs)
            total = sum(len(a.output_ids) for a in ref)
            firsts = [f for _, f in pairs]
            log(f"long check: arm {name} agrees with arm A at {agree} of "
                f"{total} token positions; {sum(f is None for f in firsts)} "
                f"of {len(firsts)} streams identical; first divergence per "
                f"request {firsts}")
            results[name]["agree"] = (agree, total, firsts)
    return results


def parent_ab(parent: str):
    """The paged kernels' decode calls (the decode entry, the deep kernel
    on both pools, ``flash_decode``) and the flash-attention forward of the
    parent tree at ``parent`` and of this tree, timed in turns (parent,
    change, change, parent), each side by
    ``areal_tpu_torch/tools/kernel_ab.py`` in its own process from its
    tree's root; prints each side's ``AB`` line."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    tool = here / "areal_tpu_torch" / "tools" / "kernel_ab.py"
    for tag in ("parent", "change", "change", "parent"):
        tik = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(tool), tag],
            cwd=str(Path(parent).resolve() if tag == "parent" else here),
            capture_output=True, text=True, timeout=600,
        )
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode != 0 or not lines:
            raise AssertionError(f"kernel_ab.py ({tag}) failed:\n"
                                 f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
        log(f"{lines[-1]} ({time.perf_counter() - tik:.1f} s with its build)")


def main() -> int:
    parent = None
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent = sys.argv[2]
    elif len(sys.argv) != 1:
        print("usage: chip_smoke.py [--parent PATH]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a card", file=sys.stderr)
        return 2
    try:
        from areal_tpu_torch.models.config import qwen25_15b_config
        from areal_tpu_torch.models.convert import serving_params
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is not importable "
              f"({e}); run from the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t_start = tik = time.perf_counter()
    libs = _build.load_libraries(
        "paged_attention", "paged_attention_deep", "flash_attention")
    log(f"build: {len(libs)} libraries in {time.perf_counter() - tik:.1f} s "
        f"(nvcc in parallel, with loading)")
    for lib in libs.values():
        log(f"build: {lib.path.name}: {lib.build_seconds:.1f} s of nvcc")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build: {line.strip()}")

    kern = kernel_phase(device)
    decode_dtype_checks(device)
    long_kern = long_kernel_phase(device)
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    cfg = qwen25_15b_config()
    tik = time.perf_counter()
    master = init_params(cfg, SEED, device, dtype=torch.float32)
    params = serving_params(master, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: Qwen2.5-1.5B architecture, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (random, seed {SEED}; float32 "
        f"master weights and their bf16 serving copy), built in "
        f"{time.perf_counter() - tik:.1f} s")
    eng = engine_phase(cfg, params, device, card=card)
    sampled_phase(cfg, params, device)
    chunked_prefill_phase(cfg, params, device)
    anatomy_phase(cfg, params, device)
    log(f"serving phases done at {time.perf_counter() - t_start:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    long = long_context_phase(cfg, master, params, device, card)
    log(f"long-context phase done at {time.perf_counter() - t_start:.1f} s; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    flash = flash_phase(device)
    log(f"flash phase done at {time.perf_counter() - t_start:.1f} s")
    train = train_phase(cfg, master, params, device, eng["outs"], card)
    log(f"train phase done at {time.perf_counter() - t_start:.1f} s")

    entries = kernel_entries(kern, long_kern, eng, long, flash, train)
    if parent is not None:
        del eng, long, master, params
        torch.cuda.empty_cache()
        parent_ab(parent)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def kernel_entries(kern, long_kern, eng, long, flash, train):
    """The ``{"kernels": [...]}`` line's entries: every kernel, with its
    launches on the main paths (the engine's greedy wave and the
    long-context arms; the trainer's steps for the flash kernels), its
    comparison's largest absolute error, and its time, plain time and
    bound at its main-path shape."""
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "shape")

    def entry(name, source, replaces, launches, err, main, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    library_ms=main.get("library_ms"),
                    **{k: main[k] for k in timed}, **extra)

    paged_src = "areal_tpu_torch/csrc/paged_attention.cu"
    deep_src = "areal_tpu_torch/csrc/paged_attention_deep.cu"
    paged_ref = "areal_tpu/ops/paged_attention.py:201"
    deep_ref = "areal_tpu/ops/paged_attention.py:463"

    def arm_launches(kind, int8):
        return sum(r["launches"][kind] for k, r in long.items()
                   if k in ("A", "B", "C") and r["int8"] == int8)

    def errs(*keys, src=kern):
        return max(src[k]["max_abs_err"] for k in keys)

    entries = [
        entry("paged_flash_attention", paged_src, paged_ref,
              eng["launches"] + arm_launches("std", False),
              max(errs("decode", "prefill", "prefill_long"),
                  errs("standard_bf16", src=long_kern)),
              kern["decode"],
              launches_by_path=dict(engine_wave=eng["launches"],
                                    long_context=arm_launches("std", False)),
              prefill_entry_launches=(eng["prefill_launches"]
                                      + arm_launches("prefill", False)),
              prefill={k: kern["prefill"][k] for k in timed},
              prefill_long={k: kern["prefill_long"][k] for k in timed},
              long_decode={k: long_kern["standard_bf16"][k] for k in timed}),
        entry("paged_flash_attention_int8", paged_src,
              "areal_tpu/ops/paged_attention.py:116",
              arm_launches("std", True),
              max(errs("int8_decode", "int8_prefill", "int8_prefill_long"),
                  errs("standard_int8", src=long_kern)),
              long_kern["standard_int8"],
              prefill_entry_launches=arm_launches("prefill", True),
              decode={k: kern["int8_decode"][k] for k in timed},
              prefill={k: kern["int8_prefill"][k] for k in timed},
              prefill_long={k: kern["int8_prefill_long"][k] for k in timed}),
        entry("paged_flash_attention_deep", deep_src, deep_ref,
              arm_launches("deep", False),
              max(errs("deep_prefill", "deep_decode"),
                  errs("deep_bf16", src=long_kern)),
              long_kern["deep_bf16"],
              decode={k: kern["deep_decode"][k] for k in timed},
              prefill={k: kern["deep_prefill"][k] for k in timed}),
        entry("paged_flash_attention_deep_int8", deep_src, deep_ref,
              arm_launches("deep", True),
              max(errs("deep_int8_prefill", "deep_int8_decode"),
                  errs("deep_int8", src=long_kern)),
              long_kern["deep_int8"],
              decode={k: kern["deep_int8_decode"][k] for k in timed},
              prefill={k: kern["deep_int8_prefill"][k] for k in timed}),
        entry("flash_decode", deep_src, "areal_tpu/ops/decode_attention.py:150",
              0, long_kern["flash_decode"]["max_abs_err"],
              long_kern["flash_decode"],
              note="on no path: compared and timed only; library_ms is "
                   "scaled_dot_product_attention on the same full rows"),
    ]
    for kind in ("fwd", "bwd"):
        main_shape, long_shape = flash["packed"][kind], flash["long"][kind]
        entries.append(dict(
            name=f"flash_attention_{kind}",
            route="cuda",
            source="areal_tpu_torch/csrc/flash_attention.cu",
            replaces="areal_tpu/ops/flash_attention.py:36",
            launches=train["launches"][kind],
            max_abs_err=max(r[kind]["max_abs_err"] for r in flash.values()),
            **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "shape")},
            long={k: long_shape[k] for k in ("shape", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
            **({"parts_ms": main_shape["parts_ms"],
                "long_parts_ms": long_shape["parts_ms"]}
               if kind == "bwd" else {}),
        ))
    return entries


def _perturbed(params, seed):
    """``params`` with every layer's MLP output projection moved by noise of
    its own scale (the other leaves are shared, not copied)."""
    import torch

    out = dict(params, layers=[])
    for lp in params["layers"]:
        w = lp["mlp"]["down"]["w"]
        g = torch.Generator(device=w.device)
        g.manual_seed(seed)
        noise = torch.randn(w.shape, generator=g, device=w.device)
        down = dict(lp["mlp"]["down"], w=(w.float() + noise * w.float().std()).to(w.dtype))
        out["layers"].append(dict(lp, mlp=dict(lp["mlp"], down=down)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
