"""One side of a parent-vs-change comparison of the paged kernels' decode
calls (the standard kernel's decode entry, the deep kernel and
``flash_decode``) and the flash-attention forward on one CUDA card.

Run it from the root of the tree under test, which supplies
``areal_tpu_torch``; the script itself may come from another checkout
(it imports nothing else of the tree than the kernels' wrappers, which
keep their interface), so one copy measures both trees::

    cd PARENT_TREE && python3 /path/to/areal_tpu_torch/tools/kernel_ab.py parent
    cd CHANGED_TREE && python3 areal_tpu_torch/tools/kernel_ab.py change

Run the sides in turns in one run on one card (parent, change, change,
parent).  It prints one ``AB {...}`` JSON line of device milliseconds per
call (CUDA events), and a digest of one call's result at the 8-row
decode shape per kernel and pool (equal digests: bit-identical results):

* the decode entry (``paged_flash_attention`` with one query token per
  row) and the deep kernel (``paged_flash_attention_deep``) at
  ``chip_smoke.py``'s 8-row shape (lengths 0, 1, 255, 256, 257, 4096,
  1365, 3072 over a 16-page table of 256-token pages; Hq 12, Hkv 2, hd
  128) and at 16 full rows of 32768 tokens, bf16 and int8 pools, and
  ``flash_decode`` over a contiguous bf16 cache of 16 full rows of 32768
  tokens.  The timed calls cycle over enough pool layers that the bytes
  they read between two calls on one layer exceed twice the card's L2, so
  every call finds its cache traffic in device memory, as a decode step
  does;
* the flash-attention forward at ``chip_smoke.py``'s packed (B=2,
  T=4096) and long (T=16384) layouts.

:func:`time_ms` and :func:`cold_layers` are also ``chip_smoke.py``'s
timing.
"""

import json
import math
import os
import sys
import time

#: the H100's L2 cache (NVIDIA's data sheet)
L2_BYTES = 50e6
#: GPU clock cycles the timing loop holds the stream for (~0.1 s at the
#: H100's ~1.98 GHz boost clock; the timed calls enqueue in far less)
SLEEP_CYCLES = 200_000_000
PAGE_SIZE = 256
#: the 8-row decode shape: a 4096-token table and lengths that cross page
#: boundaries (chip_smoke.py's kernel phase)
DECODE_LENGTHS = (0, 1, 255, 256, 257, 4096, 1365, 3072)
DECODE_MB = 16
LONG_ROWS, LONG_MB = 16, 128
#: (name, B, T, segment lengths per row): chip_smoke.py's timed layouts
FLASH_LAYOUTS = (("packed", 2, 4096, ((1000, 2000, 1096), (3128,))),
                 ("long", 1, 16384, ((16384,),)))


def time_ms(fn, iters: int, device) -> float:
    """Mean device milliseconds per call of ``fn`` (warmed up; CUDA
    events).  The stream is first held by a sleep kernel long enough for
    the host to enqueue every call, so the events time the device work
    back to back, without the host's launch gaps between calls.  On a
    CPU device, host milliseconds."""
    import torch

    fn()
    if device.type != "cuda":
        tik = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - tik) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def touched_bytes(lengths, Hkv: int, hd: int, pool_item: int,
                  scale_item: int = 0) -> int:
    """Bytes of pool one call reads: the valid K and V rows (and their
    scales) of every row."""
    return sum(max(0, int(n)) for n in lengths) * Hkv * 2 * (
        hd * pool_item + scale_item)


def cold_layers(touched: int) -> int:
    """Pool layers to cycle over so that the bytes read between two calls
    on one layer exceed twice the L2 cache."""
    return math.ceil(2 * L2_BYTES / max(touched, 1)) + 1


def decode_inputs(B, MB, lengths, int8, n_layers, device, seed=0, Hq=12,
                  Hkv=2, hd=128, BS=PAGE_SIZE):
    """q [B,1,Hq,hd] bf16 and bf16 (or int8, with f32 scales) pools of
    ``n_layers`` layers [L, B*MB, Hkv, BS, hd] behind a scrambled table:
    (q, k_pool, v_pool, k_scale, v_scale, tables, lengths)."""
    import torch

    from areal_tpu_torch.models.paged import quantize_kv

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    NB = B * MB
    q = torch.randn((B, 1, Hq, hd), generator=g, device=device).to(torch.bfloat16)
    pools, scales = [], []
    for _ in range(2):
        shape = (n_layers, NB, Hkv, BS, hd)
        pool = torch.empty(shape, dtype=torch.int8 if int8 else torch.bfloat16,
                           device=device)
        sc = torch.empty(shape[:-1], device=device) if int8 else None
        for i in range(n_layers):  # one layer at a time: bounded temporaries
            x = torch.randn(shape[1:], generator=g, device=device)
            if int8:
                pool[i], sc[i] = quantize_kv(x.to(torch.bfloat16))
            else:
                pool[i] = x
        pools.append(pool)
        scales.append(sc)
    perm = torch.randperm(NB, generator=g, device=device)
    tables = perm.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (q, pools[0], pools[1], scales[0], scales[1], tables, lens)


def cycling(fn, inputs):
    """A call of ``fn`` on the next pool layer of ``inputs`` at each call."""
    q, kp, vp, ks, vs, tables, lens = inputs
    layer = [0]

    def run():
        i = layer[0] = (layer[0] + 1) % kp.shape[0]
        sc = () if ks is None else (ks[i], vs[i])
        return fn(q, kp[i], vp[i], tables, lens, *sc)

    return run


def digest(tensors) -> str:
    """A short hash of the tensors' bytes: equal digests from two trees
    mean bit-identical results."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def decode_ms(B, MB, lengths, int8, device, iters=20, deep=False):
    """L2-cold milliseconds per call at one decode shape of the standard
    kernel (its decode entry) or, with ``deep``, the deep kernel, and the
    digest of one call's (acc, m, l)."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    fn = pa.paged_flash_attention_deep if deep else pa.paged_flash_attention
    n = cold_layers(touched_bytes(lengths, 2, 128, 1 if int8 else 2,
                                  4 if int8 else 0))
    inputs = decode_inputs(B, MB, lengths, int8, n, device)
    run = cycling(fn, inputs)
    ms = time_ms(run, iters, device)
    out = digest(run())
    del inputs
    torch.cuda.empty_cache()
    return ms, n, out


def flash_decode_ms(B, S, device, iters=10, Hq=12, Hkv=2, hd=128):
    """``flash_decode``'s L2-cold milliseconds per call over B full rows of
    a contiguous bf16 cache [B, Hkv, S, hd]."""
    import torch

    from areal_tpu_torch.ops.decode_attention import flash_decode

    n = cold_layers(touched_bytes((S,) * B, Hkv, hd, 2))
    g = torch.Generator(device=device)
    g.manual_seed(0)
    q = torch.randn((B, Hq, hd), generator=g, device=device).to(torch.bfloat16)
    k, v = (torch.randn((n, B, Hkv, S, hd), generator=g, device=device)
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.full((B,), S, dtype=torch.int32, device=device)
    layer = [0]

    def run():
        i = layer[0] = (layer[0] + 1) % n
        return flash_decode(q, k[i], v[i], lens)

    ms = time_ms(run, iters, device)
    del k, v
    torch.cuda.empty_cache()
    return ms


def flash_fwd_ms(B, T, rows, device, iters=10, Hq=12, Hkv=2, hd=128):
    """The flash-attention forward's milliseconds per call on one layout."""
    import torch

    from areal_tpu_torch.ops.flash_attention import flash_attention_with_lse

    g = torch.Generator(device=device)
    g.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    seg = torch.zeros((B, T), dtype=torch.int32)
    for b, lens in enumerate(rows):
        c = 0
        for i, n in enumerate(lens):
            seg[b, c:c + n] = i + 1
            c += n
    q, k, v, seg = rnd(B, T, Hq, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd), seg.to(device)
    return time_ms(lambda: flash_attention_with_lse(q, k, v, seg), iters, device)


def card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(tag: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    res = dict(tree=tag, card=card_line())
    long_lens = (LONG_MB * PAGE_SIZE,) * LONG_ROWS
    for int8 in (False, True):
        pool = "int8" if int8 else "bf16"
        for kind in ("decode", "deep"):
            (res[f"{kind}_{pool}_ms"], res[f"{kind}_{pool}_layers"],
             res[f"{kind}_{pool}_digest"]) = decode_ms(
                len(DECODE_LENGTHS), DECODE_MB, DECODE_LENGTHS, int8, dev,
                deep=kind == "deep")
            res[f"{kind}_16x32768_{pool}_ms"], _, _ = decode_ms(
                LONG_ROWS, LONG_MB, long_lens, int8, dev, iters=10,
                deep=kind == "deep")
    res["flash_decode_16x32768_ms"] = flash_decode_ms(
        LONG_ROWS, LONG_MB * PAGE_SIZE, dev)
    for name, B, T, rows in FLASH_LAYOUTS:
        res[f"flash_fwd_{name}_ms"] = flash_fwd_ms(B, T, rows, dev)
    print("AB " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
