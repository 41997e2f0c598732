"""One side of a parent-vs-change measurement of the flash-attention
kernels at head_dim 128: the forward, the backward and each of the
backward's kernels (D, dq, dk/dv, reduce) on chip_smoke.py's packed (B=2,
T=4096) and long (T=16384) layouts at Qwen2.5-1.5B's heads (12 query, 2
KV), with CUDA events around 20 calls behind a sleep kernel.

It measures the tree in the working directory (imported from there, its
kernels built from its own sources), so one copy of this file serves both
trees::

    cd PARENT && python3 /path/to/change/areal_tpu_torch/tools/flash_ab.py parent
    cd CHANGE && python3 areal_tpu_torch/tools/flash_ab.py change

Run the two in turns (parent, change, change, parent) in one call on one
card.  It prints one line ``FLASHAB {json}`` with the card's name and
power limit.  Card only.
"""

import json
import os
import subprocess
import sys

LAYOUTS = (("packed", 2, 4096, ((1000, 2000, 1096), (3128,))),
           ("long", 1, 16384, ((16384,),)))
HQ, HKV, HD = 12, 2, 128
ITERS = 20
SLEEP_CYCLES = 50_000_000


def _time_ms(fn, iters):
    import torch

    fn()
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


def main(tag: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from areal_tpu_torch.ops import _build
    from areal_tpu_torch.ops import flash_attention as fa

    _build.load_library("flash_attention")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    res = dict(tag=tag, tree=os.getcwd(), card=card)
    for name, B, T, rows in LAYOUTS:
        g = torch.Generator(device=dev)
        g.manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

        seg = torch.zeros((B, T), dtype=torch.int32)
        for b, lens in enumerate(rows):
            c = 0
            for i, n in enumerate(lens):
                seg[b, c:c + n] = i + 1
                c += n
        seg = seg.to(dev)
        q, k, v, dout = (rnd(B, T, HQ, HD), rnd(B, T, HKV, HD),
                         rnd(B, T, HKV, HD), rnd(B, T, HQ, HD))
        out, lse, ranges = fa._launch_fwd(q, k, v, seg)
        res[f"{name}_fwd_ms"] = _time_ms(lambda: fa._launch_fwd(q, k, v, seg),
                                         ITERS)
        res[f"{name}_bwd_ms"] = _time_ms(lambda: fa._launch_bwd(
            q, k, v, seg, ranges, out, lse, dout), ITERS)
        for part, bit in fa.BWD_PARTS.items():
            res[f"{name}_bwd_{part}_ms"] = _time_ms(
                lambda bit=bit: fa._launch_bwd(q, k, v, seg, ranges, out, lse,
                                               dout, parts=bit), ITERS)
    print("FLASHAB " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
