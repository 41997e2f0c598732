"""One side of a parent-vs-change comparison of chunked prefill and of the
serving engine on one CUDA card, at the full Qwen2.5-1.5B width and depth
(random weights).

Run it from the root of the tree under test, which supplies
``areal_tpu_torch`` and ``chip_smoke.py``; the script itself may come
from another checkout, so one copy measures both trees::

    cd PARENT_TREE && python3 /path/to/areal_tpu_torch/tools/prefill_ab.py parent
    cd CHANGED_TREE && python3 areal_tpu_torch/tools/prefill_ab.py change

Run the sides in turns in one run on one card (parent, change,
change, parent).  It prints one ``AB {...}`` JSON line: the wall times of
three 512-token prefill chunks of one row after a 31000-token cached
prefix, the device busy time of a fourth and its paged kernel's share
(``torch.profiler``), the first-token prefill rate of the async-PPO
recipe's long wave (16 rows of 32768-token KV; ``chip_smoke``'s
``LONG_PROMPT_LENS``, arm A's settings), and the engine wave's prefill
and decode rates as ``chip_smoke``'s ``engine_phase`` measures them (8
rows, ``PROMPT_LENS``, ``NEW_TOKENS``; a first-token wave, then a greedy
wave whose decode time is its wall time less the first-token wave's).
"""

import json
import os
import sys
import time

PREFIX = 31000
CHUNK = 512


def main(tag: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.models import paged
    from areal_tpu_torch.models.config import qwen25_15b_config
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.transformer import init_params

    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = qwen25_15b_config()
    params = serving_params(init_params(cfg, c.SEED, dev, dtype=torch.float32),
                            cfg)

    # one row's prefill chunk after a long prefix, over a random pool
    MB = c.LONG_KV_CACHE_LEN // c.PAGE_SIZE
    kp, vp, _, _ = paged.alloc_kv_pool(cfg, MB, c.PAGE_SIZE, dev)
    kp.normal_()
    vp.normal_()
    i32 = dict(dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, CHUNK), **i32)

    def fill():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([PREFIX], **i32),
            torch.tensor([CHUNK], **i32), torch.arange(MB, **i32)[None])

    fill()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        tik = time.perf_counter()
        fill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tik) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fill()
        torch.cuda.synchronize()
    busy, kern = c.device_seconds(
        prof, ("paged_decode_kernel", "paged_prefill_kernel",
               "combine_splits_kernel"))
    del kp, vp
    torch.cuda.empty_cache()

    # the long wave's first-token prefill rate
    eng = c.build_engine(cfg, params, dev, SamplingParams(greedy=True),
                         max_batch=c.LONG_MAX_BATCH,
                         kv_cache_len=c.LONG_KV_CACHE_LEN)
    prompts = c.make_prompts(cfg.vocab_size, c.LONG_PROMPT_LENS, c.SEED + 11)
    c.serve(eng, c.requests([p[:600] for p in prompts[:2]], 1, "warm"))
    p0 = eng.prefill_tokens_total
    _, secs = c.serve(eng, c.requests(prompts, 1, "first"))
    tps = (eng.prefill_tokens_total - p0) / secs
    eng.close()
    del eng
    torch.cuda.empty_cache()

    # the engine wave (chip_smoke's engine_phase)
    eng = c.build_engine(cfg, params, dev, SamplingParams(greedy=True))
    prompts = c.make_prompts(cfg.vocab_size, c.PROMPT_LENS, c.SEED)
    c.serve(eng, c.requests([p[:64] for p in prompts[:2]], 4, "warm"))
    p0 = eng.prefill_tokens_total
    _, first_s = c.serve(eng, c.requests(prompts, 1, "prefill"))
    wave_prefill = (eng.prefill_tokens_total - p0) / first_s
    t0 = eng.decode_tokens_total
    _, wave_s = c.serve(eng, c.requests(prompts, c.NEW_TOKENS, "greedy"))
    wave_decode = (eng.decode_tokens_total - t0) / (wave_s - first_s)
    print("AB " + json.dumps(dict(
        tree=tag, card=c.card_line(), fill_wall_ms=walls,
        fill_device_busy_ms=busy * 1e3, fill_paged_kernel_ms=kern * 1e3,
        long_first_token_wave_s=secs, long_prefill_tok_s=tps,
        engine_prefill_tok_s=wave_prefill,
        engine_decode_tok_s=wave_decode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
