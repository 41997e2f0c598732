"""One side of a parent-vs-change comparison of the serving engine's wall
times on one CUDA card, with the SLO records off and, where the tree
accepts them, on; at the full Qwen2.5-1.5B width and depth (random
weights).

Run it from the root of the tree under test, which supplies
``areal_tpu_torch`` and ``chip_smoke.py``; the script itself may come
from another checkout, so one copy measures both trees::

    cd PARENT_TREE && python3 /path/to/areal_tpu_torch/tools/engine_ab.py parent
    cd CHANGED_TREE && python3 areal_tpu_torch/tools/engine_ab.py change

Run the sides in turns in one run on one card (parent, change, change,
parent); a third argument ``reverse`` measures SLO on before off.  For
each setting it times, as ``chip_smoke.py`` does, the engine wave
(``engine_phase``: 8 rows, ``PROMPT_LENS``, a first-token wave, then a
greedy wave of ``NEW_TOKENS``), the prefix phase's group wave (16
requests over one 1000-token prompt, temperature 1, 64 new tokens) and
its pressure arm (16 prompts of 1024-3000 tokens, 256 new tokens, a
quarter of the pool), each on a fresh engine.  It prints one
``AB {...}`` JSON line; a setting the tree refuses is null.
"""

import json
import os
import sys


def main(tag: str, reverse: bool) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.models.config import qwen25_15b_config
    from areal_tpu_torch.models.convert import serving_params
    from areal_tpu_torch.models.transformer import init_params

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = qwen25_15b_config()
    params = serving_params(init_params(cfg, c.SEED, dev, dtype=torch.float32),
                            cfg)
    greedy = SamplingParams(greedy=True)
    keyed = SamplingParams(temperature=1.0)
    wave_prompts = c.make_prompts(cfg.vocab_size, c.PROMPT_LENS, c.SEED)

    def fresh(sampling, **kw):
        torch.cuda.empty_cache()
        return c.build_engine(cfg, params, dev, sampling, **kw)

    # builds the kernels and warms the allocator
    eng = fresh(greedy, slo_tracking=False)
    c.serve(eng, c.requests([p[:64] for p in wave_prompts[:2]], 4, "warm"))
    del eng

    def measure(slo: bool):
        try:
            eng = fresh(greedy, slo_tracking=slo)
        except NotImplementedError:
            return None
        out = {}
        _, first_s = c.serve(eng, c.requests(wave_prompts, 1, "prefill"))
        t0 = eng.decode_tokens_total
        _, wave_s = c.serve(eng, c.requests(wave_prompts, c.NEW_TOKENS,
                                            "greedy"))
        out.update(engine_first_token_wave_s=first_s, engine_wave_s=wave_s,
                   engine_decode_tok_s=(eng.decode_tokens_total - t0)
                   / (wave_s - first_s))
        del eng
        eng = fresh(keyed, max_batch=c.LONG_MAX_BATCH,
                    kv_cache_len=c.LONG_KV_CACHE_LEN, prefix_cache=True,
                    slo_tracking=slo)
        prompt = c.make_prompts(cfg.vocab_size, [c.PREFIX_PROMPT],
                                c.SEED + 31)[0]
        _, out["group_wave_s"] = c.serve(eng, c.requests(
            [prompt] * c.PREFIX_GROUP, c.PREFIX_NEW_TOKENS, "g"))
        del eng
        eng = fresh(keyed, max_batch=c.LONG_MAX_BATCH,
                    kv_cache_len=c.PRESSURE_KV_CACHE_LEN,
                    kv_pool_tokens=c.PRESSURE_POOL_TOKENS, prefix_cache=True,
                    slo_tracking=slo)
        prompts = c.make_prompts(cfg.vocab_size, c.PRESSURE_PROMPT_LENS,
                                 c.SEED + 34)
        _, out["pressure_s"] = c.serve(eng, c.requests(
            prompts, c.PRESSURE_NEW_TOKENS, "pressure"))
        out["pressure_preempted"] = eng.preempted_total
        return out

    res = {}
    for slo in ((True, False) if reverse else (False, True)):
        res["slo_on" if slo else "slo_off"] = measure(slo)
    print("AB " + json.dumps(dict(tree=tag, card=c.card_line(),
                                  order="on, off" if reverse else "off, on",
                                  **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree",
                  len(sys.argv) > 2 and sys.argv[2] == "reverse"))
