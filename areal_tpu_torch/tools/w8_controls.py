"""Measure what ``chip_smoke.py``'s two int8-weight gates can see, on one
card, at the full Qwen2.5-1.5B width on its first ``CUT_LAYERS`` layers.

Run from the repository root::

    python3 areal_tpu_torch/tools/w8_controls.py

It builds the kernel libraries, writes and reloads the seeded weights'
first ``CUT_LAYERS`` layers as the serving-features phase does, serves the
phase's greedy wave on a bf16 engine, and reads the teacher-forced
logprobs of those tokens under the int8 serving tree and under broken
copies of it: every scale k/127 too large or too small, a quarter and a
tenth too large, one scale a matrix (its largest) for every channel, and
the scales in reversed channel order.  For each tree it prints the drift
gate's reading (|gap| to the bf16 forward, mean and max, against
``TOL_W8_MEAN``/``TOL_W8_MAX``) and the dequantization gate's (|gap| to
the forward over the weights numpy dequantized on the host, which the
sound tree must meet bit for bit).  It exits 2 without a card.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.engine.sampling import SamplingParams  # noqa: E402
from areal_tpu_torch.models.config import qwen25_15b_config  # noqa: E402
from areal_tpu_torch.models.convert import serving_params  # noqa: E402
from areal_tpu_torch.models.hf.registry import load_hf_model  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402
from areal_tpu_torch.ops import _build  # noqa: E402


def controls(tree):
    """(name, broken copy of the int8 serving ``tree``) pairs."""
    out = [(f"scales x (1 + {k}/127)", cs._scales_times(tree, 1 + k / 127))
           for k in (1, 2, 4, 8)]
    out += [("scales x 127/128", cs._scales_times(tree, 127 / 128)),
            ("scales x 1.1", cs._scales_times(tree, 1.1)),
            ("scales x 1.25", cs._scales_times(tree, 1.25))]
    out.append(("one scale a matrix (its largest)", cs._map_quant_leaves(
        tree, lambda p: dict(p, scale=p["scale"].amax(dim=-1, keepdim=True)
                             .expand_as(p["scale"]).contiguous()))))
    out.append(("scales in reversed channel order", cs._map_quant_leaves(
        tree, lambda p: dict(p, scale=p["scale"].flip(-1).contiguous()))))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("w8_controls: needs a CUDA device", file=sys.stderr)
        return 2
    tik = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = cs.card_line()
    _build.load_libraries("paged_attention", "paged_attention_deep",
                          "flash_attention")
    with tempfile.TemporaryDirectory(prefix="w8_controls_") as tmp:
        cut_dir = os.path.join(tmp, "qwen2_cut")
        cfg = qwen25_15b_config()
        master = init_params(cfg, cs.SEED, device, dtype=torch.float32)
        cut_cfg = dataclasses.replace(cfg, n_layers=cs.CUT_LAYERS)
        cs.write_hf_dir(cut_cfg, dict(master, layers=master["layers"][
            :cs.CUT_LAYERS]), cut_dir)
        del master
        torch.cuda.empty_cache()
        cfg, master = load_hf_model(cut_dir, device=device)
    params = serving_params(master, cfg)
    greedy = SamplingParams(greedy=True)
    kw = dict(max_batch=cs.MAX_BATCH, kv_cache_len=cs.KV_CACHE_LEN,
              page_size=cs.PAGE_SIZE, prefill_chunk_tokens=cs.PREFILL_CHUNK,
              chunk_size=cs.CHUNK_SIZE)
    bf = cs.build_engine(cfg, params, device, greedy, **kw)
    q8 = cs.build_engine(cfg, params, device, greedy,
                         serving_weight_dtype="int8", **kw)
    prompts = cs.make_prompts(cfg.vocab_size, cs.FEAT_PROMPT_LENS,
                              cs.SEED + 71)
    outs, _ = cs.serve(bf, cs.requests(prompts, cs.FEAT_NEW_TOKENS, "feat"))
    lp_bf = cs.forced_logprobs(bf.params, cfg, outs)
    lp_host = cs.forced_logprobs(cs._host_dequantized(q8.params, device),
                                 cfg, outs)
    print(f"{card}; {len(lp_bf)} teacher-forced tokens; drift gate limits "
          f"{cs.TOL_W8_MEAN} / {cs.TOL_W8_MAX}")
    for name, tree in [("sound int8 tree", q8.params)] + controls(q8.params):
        lp = cs.forced_logprobs(tree, cfg, outs)
        drift, deq = cs._gap(lp, lp_bf), cs._gap(lp, lp_host)
        held = drift[0] <= cs.TOL_W8_MEAN and drift[1] <= cs.TOL_W8_MAX
        print(f"{name}: against bf16 mean {drift[0]:.4e} max {drift[1]:.4e}"
              f" ({'passes' if held else 'fails'} the drift gate); against "
              f"the host's dequantization mean {deq[0]:.4e} max "
              f"{deq[1]:.4e}")
    print(f"done in {time.perf_counter() - tik:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
