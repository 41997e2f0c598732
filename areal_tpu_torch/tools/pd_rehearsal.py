"""Run ``chip_smoke.py``'s P/D phase alone: on one card at the full
Qwen2.5-1.5B width on its first ``CUT_LAYERS`` layers, or, when asked, on
the CPU at tiny widths.

Run from the repository root::

    python3 areal_tpu_torch/tools/pd_rehearsal.py         # one card
    python areal_tpu_torch/tools/pd_rehearsal.py --cpu    # CPU, tiny

The card run builds the kernel libraries and runs ``chip_smoke.pd_phase``
at the script's settings (a prefill and a decode server, the gserver
manager and a ``PartialRolloutManager``; the K-scale and version
controls; the int8 arm; the fabric pull between two unified servers),
then prints the card's name and power limit; it exits 2 without a card.
The CPU run serves a tiny bf16 model at 4 rows x 512 tokens, pages of 16
and fill chunks of 32, with the paged kernels replaced by counting
wrappers of their plain versions (``prefix_rehearsal.counting``), so the
launch gates hold; the fabric arm's prefix is 16 pages there, to clear
the manager's 256-token floor.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    card = "--cpu" not in sys.argv[1:]
    tik = time.perf_counter()
    if card:
        from areal_tpu_torch.models.config import qwen25_15b_config
        from areal_tpu_torch.ops import _build

        if not torch.cuda.is_available():
            print("pd_rehearsal: needs a CUDA device (--cpu for the CPU "
                  "rehearsal)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device("cuda")
        line = cs.card_line()
        cs.log(f"card: {line}; torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}")
        _build.load_libraries("paged_attention", "paged_attention_deep",
                              "flash_attention")
        cs.log(f"build done at {time.perf_counter() - tik:.1f} s")
        cfg = dataclasses.replace(qwen25_15b_config(), n_layers=cs.CUT_LAYERS)
        res = cs.pd_phase(cfg, device, line)
    else:
        from areal_tpu_torch.models import paged
        from areal_tpu_torch.models.config import tiny_config
        from areal_tpu_torch.ops import paged_attention as pa
        from areal_tpu_torch.tools.prefix_rehearsal import counting

        torch.set_num_threads(4)
        pa.paged_flash_attention = paged.paged_flash_attention = counting(
            pa.paged_flash_attention, True)
        pa.paged_flash_attention_deep = paged.paged_flash_attention_deep = (
            counting(pa.paged_flash_attention_deep, False))
        line = "cpu"
        res = cs.pd_phase(
            tiny_config(dtype="bfloat16", vocab_size=256), torch.device("cpu"),
            line, prompt_lens=(30, 300, 77, 150), new_tokens=12,
            control_len=30, int8_prompt=100, int8_new=4, fabric_pages=16,
            fabric_tail=5, fabric_suffix=20, max_batch=4, kv_cache_len=512,
            page_size=16, prefill_chunk=32, chunk_size=4)
    print(f"P/D phase: launches {res['launches']} (int8 "
          f"{res['launches_int8']}), handoff {res['handoff']}, fabric "
          f"{res['fabric']}; done in {time.perf_counter() - tik:.1f} s")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
