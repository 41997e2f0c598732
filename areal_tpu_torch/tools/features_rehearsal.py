"""Run ``chip_smoke.py``'s serving-features phase alone on one card, at the
full Qwen2.5-1.5B width on its first ``CUT_LAYERS`` layers.

Run from the repository root::

    python3 areal_tpu_torch/tools/features_rehearsal.py

It builds the kernel libraries, writes the seeded weights' first
``CUT_LAYERS`` layers as the bf16 ``Qwen2ForCausalLM`` directory that the
script's ``hf`` phase cuts, loads it back as float32 master weights, runs
``chip_smoke.serving_features_phase`` on it at the script's settings and
prints the card's name and power limit.  It exits 2 without a card.  On
the CPU, ``prefix_rehearsal.py features`` rehearses the phase at tiny
widths.
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
from areal_tpu_torch.models.config import qwen25_15b_config  # noqa: E402
from areal_tpu_torch.models.hf.registry import load_hf_model  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402
from areal_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("features_rehearsal: needs a CUDA device", file=sys.stderr)
        return 2
    tik = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    _build.load_libraries("paged_attention", "paged_attention_deep",
                          "flash_attention")
    cs.log(f"build done at {time.perf_counter() - tik:.1f} s")
    with tempfile.TemporaryDirectory(prefix="features_rehearsal_") as tmp:
        cut_dir = os.path.join(tmp, "qwen2_cut")
        cfg = qwen25_15b_config()
        master = init_params(cfg, cs.SEED, device, dtype=torch.float32)
        cut_cfg = dataclasses.replace(cfg, n_layers=cs.CUT_LAYERS)
        cs.write_hf_dir(cut_cfg, dict(master, layers=master["layers"][
            :cs.CUT_LAYERS]), cut_dir)
        del master
        torch.cuda.empty_cache()
        feat_cfg, feat_master = load_hf_model(cut_dir, device=device)
        res = cs.serving_features_phase(feat_cfg, feat_master, device, card)
    print(f"serving-features phase: launches {res['launches']}; done in "
          f"{time.perf_counter() - tik:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
