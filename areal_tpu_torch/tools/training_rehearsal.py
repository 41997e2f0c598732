"""Run ``chip_smoke.py``'s training phase alone on one card, at the full
Qwen2.5-1.5B size.

Run from the repository root::

    python3 areal_tpu_torch/tools/training_rehearsal.py

It builds the flash kernels, writes the seeded weights as the bf16
``Qwen2ForCausalLM`` directory that the script's ``hf`` phase writes,
runs ``chip_smoke.training_phase`` on it at the script's settings and
prints the card's name and power limit.  It exits 2 without a card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.models.config import qwen25_15b_config  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402
from areal_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("training_rehearsal: needs a CUDA device", file=sys.stderr)
        return 2
    tik = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    _build.load_libraries("flash_attention")
    with tempfile.TemporaryDirectory(prefix="training_rehearsal_") as tmp:
        hf_dir = os.path.join(tmp, "qwen2")
        cfg = qwen25_15b_config()
        master = init_params(cfg, cs.SEED, device, dtype=torch.float32)
        cs.write_hf_dir(cfg, master, hf_dir)
        del master
        torch.cuda.empty_cache()
        res = cs.training_phase(cfg, device, cs.card_line(), hf_dir)
    print(f"training phase: launches {res['launches']}, SFT losses "
          f"{[round(l, 6) for l in res['sft_losses']]}, packed "
          f"{[round(l, 6) for l in res['packed_losses']]}, DPO "
          f"{res['dpo']:.6f}, rw {res['rw']:.6f}, checks {res['checks']}, "
          f"runs {res['runs']}; done in {time.perf_counter() - tik:.1f} s")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
