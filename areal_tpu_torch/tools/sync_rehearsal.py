"""Run ``chip_smoke.py``'s sync-PPO phase alone: on one card at the full
Qwen2.5-1.5B size, or, when asked, on the CPU at tiny widths.

Run from the repository root::

    python3 areal_tpu_torch/tools/sync_rehearsal.py         # one card
    python areal_tpu_torch/tools/sync_rehearsal.py --cpu    # CPU, tiny

The CPU run writes a qwen2-shaped tiny model (qkv biases, tied embedding,
float32) as an HF directory and runs ``chip_smoke.sync_ppo_phase`` on it
with 4 sequences of 24 new tokens over 8 rows (every kernel wrapper takes
its plain version, so the launch gates expect 0).  The card run builds
the kernels, writes the seeded weights as the bf16 ``Qwen2ForCausalLM``
directory that the script's ``hf`` phase writes, and runs the phase at
its SYNC_* settings; it prints the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402


def main() -> int:
    card = "--cpu" not in sys.argv[1:]
    tik = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sync_rehearsal_") as tmp:
        hf_dir = os.path.join(tmp, "qwen2")
        if card:
            from areal_tpu_torch.models.config import qwen25_15b_config
            from areal_tpu_torch.ops import _build

            if not torch.cuda.is_available():
                print("sync_rehearsal: needs a CUDA device (--cpu for the CPU rehearsal)",
                      file=sys.stderr)
                return 2
            torch.backends.cuda.matmul.allow_tf32 = False
            device = torch.device("cuda")
            cs.log(f"card: {cs.card_line()}")
            _build.load_libraries(
                "paged_attention", "paged_attention_deep", "flash_attention")
            cfg = qwen25_15b_config()
            master = init_params(cfg, cs.SEED, device, dtype=torch.float32)
            cs.write_hf_dir(cfg, master, hf_dir)
            del master
            torch.cuda.empty_cache()
            res = cs.sync_ppo_phase(cfg, device, cs.card_line(), hf_dir)
        else:
            from areal_tpu_torch.models.config import tiny_config

            torch.set_num_threads(4)
            device = torch.device("cpu")
            cfg = tiny_config(vocab_size=512, use_attention_bias=True,
                              tied_embedding=True,
                              max_position_embeddings=2048)
            cs.write_hf_dir(
                cfg, init_params(cfg, cs.SEED, device, dtype=torch.float32),
                hf_dir)
            res = cs.sync_ppo_phase(
                cfg, device, "cpu", hf_dir, rows=8, prompt_words=(5, 20),
                train_bs=4, new_tokens=24, n_answers=8,
                overrides=["actor.args.dtype=float32"])
    print(f"sync phase: launches {res['launches']}, step walls "
          f"{[round(w, 3) for w in res['step_s']]} s, generation "
          f"{[round(t, 1) for t in res['gen_tok_s']]} tokens/s, peak "
          f"{res['peak_gib']:.2f} GiB; decode anatomy "
          f"{cs.split_line(np.array([res['anatomy']['split_ms']]) / 1e3)}, "
          f"device busy {res['anatomy']['busy_ms']} ms a step; done in "
          f"{time.perf_counter() - tik:.1f} s")
    if card:
        print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
