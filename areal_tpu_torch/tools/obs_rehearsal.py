"""Run ``chip_smoke.py``'s generation-server phase and the loop's phase
(phase 8) alone on one card, the phases that carry the observability and
evaluation gates: the compile watch, the HBM ledger and its
reconciliation, a ``/profile`` capture, the token-stream arm, and the
loop's evaluator job on its HF save.

Run from the repository root::

    python3 areal_tpu_torch/tools/obs_rehearsal.py [--profile-seconds S]

It builds the kernel libraries, makes the Qwen2.5-1.5B architecture's
first ``CUT_LAYERS`` layers (random, seed ``SEED``; float32 master
weights), runs ``chip_smoke.server_phase`` (``--profile-seconds`` sets its
capture, default ``PROFILE_SECONDS``), writes those layers as an HF
directory and runs ``chip_smoke.async_ppo_phase`` at the script's phase-8
settings; it exits 2 without a card.  On the CPU the same phases run as
``prefix_rehearsal.py server`` and as ``chip_smoke.async_ppo_phase`` on a
tiny config (with ``eval_rows`` and ``eval_new`` cut).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--profile-seconds", type=float, default=cs.PROFILE_SECONDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("obs_rehearsal: no CUDA device", file=sys.stderr)
        return 2
    from areal_tpu_torch.models.config import qwen25_15b_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.load_libraries("paged_attention", "paged_attention_deep",
                          "flash_attention")
    cs.log(f"obs_rehearsal: built the libraries in "
           f"{time.perf_counter() - t0:.1f} s on {card}")
    cfg = dataclasses.replace(qwen25_15b_config(), n_layers=cs.CUT_LAYERS)
    master = init_params(cfg, cs.SEED, dev, dtype=torch.float32)
    tik = time.perf_counter()
    server = cs.server_phase(cfg, master, dev, card,
                             profile_s=args.profile_seconds)
    cs.log(f"obs_rehearsal: server phase {time.perf_counter() - tik:.1f} s: "
           f"{server['observability']}; streams {server['streams']}")
    root = tempfile.mkdtemp(prefix="obs_rehearsal_")
    try:
        hf_dir = os.path.join(root, "cut")
        cs.write_hf_dir(cfg, master, hf_dir)
        del master
        torch.cuda.empty_cache()
        tik = time.perf_counter()
        loop = cs.async_ppo_phase(
            cfg, dev, card, hf_dir, train_bs=cs.LOOP_TRAIN_BS,
            new_tokens=cs.LOOP_NEW_TOKENS, steps=cs.LOOP_STEPS,
            offpolicyness=cs.LOOP_OFFPOLICYNESS)
        cs.log(f"obs_rehearsal: loop phase {time.perf_counter() - tik:.1f} s; "
               f"the eval job {loop['eval']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.log(f"obs_rehearsal: total {time.perf_counter() - t0:.1f} s on "
           f"{cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
