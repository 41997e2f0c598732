"""Rehearse ``chip_smoke.py``'s prefix-cache and generation-server phases
on the CPU, at tiny widths, before a chip call.

Run from the repository root::

    python areal_tpu_torch/tools/prefix_rehearsal.py phase
    python areal_tpu_torch/tools/prefix_rehearsal.py pressure
    python areal_tpu_torch/tools/prefix_rehearsal.py server

``phase`` runs ``chip_smoke.prefix_phase`` on both pools at tiny sizes
(groups of 4, pages of 16), with the paged kernels replaced by wrappers
that call their plain version and count launches as the kernels do, so
the launch gates hold on the CPU.  The int8 logprob gate is set for the
full-width model, so this run lifts it.  ``pressure`` serves the pressure
arm's geometry (16 rows, 4096-token KV, a 64-page pool of 256, the
phase's prompt lengths and budget) through a bf16 tiny model and prints
its work counts (preemptions, fills given back, tokens prefilled, fill
and decode chunks); scheduling depends on token counts only, not on the
model's widths.  ``server`` runs ``chip_smoke.server_phase`` (publish,
the generation server in a thread, a group of 4 staged-swapped to
perturbed weights while it decodes, continuations, the bad-manifest
control) with the same counting wrappers, pages of 16 and decode chunks of
4; its restore is held 0.2 s, as long as several decode steps, so the
stage's check that decoding went on during the restore can pass.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from areal_tpu_torch.engine.sampling import SamplingParams  # noqa: E402
from areal_tpu_torch.models import paged  # noqa: E402
from areal_tpu_torch.models.config import tiny_config  # noqa: E402
from areal_tpu_torch.models.convert import serving_params  # noqa: E402
from areal_tpu_torch.models.transformer import init_params  # noqa: E402
from areal_tpu_torch.ops import paged_attention as pa  # noqa: E402


def counting(real, std: bool):
    """``real`` (a paged kernel's wrapper, which runs its plain version on
    the CPU) with the launch counts its kernel keeps on the card."""

    def f(q, k_pool, v_pool, tables, lengths, k_scale=None, v_scale=None):
        out = real(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
        if k_pool.dtype == torch.int8:
            f.int8_launches += 1
        else:
            f.launches += 1
        if std and pa.paged_entry(q.shape[1], q.dtype,
                                  k_pool.dtype) == pa.PREFILL_ENTRY:
            f.prefill_launches += 1
        return out

    f.launches = f.int8_launches = f.prefill_launches = 0
    f.__name__ = real.__name__
    return f


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "phase"
    torch.set_num_threads(4)
    dev = torch.device("cpu")
    cfg = tiny_config(dtype="bfloat16", vocab_size=256)
    master = init_params(cfg, cs.SEED, dev, dtype=torch.float32)
    params = serving_params(master, cfg)
    tik = time.perf_counter()
    if mode in ("phase", "server"):
        pa.paged_flash_attention = paged.paged_flash_attention = counting(
            pa.paged_flash_attention, True)
        pa.paged_flash_attention_deep = paged.paged_flash_attention_deep = (
            counting(pa.paged_flash_attention_deep, False))
    if mode == "server":
        from areal_tpu_torch.engine import checkpoint

        real_restore = checkpoint.load_params_staged

        def restore(*args, **kwargs):
            # a tiny snapshot restores within one decode step; at full
            # width the restore spans many steps
            time.sleep(0.2)
            return real_restore(*args, **kwargs)

        checkpoint.load_params_staged = restore
        cs.server_phase(
            cfg, cs._perturbed(master, cs.SEED + 7), dev, "cpu", group=4,
            prompt_len=37, new_tokens=120, cont_new=6, max_batch=4,
            kv_cache_len=256, page_size=16, chunk_size=4, cache_mode="paged",
            prefill_chunk_tokens=32, stage_chunk_bytes=4096)
    elif mode == "phase":
        cs.TOL_INT8_MEAN = cs.TOL_INT8_MAX = 1.0
        for kv in ("auto", "int8"):
            cs.prefix_phase(
                cfg, master, params, dev, "cpu", kv_dtype=kv, group=4,
                prompt_len=37, suffix_len=20, new_tokens=6, shared_new=30,
                swap_after=10, max_batch=4, kv_cache_len=256,
                pressure_lens=(30, 90, 50, 70), pressure_batch=4,
                pressure_kv=128,
                pressure_pool=256, pressure_new=32, page_size=16,
                prefill_chunk_tokens=32, chunk_size=4)
    elif mode == "pressure":
        eng = cs.build_engine(
            cfg, params, dev, SamplingParams(temperature=1.0),
            max_batch=cs.PRESSURE_MAX_BATCH,
            kv_cache_len=cs.PRESSURE_KV_CACHE_LEN,
            kv_pool_tokens=cs.PRESSURE_POOL_TOKENS, prefix_cache=True)
        prompts = cs.make_prompts(cfg.vocab_size, cs.PRESSURE_PROMPT_LENS,
                                  cs.SEED + 34)
        outs, _ = cs.serve(eng, cs.requests(prompts, cs.PRESSURE_NEW_TOKENS,
                                            "pressure"))
        print(f"pressure arm geometry: {len(outs)} requests, "
              f"{sum(cs.PRESSURE_PROMPT_LENS)} prompt tokens, "
              f"{sum(len(o.output_ids) for o in outs)} new tokens; "
              f"{eng.preempted_total} preemptions, {eng.aborted_fills_total} "
              f"fills given back, {eng.prefill_tokens_total} tokens prefilled "
              f"in {eng.prefill_calls} fill chunks, {eng.decode_chunks_total} "
              f"decode chunks, "
              f"{eng.prefix_cache_stats()['evictions_total']} cache evictions")
    else:
        print(f"unknown mode {mode!r} (phase | pressure | server)",
              file=sys.stderr)
        return 2
    print(f"done in {time.perf_counter() - tik:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
