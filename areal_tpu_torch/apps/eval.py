"""Offline evaluation CLI: score a saved checkpoint on a prompt dataset or
a benchmark file (AIME24 / MATH-500 / AMC / GPQA-style jsonl); port of
``areal_tpu/apps/eval.py``.

The eval job the automatic evaluator submits per checkpoint: it loads the
HF-format checkpoint into the port's continuous-batching engine on the
card (``--device``, default ``cuda``; the paged kernel serves its decode),
generates n answers per prompt, scores them with the math parser / local
verifiers, and writes per-task pass@1/pass@k JSON, with the device's name
and the paged kernel's launches beside the scores.

Dataset schema is auto-detected per file: training-style
({query_id, prompt, solutions}) loads through the math_code dataset
validator; benchmark-style ({problem|question, answer}, reference:
evaluation/data/*/test.jsonl) normalizes through
areal_tpu_torch/data/benchmarks.py, which appends the boxed-answer instruction
and handles multiple-choice options.

Usage::

    python -m areal_tpu_torch.apps.eval --ckpt DIR --dataset D.jsonl \
        --output OUT.json [--max-prompts N] [--max-new-tokens M] \
        [--n-samples K] [--no-chat-template] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def pass_at_k(n_correct, n_samples: int, k: int) -> float:
    """Unbiased pass@k over prompts: mean of 1 - C(n-c, k)/C(n, k)
    (the reference evaluation suite's estimator)."""
    from math import comb

    vals = []
    for c in n_correct:
        if n_samples - c < k:
            vals.append(1.0)
        else:
            vals.append(1.0 - comb(n_samples - c, k) / comb(n_samples, k))
    return sum(vals) / max(1, len(vals))


def load_eval_dataset(dataset_path: str):
    """(id2info, style) from either a training-style or benchmark-style
    jsonl (schema sniffed from the first record).  ``style`` is
    "training" or "benchmark" — benchmark prompts are bare problems that
    want the model's chat template; training prompts are already in the
    exact surface form the training pipeline tokenizes raw."""
    with open(dataset_path) as f:
        first = json.loads(next(line for line in f if line.strip()))
    if "query_id" in first and "prompt" in first:
        from areal_tpu_torch.data.math_code_dataset import load_metadata

        id2info, _ = load_metadata(dataset_path)
        return id2info, "training"
    from areal_tpu_torch.data.benchmarks import load_benchmark

    return load_benchmark(dataset_path), "benchmark"


def evaluate_checkpoint(
    ckpt_dir: str,
    dataset_path: str,
    max_prompts: int = 64,
    max_new_tokens: int = 512,
    kv_cache_len: int = 2048,
    max_batch: int = 16,
    n_samples: int = 1,
    temperature: float = 0.6,
    chat_template: bool = True,
    device=None,
) -> dict:
    """``n_samples == 1``: deterministic greedy accuracy.  ``n_samples > 1``:
    temperature sampling with the unbiased pass@k estimator
    (1 - C(n-c,k)/C(n,k); the reference's evaluation suite reports pass@k
    over sampled generations, evaluation/eval_and_aggregate.py).
    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the CPU."""
    import torch
    from transformers import AutoTokenizer

    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )
    from areal_tpu_torch.base.device import resolve_device
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.models.hf.registry import load_hf_model
    from areal_tpu_torch.ops.paged_attention import paged_flash_attention
    from areal_tpu_torch.verifiers.dispatch import verify_batch

    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    device = resolve_device(device)
    cfg, params = load_hf_model(ckpt_dir, device=device)
    tokenizer = AutoTokenizer.from_pretrained(ckpt_dir)
    greedy = n_samples == 1
    engine = ContinuousBatchingEngine(
        cfg,
        params,
        tokenizer=tokenizer,
        max_batch=max_batch,
        kv_cache_len=kv_cache_len,
        # pass@1 decodes greedily, so scores are deterministic and
        # comparable across checkpoints
        sampling=SamplingParams(greedy=greedy, temperature=temperature),
        device=device,
    )
    del params  # the engine keeps its serving copy
    launches0 = (paged_flash_attention.launches
                 + paged_flash_attention.int8_launches)

    id2info, style = load_eval_dataset(dataset_path)
    items = list(id2info.values())[:max_prompts]
    gcfg = GenerationHyperparameters(
        max_new_tokens=max_new_tokens, greedy=greedy, temperature=temperature
    )
    # chat template only for benchmark-style bare problems: training-style
    # prompts already carry their exact surface form (the training pipeline
    # tokenizes them raw), and double-wrapping would skew scores
    use_chat = (
        chat_template
        and style == "benchmark"
        and getattr(tokenizer, "chat_template", None)
    )
    t0 = time.time()
    qids = []  # submit order = aggregation order, single-source format
    for d in items:
        if use_chat:
            ids = tokenizer.apply_chat_template(
                [{"role": "user", "content": d["prompt"]}],
                add_generation_prompt=True,
            )
        else:
            ids = tokenizer(d["prompt"])["input_ids"]
        for s in range(n_samples):
            qid = f"{d['query_id']}#{s}"
            qids.append(qid)
            engine.submit(
                APIGenerateInput(
                    qid=qid, prompt_ids=ids, input_ids=ids, gconfig=gcfg
                )
            )
    outs = {}
    while len(outs) < len(qids):
        engine.step()
        for qid in qids:
            if qid not in outs:
                r = engine.try_get_result(qid)
                if r is not None:
                    outs[qid] = r
    gen_time = time.time() - t0
    launches = (paged_flash_attention.launches
                + paged_flash_attention.int8_launches - launches0)
    engine.close()

    texts, tasks, problems = [], [], []
    for i, d in enumerate(items):
        for s in range(n_samples):
            texts.append(
                tokenizer.decode(
                    outs[qids[i * n_samples + s]].output_ids,
                    skip_special_tokens=True,
                )
            )
            tasks.append(d.get("task", "math"))
            problems.append(d)
    rewards = verify_batch(tasks, texts, problems)

    # group per prompt: c = correct count among n samples
    per_task: dict = {}
    n_correct = []
    for i, d in enumerate(items):
        rs = rewards[i * n_samples : (i + 1) * n_samples]
        c = sum(1 for r in rs if r > 0)
        n_correct.append(c)
        per_task.setdefault(d.get("task", "math"), []).append(c)

    ks = sorted({1, n_samples} | {k for k in (4, 8, 16) if k < n_samples})
    result = {
        "dataset": os.path.basename(dataset_path),
        "n_prompts": len(items),
        "n_samples": n_samples,
        "accuracy": pass_at_k(n_correct, n_samples, 1),
        "pass_at_k": {
            str(k): round(pass_at_k(n_correct, n_samples, k), 4) for k in ks
        },
        "per_task": {
            t: {
                "accuracy": sum(cs) / (len(cs) * n_samples),
                "n": len(cs),
            }
            for t, cs in per_task.items()
        },
        "gen_time_s": round(gen_time, 2),
        # where the answers were generated: the device, and the paged
        # kernel's launches (0 on the CPU, where its plain version runs)
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "paged_kernel_launches": int(launches),
    }
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="areal_tpu_torch offline evaluation")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-prompts", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--kv-cache-len", type=int, default=2048)
    p.add_argument("--n-samples", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument(
        "--no-chat-template",
        action="store_true",
        help="tokenize prompts raw even when the tokenizer has a chat template",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    result = evaluate_checkpoint(
        args.ckpt,
        args.dataset,
        max_prompts=args.max_prompts,
        max_new_tokens=args.max_new_tokens,
        kv_cache_len=args.kv_cache_len,
        n_samples=args.n_samples,
        temperature=args.temperature,
        chat_template=not args.no_chat_template,
        device=args.device,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    tmp = args.output + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=2)
    os.replace(tmp, args.output)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
