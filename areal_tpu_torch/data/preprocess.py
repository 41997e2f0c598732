"""Training-data preprocessing: normalize raw math/code dumps into the
framework's JSONL schema.

Rebuild of the reference's preprocessing scripts (reference:
examples/data_preprocess/math_process.py — join prompts with an id2info
solutions map; preprocess_training_data.py — chat-template wrapping +
code input_output normalization; math_code_process.py — mixed-task merge).
One CLI instead of three scripts::

    python -m areal_tpu_torch.data.preprocess math \
        --prompts prompts.jsonl --id2info id2info.json --output math.jsonl
    python -m areal_tpu_torch.data.preprocess code \
        --input raw_code.jsonl --output code.jsonl \
        [--prompt-template qwen-think]
    python -m areal_tpu_torch.data.preprocess merge \
        --inputs math.jsonl code.jsonl --output mixed.jsonl [--shuffle]

Output rows: ``{query_id, prompt, task, solutions?, input_output?}`` —
exactly what ``data/math_code_dataset.py`` loads and the verifiers score.

The port's copy of ``areal_tpu/data/preprocess.py``, its imports renamed
to ``areal_tpu_torch``: the same rows and files.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from typing import Dict, List, Optional

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("preprocess")

PROMPT_TEMPLATES = {
    "plain": "{question}",
    # boba-2-style think template (reference preprocess_training_data.py)
    "qwen-think": (
        "<|im_start|>user\n{question}\n/think<|im_end|>\n"
        "<|im_start|>assistant\n<think>"
    ),
}


def load_jsonl(path: str) -> List[Dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def dump_jsonl(rows: List[Dict], path: str):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    logger.info("wrote %d rows -> %s", len(rows), path)


def process_math(
    prompts: List[Dict], id2info: Dict[str, Dict]
) -> List[Dict]:
    """Join prompt rows with the solutions map; rows without a resolvable
    query_id are dropped (counted)."""
    out, missing = [], 0
    for item in prompts:
        # normalize: JSON map keys are strings, prompt ids may be ints
        # (and 0 is a legitimate id)
        qid = item.get("query_id")
        qid = None if qid is None else str(qid)
        if qid is None or qid not in id2info:
            missing += 1
            continue
        out.append(
            {
                "prompt": item.get("prompt", ""),
                "task": "math",
                "query_id": qid,
                "solutions": id2info[qid].get("solutions", []),
            }
        )
    if missing:
        logger.warning("%d rows dropped (missing/unknown query_id)", missing)
    return out


def process_code(
    rows: List[Dict], prompt_template: str = "plain"
) -> List[Dict]:
    """Normalize code rows: parse stringified input_output, wrap the
    question in the chat template, keep per-case timeouts."""
    template = PROMPT_TEMPLATES[prompt_template]
    out, bad = [], 0
    for item in rows:
        try:
            io = item["input_output"]
            if isinstance(io, str):
                io = json.loads(io)
            row = {
                "task": "code",
                "query_id": str(item["query_id"]),
                "prompt": template.format(
                    question=item.get("question") or item.get("prompt", "")
                ),
                "input_output": json.dumps(io),
            }
            if item.get("timeout") is not None:
                row["timeout"] = item["timeout"]
            out.append(row)
        except (KeyError, json.JSONDecodeError):
            bad += 1
    if bad:
        logger.warning("%d code rows dropped (malformed)", bad)
    return out


def merge(
    datasets: List[List[Dict]],
    shuffle: bool = False,
    seed: int = 0,
    dedup: bool = True,
) -> List[Dict]:
    rows: List[Dict] = []
    seen = set()
    for ds in datasets:
        for r in ds:
            key = (r.get("task"), r.get("query_id"))
            if dedup and key in seen:
                continue
            seen.add(key)
            rows.append(r)
    if shuffle:
        random.Random(seed).shuffle(rows)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="training data preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("math", help="join prompts with an id2info map")
    pm.add_argument("--prompts", required=True)
    pm.add_argument("--id2info", required=True)
    pm.add_argument("--output", required=True)

    pc = sub.add_parser("code", help="normalize raw code rows")
    pc.add_argument("--input", required=True)
    pc.add_argument("--output", required=True)
    pc.add_argument(
        "--prompt-template",
        default="plain",
        choices=sorted(PROMPT_TEMPLATES),
    )

    pg = sub.add_parser("merge", help="merge + dedup + shuffle datasets")
    pg.add_argument("--inputs", nargs="+", required=True)
    pg.add_argument("--output", required=True)
    pg.add_argument("--shuffle", action="store_true")
    pg.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "math":
        with open(args.id2info, encoding="utf-8") as f:
            id2info = json.load(f)
        rows = process_math(load_jsonl(args.prompts), id2info)
    elif args.cmd == "code":
        rows = process_code(
            load_jsonl(args.input), prompt_template=args.prompt_template
        )
    else:
        rows = merge(
            [load_jsonl(x) for x in args.inputs],
            shuffle=args.shuffle,
            seed=args.seed,
        )
    if not rows:
        logger.error("no valid rows produced")
        return 1
    dump_jsonl(rows, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
