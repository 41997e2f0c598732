"""Benchmark dataset loaders for offline evaluation (copy of
``areal_tpu/data/benchmarks.py``).

Plays the data-loading role of the reference's offline evaluation suite
(reference: evaluation/data_loader.py + evaluation/data/{aime24,aime25,
math_500,amc23,gpqa_diamond}/test.jsonl — AIME/MATH-500-class benchmark
files), normalized into the prompt/solutions records apps/eval.py scores
with the hardened math parser.

Accepted jsonl schemas (auto-detected per line):
  benchmark style:  {"problem"|"question": str, "answer": ...}
                    (optionally "solution", "id"/"unique_id")
  gpqa style:       {"question", "options"|"labeled_options", "answer"}
  training style:   {"query_id", "prompt", "solutions": [...]}
                    (passed through unchanged)

Math answers are wrapped as ``\\boxed{answer}`` solutions so the grader's
boxed-extraction path applies; multiple-choice answers grade via the
parser's choice-letter rule.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

#: appended to bare benchmark problems — the instruction the reference's
#: benchmark prompts carry so the model emits a parseable final answer
BOXED_INSTRUCTION = (
    "\nPlease reason step by step, and put your final answer within "
    "\\boxed{}."
)


def _mc_prompt(question: str, options: List[str]) -> str:
    letters = "ABCDEFGH"
    lines = [question, ""]
    for letter, opt in zip(letters, options):
        opt = str(opt)
        # options may already carry their letter ("A) ...")
        if opt[:2] in (f"{letter})", f"{letter}.", f"{letter}:"):
            lines.append(opt)
        else:
            lines.append(f"{letter}) {opt}")
    lines.append(
        "\nAnswer with the letter of the correct option within \\boxed{}."
    )
    return "\n".join(lines)


def load_benchmark(path: str, name: Optional[str] = None) -> Dict[str, Dict]:
    """Normalize one benchmark jsonl into ``id2info`` records:
    {query_id, prompt, task, solutions}."""
    tag = name or os.path.basename(os.path.dirname(path)) or "bench"
    id2info: Dict[str, Dict] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "query_id" in d and "prompt" in d:  # training style
                rec = dict(d)
                rec.setdefault("task", "math")
            else:
                qid = str(d.get("id", d.get("unique_id", i)))
                options = d.get("labeled_options") or d.get("options")
                question = d.get("problem") or d.get("question")
                if question is None:
                    raise ValueError(
                        f"{path}:{i + 1}: no problem/question field"
                    )
                if options:
                    prompt = _mc_prompt(question, options)
                    answer = d.get("answer")
                    # gpqa gives the correct option index or letter
                    if isinstance(d.get("correct_option_index"), int):
                        answer = "ABCDEFGH"[d["correct_option_index"]]
                else:
                    prompt = question + BOXED_INSTRUCTION
                    answer = d.get("answer")
                    if answer is None and d.get("solution") is not None:
                        answer = d["solution"]  # grader extracts last boxed
                if answer is None:
                    # failing loudly beats an eval that silently scores 0
                    raise ValueError(
                        f"{path}:{i + 1}: no answer/solution/"
                        "correct_option_index field in benchmark record"
                    )
                rec = {
                    "query_id": f"{tag}-{qid}",
                    "prompt": prompt,
                    "task": "math",
                    "solutions": [f"\\boxed{{{answer}}}"],
                }
            id2info[rec["query_id"]] = rec
    if not id2info:
        raise ValueError(f"no records in {path}")
    return id2info
