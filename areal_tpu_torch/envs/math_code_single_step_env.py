"""Single-step math/code verification environment
(reference: realhf/impl/environment/math_code_single_step_env.py:42 — an
async env whose step() scores generated answers via the math/code verifier,
local fallback here; the functioncall HTTP service plugs in transparently).

The port's copy of ``areal_tpu/envs/math_code_single_step_env.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import asyncio
from typing import List, Tuple

from areal_tpu_torch.api import dataset_api, env_api
from areal_tpu_torch.base import logging_
from areal_tpu_torch.verifiers.dispatch import verify_batch

logger = logging_.getLogger("math_env")


class MathCodeSingleStepEnv(env_api.EnvironmentService):
    def __init__(self, tokenizer_path: str = None, dataset_path: str = None):
        self._tokenizer = (
            dataset_api.load_hf_tokenizer(tokenizer_path)
            if tokenizer_path
            else None
        )

    async def step(self, action) -> Tuple[None, List[float], bool, bool, dict]:
        """action = {qid, seqs [list of token lists], prompt_len, task,
        problem {query_id, solutions, input_output}}.
        Returns (obs, per-answer rewards, terminated, truncated, info).
        Math answers go through final-answer equivalence, code answers
        through sandboxed testcase execution (multi-task dispatch,
        reference: math_code_single_step_env.py:42)."""
        qid = action["qid"]
        seqs = action["seqs"]
        prompt_len = action["prompt_len"]
        task = action.get("task", "math")
        problem = action.get("problem") or {"query_id": qid, "solutions": []}
        assert self._tokenizer is not None, "env needs a tokenizer"
        texts = await asyncio.to_thread(
            self._tokenizer.batch_decode,
            [s[prompt_len:] for s in seqs],
            skip_special_tokens=True,
        )
        rewards = await asyncio.to_thread(
            verify_batch,
            [task] * len(texts),
            texts,
            [problem] * len(texts),
        )
        return None, rewards, True, False, {}

    async def reset(self, seed=None, options=None):
        return None, {}


env_api.register_environment("math-code-single-step", MathCodeSingleStepEnv)
