"""Single-step math agent.

Rebuild of the reference's agent (reference:
realhf/impl/agent/math_single_step_agent.py:23 — puts the prompt on
obs_queue, awaits the sampled group from act_queue, scores via the env,
filters groups by success rate (reject all-right/all-wrong) :94-101, and
builds trajectory SequenceSamples with version/birth_time keys :103-180).

The port's copy of ``areal_tpu/agents/math_single_step_agent.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import time
from typing import List

import numpy as np

from areal_tpu_torch.api import agent_api, model_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("math_single_step_agent")


class MathSingleStepAgent(agent_api.Agent):
    def __init__(
        self,
        gconfig: model_api.GenerationHyperparameters = None,
        answer_save_path: str = None,
        tokenizer_path: str = None,
        success_rate_lb: float = 0.0,
        success_rate_ub: float = 1.0,
        reward_scaling: float = 1.0,
        reward_bias: float = 0.0,
    ):
        self.gconfig = gconfig or model_api.GenerationHyperparameters()
        self.success_rate_lb = success_rate_lb
        self.success_rate_ub = success_rate_ub
        self.reward_scaling = reward_scaling
        self.reward_bias = reward_bias

    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]:
        qid = str(prompt.ids[0])
        prompt_ids = prompt.data["packed_prompts"].tolist()
        await obs_queue.put((qid, prompt_ids, self.gconfig.n))

        bundle: model_api.BundledGenerationOutputs = await act_queue.get()

        await env.reset()
        answers = bundle.seqs  # token ids; env decodes/scores
        _, rewards, *_ = await env.step(
            {
                "qid": qid,
                "seqs": answers,
                "prompt_len": len(prompt_ids),
                "task": prompt.metadata.get("task", ["math"])[0],
                "problem": {
                    "query_id": qid,
                    "solutions": prompt.metadata.get("solutions", [[]])[0],
                    "input_output": prompt.metadata.get(
                        "input_output", [None]
                    )[0],
                    **(
                        {"timeout": prompt.metadata["timeout"][0]}
                        if prompt.metadata.get("timeout", [None])[0]
                        is not None
                        else {}
                    ),
                },
            }
        )
        rewards = np.asarray(rewards, np.float32)

        # group filtering: all-correct or all-wrong groups carry no learning
        # signal for group-normalized advantages
        sr = float(np.mean(rewards > 0))
        if not (self.success_rate_lb <= sr <= self.success_rate_ub):
            logger.debug("qid %s filtered (success rate %.2f)", qid, sr)
            return []

        rewards = rewards * self.reward_scaling - self.reward_bias
        now = time.time()  # wall clock: comparable across worker processes
        samples = []
        for j, seq in enumerate(bundle.seqs):
            L = len(seq)
            pmask = np.zeros(L, bool)
            pmask[: len(bundle.prompt_ids)] = True
            samples.append(
                SequenceSample.from_default(
                    seqlens=[L],
                    ids=[f"{qid}-{j}"],
                    data={
                        "packed_input_ids": np.asarray(seq, np.int64),
                        "packed_logprobs": np.asarray(
                            bundle.logprobs[j], np.float32
                        ),
                        "prompt_mask": pmask,
                        "seq_no_eos_mask": np.asarray(
                            [bundle.no_eos[j]], np.float32
                        ),
                        "rewards": np.asarray([rewards[j]], np.float32),
                        "version_start": np.asarray(
                            [bundle.version_start[j]], np.int32
                        ),
                        "version_end": np.asarray(
                            [bundle.version_end[j]], np.int32
                        ),
                        "birth_time": np.asarray([now], np.float64),
                    },
                    # birth_time orders master-buffer dequeues;
                    # version_end rides along for the buffer-age
                    # stall watchdog (flight recorder)
                    metadata={
                        "birth_time": [now],
                        "version_end": [int(bundle.version_end[j])],
                    },
                )
            )
        return samples


agent_api.register_agent("math-single-step", MathSingleStepAgent)
