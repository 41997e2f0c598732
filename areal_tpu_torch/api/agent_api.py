"""Agent API (reference: realhf/api/core/agent_api.py:16 —
``Agent.collect_trajectory(prompt, env, obs_queue, act_queue)`` coroutine +
registry).

The port's copy of ``areal_tpu/api/agent_api.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import abc
import asyncio
from typing import Any, Callable, Dict, List

from areal_tpu_torch.api.data import SequenceSample


class Agent(abc.ABC):
    """Collects one trajectory by exchanging observations/actions with the
    generation infrastructure through asyncio queues: the agent puts token
    prompts into ``obs_queue`` and awaits sampled generations from
    ``act_queue``."""

    @abc.abstractmethod
    async def collect_trajectory(
        self,
        prompt: SequenceSample,
        env,
        obs_queue: asyncio.Queue,
        act_queue: asyncio.Queue,
    ) -> List[SequenceSample]: ...


ALL_AGENTS: Dict[str, Callable[..., Agent]] = {}


def register_agent(name: str, cls):
    if name in ALL_AGENTS:
        raise KeyError(f"agent {name} already registered")
    ALL_AGENTS[name] = cls


def make_agent(cfg) -> Agent:
    from areal_tpu_torch.api.config import AgentAbstraction

    if isinstance(cfg, str):
        cfg = AgentAbstraction(cfg)
    return ALL_AGENTS[cfg.type_](**cfg.args)
