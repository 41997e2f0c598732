"""Environment API (reference: realhf/api/core/env_api.py:9 — gym-like async
``EnvironmentService.step/reset`` + registry).

The port's copy of ``areal_tpu/api/env_api.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Tuple


class EnvironmentService(abc.ABC):
    @abc.abstractmethod
    async def reset(self, seed=None, options=None) -> Tuple[Any, Dict]: ...

    @abc.abstractmethod
    async def step(self, action) -> Tuple[Any, float, bool, bool, Dict]: ...


ALL_ENVIRONMENTS: Dict[str, Callable[..., EnvironmentService]] = {}


def register_environment(name: str, cls):
    if name in ALL_ENVIRONMENTS:
        raise KeyError(f"environment {name} already registered")
    ALL_ENVIRONMENTS[name] = cls


def make_env(cfg) -> EnvironmentService:
    from areal_tpu_torch.api.config import EnvServiceAbstraction

    if isinstance(cfg, str):
        cfg = EnvServiceAbstraction(cfg)
    return ALL_ENVIRONMENTS[cfg.type_](**cfg.args)
