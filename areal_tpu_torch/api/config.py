"""Core named abstractions (copy of ``areal_tpu/api/config.py``).

``ModelName`` identifies a model role and replica.  The ``*Abstraction``
dataclasses are ``(type_, args)`` factory references resolved through the
port's registries (``api/model_api``, ``api/dataset_api``,
``api/agent_api``, ``api/env_api``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True, order=True)
class ModelName:
    role: str
    replica_id: int = 0

    def __str__(self):
        return f"{self.role}@{self.replica_id}"

    @classmethod
    def from_str(cls, s: str) -> "ModelName":
        role, _, rid = s.partition("@")
        return cls(role=role, replica_id=int(rid or 0))


def _abstraction(name: str):
    @dataclasses.dataclass
    class _Abstraction:
        type_: str
        args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _Abstraction.__name__ = name
    _Abstraction.__qualname__ = name
    return _Abstraction


DatasetAbstraction = _abstraction("DatasetAbstraction")
ModelAbstraction = _abstraction("ModelAbstraction")
ModelInterfaceAbstraction = _abstraction("ModelInterfaceAbstraction")
ModelBackendAbstraction = _abstraction("ModelBackendAbstraction")
AgentAbstraction = _abstraction("AgentAbstraction")
EnvServiceAbstraction = _abstraction("EnvServiceAbstraction")
