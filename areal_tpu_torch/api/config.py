"""Core named abstractions (the ``ModelName`` and ``ModelAbstraction``
parts of ``areal_tpu/api/config.py``).

``ModelName`` identifies a model role and replica; ``ModelAbstraction`` is
a ``(type_, args)`` factory reference that
:func:`areal_tpu_torch.engine.backend.make_model` resolves.
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


@dataclasses.dataclass
class ModelAbstraction:
    type_: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
