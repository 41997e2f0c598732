"""Device-mesh topology (port of ``areal_tpu/base/topology.py``).

* ``MeshSpec`` — the named-axis shape of a model's device mesh (axes
  ``data``, ``fsdp``, ``model``, ``pipe``, ``seq``, ``expert``) and its
  compact string form (``d2f2m2``).  The port runs each model on one
  device: :meth:`MeshSpec.make_mesh` returns ``None`` for a one-device
  spec and raises for more (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# Canonical mesh axis names, in layout-major order.  ``data`` and ``fsdp``
# vary slowest (DCN-friendly), ``model`` fastest (ICI-ring-friendly): tensor
# parallel collectives are the most latency sensitive so the model axis maps
# onto adjacent chips.
MESH_AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named-axis mesh shape for one model role.

    The product of all axis sizes is the model's world size (number of chips).
    """

    data: int = 1
    fsdp: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1  # expert parallelism: shards the MoE expert dimension

    def __post_init__(self):
        for ax in MESH_AXIS_ORDER:
            if getattr(self, ax) < 1:
                raise ValueError(f"axis {ax} must be >= 1")

    @property
    def world_size(self) -> int:
        return (
            self.data
            * self.fsdp
            * self.model
            * self.pipe
            * self.seq
            * self.expert
        )

    @property
    def shape(self) -> Dict[str, int]:
        return {ax: getattr(self, ax) for ax in MESH_AXIS_ORDER}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return MESH_AXIS_ORDER

    @property
    def dp_size(self) -> int:
        """Number of independent data shards (gradient-averaged groups)."""
        return self.data * self.fsdp

    def make_mesh(self, devices: Optional[Sequence] = None):
        """The mesh of a one-device spec: ``None`` (engines run on their
        one device).  Specs of more than one device raise: meshes come
        with the parallelism port (ROADMAP.md queue 1, item 10)."""
        if self.world_size != 1:
            raise NotImplementedError(
                f"mesh {self} spans {self.world_size} devices: device meshes "
                "are not ported to areal_tpu_torch yet (ROADMAP.md queue 1, "
                "item 10); use MeshSpec() (one device)"
            )
        return None

    @classmethod
    def from_str(cls, s: str) -> "MeshSpec":
        """Parse compact strings like ``d2f2m2`` / ``d4p1m1`` / ``d2f1m2s1p1``.

        Letters: d=data, f=fsdp, m=model, p=pipe, s=seq.  Mirrors the
        reference's ``AllocationMode.from_str`` parallel-strategy substrings
        (reference: realhf/experiments/common/utils.py:245-372).
        """
        import re

        mapping = {
            "d": "data",
            "f": "fsdp",
            "m": "model",
            "p": "pipe",
            "s": "seq",
            "e": "expert",
        }
        kwargs = {}
        for m in re.finditer(r"([dfmpse])(\d+)", s):
            kwargs[mapping[m.group(1)]] = int(m.group(2))
        if not kwargs:
            raise ValueError(f"cannot parse mesh spec {s!r}")
        return cls(**kwargs)

    def __str__(self):
        return (
            f"d{self.data}f{self.fsdp}m{self.model}"
            f"p{self.pipe}s{self.seq}e{self.expert}"
        )
