"""Master-side data-location tracking and transfer planning.

Rebuild of the reference's redistribution planner (reference:
realhf/system/redistributor.py — ``GlobalStorageTracker`` :12,
``RedistribPlanner.derive_plan`` :79, ``RedistribStep`` :54).

The reference plans NCCL gather/scatter/bcast steps between GPUs; here the
data plane is host-side (device arrays exist only inside an engine step), so
a plan is a list of pull steps: ``dst`` worker fetches (ids × keys) from
``src`` worker over the data stream.  Steps already satisfied by local
storage are pruned.

The port's copy of ``areal_tpu/system/redistributor.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("redistributor")


@dataclasses.dataclass
class RedistribStep:
    dst: str  # worker that needs the data
    src: str  # worker that owns it
    ids: List[object]
    keys: List[str]


class GlobalStorageTracker:
    """(sample_id, key) -> set of worker names owning the host data."""

    def __init__(self):
        self.storage: Dict[Tuple[object, str], Set[str]] = {}

    def add_data(
        self, worker: str, ids: Sequence[object], keys: Sequence[str]
    ):
        for i in ids:
            for k in keys:
                self.storage.setdefault((i, k), set()).add(worker)

    def owners(self, sample_id, key) -> Set[str]:
        return self.storage.get((sample_id, key), set())

    def drop_ids(self, ids: Sequence[object]):
        for (i, k) in list(self.storage):
            if i in set(ids):
                del self.storage[(i, k)]


class RedistribPlanner:
    def __init__(self, tracker: GlobalStorageTracker):
        self.tracker = tracker

    def derive_plan(
        self,
        dst_workers: Sequence[str],
        ids: Sequence[object],
        keys: Sequence[str],
    ) -> List[RedistribStep]:
        """Every dst worker must end up owning every (id, key).  Pulls are
        grouped per (dst, src) pair to minimize round trips; source choice
        prefers the owner with the most co-located ids for the key."""
        plan: List[RedistribStep] = []
        for dst in dst_workers:
            # id -> src chosen, grouped by (src, key-tuple)
            group: Dict[Tuple[str, Tuple[str, ...]], List[object]] = {}
            for i in ids:
                missing = tuple(
                    k for k in keys if dst not in self.tracker.owners(i, k)
                )
                if not missing:
                    continue
                # prefer a single src owning all missing keys for this id
                candidates: Dict[str, int] = {}
                for k in missing:
                    owners = self.tracker.owners(i, k)
                    if not owners:
                        raise RuntimeError(
                            f"no owner for sample {i} key {k!r}"
                        )
                    for o in owners:
                        candidates[o] = candidates.get(o, 0) + 1
                src = max(candidates, key=candidates.get)
                src_keys = tuple(
                    k for k in missing if src in self.tracker.owners(i, k)
                )
                group.setdefault((src, src_keys), []).append(i)
                rest = tuple(k for k in missing if k not in src_keys)
                for k in rest:
                    o = sorted(self.tracker.owners(i, k))[0]
                    group.setdefault((o, (k,)), []).append(i)
            for (src, ks), gids in group.items():
                plan.append(
                    RedistribStep(dst=dst, src=src, ids=gids, keys=list(ks))
                )
                # after execution dst owns these
                self.tracker.add_data(dst, gids, ks)
        return plan
