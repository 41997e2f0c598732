"""Master-side sequence buffer.

Rebuild of the reference's ``AsyncIOSequenceBuffer`` (reference:
realhf/system/buffer.py — slot indicators :117, ``put_batch`` :247,
``amend_batch`` :309, RPC readiness ``_can_do_rpc`` :337,
``get_batch_for_rpc`` waiting for n_seqs with birth-time ordering :348).

The buffer stores SequenceSample *metadata* (ids + which keys exist); the
actual tensor data lives on the workers' DataManagers.  An MFC becomes ready
when >= n_seqs sequences carry all its input keys and have not yet been used
by that MFC this epoch-step.

The port's copy of ``areal_tpu/system/buffer.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("buffer")


@dataclasses.dataclass
class _Slot:
    sample: SequenceSample  # metadata-only sample (data=None entries ok)
    birth_time: float
    keys: Set[str] = dataclasses.field(default_factory=set)
    consumed_by: Set[str] = dataclasses.field(default_factory=set)


class AsyncIOSequenceBuffer:
    def __init__(self, max_size: int = 100000):
        self.max_size = max_size
        self._slots: Dict[int, _Slot] = {}
        self._next_idx = itertools.count()
        self._id_to_idx: Dict[object, int] = {}
        self._lock = asyncio.Lock()
        self._cond = asyncio.Condition(self._lock)
        from areal_tpu_torch.observability import get_registry
        from areal_tpu_torch.observability.tracing import get_tracer

        reg = get_registry()
        self._m_size = reg.gauge("areal_buffer_size")
        self._m_age = reg.gauge("areal_buffer_oldest_sample_age_seconds")
        # flight recorder: each sample's residency is an open span from
        # push to final consumption — the stall watchdog's buffer-age
        # check reads the version attr recorded at push
        self._tracer = get_tracer()

    def _export_metrics(self):
        """Refresh the scrape gauges (called on every mutation, under the
        buffer lock — sample age is birth-time of the oldest resident)."""
        self._m_size.set(len(self._slots))
        if self._slots:
            oldest = min(s.birth_time for s in self._slots.values())
            self._m_age.set(max(0.0, time.time() - oldest))
        else:
            self._m_age.set(0.0)

    @property
    def size(self) -> int:
        return len(self._slots)

    async def put_batch(self, samples: Sequence[SequenceSample]):
        async with self._cond:
            for s in samples:
                assert len(s.ids) == 1 or s.bs >= 1
                for one in s.unpack() if s.bs > 1 else [s]:
                    sid = one.ids[0]
                    if sid in self._id_to_idx:
                        raise ValueError(f"duplicate sample id {sid}")
                    if len(self._slots) >= self.max_size:
                        raise RuntimeError("buffer full")
                    idx = next(self._next_idx)
                    birth = (
                        one.metadata["birth_time"][0]
                        if one.metadata and "birth_time" in one.metadata
                        else time.time()
                    )
                    self._slots[idx] = _Slot(
                        sample=one, birth_time=birth, keys=set(one.keys)
                    )
                    self._id_to_idx[sid] = idx
                    ver = -1
                    if one.metadata and "version_end" in one.metadata:
                        try:
                            ver = int(one.metadata["version_end"][0])
                        except (TypeError, ValueError, IndexError):
                            ver = -1
                    self._tracer.span_begin(
                        str(sid), "buffer.resident", version=ver
                    )
            self._export_metrics()
            self._cond.notify_all()

    async def amend_batch(self, sample: SequenceSample):
        """Merge new keys produced by an MFC into existing slots."""
        async with self._cond:
            for one in sample.unpack() if sample.bs > 1 else [sample]:
                idx = self._id_to_idx.get(one.ids[0])
                if idx is None:
                    logger.warning(
                        "amend for unknown id %s (dropped?)", one.ids[0]
                    )
                    continue
                slot = self._slots[idx]
                slot.sample.update_(one)
                slot.keys |= set(one.keys)
            self._export_metrics()
            self._cond.notify_all()

    def _ready_indices(
        self, rpc_name: str, input_keys: Sequence[str]
    ) -> List[int]:
        need = set(input_keys)
        out = [
            idx
            for idx, slot in self._slots.items()
            if need.issubset(slot.keys) and rpc_name not in slot.consumed_by
        ]
        out.sort(key=lambda i: (self._slots[i].birth_time, i))
        return out

    async def get_batch_for_rpc(
        self,
        rpc_name: str,
        input_keys: Sequence[str],
        n_seqs: int,
        consume: bool = False,
    ) -> Tuple[List[int], SequenceSample]:
        """Wait until n_seqs are ready for this RPC; returns (indices, gathered
        metadata sample).  ``consume=True`` removes the sequences from the
        buffer afterwards (for terminal MFCs)."""
        async with self._cond:
            while True:
                ready = self._ready_indices(rpc_name, input_keys)
                if len(ready) >= n_seqs:
                    break
                await self._cond.wait()
            chosen = ready[:n_seqs]
            for i in chosen:
                self._slots[i].consumed_by.add(rpc_name)
                self._tracer.event(
                    str(self._slots[i].sample.ids[0]), "buffer.consume",
                    rpc=rpc_name,
                )
            gathered = SequenceSample.gather(
                [self._slots[i].sample for i in chosen]
            )
            if consume:
                for i in chosen:
                    sid = self._slots[i].sample.ids[0]
                    del self._id_to_idx[sid]
                    del self._slots[i]
                    self._tracer.span_end(
                        str(sid), "buffer.resident", consumed_by=rpc_name
                    )
            self._export_metrics()
            return chosen, gathered

    async def pop_consumed(self, by_rpcs: Sequence[str]) -> List[object]:
        """Remove sequences consumed by ALL the given RPCs; returns their ids
        (end-of-step garbage collection)."""
        done_ids = []
        async with self._cond:
            for idx in list(self._slots):
                slot = self._slots[idx]
                if set(by_rpcs).issubset(slot.consumed_by):
                    done_ids.append(slot.sample.ids[0])
                    del self._id_to_idx[slot.sample.ids[0]]
                    del self._slots[idx]
                    self._tracer.span_end(
                        str(slot.sample.ids[0]), "buffer.resident",
                        consumed_by="*",
                    )
            self._export_metrics()
        return done_ids
