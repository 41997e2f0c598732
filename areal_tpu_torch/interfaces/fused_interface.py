"""Fused inference interface: several sub-interfaces as one MFC (port of
``areal_tpu/interfaces/fused_interface.py``; reference:
realhf/impl/model/interface/fused_interface.py:23
``FusedThreadingForwardInterface``).

The sub-interfaces run in a thread pool on the same model and their
output samples are unioned, in the order the interfaces are named; a
sub-interface that returns ``None`` adds nothing.  Sync PPO uses it to
collapse ``rew_inf`` and ``ref_inf`` into one dispatch: the verifier's
host work overlaps the reference model's forward on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.config import ModelInterfaceAbstraction
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import logging_

logger = logging_.getLogger("fused_interface")


@dataclasses.dataclass
class FusedInferenceInterface(model_api.ModelInterface):
    """``interfaces``: name -> sub-interface abstraction (or instance)."""

    def __init__(self, interfaces: Dict[str, ModelInterfaceAbstraction]):
        self.interfaces = {
            key: (
                iface
                if isinstance(iface, model_api.ModelInterface)
                else model_api.make_interface(
                    ModelInterfaceAbstraction(**iface)
                    if isinstance(iface, dict)
                    else iface
                )
            )
            for key, iface in interfaces.items()
        }

    def _run_one(self, name, model, data, mb_spec, stream):
        tik = time.perf_counter()
        # a CUDA stream is a thread's own setting: the pool's threads run
        # on the caller's, after the work already queued there
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            res = self.interfaces[name].inference(model, data, mb_spec)
        logger.debug(
            "fused sub-interface %s took %.3fs", name, time.perf_counter() - tik
        )
        return res

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample | None:
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_initialized() else None)
        with ThreadPoolExecutor(max_workers=len(self.interfaces)) as pool:
            futs = {
                name: pool.submit(
                    self._run_one, name, model, data, mb_spec, stream)
                for name in self.interfaces
            }
            results = {name: f.result() for name, f in futs.items()}
        merged = None
        for name in self.interfaces:  # deterministic merge order
            res = results[name]
            if res is None:
                continue
            if merged is None:
                merged = res
            else:
                merged.update_(res)
        return merged

    def save(self, model, save_dir):
        for iface in self.interfaces.values():
            iface.save(model, save_dir)


model_api.register_interface("fused-inference", FusedInferenceInterface)
