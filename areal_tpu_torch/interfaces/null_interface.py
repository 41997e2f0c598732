"""Null interface: MFC handlers that touch no model (port of
``areal_tpu/interfaces/null_interface.py``; the reference's ``null``
interface of null_exp.py).  The null experiments use it to run the
master, the workers and the data plane alone: inference emits zero
rewards, ``train_step`` takes the data and reports its size.  It
registers as ``null``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample


@dataclasses.dataclass
class NullInterface(model_api.ModelInterface):
    output_key: str = "rewards"

    def inference(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> SequenceSample:
        return SequenceSample.from_default(
            seqlens=[1] * data.bs,
            ids=list(data.ids),
            data={self.output_key: np.zeros(data.bs, np.float32)},
        )

    def train_step(
        self,
        model: model_api.Model,
        data: SequenceSample,
        mb_spec: MicroBatchSpec,
    ) -> Dict:
        n_tokens = sum(int(sum(l)) for l in next(iter(data.seqlens.values())))
        return {"null/n_seqs": float(data.bs), "null/n_tokens": float(n_tokens)}

    def generate(self, model, data, mb_spec):
        return None


model_api.register_interface("null", NullInterface)
