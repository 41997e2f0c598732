"""SFT experiment: a single train MFC (port of
``areal_tpu/experiments/sft_exp.py``; reference:
realhf/experiments/common/sft_exp.py).  Registered as ``sft``; its model
runs on its worker's one device (``experiments/common.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from areal_tpu_torch.api import system_api
from areal_tpu_torch.api.config import (
    DatasetAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType
from areal_tpu_torch.api.system_api import ModelShard
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.experiments.common import CommonExperimentConfig


@dataclasses.dataclass
class SFTExperiment(CommonExperimentConfig):
    model: ModelAbstraction = None
    dataset: DatasetAbstraction = None
    train_bs_n_seqs: int = 8
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )

    def _main_model(self):
        return self.model

    def initial_setup(self) -> system_api.ExperimentConfig:
        self.prepare_common()
        model_name = ModelName("default")
        rpc = MFCDef(
            name="trainDefault",
            model_name=model_name,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=ModelInterfaceAbstraction("sft"),
            input_keys=("packed_input_ids", "prompt_mask"),
            n_seqs=self.train_bs_n_seqs,
            mb_spec=self.mb_spec,
            log_return_value=True,
        )
        shard = ModelShard(
            model_name=model_name,
            model=self.model,
            backend=ModelBackendAbstraction(
                "train", {"optimizer": self.optimizer}
            ),
            mesh_spec=self.mesh_spec,
        )
        workers = self.build_model_workers(
            [shard],
            {"trainDefault": ModelInterfaceAbstraction("sft")},
            [self.dataset],
        )
        return self.make_config([rpc], workers)


system_api.register_experiment("sft", SFTExperiment)
