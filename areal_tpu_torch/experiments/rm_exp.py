"""Reward-model training experiment: a single pairwise-BT train MFC over
the paired dataset (the ReaLHF-era ``rw`` quickstart shape; the surveyed
reference keeps the dataset, reference:
realhf/impl/dataset/rw_paired_dataset.py, without the trainer).

The port of ``areal_tpu/experiments/rm_exp.py``, over the port's
``rw_train`` interface.  Launch by registry name: ``python -m
areal_tpu_torch.apps.quickstart rw ...``.
"""

from __future__ import annotations

import dataclasses

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

# interface registration side effect
from areal_tpu_torch.interfaces import rm_interface  # noqa: F401


@dataclasses.dataclass
class RMExperiment(CommonExperimentConfig):
    model: ModelAbstraction = None  # must be a critic (value head)
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
        model_name = ModelName("reward")
        iface = ModelInterfaceAbstraction("rw_train")
        rpc = MFCDef(
            name="rw_train",
            model_name=model_name,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=iface,
            input_keys=("packed_input_ids",),
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
            [shard], {"rw_train": iface}, [self.dataset]
        )
        return self.make_config([rpc], workers)


system_api.register_experiment("rw", RMExperiment)
