"""DPO experiment: a two-node graph — frozen-reference inference feeding the
actor's preference train step.

The reference keeps DPO math in
realhf/impl/model/utils/dpo_functional.py without a wired experiment; this
follows its ReaLHF-era quickstart shape (ref_inf -> dpo_train over the
paired dataset, reference: realhf/impl/dataset/rw_paired_dataset.py).

The port of ``areal_tpu/experiments/dpo_exp.py``, registered as ``dpo``:
the actor on a ``train`` backend, the frozen reference (the actor's
abstraction unless ``ref`` is given) on an ``inference`` backend, both on
the model worker's one device.
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
from areal_tpu_torch.interfaces import dpo_interface  # noqa: F401


@dataclasses.dataclass
class DPOExperiment(CommonExperimentConfig):
    actor: ModelAbstraction = None
    ref: ModelAbstraction = None  # frozen reference; defaults to actor
    dataset: DatasetAbstraction = None
    train_bs_n_seqs: int = 8
    beta: float = 0.1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )

    def _main_model(self):
        return self.actor

    def initial_setup(self) -> system_api.ExperimentConfig:
        self.prepare_common()
        actor = ModelName("actor")
        ref = ModelName("ref")
        iface = ModelInterfaceAbstraction("dpo", {"beta": self.beta})
        n = self.train_bs_n_seqs

        ref_inf = MFCDef(
            name="ref_inf",
            model_name=ref,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=iface,
            input_keys=("packed_input_ids",),
            output_keys=("packed_ref_logprobs",),
            n_seqs=n,
        )
        dpo_train = MFCDef(
            name="dpo_train",
            model_name=actor,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=iface,
            input_keys=(
                "packed_input_ids", "prompt_mask", "packed_ref_logprobs"
            ),
            n_seqs=n,
            mb_spec=self.mb_spec,
            log_return_value=True,
        )
        shards = [
            ModelShard(
                model_name=actor,
                model=self.actor,
                backend=ModelBackendAbstraction(
                    "train", {"optimizer": self.optimizer}
                ),
                mesh_spec=self.mesh_spec,
            ),
            ModelShard(
                model_name=ref,
                model=self.ref or self.actor,
                backend=ModelBackendAbstraction("inference"),
                mesh_spec=self.mesh_spec,
            ),
        ]
        workers = self.build_model_workers(
            shards,
            {"ref_inf": iface, "dpo_train": iface},
            [self.dataset],
        )
        return self.make_config([ref_inf, dpo_train], workers)


system_api.register_experiment("dpo", DPOExperiment)
