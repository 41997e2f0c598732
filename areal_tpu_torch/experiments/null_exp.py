"""Null experiments: exercise the full master/worker/data plane with no-op
model computation.

Rebuild of the reference's null experiments (reference:
realhf/experiments/common/null_exp.py — ``NullSFTConfig`` one train MFC,
``NullPPOConfig`` reward-inference + train MFCs, both on the ``null``
interface).  Used for plumbing tests, scheduler profiling, and isolating
system overhead from model compute: step time here IS the framework
overhead (dispatch + data plane + host sync), which is exactly what a
profiling run wants to measure.

The port of ``areal_tpu/experiments/null_exp.py`` (``null_ppo``), on the
port's ``null`` model and backend (``engine/backend.py``).
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
from areal_tpu_torch.experiments.common import CommonExperimentConfig


@dataclasses.dataclass
class NullPPOExperiment(CommonExperimentConfig):
    """reward-inf -> train on null interfaces over a prompt dataset."""

    dataset: DatasetAbstraction = None
    train_bs_n_seqs: int = 8
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)

    def initial_setup(self) -> system_api.ExperimentConfig:
        self.resolve_allocation()
        from areal_tpu_torch.interfaces import null_interface  # noqa: F401

        default = ModelName("default")
        null_iface = ModelInterfaceAbstraction("null")
        n = self.train_bs_n_seqs
        rew = MFCDef(
            name="reward",
            model_name=default,
            interface_type=ModelInterfaceType.INFERENCE,
            interface_impl=null_iface,
            input_keys=("packed_prompts",),
            output_keys=("rewards",),
            n_seqs=n,
        )
        train = MFCDef(
            name="trainDefault",
            model_name=default,
            interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=null_iface,
            input_keys=("packed_prompts", "rewards"),
            n_seqs=n,
            mb_spec=self.mb_spec,
            log_return_value=True,
        )
        shards = [
            ModelShard(
                model_name=default,
                model=ModelAbstraction("null"),
                backend=ModelBackendAbstraction("null"),
                mesh_spec=self.mesh_spec,
            )
        ]
        interfaces = {"reward": null_iface, "trainDefault": null_iface}
        workers = self.build_model_workers(shards, interfaces, [self.dataset])
        return self.make_config([rew, train], workers)


system_api.register_experiment("null_ppo", NullPPOExperiment)
