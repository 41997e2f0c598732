"""Shared experiment-building helpers (port of
``areal_tpu/experiments/common.py``: ``CommonExperimentConfig`` with its
worker-config building).

What differs: ``allocation_mode`` strings and the heuristic allocation
(``areal_tpu/api/allocation.py``) are refused (ROADMAP.md queue 1, item
10), and ``force_cpu_devices`` means "run every worker on the CPU": only
the value 1 is accepted (the port runs each model on one device), and the
generation servers and model workers get ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from areal_tpu_torch.api import system_api
from areal_tpu_torch.api.config import DatasetAbstraction, ModelAbstraction
from areal_tpu_torch.api.system_api import (
    ExperimentConfig,
    ExperimentSaveEvalControl,
    MasterWorkerConfig,
    ModelWorkerConfig,
)
from areal_tpu_torch.base.topology import MeshSpec


@dataclasses.dataclass
class CommonExperimentConfig(system_api.Experiment):
    """Base options shared by quickstart experiments."""

    experiment_name: str = "test-exp"
    trial_name: str = "test-trial"
    seed: int = 1
    # number of model-worker processes (hosts); each drives its local chips
    n_model_workers: int = 1
    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    exp_ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    tokenizer_path: Optional[str] = None
    # compact allocation string ("d2f2m2", "gen.d2m1+d4f2m1", "heuristic"):
    # not ported, only "" is accepted (ROADMAP.md queue 1, item 10)
    allocation_mode: str = ""
    # 1 = run every worker on the CPU instead of the card (debug/CI mode);
    # None = the card.  Other values are refused: each model runs on one
    # device
    force_cpu_devices: Optional[int] = None
    # automatic checkpoint evaluator (reference: exp_cfg.evaluator driven by
    # apps/main.py); consumed by the process launcher's monitor loop
    evaluator: Optional[system_api.EvaluatorConfig] = None

    def resolve_allocation(self):
        """``allocation_mode`` is not ported: "" returns None, any other
        string raises."""
        if not self.allocation_mode:
            return None
        raise NotImplementedError(
            f"allocation_mode={self.allocation_mode!r}: allocation strings "
            "and the heuristic allocation are not ported to areal_tpu_torch "
            "yet (ROADMAP.md queue 1, item 10); set mesh_spec=MeshSpec()"
        )

    def _main_model(self) -> Optional[ModelAbstraction]:
        """The trained model's abstraction (drives tokenizer defaulting);
        None when the experiment has no single one."""
        return None

    def prepare_common(self):
        """Shared initial_setup preamble: resolve the allocation string and
        default the tokenizer to the main model's HF path."""
        self.resolve_allocation()
        main = self._main_model()
        if (
            self.tokenizer_path is None
            and main is not None
            and main.type_ == "hf"
        ):
            self.tokenizer_path = main.args["path"]

    def worker_device(self) -> Optional[str]:
        """The device every worker runs on: ``"cpu"`` with
        ``force_cpu_devices=1``, else None (``cuda``)."""
        if self.force_cpu_devices is None:
            return None
        if self.force_cpu_devices != 1:
            raise NotImplementedError(
                f"force_cpu_devices={self.force_cpu_devices}: the port runs "
                "each model on one device, so only 1 (every worker on the "
                "CPU) is accepted (ROADMAP.md queue 1, item 10)"
            )
        return "cpu"

    def apply_device_overrides(self):
        """Checks ``force_cpu_devices`` (the workers read their device from
        their configs, :meth:`worker_device`)."""
        self.worker_device()

    def model_worker_names(self) -> List[str]:
        return [f"model_worker_{i}" for i in range(self.n_model_workers)]

    def build_model_workers(
        self,
        shards: List[system_api.ModelShard],
        interfaces: Dict,
        datasets: List[DatasetAbstraction],
    ) -> List[ModelWorkerConfig]:
        names = self.model_worker_names()
        return [
            ModelWorkerConfig(
                worker_name=name,
                shards=shards,
                interfaces=interfaces,
                datasets=datasets,
                tokenizer_path=self.tokenizer_path,
                dataset_seed=self.seed,
                dataset_shard=(i, len(names)),
                seed=self.seed,
                device=self.worker_device(),
            )
            for i, name in enumerate(names)
        ]

    def make_config(self, rpcs, model_workers) -> ExperimentConfig:
        return ExperimentConfig(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            master=MasterWorkerConfig(
                model_rpcs=rpcs,
                exp_ctrl=self.exp_ctrl,
                seed=self.seed,
            ),
            model_workers=model_workers,
            evaluator=self.evaluator,
        ).lazy_init()
