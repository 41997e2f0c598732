"""SFT training entry point of the port (mirrors ``training/main_sft.py``).

Runs :class:`~areal_tpu_torch.experiments.sft_exp.SFTExperiment` in one
process through
:func:`areal_tpu_torch.apps.local_runner.run_experiment_local`: the master
and one model worker, whose ``trainDefault`` MFC runs
:class:`~areal_tpu_torch.interfaces.sft_interface.SFTInterface` over a
``prompt_answer`` dataset.

Usage (from the repository root)::

    python -m areal_tpu_torch.apps.main_sft \\
        --config training/configs/sft.yaml mesh_spec=d1 \\
        model.args.path=/path/to/hf_model tokenizer_path=/path/to/hf_model \\
        dataset.args.dataset_path=sft.jsonl

The recipe's mesh (``mesh_spec: d1f8m1``) is not ported yet (ROADMAP.md
queue 1, item 10): ``mesh_spec=d1`` runs the model on one card.
``model.type_=random`` trains random weights; ``force_cpu_devices=1``
runs on the CPU.
"""

import os

from areal_tpu_torch.api.cli_args import dump_config, parse_cli
from areal_tpu_torch.apps.local_runner import register_impls, run_experiment_local
from areal_tpu_torch.base import constants, logging_
from areal_tpu_torch.experiments.sft_exp import SFTExperiment

logger = logging_.getLogger("main_sft")


def main(argv=None):
    register_impls()
    exp: SFTExperiment = parse_cli(SFTExperiment, argv)
    exp.apply_device_overrides()
    cfg = exp.initial_setup()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    dump_config(exp, os.path.join(constants.get_log_path(), "config.yaml"))
    logger.info(
        "starting SFT %s/%s: %d worker(s), mesh %s", cfg.experiment_name,
        cfg.trial_name, len(cfg.model_workers), exp.mesh_spec,
    )
    master = run_experiment_local(cfg)
    logger.info("finished: final stats %s", master.stats)
    return master


if __name__ == "__main__":
    main()
