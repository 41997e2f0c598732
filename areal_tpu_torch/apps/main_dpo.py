"""DPO training entry point of the port (mirrors ``training/main_dpo.py``).

Runs :class:`~areal_tpu_torch.experiments.dpo_exp.DPOExperiment` in one
process through
:func:`areal_tpu_torch.apps.local_runner.run_experiment_local`: the master
and one model worker holding the actor and its frozen reference, whose
MFCs are ``ref_inf`` (the reference's logprobs) and ``dpo_train`` over an
``rw_pair`` dataset.

Usage (from the repository root)::

    python -m areal_tpu_torch.apps.main_dpo \\
        --config training/configs/dpo.yaml mesh_spec=d1 \\
        actor.args.path=/path/to/hf_model tokenizer_path=/path/to/hf_model \\
        dataset.args.dataset_path=pairs.jsonl

The recipe's mesh (``mesh_spec: d1f8m1``) is not ported yet (ROADMAP.md
queue 1, item 10): ``mesh_spec=d1`` runs both models on one card.  The
reference model defaults to the actor's abstraction.
``actor.type_=random`` trains random weights; ``force_cpu_devices=1`` runs
on the CPU.
"""

import os

from areal_tpu_torch.api.cli_args import dump_config, parse_cli
from areal_tpu_torch.apps.local_runner import register_impls, run_experiment_local
from areal_tpu_torch.base import constants, logging_
from areal_tpu_torch.experiments.dpo_exp import DPOExperiment

logger = logging_.getLogger("main_dpo")


def main(argv=None):
    register_impls()
    exp: DPOExperiment = parse_cli(DPOExperiment, argv)
    exp.apply_device_overrides()
    cfg = exp.initial_setup()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    dump_config(exp, os.path.join(constants.get_log_path(), "config.yaml"))
    logger.info(
        "starting DPO %s/%s: %d worker(s), mesh %s", cfg.experiment_name,
        cfg.trial_name, len(cfg.model_workers), exp.mesh_spec,
    )
    master = run_experiment_local(cfg)
    logger.info("finished: final stats %s", master.stats)
    return master


if __name__ == "__main__":
    main()
