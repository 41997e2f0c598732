"""Synchronous PPO training entry point of the port (mirrors
``training/main_sync_ppo.py``).

Runs :class:`~areal_tpu_torch.experiments.ppo_math_exp.PPOMathExperiment`
in one process through
:func:`areal_tpu_torch.apps.local_runner.run_experiment_local`: the master
and the model worker, which holds every model of the graph (the actor,
and as the options ask, the critic, the reference model and a reward
model) and runs its MFCs in turn: ``actor_gen`` (generation over the
dense KV cache), the rewards, the inference passes and the train steps.

Usage (from the repository root)::

    python -m areal_tpu_torch.apps.main_sync_ppo \\
        --config training/configs/sync_ppo.yaml mesh_spec=d1 \\
        actor.args.path=/path/to/hf_model tokenizer_path=/path/to/hf_model \\
        dataset.args.dataset_path=math.jsonl

The recipe's mesh (``mesh_spec: d1f8m1``) is not ported yet (ROADMAP.md
queue 1, item 10): ``mesh_spec=d1`` runs every model on one card.
``ppo.disable_value=false`` adds the critic, ``ppo.kl_ctl=0.1`` the
reference model, ``fuse_rew_ref=true`` fuses the reward into the
reference model's MFC.  ``actor.type_=random`` trains random weights;
``force_cpu_devices=1`` runs on the CPU.
"""

import os

from areal_tpu_torch.api.cli_args import dump_config, parse_cli
from areal_tpu_torch.apps.local_runner import register_impls, run_experiment_local
from areal_tpu_torch.base import constants, logging_
from areal_tpu_torch.experiments.ppo_math_exp import PPOMathExperiment

logger = logging_.getLogger("main_sync_ppo")


def main(argv=None):
    register_impls()
    exp: PPOMathExperiment = parse_cli(PPOMathExperiment, argv)
    exp.apply_device_overrides()
    cfg = exp.initial_setup()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    dump_config(exp, os.path.join(constants.get_log_path(), "config.yaml"))
    logger.info(
        "starting sync PPO %s/%s: graph=%s",
        cfg.experiment_name,
        cfg.trial_name,
        [r.name for r in cfg.master.model_rpcs],
    )
    master = run_experiment_local(cfg)
    logger.info("finished: final stats %s", master.stats)
    return master


if __name__ == "__main__":
    main()
