"""Asynchronous PPO training entry point of the port (mirrors
``training/main_async_ppo.py``).

Runs the decoupled pipeline in one process through
:func:`areal_tpu_torch.apps.local_runner.run_experiment_local`: generation
servers, the gserver manager, rollout workers (agent/env loops) and the
trainer (master + model worker fed by the trajectory push stream), with
each trained version published and swapped into the servers.

Usage (from the repository root)::

    python -m areal_tpu_torch.apps.main_async_ppo \\
        --config training/configs/async_ppo.yaml mesh_spec=d1 \\
        gen_device_start=null actor.args.path=/path/to/hf_model \\
        tokenizer_path=/path/to/hf_model dataset.args.dataset_path=math.jsonl

The recipe's actor is an HF checkpoint directory (``actor.type_: hf``),
saved every ``save_freq_steps`` as an HF directory under the save root.
Its four-chip trainer mesh (``mesh_spec: d1f4m1``, ``gen_device_start:
4``) is not ported yet (ROADMAP.md queue 1, item 10): ``mesh_spec=d1
gen_device_start=null`` runs trainer and server on one card.
``actor.type_=random`` trains random weights instead (its saves are of
the ``llama`` family, and a config that family cannot hold, such as qkv
biases, fails at the save); ``force_cpu_devices=1`` runs every worker on
the CPU (the paged cache needs ``gen_cache_mode=paged`` below 2048
tokens of KV).
"""

import os

from areal_tpu_torch.api.cli_args import dump_config, parse_cli
from areal_tpu_torch.apps.local_runner import register_impls, run_experiment_local
from areal_tpu_torch.base import constants, logging_
from areal_tpu_torch.experiments.async_ppo_exp import AsyncPPOMathExperiment

logger = logging_.getLogger("main_async_ppo")


def main(argv=None):
    register_impls()
    exp: AsyncPPOMathExperiment = parse_cli(AsyncPPOMathExperiment, argv)
    exp.apply_device_overrides()
    cfg = exp.initial_setup()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    dump_config(exp, os.path.join(constants.get_log_path(), "config.yaml"))
    logger.info(
        "starting async PPO %s/%s: trainer graph=%s, %d gen server(s), "
        "%d rollout worker(s), offpolicyness<=%d",
        cfg.experiment_name,
        cfg.trial_name,
        [r.name for r in cfg.master.model_rpcs],
        len(cfg.gen_servers),
        len(cfg.rollout_workers),
        exp.max_head_offpolicyness,
    )
    master = run_experiment_local(cfg)
    logger.info("finished: final stats %s", master.stats)
    return master


if __name__ == "__main__":
    main()
