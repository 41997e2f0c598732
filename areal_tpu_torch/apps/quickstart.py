"""Quickstart CLI: launch a registered experiment by name (port of
``areal_tpu/apps/quickstart.py``).

Resolves the experiment class from the port's registry, parses
``--config`` and dotted overrides (``api/cli_args.py``) and runs it either
in this process (``--mode threads``, the default) or as one process per
worker through the launcher (``--mode processes``, ``apps/main.py``).

Usage::

    python -m areal_tpu_torch.apps.quickstart list
    python -m areal_tpu_torch.apps.quickstart async_ppo_math \\
        --config training/configs/async_ppo.yaml --mode processes \\
        mesh_spec=d1 gen_device_start=null actor.args.path=/path/to/hf_model
"""

from __future__ import annotations

import os
import sys

from areal_tpu_torch.api import system_api
from areal_tpu_torch.api.cli_args import dump_config, parse_cli
from areal_tpu_torch.base import constants, logging_

logger = logging_.getLogger("quickstart")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from areal_tpu_torch.apps.local_runner import register_impls

    register_impls()

    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("registered experiments:")
        for name in system_api.list_experiments():
            print(f"  {name}")
        return 0
    cmd = argv.pop(0)
    if cmd == "list":
        for name in system_api.list_experiments():
            print(name)
        return 0

    mode = "threads"
    if "--mode" in argv:
        i = argv.index("--mode")
        mode = argv[i + 1]
        del argv[i : i + 2]
    if mode not in ("threads", "processes"):
        raise ValueError(f"--mode {mode!r}: choose threads or processes")

    exp = parse_cli(system_api.experiment_cls(cmd), argv=argv)
    exp.apply_device_overrides()
    cfg = exp.initial_setup()
    constants.set_experiment_trial_names(cfg.experiment_name, cfg.trial_name)
    dump_config(exp, os.path.join(constants.get_log_path(), "config.yaml"))
    logger.info(
        "quickstart %s (%s/%s, %s): %d model worker(s), %d gen server(s), "
        "%d rollout worker(s)",
        cmd, cfg.experiment_name, cfg.trial_name, mode,
        len(cfg.model_workers), len(cfg.gen_servers),
        len(cfg.rollout_workers),
    )
    if mode == "threads":
        from areal_tpu_torch.apps.local_runner import run_experiment_local

        master = run_experiment_local(cfg)
        logger.info("finished: final stats %s", master.stats)
    else:
        from areal_tpu_torch.apps.main import launch_experiment

        launch_experiment(cfg, mode="local")
    return 0


if __name__ == "__main__":
    sys.exit(main())
