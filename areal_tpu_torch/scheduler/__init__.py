"""Scheduler clients that start, watch and stop an experiment's worker
processes (port of ``areal_tpu/scheduler``: the local client and the
slurm client)."""
