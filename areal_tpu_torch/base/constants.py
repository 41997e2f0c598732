"""Process-global experiment context (copy of the experiment and trial
names of ``areal_tpu/base/constants.py``).

The reference's mesh registry, ``model_scope`` and path helpers are not
copied: the port serves on one card and nothing in it calls them yet.
"""

from __future__ import annotations

from typing import Optional

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None


def set_experiment_trial_names(experiment_name: str, trial_name: str):
    global _experiment_name, _trial_name
    if "_" in experiment_name or "_" in trial_name:
        raise ValueError("experiment/trial names may not contain underscores")
    _experiment_name = experiment_name
    _trial_name = trial_name


def experiment_name() -> str:
    if _experiment_name is None:
        raise RuntimeError("experiment name not set")
    return _experiment_name


def trial_name() -> str:
    if _trial_name is None:
        raise RuntimeError("trial name not set")
    return _trial_name
