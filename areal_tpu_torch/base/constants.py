"""Process-global experiment context (copy of ``areal_tpu/base/constants.py``).

Holds the experiment and trial names and the path helpers.  Default roots
sit under the process's temporary directory; ``AREAL_LOG_ROOT`` and
``AREAL_SAVE_ROOT`` override them.  The JAX package's mesh registry and
``model_scope`` are not copied: the port runs each model on one device.
"""

from __future__ import annotations

import getpass
import os
import tempfile
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


# ---------------------------------------------------------------------------
# Path helpers (reference :82-118).
# ---------------------------------------------------------------------------

def _tmp_root() -> str:
    return os.path.join(tempfile.gettempdir(), "areal_tpu_torch")


def get_cache_path() -> str:
    """Where the launcher dumps an experiment's config for its worker
    processes (``AREAL_CACHE_ROOT`` overrides)."""
    root = os.environ.get("AREAL_CACHE_ROOT", os.path.join(_tmp_root(), "cache"))
    os.makedirs(root, exist_ok=True)
    return root


def _trial_path(root_env: str, default_root: str, *sub) -> str:
    root = os.environ.get(root_env, default_root)
    p = os.path.join(root, getpass.getuser(), experiment_name(), trial_name(), *sub)
    os.makedirs(p, exist_ok=True)
    return p


def get_log_path() -> str:
    return _trial_path("AREAL_LOG_ROOT", os.path.join(_tmp_root(), "logs"))


def get_save_path() -> str:
    return _trial_path(
        "AREAL_SAVE_ROOT", os.path.join(_tmp_root(), "checkpoints")
    )


def get_param_realloc_path() -> str:
    """Staging dir for train->generation weight sync (disk fallback path)."""
    return _trial_path(
        "AREAL_SAVE_ROOT",
        os.path.join(_tmp_root(), "checkpoints"),
        "param_realloc",
    )


def get_recover_path() -> str:
    return _trial_path(
        "AREAL_SAVE_ROOT", os.path.join(_tmp_root(), "checkpoints"), "recover"
    )


def reset():
    """Forget the experiment and trial names (a restart in tests)."""
    global _experiment_name, _trial_name
    _experiment_name = None
    _trial_name = None
