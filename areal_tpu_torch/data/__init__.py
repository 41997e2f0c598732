"""Datasets and the math answer parser.

Importing a dataset module registers its dataset; :func:`register_all`
imports every one (``math_code_prompt``, ``prompt_answer``, ``prompt``,
``rw_pair``), as importing the reference's ``areal_tpu/data`` package
does.  The package import itself stays light: the verifier pool's
workers import :mod:`areal_tpu_torch.data.math_parser`, and loading the
datasets (torch among them) there would add seconds to each worker's
start.
"""

import importlib

DATASET_MODULES = (
    "math_code_dataset",
    "prompt_answer_dataset",
    "prompt_dataset",
    "rw_paired_dataset",
)


def register_all():
    """Import every dataset module, registering its dataset."""
    for m in DATASET_MODULES:
        importlib.import_module(f"{__name__}.{m}")
