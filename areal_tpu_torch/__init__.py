"""PyTorch / CUDA port of the ``areal_tpu`` serving path, for NVIDIA Hopper.

The JAX package ``areal_tpu`` is the reference this package is held
against; module paths and names mirror it so each counterpart is easy to
find (``areal_tpu_torch/models/paged.py`` <-> ``areal_tpu/models/paged.py``).
This package imports ``torch`` and never ``jax`` or ``areal_tpu``: what it
needs from the reference it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`areal_tpu_torch.base.device`).  On the CPU every kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the
hand-written kernel or raises.
"""
