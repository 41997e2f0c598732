"""Device resolution for the port's entry points.

``cuda`` is the default; ``cpu`` must be asked for explicitly.  There is
no silent fallback: without a CUDA device and without an explicit
``"cpu"``, resolution raises an error that names the missing device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no CUDA device is present);
    anything else is taken as asked, after checking that a requested
    CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "areal_tpu_torch runs on a CUDA device unless told otherwise, "
            "and no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU"
        )
    return dev
