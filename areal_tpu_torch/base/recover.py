"""Recover / resume bookkeeping (reference: realhf/base/recover.py —
``StepInfo`` :19, ``RecoverInfo`` :26, dump/load :43-75, discover_ckpt :80).

A recover checkpoint = model checkpoints (saved elsewhere, via orbax /
safetensors) + this JSON-serializable RecoverInfo: where training stopped,
frequency-control states, and which dataset ids were already consumed.

The port's copy of ``areal_tpu/base/recover.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import constants, logging_

logger = logging_.getLogger("recover")

RECOVER_INFO_FILE = "recover_info.json"


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self, steps_per_epoch: int) -> "StepInfo":
        ep, es = self.epoch, self.epoch_step + 1
        if es >= steps_per_epoch:
            ep, es = ep + 1, 0
        return StepInfo(ep, es, self.global_step + 1)


@dataclasses.dataclass
class RecoverInfo:
    recover_start: StepInfo = dataclasses.field(default_factory=StepInfo)
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    save_ctl_states: Dict[str, Any] = dataclasses.field(default_factory=dict)
    eval_ctl_states: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ckpt_ctl_states: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hash_vals_to_ignore: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "recover_start": dataclasses.asdict(self.recover_start),
            "last_step_info": dataclasses.asdict(self.last_step_info),
            "save_ctl_states": self.save_ctl_states,
            "eval_ctl_states": self.eval_ctl_states,
            "ckpt_ctl_states": self.ckpt_ctl_states,
            "hash_vals_to_ignore": list(self.hash_vals_to_ignore),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecoverInfo":
        return cls(
            recover_start=StepInfo(**d["recover_start"]),
            last_step_info=StepInfo(**d["last_step_info"]),
            save_ctl_states=d.get("save_ctl_states", {}),
            eval_ctl_states=d.get("eval_ctl_states", {}),
            ckpt_ctl_states=d.get("ckpt_ctl_states", {}),
            hash_vals_to_ignore=d.get("hash_vals_to_ignore", []),
        )


def dump(info: RecoverInfo, path: Optional[str] = None):
    path = path or os.path.join(constants.get_recover_path(), RECOVER_INFO_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info.to_dict(), f, indent=2)
    os.replace(tmp, path)
    logger.debug("dumped recover info to %s", path)


def load(path: Optional[str] = None) -> RecoverInfo:
    path = path or os.path.join(constants.get_recover_path(), RECOVER_INFO_FILE)
    with open(path) as f:
        return RecoverInfo.from_dict(json.load(f))


def discover(path: Optional[str] = None) -> Optional[RecoverInfo]:
    """Return RecoverInfo if a recover checkpoint exists, else None."""
    path = path or os.path.join(constants.get_recover_path(), RECOVER_INFO_FILE)
    if not os.path.isfile(path):
        return None
    try:
        return load(path)
    except (json.JSONDecodeError, KeyError):
        logger.warning("corrupt recover info at %s; ignoring", path)
        return None
