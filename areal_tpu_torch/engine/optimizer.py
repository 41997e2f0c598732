"""Optimizer (port of the plain AdamW branch of
``areal_tpu/engine/optimizer.py``).

:func:`make_optimizer` returns an :class:`AdamW` that applies, over a
list of float32 parameter tensors and their gradients, the same chain as
the reference's optax ``chain(clip_by_global_norm, adamw)``, in optax's
arithmetic order:

    g <- g                             if |g| < clip, else g / |g| * clip
    mu <- (1 - b1) g + b1 mu ;  nu <- (1 - b2) g^2 + b2 nu ;  count += 1
    u  <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u  <- u + wd p
    p  <- p + (-lr(count - 1)) u

with moments in the parameters' dtype (optax's default when ``mu_dtype``
is None).  Unlike optax, which returns new arrays, it updates parameters
and moments in place (no second copy of the model).  The low-precision
and factored moments (``mu_dtype``, ``nu_dtype``,
``factored_second_moment``) and SGD are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adam"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.001
    gradient_clipping: float = 1.0
    mu_dtype: Optional[str] = None
    nu_dtype: Optional[str] = None
    factored_second_moment: bool = False

    def __post_init__(self):
        if self.type != "adam":
            raise NotImplementedError(f"optimizer type {self.type!r} is not ported")
        for name in ("mu_dtype", "nu_dtype", "factored_second_moment"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}: low-precision and factored Adam moments are not "
                    "ported; moments keep the parameters' float32"
                )


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def make_lr_schedule(
    cfg: OptimizerConfig, total_train_steps: int
) -> Callable[[int], float]:
    """lr as a function of the update count (0 for the first update): a
    linear warm-up from 0 over ``max(1, int(warmup_steps_proportion *
    total))`` steps, then the main schedule (optax ``join_schedules``)."""
    warmup_steps = max(1, int(cfg.warmup_steps_proportion * total_train_steps))
    decay_steps = max(1, total_train_steps - warmup_steps)
    end_lr = cfg.lr * cfg.min_lr_ratio
    if cfg.lr_scheduler_type == "constant":
        main = lambda count: cfg.lr  # noqa: E731
    elif cfg.lr_scheduler_type == "linear":
        main = _linear(cfg.lr, end_lr, decay_steps)
    elif cfg.lr_scheduler_type == "cosine":

        def main(count: int) -> float:
            c = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return cfg.lr * ((1 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)

    else:
        raise NotImplementedError(cfg.lr_scheduler_type)
    warmup = _linear(0.0, cfg.lr, warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        return main(count - warmup_steps)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (a device scalar)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW:
    """Global-norm clipping then AdamW over a fixed list of parameters."""

    def __init__(self, cfg: OptimizerConfig, total_train_steps: int):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, total_train_steps)
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: List[torch.Tensor]):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        """One update of ``params`` in place from ``grads`` (consumed: the
        clipped gradients are written into them).  Returns the gradients'
        global norm before clipping, as a device scalar: nothing is read
        on the host."""
        cfg = self.cfg
        g_norm = global_norm(grads)
        if cfg.gradient_clipping:
            keep = g_norm < cfg.gradient_clipping
            for g in grads:
                g.copy_(torch.where(keep, g, g / g_norm * cfg.gradient_clipping))
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = 1 - b1**self.count
        bc2 = 1 - b2**self.count
        step_size = -self.schedule(self.count - 1)
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p
            p.add_(step_size * u)
        return g_norm


def make_optimizer(cfg: OptimizerConfig, total_train_steps: int) -> AdamW:
    return AdamW(cfg, total_train_steps)
