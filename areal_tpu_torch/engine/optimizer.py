"""Optimizers (port of ``areal_tpu/engine/optimizer.py``).

:func:`make_optimizer` returns, over a list of float32 parameter tensors
and their gradients, the reference's optax chain ``chain(
clip_by_global_norm, opt)``, in optax's arithmetic order.  For ``type:
adam`` (optax ``adamw``):

    g <- g                             if |g| < clip, else g / |g| * clip
    mu <- (1 - b1) g + b1 mu ;  nu <- (1 - b2) g^2 + b2 nu ;  count += 1
    u  <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u  <- u + wd p
    p  <- p + (-lr(count - 1)) u

The moment options work as the reference's do:

* ``mu_dtype`` (optax's own): the first moment is stored in that dtype;
  this step's update uses the float32 ``mu`` before it is rounded (and,
  as in optax, ``b1 mu`` of a stored low-precision moment is formed in
  its dtype, with ``b1`` rounded to it, before the float32 sum).
* ``nu_dtype`` (the reference's ``_with_nu_dtype``): the second moment is
  widened to float32, updated, used and stored back rounded.
* ``factored_second_moment`` (the reference's ``_scale_by_factored_adam``):
  a per-layer matrix whose two dims both reach ``factored_min_dim`` keeps
  Adafactor's row and column means ``r, c`` of ``g^2`` in place of its
  second moment, and uses ``V = r c^T / mean(r)``; every other leaf keeps
  the exact moment.  The reference factors the leaves of its layer stack
  ``[L, n, m]`` over their two trailing dims; the port keeps each layer's
  matrices as their own 2-D tensors (``models/convert.py``), so the rule
  is "a 2-D leaf of ``params["layers"]``" (the engine passes that mask):
  the embedding, an untied head and a critic's value head stay exact, as
  in the reference.

``type: sgd`` is optax's ``sgd`` without momentum: ``p <- p - lr(count)
g`` after the clip.  Unlike optax, which returns new arrays, both update
parameters and moments in place (no second copy of the model).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adam"  # adam | sgd
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # constant | linear | cosine
    warmup_steps_proportion: float = 0.001
    gradient_clipping: float = 1.0
    # storage dtype of the first / second Adam moment (e.g. "bfloat16");
    # None keeps the parameters' float32.  The arithmetic stays float32
    mu_dtype: Optional[str] = None
    nu_dtype: Optional[str] = None
    # Adafactor-style rank-1 second moment for per-layer matrices whose
    # two dims both reach factored_min_dim
    factored_second_moment: bool = False
    factored_min_dim: int = 128

    def __post_init__(self):
        if self.type not in ("adam", "sgd"):
            raise NotImplementedError(f"optimizer type {self.type!r}")


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


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    from areal_tpu_torch.models.transformer import torch_dtype

    if name is None:
        return None
    try:
        return torch_dtype(str(name))
    except KeyError:
        raise ValueError(
            f"moment dtype {name!r}: choose float32, bfloat16 or float16"
        ) from None


class _ClippedOptimizer:
    """Global-norm clipping, the update count and the lr schedule shared
    by the optimizers."""

    #: int32 step counts the reference's optax state holds
    _N_COUNTS = 1

    def __init__(self, cfg: OptimizerConfig, total_train_steps: int):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, total_train_steps)
        self.count = 0

    def init(self, params: List[torch.Tensor],
             factored: Optional[Sequence[bool]] = None):
        self.count = 0

    def state_tensors(self) -> List[torch.Tensor]:
        return []

    def _clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        g_norm = global_norm(grads)
        clip = self.cfg.gradient_clipping
        if clip:
            keep = g_norm < clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / g_norm * clip))
        return g_norm


class SGD(_ClippedOptimizer):
    """Clipping then optax's ``sgd`` without momentum."""

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        g_norm = self._clip(grads)
        step_size = -self.schedule(self.count)
        self.count += 1
        for p, g in zip(params, grads):
            p.add_(step_size * g)
        return g_norm


class AdamW(_ClippedOptimizer):
    """Global-norm clipping then AdamW over a fixed list of parameters,
    with the reference's moment options (module docstring)."""

    #: Adam's count and the lr schedule's
    _N_COUNTS = 2

    def __init__(self, cfg: OptimizerConfig, total_train_steps: int):
        super().__init__(cfg, total_train_steps)
        self.mu_dtype = _dtype(cfg.mu_dtype)
        self.nu_dtype = _dtype(cfg.nu_dtype)
        self.mu: List[torch.Tensor] = []
        #: per leaf: the moment tensor, or ``{"r", "c"}`` for a factored one
        self.nu: List = []

    def init(self, params: List[torch.Tensor],
             factored: Optional[Sequence[bool]] = None):
        """Zero moments for ``params``; ``factored`` marks the per-layer
        matrices (the leaves the factored second moment may take)."""
        self.count = 0
        cfg = self.cfg
        if factored is None:
            factored = [False] * len(params)
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params]
        self.nu = []
        for p, f in zip(params, factored):
            dt = self.nu_dtype or p.dtype
            if (cfg.factored_second_moment and f and p.dim() == 2
                    and min(p.shape) >= cfg.factored_min_dim):
                self.nu.append({
                    "r": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                    "c": torch.zeros(p.shape[-1:], dtype=dt, device=p.device),
                })
            else:
                self.nu.append(torch.zeros_like(p, dtype=dt))

    def state_tensors(self) -> List[torch.Tensor]:
        out = list(self.mu)
        for nu in self.nu:
            out.extend([nu["r"], nu["c"]] if isinstance(nu, dict) else [nu])
        return out

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        """One update of ``params`` in place from ``grads`` (consumed: the
        clipped gradients are written into them).  Returns the gradients'
        global norm before clipping, as a device scalar: nothing is read
        on the host."""
        cfg = self.cfg
        g_norm = self._clip(grads)
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = 1 - b1**self.count
        bc2 = 1 - b2**self.count
        step_size = -self.schedule(self.count - 1)
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            if cfg.factored_second_moment:
                # the reference's factored transformation: every moment
                # widened to float32 first
                m = b1 * mu.float() + (1 - b1) * g
                g2 = g * g
                if isinstance(nu, dict):
                    r = b2 * nu["r"].float() + (1 - b2) * g2.mean(dim=-1)
                    c = b2 * nu["c"].float() + (1 - b2) * g2.mean(dim=-2)
                    v = r[:, None] * c[None, :] / torch.clamp(r.mean(), min=1e-30)
                    nu["r"].copy_(r)
                    nu["c"].copy_(c)
                else:
                    v = b2 * nu.float() + (1 - b2) * g2
                    nu.copy_(v)
                mu.copy_(m)
            else:
                # optax's arithmetic; with a low-precision stored mu, b1 mu
                # is formed in its dtype, b1 rounded to it first (as JAX
                # does a Python scalar), and a low-precision nu is widened
                # to float32 first (the reference's nu wrapper)
                b1_mu = b1 if mu.dtype == torch.float32 else torch.tensor(
                    b1, dtype=mu.dtype, device=mu.device)
                # a float32 moment holds the value itself: its temporary
                # goes at once (the largest leaf, the embedding, is ~1 GB)
                m = (1 - b1) * g + b1_mu * mu
                mu.copy_(m)
                m = mu if mu.dtype == torch.float32 else m
                v = (1 - b2) * (g * g) + b2 * nu.float()
                nu.copy_(v)
                v = nu if nu.dtype == torch.float32 else v
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p
            p.add_(step_size * u)
        return g_norm


def make_optimizer(cfg: OptimizerConfig, total_train_steps: int):
    if cfg.type == "adam":
        return AdamW(cfg, total_train_steps)
    if cfg.type == "sgd":
        return SGD(cfg, total_train_steps)
    raise NotImplementedError(cfg.type)


def opt_state_bytes(opt) -> int:
    """Bytes of an optimizer's state, counted as the reference's
    ``opt_state_bytes`` counts its optax state: every moment tensor (a
    factored moment's ``r`` and ``c``) and the int32 step counts (Adam's
    and the lr schedule's; the schedule's alone for SGD)."""
    return 4 * opt._N_COUNTS + sum(
        t.numel() * t.element_size() for t in opt.state_tensors()
    )
