"""Deterministic seeding (port of ``areal_tpu/base/seeding.py``).

Derives per-key seeds as ``base_seed + stable_hash(key)`` and seeds python
and numpy; :func:`prng_key` gives a seeded ``torch.Generator`` for a named
stream.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

_BASE_SEED: int = 0
_SEEDED = False


def _stable_hash(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")


def set_random_seed(base_seed: int, key: str = "") -> None:
    """Seed python/numpy deterministically for this process.

    ``key`` should identify the worker (e.g. its name) so different workers get
    decorrelated but reproducible streams.
    """
    global _BASE_SEED, _SEEDED
    _BASE_SEED = base_seed
    seed = (base_seed + _stable_hash(key)) % (2**31)
    random.seed(seed)
    np.random.seed(seed)
    _SEEDED = True


def get_seed(key: str = "") -> int:
    return (_BASE_SEED + _stable_hash(key)) % (2**31)


def prng_key(key: str = "", device=None):
    """A ``torch.Generator`` on ``device`` (default: the CPU) seeded with
    this stream's seed: the port's counterpart of the JAX package's root
    ``jax.random.PRNGKey``."""
    import torch

    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(get_seed(key))
    return g
