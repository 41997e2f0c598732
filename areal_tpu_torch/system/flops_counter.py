"""Analytic FLOPs of a training step (port of the dense-model part of
``areal_tpu/system/flops_counter.py``), for the MFU the train engine
reports.

Conventions: one MAC = 2 FLOPs; causal attention costs ~``q_dim * t^2``
per sequence of length t per layer (scores and values over the causal
triangle); the backward is 2x the forward.
"""

from __future__ import annotations

from typing import Sequence

from areal_tpu_torch.models.config import TransformerConfig


def matmul_params_per_layer(cfg: TransformerConfig) -> int:
    """Weight-matrix parameters touched per token per layer (excludes
    norms and embeddings)."""
    attn = cfg.hidden_dim * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.hidden_dim
    n_mats = 3 if cfg.gated_mlp else 2
    return attn + n_mats * cfg.hidden_dim * cfg.intermediate_dim


def forward_flops(cfg: TransformerConfig, seqlens: Sequence[int]) -> int:
    """FLOPs of one forward pass over packed sequences, the head included."""
    total_tokens = sum(seqlens)
    flops = 2 * matmul_params_per_layer(cfg) * cfg.n_layers * total_tokens
    for t in seqlens:
        flops += 2 * cfg.n_layers * cfg.q_dim * t * t
    return flops + 2 * cfg.hidden_dim * cfg.vocab_size * total_tokens


def train_flops(cfg: TransformerConfig, seqlens: Sequence[int]) -> int:
    """Forward + backward (2x forward)."""
    return 3 * forward_flops(cfg, seqlens)
