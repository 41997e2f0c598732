"""Analytic FLOPs of model function calls (port of the dense-model part
of ``areal_tpu/system/flops_counter.py``), for the MFU the train engine
reports and the per-MFC throughput the model worker reports.

Conventions: one MAC = 2 FLOPs; causal attention costs ~``q_dim * t^2``
per sequence of length t per layer (scores and values over the causal
triangle); the backward is 2x the forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

from areal_tpu_torch.models.config import TransformerConfig


def matmul_params_per_layer(cfg: TransformerConfig) -> int:
    """Weight-matrix parameters touched per token per layer (excludes
    norms and embeddings)."""
    attn = cfg.hidden_dim * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.hidden_dim
    n_mats = 3 if cfg.gated_mlp else 2
    return attn + n_mats * cfg.hidden_dim * cfg.intermediate_dim


def forward_flops(
    cfg: TransformerConfig,
    seqlens: Sequence[int],
    with_head: bool = True,
) -> int:
    """FLOPs of one forward pass over packed sequences, the head (a
    critic's value head) included unless ``with_head`` is False."""
    total_tokens = sum(seqlens)
    flops = 2 * matmul_params_per_layer(cfg) * cfg.n_layers * total_tokens
    for t in seqlens:
        flops += 2 * cfg.n_layers * cfg.q_dim * t * t
    if with_head:
        out_dim = 1 if cfg.is_critic else cfg.vocab_size
        flops += 2 * cfg.hidden_dim * out_dim * total_tokens
    return flops


def train_flops(cfg: TransformerConfig, seqlens: Sequence[int]) -> int:
    """Forward + backward (2x forward)."""
    return 3 * forward_flops(cfg, seqlens)


def generate_flops(
    cfg: TransformerConfig,
    prompt_lens: Sequence[int],
    gen_lens: Sequence[int],
) -> int:
    """Prefill of each prompt + per-token decode over the growing cache."""
    flops = forward_flops(cfg, prompt_lens, with_head=False)
    per_tok_mats = 2 * matmul_params_per_layer(cfg) * cfg.n_layers
    out_dim = 1 if cfg.is_critic else cfg.vocab_size
    head = 2 * cfg.hidden_dim * out_dim
    for p, g in zip(prompt_lens, gen_lens):
        # decode token i attends to p+i cached positions
        avg_ctx = p + g / 2.0
        flops += int(
            g * (per_tok_mats + head + 4 * cfg.n_layers * cfg.q_dim * avg_ctx)
        )
    return flops


def mfc_flops(
    handle: str,
    cfg: TransformerConfig,
    seqlens: Sequence[int],
    prompt_lens: Optional[Sequence[int]] = None,
) -> int:
    """FLOPs of one MFC from its handle and its *output* seqlens (for
    ``generate``, the full prompt+response lengths and ``prompt_lens``):
    what the model worker reports to the master's throughput statistics
    (``tflops``, ``tokens_per_sec``, ``n_tokens`` under the MFC's name)."""
    if handle == "train_step":
        return train_flops(cfg, seqlens)
    if handle == "generate" and prompt_lens is not None:
        gen_lens = [s - p for s, p in zip(seqlens, prompt_lens)]
        return generate_flops(cfg, prompt_lens, gen_lens)
    return forward_flops(cfg, seqlens)
