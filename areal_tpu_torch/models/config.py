"""Transformer architecture config (port of ``areal_tpu/models/config.py``).

A copy of the reference's :class:`TransformerConfig` with the fields the
serving and training forwards read.  Of the training knobs only layer
rematerialisation with the default policy (full recompute) is ported;
context parallelism, the pipeline schedule and the critic head are not.
Mixture-of-experts and critic configs are rejected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    hidden_dim: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    intermediate_dim: int
    vocab_size: int
    max_position_embeddings: int = 32768

    # architecture knobs
    activation: str = "silu"  # silu | gelu
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-6
    rotary_base: float = 10000.0
    use_attention_bias: bool = False  # qwen2-style qkv bias
    use_mlp_bias: bool = False
    gated_mlp: bool = True  # SwiGLU-style; False = plain fc->act->proj
    tied_embedding: bool = False
    use_qk_norm: bool = False  # qwen3-style per-head q/k RMSNorm
    embed_scale: Optional[float] = None  # gemma multiplies embeddings
    abs_position_embedding: bool = False  # gpt2
    sliding_window: Optional[int] = None  # mistral

    # MoE; n_experts=0 disables (the only value the port accepts)
    n_experts: int = 0

    # head; True (a value head) is not ported
    is_critic: bool = False

    # numerics
    dtype: str = "bfloat16"  # activation dtype (and serving param dtype)
    logits_dtype: str = "float32"
    # rematerialise each layer in the backward (a per-layer checkpoint)
    remat: bool = False
    # what the layer checkpoint keeps: only the reference's default
    # "none" (full recompute) is ported
    remat_policy: str = "none"

    def __post_init__(self):
        if self.n_q_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_q_heads {self.n_q_heads} is not a multiple of "
                f"n_kv_heads {self.n_kv_heads}"
            )
        if self.activation not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.norm_type not in ("rms", "layer"):
            raise ValueError(f"unknown norm_type {self.norm_type!r}")
        if self.n_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts models are not ported yet; the torch "
                "port serves dense models"
            )
        if self.is_critic:
            raise NotImplementedError(
                "critic (value-head) models are not ported yet"
            )
        if self.remat_policy != "none":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r}: only the default full "
                "per-layer recompute ('none') is ported"
            )

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def tiny_config(vocab_size: int = 256, **kwargs) -> TransformerConfig:
    """Small config for tests."""
    defaults = dict(
        n_layers=2,
        hidden_dim=32,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=8,
        intermediate_dim=64,
        vocab_size=vocab_size,
        max_position_embeddings=128,
        dtype="float32",
    )
    defaults.update(kwargs)
    return TransformerConfig(**defaults)


def qwen25_15b_config() -> TransformerConfig:
    """The Qwen2.5-1.5B architecture (hidden 1536, 28 layers, GQA 12q/2kv,
    head 128, SwiGLU 8960, vocab 151936, tied embedding, qkv bias, bf16).
    Weights are random; the repository holds no checkpoint."""
    return TransformerConfig(
        n_layers=28,
        hidden_dim=1536,
        n_q_heads=12,
        n_kv_heads=2,
        head_dim=128,
        intermediate_dim=8960,
        vocab_size=151936,
        max_position_embeddings=32768,
        use_attention_bias=True,
        tied_embedding=True,
        dtype="bfloat16",
    )
