"""Llama-family HF adapters: llama, qwen2, qwen3, mistral, gemma (port of
``areal_tpu/models/hf/llama_like.py``).

These share the ``model.layers.{i}.self_attn.*`` naming; the families
differ in bias flags (qwen2's q/k/v biases), qk-norm (qwen3), the sliding
window (mistral), tied embeddings, the norm offset (gemma stores its
RMSNorm scale as ``weight + 1``), gemma's embedding scale ``sqrt(hidden)``
and its tanh gelu.  The converters build the port's layout directly:
``params["layers"]`` is a list of per-layer dicts, matrices ``[in, out]``.

One difference from the reference: a config whose ``rope_scaling`` is not
null is refused (the reference ignores the key and would load Llama-3.x
checkpoints with the wrong rotary frequencies past their original
context).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.hf.registry import (
    CheckpointReader,
    HFFamily,
    Params,
    StateDict,
    register_hf_family,
)


def _llama_like_config_from_hf(hf: Dict[str, Any], **overrides) -> TransformerConfig:
    if hf.get("rope_scaling") is not None:
        raise ValueError(
            f"config.json sets rope_scaling={hf['rope_scaling']!r}: scaled "
            "rotary embeddings are not supported (only rope_scaling: null "
            "loads; ROADMAP.md section 3)"
        )
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    kwargs = dict(
        n_layers=hf["num_hidden_layers"],
        hidden_dim=hf["hidden_size"],
        n_q_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        rotary_base=hf.get("rope_theta", 10000.0),
        tied_embedding=hf.get("tie_word_embeddings", False),
        # qwen2 configs carry a window with use_sliding_window: false
        sliding_window=(
            hf.get("sliding_window")
            if hf.get("use_sliding_window", True)
            else None
        ),
    )
    kwargs.update(overrides)
    return TransformerConfig(**kwargs)


def _llama_like_config_to_hf(
    cfg: TransformerConfig, model_type: str, architecture: str, **extra
) -> Dict[str, Any]:
    hf = dict(
        architectures=[architecture],
        model_type=model_type,
        hidden_size=cfg.hidden_dim,
        intermediate_size=cfg.intermediate_dim,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_q_heads,
        num_key_value_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        vocab_size=cfg.vocab_size,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rotary_base,
        tie_word_embeddings=cfg.tied_embedding,
        hidden_act="silu" if cfg.activation == "silu" else "gelu_pytorch_tanh",
        torch_dtype="bfloat16",
    )
    if cfg.sliding_window is not None:
        hf["sliding_window"] = cfg.sliding_window
        hf["use_sliding_window"] = True
    hf.update(extra)
    return hf


def _params_from_hf(
    state: CheckpointReader,
    cfg: TransformerConfig,
    qkv_bias: bool = False,
    qk_norm: bool = False,
    gemma_norm: bool = False,
) -> Params:
    def norm(name: str) -> Dict[str, torch.Tensor]:
        t = state.get(name)
        return {"scale": t + 1.0 if gemma_norm else t}

    layers = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        attn: Params = {
            ours: {"w": state.get(f"{pre}self_attn.{ours}_proj.weight",
                                  transpose=True)}
            for ours in ("q", "k", "v", "o")
        }
        if qkv_bias:
            for ours in ("q", "k", "v"):
                attn[ours]["b"] = state.get(f"{pre}self_attn.{ours}_proj.bias")
        if qk_norm:
            attn["q_norm"] = norm(f"{pre}self_attn.q_norm.weight")
            attn["k_norm"] = norm(f"{pre}self_attn.k_norm.weight")
        mlp = {
            ours: {"w": state.get(f"{pre}mlp.{ours}_proj.weight",
                                  transpose=True)}
            for ours in ("gate", "down", "up")
        }
        layers.append({
            "attn_norm": norm(f"{pre}input_layernorm.weight"),
            "attn": attn,
            "mlp_norm": norm(f"{pre}post_attention_layernorm.weight"),
            "mlp": mlp,
        })
    params: Params = {
        "embed": {"weight": state.get("model.embed_tokens.weight")},
        "layers": layers,
        "final_norm": norm("model.norm.weight"),
    }
    if not cfg.tied_embedding and not cfg.is_critic:
        params["lm_head"] = {"w": state.get("lm_head.weight", transpose=True)}
    return params


def _params_to_hf(
    params: Params,
    cfg: TransformerConfig,
    qkv_bias: bool = False,
    qk_norm: bool = False,
    gemma_norm: bool = False,
) -> StateDict:
    """HF names to tensors in the reference's order; matrices are
    transposed views, norm scales lose gemma's offset."""
    t = torch.as_tensor

    def norm(p):
        return t(p["scale"]).float() - 1.0 if gemma_norm else t(p["scale"])

    out: StateDict = {"model.embed_tokens.weight": t(params["embed"]["weight"])}
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = norm(lp["attn_norm"])
        out[pre + "post_attention_layernorm.weight"] = norm(lp["mlp_norm"])
        for ours in ("q", "k", "v", "o"):
            out[pre + f"self_attn.{ours}_proj.weight"] = t(
                lp["attn"][ours]["w"]).T
            if qkv_bias and ours != "o":
                out[pre + f"self_attn.{ours}_proj.bias"] = t(
                    lp["attn"][ours]["b"])
        if qk_norm:
            out[pre + "self_attn.q_norm.weight"] = norm(lp["attn"]["q_norm"])
            out[pre + "self_attn.k_norm.weight"] = norm(lp["attn"]["k_norm"])
        for ours in ("gate", "up", "down"):
            out[pre + f"mlp.{ours}_proj.weight"] = t(lp["mlp"][ours]["w"]).T
    out["model.norm.weight"] = norm(params["final_norm"])
    if "lm_head" in params:
        out["lm_head.weight"] = t(params["lm_head"]["w"]).T
    if "value_head" in params:
        out["value_head.weight"] = t(params["value_head"]["w"]).T
    return out


def _register(name, arch, config_from_hf=None, **flags):
    register_hf_family(HFFamily(
        name=name,
        hf_architecture=arch,
        config_from_hf=config_from_hf or (
            lambda hf: _llama_like_config_from_hf(hf)),
        config_to_hf=lambda cfg: _llama_like_config_to_hf(cfg, name, arch),
        params_from_hf=lambda s, c: _params_from_hf(s, c, **flags),
        params_to_hf=lambda p, c: _params_to_hf(p, c, **flags),
    ))


_register("llama", "LlamaForCausalLM")
_register("qwen2", "Qwen2ForCausalLM",
          config_from_hf=lambda hf: _llama_like_config_from_hf(
              hf, use_attention_bias=True),
          qkv_bias=True)
_register("qwen3", "Qwen3ForCausalLM",
          config_from_hf=lambda hf: _llama_like_config_from_hf(
              hf, use_qk_norm=True),
          qk_norm=True)
_register("mistral", "MistralForCausalLM")


def _gemma_config_from_hf(hf: Dict[str, Any]) -> TransformerConfig:
    return _llama_like_config_from_hf(
        hf,
        activation="gelu",
        tied_embedding=True,
        embed_scale=float(math.sqrt(hf["hidden_size"])),
    )


# gemma's gelu exports as hidden_act "gelu_pytorch_tanh", as the reference's
_register("gemma", "GemmaForCausalLM", config_from_hf=_gemma_config_from_hf,
          gemma_norm=True)
