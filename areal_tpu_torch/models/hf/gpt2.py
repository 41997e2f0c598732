"""GPT-2 HF adapter (port of ``areal_tpu/models/hf/gpt2.py``).

GPT-2's quirks: LayerNorm with bias, absolute position embeddings, the
fused q/k/v ``c_attn`` and every projection stored in Conv1D layout
(``[in, out]``, the port's own orientation, so nothing is transposed),
gelu, a tied LM head, and names under ``transformer.`` in checkpoints
saved from ``GPT2LMHeadModel``.
"""

from __future__ import annotations

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


def _config_from_hf(hf: Dict[str, Any]) -> TransformerConfig:
    return TransformerConfig(
        n_layers=hf["n_layer"],
        hidden_dim=hf["n_embd"],
        n_q_heads=hf["n_head"],
        n_kv_heads=hf["n_head"],
        head_dim=hf["n_embd"] // hf["n_head"],
        intermediate_dim=hf.get("n_inner") or 4 * hf["n_embd"],
        vocab_size=hf["vocab_size"],
        max_position_embeddings=hf.get("n_positions", 1024),
        activation="gelu",
        norm_type="layer",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        use_attention_bias=True,
        use_mlp_bias=True,
        gated_mlp=False,
        tied_embedding=True,
        abs_position_embedding=True,
    )


def _config_to_hf(cfg: TransformerConfig) -> Dict[str, Any]:
    return dict(
        architectures=["GPT2LMHeadModel"],
        model_type="gpt2",
        n_layer=cfg.n_layers,
        n_embd=cfg.hidden_dim,
        n_head=cfg.n_q_heads,
        n_inner=cfg.intermediate_dim,
        vocab_size=cfg.vocab_size,
        n_positions=cfg.max_position_embeddings,
        n_ctx=cfg.max_position_embeddings,
        layer_norm_epsilon=cfg.norm_eps,
        activation_function="gelu_new",
    )


def _params_from_hf(state: CheckpointReader, cfg: TransformerConfig) -> Params:
    pre = ("transformer." if any(k.startswith("transformer.")
                                 for k in state.keys()) else "")
    D = cfg.hidden_dim

    def g(name: str) -> torch.Tensor:
        return state.get(pre + name)

    def dense(name: str) -> Dict[str, torch.Tensor]:
        return {"w": g(name + ".weight"), "b": g(name + ".bias")}

    def norm(name: str) -> Dict[str, torch.Tensor]:
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    layers = []
    for i in range(cfg.n_layers):
        h = f"h.{i}."
        w = g(h + "attn.c_attn.weight")  # [D, 3D]
        b = g(h + "attn.c_attn.bias")  # [3D]
        attn: Params = {
            ours: {"w": w[:, j * D:(j + 1) * D].contiguous(),
                   "b": b[j * D:(j + 1) * D].contiguous()}
            for j, ours in enumerate(("q", "k", "v"))
        }
        attn["o"] = dense(h + "attn.c_proj")
        layers.append({
            "attn_norm": norm(h + "ln_1"),
            "attn": attn,
            "mlp_norm": norm(h + "ln_2"),
            # non-gated mlp: "gate" is the fc layer
            "mlp": {"gate": dense(h + "mlp.c_fc"),
                    "down": dense(h + "mlp.c_proj")},
        })
    return {
        "embed": {"weight": g("wte.weight")},
        "layers": layers,
        "final_norm": norm("ln_f"),
        "pos_embed": {"weight": g("wpe.weight")},
    }


def _params_to_hf(params: Params, cfg: TransformerConfig) -> StateDict:
    t = torch.as_tensor
    out: StateDict = {"wte.weight": t(params["embed"]["weight"]),
                      "wpe.weight": t(params["pos_embed"]["weight"])}
    for i, lp in enumerate(params["layers"]):
        pre = f"h.{i}."
        for hf_name, ours in (("ln_1", "attn_norm"), ("ln_2", "mlp_norm")):
            out[pre + hf_name + ".weight"] = t(lp[ours]["scale"])
            out[pre + hf_name + ".bias"] = t(lp[ours]["bias"])
        attn = lp["attn"]
        for part in ("w", "b"):
            out[pre + "attn.c_attn." + ("weight" if part == "w" else "bias")] = (
                torch.cat([t(attn[x][part]).float() for x in "qkv"], dim=-1))
        for hf_name, p in (("attn.c_proj", attn["o"]),
                           ("mlp.c_fc", lp["mlp"]["gate"]),
                           ("mlp.c_proj", lp["mlp"]["down"])):
            out[pre + hf_name + ".weight"] = t(p["w"])
            out[pre + hf_name + ".bias"] = t(p["b"])
    out["ln_f.weight"] = t(params["final_norm"]["scale"])
    out["ln_f.bias"] = t(params["final_norm"]["bias"])
    return out


register_hf_family(
    HFFamily(
        name="gpt2",
        hf_architecture="GPT2LMHeadModel",
        config_from_hf=_config_from_hf,
        config_to_hf=_config_to_hf,
        params_from_hf=_params_from_hf,
        params_to_hf=_params_to_hf,
    )
)
