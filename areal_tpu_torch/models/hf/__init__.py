"""HF family adapters (port of ``areal_tpu/models/hf``).  Importing
registers the dense families: llama, qwen2, qwen3, mistral, gemma and
gpt2; the mixture-of-experts families are refused by name."""

from areal_tpu_torch.models.hf import gpt2, llama_like  # noqa: F401
from areal_tpu_torch.models.hf.registry import (  # noqa: F401
    get_hf_family,
    load_hf_config,
    load_hf_model,
    save_hf_model,
)
