"""Dataset utilities (the ``load_hf_tokenizer`` part of
``areal_tpu/api/dataset_api.py``; datasets and their registry are not
ported yet, ROADMAP.md queue 1, item 5)."""

from __future__ import annotations

from typing import Optional


def load_hf_tokenizer(
    model_name_or_path: str,
    fast_tokenizer: bool = True,
    padding_side: Optional[str] = None,
):
    """A local HF tokenizer directory's tokenizer, with the pad token set
    to EOS when the tokenizer has none."""
    import transformers

    kwargs = {}
    if padding_side is not None:
        kwargs["padding_side"] = padding_side
    tokenizer = transformers.AutoTokenizer.from_pretrained(
        model_name_or_path,
        use_fast=fast_tokenizer,
        trust_remote_code=True,
        **kwargs,
    )
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token_id = tokenizer.eos_token_id
    return tokenizer
