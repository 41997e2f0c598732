"""Batched autoregressive generation over the dense KV cache (port of
``areal_tpu/engine/generation.py``): sync PPO's ``actor_gen``.

:func:`generate_loop` prefills every prompt into a
:class:`~areal_tpu_torch.models.transformer.KVCache` and then decodes one
token per row per step with
:func:`~areal_tpu_torch.models.transformer.decode_step`, whose attention
on a card is the hand-written ``flash_decode`` kernel.  The reference
runs its decode loop on the device (a ``lax.while_loop`` that exits when
every row has finished); here the loop is on the host, and it reads one
value from the device a step (whether any row is still active), so it
stops when no row is active, as the reference's does.

Sampling is the serving engine's counter-keyed
:func:`~areal_tpu_torch.engine.sampling.sample_logits_keyed`: the draw for
row r's token at absolute position p is a function of ``(seed, r, p)``
alone.  Stop tokens are banned from sampling (not from the reported
logprob) until ``min_new_tokens`` have been generated.  Greedy tokens
equal the reference's; sampled ones follow its distribution (the two
packages' random streams differ).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.engine.batching import bucket_len
from areal_tpu_torch.engine.sampling import SamplingParams, sample_logits_keyed
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import KVCache, decode_step, prefill


@dataclasses.dataclass
class GenerationCounters:
    """Work of :func:`generate_loop`: decode steps (each one
    :func:`decode_step` over every row) and prefills."""

    decode_steps: int = 0
    prefills: int = 0


#: the work of :func:`generate_loop` since these were last set to 0
counters = GenerationCounters()


def _is_stop(tok: torch.Tensor, stop_tokens: Tuple[int, ...]) -> torch.Tensor:
    stop = torch.zeros_like(tok, dtype=torch.bool)
    for s in stop_tokens:
        stop |= tok == s
    return stop


@torch.no_grad()
def generate_loop(
    params,
    cfg: TransformerConfig,
    prompt_tokens: torch.Tensor,  # [B, T] right-padded
    prompt_lens: torch.Tensor,  # [B] int
    seed: int,
    max_new_tokens: int,
    min_new_tokens: int,
    stop_tokens: Tuple[int, ...],
    sampling: SamplingParams,
    cache_len: int,
):
    """Prefill, then decode until every row has stopped or
    ``max_new_tokens`` are out.  Returns ``(out_tokens [B, max_new] int32,
    out_logps [B, max_new] float32, n_generated [B] int32, no_eos [B]
    bool)`` on the prompts' device."""
    B, T = prompt_tokens.shape
    dev = prompt_tokens.device
    cache = KVCache.zeros(cfg, B, cache_len, device=dev)
    positions = torch.arange(T, device=dev).expand(B, T)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    seg_ids = (positions < prompt_lens[:, None]).to(torch.int32)
    last_idx = torch.clamp(prompt_lens - 1, min=0)
    logits, cache = prefill(
        params, cfg, prompt_tokens, positions, seg_ids, cache,
        last_pos=last_idx,
    )
    counters.prefills += 1

    banned = None
    if min_new_tokens > 0 and stop_tokens:
        banned = torch.zeros((cfg.vocab_size,), dtype=torch.bool, device=dev)
        banned[list(stop_tokens)] = True

    def ban_mask(n_prev):
        """[B, V]: stop tokens banned from sampling until min_new_tokens."""
        if banned is None:
            return None
        allow = (n_prev + 1 >= min_new_tokens)[:, None]
        return ~allow & banned[None, :]

    rows = torch.arange(B, dtype=torch.int32, device=dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    tok, logp = sample_logits_keyed(
        logits[:, 0].float(), seed, rows, prompt_lens, sampling,
        ban_mask=ban_mask(n_gen),
    )
    out_tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    out_logps = torch.zeros((B, max_new_tokens), dtype=torch.float32, device=dev)
    out_tokens[:, 0] = tok
    out_logps[:, 0] = logp
    n_gen += 1
    # padding rows are never active; a row continues only while the next
    # step's write (slot ``lengths``) fits the cache
    active = ~_is_stop(tok, stop_tokens) & (prompt_lens > 0)
    active &= cache.lengths < cache_len
    step = 1
    while step < max_new_tokens and bool(active.any()):
        logits, cache = decode_step(params, cfg, tok, cache, active=active)
        counters.decode_steps += 1
        # the advanced length is the sampled token's absolute position
        new_tok, logp = sample_logits_keyed(
            logits.float(), seed, rows, cache.lengths, sampling,
            ban_mask=ban_mask(n_gen),
        )
        tok = torch.where(active, new_tok, torch.zeros_like(new_tok))
        n_gen += active.to(torch.int32)
        out_tokens[:, step] = tok
        out_logps[:, step] = torch.where(active, logp, torch.zeros_like(logp))
        active = active & ~_is_stop(tok, stop_tokens)
        active &= cache.lengths < cache_len
        step += 1
    # still active == ran out of budget
    return out_tokens, out_logps, n_gen, active


def generate_tokens(
    params,
    cfg: TransformerConfig,
    prompts: Sequence[Sequence[int]],
    gconfig: model_api.GenerationHyperparameters,
    eos_token_id: Optional[int],
    seed: int,
) -> List[Dict]:
    """Expand each prompt into ``gconfig.n`` rows, bucket the shapes, run
    :func:`generate_loop` on the device ``params`` lie on and trim the outputs.  Returns one dict per (prompt, group member):
    ``{output_ids, output_logprobs, no_eos}``.

    The cache length is ``bucket_len(T + max_new_tokens)``: every bucket
    of at least 64 tokens is a multiple of 64, which lets a bf16 cache's
    ``flash_decode`` copy its tiles by TMA."""
    device = params["embed"]["weight"].device
    expanded: List[Sequence[int]] = []
    for p in prompts:
        expanded.extend([p] * gconfig.n)
    B = len(expanded)
    T = bucket_len(max(len(p) for p in expanded))
    toks = np.zeros((B, T), np.int64)
    lens = np.zeros((B,), np.int32)
    for i, p in enumerate(expanded):
        toks[i, : len(p)] = p
        lens[i] = len(p)

    stop = tuple(
        sorted(
            set(
                ([] if eos_token_id is None else [eos_token_id])
                + list(gconfig.stop_token_ids)
            )
        )
    )
    sampling = SamplingParams(
        temperature=gconfig.temperature,
        top_p=gconfig.top_p,
        top_k=(gconfig.top_k if gconfig.top_k < cfg.vocab_size else 0),
        greedy=gconfig.greedy,
    )
    max_new = gconfig.max_new_tokens
    out_tokens, out_logps, n_gen, no_eos = generate_loop(
        params,
        cfg,
        torch.from_numpy(toks).to(device),
        torch.from_numpy(lens).to(device),
        seed,
        max_new_tokens=max_new,
        min_new_tokens=gconfig.min_new_tokens,
        stop_tokens=stop,
        sampling=sampling,
        cache_len=bucket_len(T + max_new),
    )
    out_tokens = out_tokens.cpu().numpy()
    out_logps = out_logps.cpu().numpy()
    n_gen = n_gen.cpu().numpy()
    no_eos = no_eos.cpu().numpy()
    results = []
    for i in range(B):
        n = int(n_gen[i])
        results.append(
            dict(
                output_ids=out_tokens[i, :n].tolist(),
                output_logprobs=out_logps[i, :n].tolist(),
                no_eos=bool(no_eos[i]),
            )
        )
    return results


def generate_for_sample(
    model: model_api.Model,
    data: SequenceSample,
    gconfig: model_api.GenerationHyperparameters,
) -> SequenceSample:
    """sync PPO's ``actor_gen``: prompts in, PPO training keys out.

    It generates from the engine's parameters in the serving types
    (:func:`~areal_tpu_torch.models.convert.serving_params`: the model
    dtype, norm scales in float32), which is what the reference's forward
    computes from its float32 parameters, since it casts each of them to
    the activation dtype where it uses it; the copy is made once per call
    and dropped after it."""
    from areal_tpu_torch.models.convert import serving_params

    engine = model.engine
    prompt_lens = [l[0] for l in data.seqlens["packed_prompts"]]
    offsets = np.concatenate([[0], np.cumsum(prompt_lens)])
    prompts = [
        data.data["packed_prompts"][offsets[i] : offsets[i + 1]].tolist()
        for i in range(data.bs)
    ]
    eos = model.tokenizer.eos_token_id if model.tokenizer else None
    params = serving_params(engine.params, engine.model_cfg)
    results = generate_tokens(
        params,
        engine.model_cfg,
        prompts,
        gconfig,
        eos,
        (model.version.global_step * 2654435761) % (2**31),
    )
    del params

    seqs, logps, prompt_mask, no_eos, seqlens = [], [], [], [], []
    ids = []
    for i in range(data.bs):
        for j in range(gconfig.n):
            r = results[i * gconfig.n + j]
            p = prompts[i]
            seq = list(p) + r["output_ids"]
            seqs.append(np.array(seq, np.int32))
            lp = [0.0] * (len(p) - 1) + r["output_logprobs"]
            logps.append(np.array(lp, np.float32))
            pm = np.zeros(len(seq), bool)
            pm[: len(p)] = True
            prompt_mask.append(pm)
            no_eos.append(r["no_eos"])
            seqlens.append(len(seq))
            ids.append(f"{data.ids[i]}-{j}" if gconfig.n > 1 else data.ids[i])

    return SequenceSample.from_default(
        seqlens,
        ids,
        {
            "packed_input_ids": np.concatenate(seqs),
            "packed_logprobs": np.concatenate(logps),
            "prompt_mask": np.concatenate(prompt_mask),
            "seq_no_eos_mask": np.array(no_eos, np.float32),
        },
    )
